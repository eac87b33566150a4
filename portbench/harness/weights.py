"""Weights and images made from the seed, on the device, in a few large
calls.

The weight tree is the layout the ViT path takes (stacked over layers under
``blocks``): the benchmark builds it from the configuration file alone, and
hands the same tensors to the program and to the reference. Every leaf is a
view into one flat buffer drawn by one ``torch.randn`` in the served dtype,
then scaled in place: matrices by 1/sqrt(fan in), the class and position
embeddings by 0.02, biases by 0.02, layer-norm scales to 1 + 0.02 z.
"""
from __future__ import annotations

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg: dict) -> torch.dtype:
    return _DTYPES[cfg["dtype"]]


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one use (``stream``) of the run's ``seed``."""
    return int(np.random.SeedSequence([seed % 2**64, stream]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def layout(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(path, shape, kind) of every leaf; kind is how it is scaled."""
    d, f, n = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    pdim = cfg["patch"] ** 2 * cfg["in_channels"]
    leaves = [("patch_embed/w", (pdim, d), "matrix"), ("patch_embed/b", (d,), "bias"),
              ("cls", (1, 1, d), "embed"), ("pos", (1, cfg["num_tokens"], d), "embed")]
    block = [("ln1/scale", (d,), "scale"), ("ln1/bias", (d,), "bias")]
    for name in ("q", "k", "v", "o"):
        block += [(f"attn/w{name}", (d, d), "matrix"), (f"attn/b{name}", (d,), "bias")]
    block += [("ln2/scale", (d,), "scale"), ("ln2/bias", (d,), "bias"),
              ("mlp/fc1/w", (d, f), "matrix"), ("mlp/fc1/b", (f,), "bias"),
              ("mlp/fc2/w", (f, d), "matrix"), ("mlp/fc2/b", (d,), "bias")]
    leaves += [(f"blocks/{p}", (n, *s), k) for p, s, k in block]
    leaves += [("norm/scale", (d,), "scale"), ("norm/bias", (d,), "bias"),
               ("head/w", (d, cfg["num_classes"]), "matrix"),
               ("head/b", (cfg["num_classes"],), "bias")]
    return leaves


def make_params(cfg: dict, seed: int, device: torch.device) -> dict:
    leaves = layout(cfg)
    total = sum(int(np.prod(s)) for _, s, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 0))
    flat = torch.randn(total, generator=gen, dtype=dtype_of(cfg), device=device)
    tree: dict = {}
    off = 0
    for path, shape, kind in leaves:
        size = int(np.prod(shape))
        leaf = flat[off:off + size].view(shape)
        off += size
        if kind == "matrix":
            leaf.mul_(shape[-2] ** -0.5)
        elif kind == "scale":
            leaf.mul_(0.02).add_(1.0)
        else:
            leaf.mul_(0.02)
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def make_images(cfg: dict, count: int, seed: int, device: torch.device,
                chunk: int = 256) -> torch.Tensor:
    """``count`` images [count, H, W, C] in the served dtype: smooth noise
    (a coarse grid of one value a patch, upsampled bilinearly) plus fine
    noise at a tenth of its scale, so that neighbouring patches are alike
    as in a photograph and ToMe finds pairs worth merging."""
    res, grid, c = cfg["img_res"], cfg["img_res"] // cfg["patch"], cfg["in_channels"]
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 1))
    out = torch.empty((count, res, res, c), dtype=dtype_of(cfg), device=device)
    for lo in range(0, count, chunk):
        n = min(chunk, count - lo)
        coarse = torch.randn((n, c, grid, grid), generator=gen, device=device)
        img = torch.nn.functional.interpolate(coarse, size=(res, res), mode="bilinear",
                                              align_corners=False)
        img += 0.1 * torch.randn(img.shape, generator=gen, device=device)
        out[lo:lo + n] = img.permute(0, 2, 3, 1)
    return out
