"""The plain reference of the benchmark's ViT configurations: a Vision
Transformer (arXiv:2010.11929) with ToMe token merging (Bolya et al.,
ICLR'23, bipartite soft matching with proportional attention), written in
plain PyTorch in float32 from the published description.

It imports nothing of the program under test. It takes the benchmark's own
weights (a dict of tensors in the layout documented in ``harness.weights``)
and images, upcasts each layer's weights to float32 as it reaches them, and
computes its own merges from its own float32 scores.

Departures from the papers, shared with the system under test: GELU is the
tanh form, layer norms use eps 1e-6, and the ToMe similarity metric is the
keys averaged over heads; the class token never merges.

``quant`` makes the control: a function applied to every matrix product's
operands (weights, activations, attention's q, k, v and probabilities), such
as ``fp8_rows``, which rounds to float8 e4m3 with one scale per row.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

Quant = Callable[[torch.Tensor], torch.Tensor] | None

E4M3_MAX = 448.0


def fp8_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per row (its last axis),
    back in float32: the operands of an fp8 matrix product."""
    amax = t.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
    scale = amax / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _q(quant: Quant, t: torch.Tensor) -> torch.Tensor:
    return t if quant is None else quant(t)


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, quant: Quant) -> torch.Tensor:
    """x [..., d_in] @ w [d_in, d_out] + b; under ``quant`` the weight is
    rounded per output column (the rows of w transposed)."""
    w = w.float()
    if quant is not None:
        w = quant(w.t().contiguous()).t()
    return _q(quant, x) @ w + b.float()


def _layernorm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)(W/p), p*p*C], patches in row-major order,
    each patch's pixels row-major with channels last."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // patch, patch, w // patch, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // patch) * (w // patch), patch * patch * c)


def embed(params: dict, cfg: dict, images: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    pe = params["patch_embed"]
    x = _linear(patchify(images.float(), cfg["patch"]), pe["w"], pe["b"], quant)
    cls = params["cls"].float().expand(x.shape[0], 1, x.shape[2])
    return torch.cat([cls, x], dim=1) + params["pos"].float()


def attention(x: torch.Tensor, p: dict, sizes: torch.Tensor, n_heads: int,
              quant: Quant = None):
    """Multi-head self-attention with the proportional-attention bias
    log(size) on every key. Returns (out [B, N, d], keys averaged over the
    heads [B, N, head_dim])."""
    b, n, d = x.shape
    hd = d // n_heads

    def heads(name):
        y = _linear(x, p[f"w{name}"], p[f"b{name}"], quant)
        return y.reshape(b, n, n_heads, hd).transpose(1, 2)

    q, k, v = heads("q"), heads("k"), heads("v")
    s = _q(quant, q) @ _q(quant, k).transpose(-1, -2) / math.sqrt(hd)
    s = s + torch.log(sizes)[:, None, None, :]
    prob = torch.softmax(s, dim=-1)
    o = _q(quant, prob) @ _q(quant, v.transpose(-1, -2).contiguous()).transpose(-1, -2)
    o = o.transpose(1, 2).reshape(b, n, d)
    return _linear(o, p["wo"], p["bo"], quant), k.mean(dim=1)


def tome_merge(x: torch.Tensor, metric: torch.Tensor, sizes: torch.Tensor, r: int):
    """Merge the ``r`` tokens of the even-position set A most similar (cosine
    of ``metric``) to a token of the odd-position set B into it, as
    size-weighted means. Token 0 (the class token, in A) never merges. The
    survivors of A keep their order, followed by B."""
    m = metric / metric.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    scores = m[:, ::2] @ m[:, 1::2].transpose(-1, -2)
    node_max, node_idx = scores.max(dim=-1)
    node_max[:, 0] = -math.inf
    order = torch.argsort(node_max, dim=-1, descending=True, stable=True)
    src, keep = order[:, :r], torch.sort(order[:, r:], dim=-1).values
    dst = torch.gather(node_idx, 1, src)

    a, bset = x[:, ::2], x[:, 1::2]
    sa, sb = sizes[:, ::2], sizes[:, 1::2]
    d = x.shape[-1]
    wsum = (bset * sb[..., None]).scatter_add(
        1, dst[..., None].expand(-1, -1, d),
        torch.gather(a * sa[..., None], 1, src[..., None].expand(-1, -1, d)))
    sb_new = sb.scatter_add(1, dst, torch.gather(sa, 1, src))
    kept = torch.gather(a, 1, keep[..., None].expand(-1, -1, d))
    return (torch.cat([kept, wsum / sb_new[..., None]], dim=1),
            torch.cat([torch.gather(sa, 1, keep), sb_new], dim=1))


def block(x: torch.Tensor, sizes: torch.Tensor, p: dict, cfg: dict, r: int,
          quant: Quant = None):
    eps = cfg["layer_norm_eps"]
    a, metric = attention(_layernorm(x, p["ln1"], eps), p["attn"], sizes,
                          cfg["num_attention_heads"], quant)
    x = x + a
    if r > 0:
        x, sizes = tome_merge(x, metric, sizes, r)
    h = _layernorm(x, p["ln2"], eps)
    h = torch.nn.functional.gelu(_linear(h, p["mlp"]["fc1"]["w"], p["mlp"]["fc1"]["b"], quant),
                                 approximate="tanh")
    return x + _linear(h, p["mlp"]["fc2"]["w"], p["mlp"]["fc2"]["b"], quant), sizes


def _layer(tree, l: int):
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


def forward(params: dict, cfg: dict, images: torch.Tensor, schedule: Sequence[int],
            quant: Quant = None) -> torch.Tensor:
    """images [B, H, W, C] -> logits [B, classes] in float32, merging
    ``schedule[l]`` tokens in layer l."""
    if len(schedule) != cfg["num_hidden_layers"]:
        raise ValueError(f"schedule has {len(schedule)} layers, config "
                         f"{cfg['num_hidden_layers']}")
    x = embed(params, cfg, images, quant)
    sizes = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
    for l, r in enumerate(schedule):
        x, sizes = block(x, sizes, _layer(params["blocks"], l), cfg, int(r), quant)
    x = _layernorm(x, params["norm"], cfg["layer_norm_eps"])
    return _linear(x[:, 0], params["head"]["w"], params["head"]["b"], quant)
