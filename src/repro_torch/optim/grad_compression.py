"""Gradient compression, PyTorch port of ``repro.optim.grad_compression``.

* ``topk_sparsify`` + error feedback (Lin et al., DGC): keep the largest-|g|
  fraction, carry the residual to the next step. The threshold is the k-th
  largest |g| (``torch.topk``, as ``jax.lax.top_k``), so ties keep the same
  mask, bit for bit. A dropped element is +0, as the reference's product
  with the mask gives (XLA makes it a select; a float product would keep
  the sign of a negative element).
* ``int8_compress``/``int8_decompress``: per-tensor max-abs int8
  quantization (``torch.round`` and ``jnp.round`` both round half to even).
* ``compressed_psum_mean``, the data-parallel mean with an int8 wire format,
  needs the sharded train step: it waits for the training mesh, the next
  slice of the port (ROADMAP.md queue 1), and raises.
"""
from __future__ import annotations

import torch

from repro_torch.models.param import flatten, unflatten


def topk_sparsify(g: torch.Tensor, keep_ratio: float):
    """Returns (sparse_g, mask): the top-|g| fraction of ``g`` kept."""
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * keep_ratio))
    thresh = torch.topk(flat.abs(), k).values[-1]
    mask = g.abs() >= thresh
    return torch.where(mask, g, 0.0), mask  # +0 where dropped, as the reference


def ef_step(grads: dict, error_state: dict, keep_ratio: float):
    """Error-feedback top-k on a param tree: returns (compressed, new_error)."""
    flat_e = flatten(error_state)
    sparse, error = {}, {}
    for key, g in flatten(grads).items():
        corrected = g.float() + flat_e[key]
        s, mask = topk_sparsify(corrected, keep_ratio)
        sparse[key] = s.to(g.dtype)
        error[key] = torch.where(mask, 0.0, corrected)
    return unflatten(sparse), unflatten(error)


def init_error_state(grads: dict) -> dict:
    return unflatten({k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                      for k, g in flatten(grads).items()})


def int8_compress(x: torch.Tensor):
    """(q int8, scale f32 0-d) with q = clip(round(x / scale), -127, 127)."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def compressed_psum_mean(tree, mesh, axis: str = "data"):
    """Data-parallel mean with an int8 wire format: needs a mesh."""
    raise NotImplementedError(
        "compressed_psum_mean is not ported yet: it comes with the training mesh, "
        "the next slice of the port (ROADMAP.md queue 1)")
