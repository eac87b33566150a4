"""Gradient compression, PyTorch port of ``repro.optim.grad_compression``.

* ``topk_sparsify`` + error feedback (Lin et al., DGC): keep the largest-|g|
  fraction, carry the residual to the next step. The threshold is the k-th
  largest |g| (``torch.topk``, as ``jax.lax.top_k``), so ties keep the same
  mask, bit for bit. A dropped element is +0, as the reference's product
  with the mask gives (XLA makes it a select; a float product would keep
  the sign of a negative element).
* ``int8_compress``/``int8_decompress``: per-tensor max-abs int8
  quantization (``torch.round`` and ``jnp.round`` both round half to even).
* ``compressed_psum_mean``: the data-parallel mean with an int8 wire format,
  the reference's formula: each rank quantizes its own leaf with its own
  scale, the int8 values are summed in int32 and the scales reduced by max
  across the mesh axis, and the sum is dequantized with the largest scale
  over the axis' size. Where the ranks' scales differ that is not the exact
  mean (each ``q`` was quantized with its own scale and is dequantized with
  the largest); the reference only ever feeds it replicated leaves, where
  it is the int8 round trip.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

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
    """Mean over the ``axis`` of ``mesh`` (a ``DeviceMesh``) of every leaf of
    ``tree`` (a tensor or a nested dict of them) with an int8 wire format:
    ``sum_i(q_i) * max_i(scale_i) / n``, the sum in int32, on each rank's
    local tensor. A plain tensor is this rank's value; a DTensor leaf must
    be replicated on every mesh dim of size > 1 (the reference's in_specs
    ``P()``) and comes back with its placements."""
    group = mesh.get_group(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))

    def one(x):
        local = x
        if isinstance(x, DTensor):
            if any(mesh.size(i) > 1 and not isinstance(p, Replicate)
                   for i, p in enumerate(x.placements)):
                raise ValueError(f"compressed_psum_mean: a leaf placed {x.placements} "
                                 "is not replicated; it takes replicated leaves, as the "
                                 "reference's shard_map in_specs P()")
            local = x.to_local()
        q, scale = int8_compress(local)
        acc = q.to(torch.int32)
        dist.all_reduce(acc, dist.ReduceOp.SUM, group=group)
        smax = scale.clone()
        dist.all_reduce(smax, dist.ReduceOp.MAX, group=group)
        out = (acc.float() * smax / n).to(x.dtype)
        if isinstance(x, DTensor):
            return DTensor.from_local(out, x.device_mesh, x.placements, run_check=False)
        return out

    if isinstance(tree, torch.Tensor):
        return one(tree)
    return unflatten({k: one(v) for k, v in flatten(tree).items()})
