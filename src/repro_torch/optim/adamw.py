"""AdamW and its learning-rate schedule, PyTorch port of ``repro.optim.adamw``.

State mirrors the param tree: ``m`` and ``v`` in f32 whatever the params'
dtype, ``step`` an int32 0-d tensor. The update is computed in f32 and cast
back to each param's dtype, so bf16 params stay bf16 (``master_fp32`` is the
reference's field, which its update does not read either).

Numerics kept from the reference:
- ``lr_at`` and the bias corrections are f32 tensor arithmetic: ``b1 ** step``
  is an f32 power of an f32 step, not a Python double.
- ``global_norm`` sums the leaves' f32 squared sums one after another in the
  reference's leaf order (``jax.tree.leaves``: dict keys sorted).

Unlike the reference, which returns new arrays, ``apply_updates`` runs under
``torch.no_grad()`` and updates params, ``m`` and ``v`` IN PLACE (a full
ViT-L/16 step would otherwise hold a second copy of 3 GB of state), and
returns the same objects. On a mesh (DTensor leaves, under ``use_rules``) a
grad, its param and its moments share one placement, so every update is
elementwise on each rank's shard: nothing is gathered, and each leaf keeps
its placement; the scalars (step, lr, clip) are replicated.
``abstract_state`` is ``init_state`` on ``device="meta"``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch

from repro_torch.models.param import flatten, tree_map
from repro_torch.sharding.rules import replicated


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    master_fp32: bool = False


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in f32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_state(params: dict) -> dict:
    """Zero f32 moments on each param's device, and step 0."""
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = next(iter(flatten(params).values())).device
    return {"m": tree_map(zeros32, params), "v": tree_map(zeros32, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def leaves(tree) -> list[torch.Tensor]:
    """The leaves in ``jax.tree.leaves`` order: dict keys sorted, sequences
    in order."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 squared sum, f32 0-d. A sharded
    (DTensor) leaf's sum is reduced across its ranks before it is added, so
    on a mesh the norm is a replicated 0-d DTensor, the same on every rank."""
    total = None
    for x in leaves(tree):
        sq = replicated(torch.sum(torch.square(x.float())))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: dict, grads: dict, state: dict):
    """One AdamW step, in place. Returns (params, state, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) if cfg.grad_clip else 1.0
    lr = lr_at(cfg, step)
    stepf = step.float()
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)

    flat_g, flat_m, flat_v = flatten(grads), flatten(state["m"]), flatten(state["v"])
    for key, p in flatten(params).items():
        g = flat_g[key].float() * clip
        m, v = flat_m[key], flat_v[key]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        update = update + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * update)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
