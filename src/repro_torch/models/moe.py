"""Mixture-of-Experts layer with group-wise capacity routing (gather-based):
PyTorch port of ``repro.models.moe``.

Tokens are routed in groups of ``group_size`` along the flattened batch
(one group of all tokens when it does not divide, e.g. a decode batch of 8);
each group gives every expert ``capacity`` cells. Routing is a softmax
router and a top-k taken by a stable descending sort (lower expert index
first on exact ties, as ``jax.lax.top_k``; ``torch.topk`` orders ties
otherwise). A slot's rank within its expert comes from a stable sort of the
expert ids, so earlier slots win the capacity and later ones are dropped.
Dispatch gathers tokens into ``[g, e, c, d]`` cells, the SwiGLU experts run
as batched matmuls over the expert axis, and the combine gathers each slot's
output back and weighs it by its gate.

Experts may be zero-padded to ``n_experts_padded`` (granite's 40 -> 48):
the router spans the ``n_experts`` real experts, the weights and cells span
``e_pad``, and the capacity divides by ``n_experts``. The dispatch is plain
PyTorch: the reference's is jnp gathers and einsums outside any Pallas
kernel.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.param import ParamSpec
from repro_torch.sharding.rules import constrain, run_local


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                      # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 256          # tokens per routing group
    n_experts_padded: int | None = None  # zero-pad experts to this for even EP
    router_dtype: torch.dtype = torch.float32

    @property
    def e_pad(self) -> int:
        return self.n_experts_padded or self.n_experts

    def capacity(self, group_size: int | None = None) -> int:
        sg = group_size or self.group_size
        c = math.ceil(sg * self.top_k * self.capacity_factor / self.n_experts)
        return max(c, 1)


def specs(cfg: MoEConfig) -> dict:
    e = cfg.e_pad
    return {
        "router": ParamSpec((cfg.d_model, cfg.n_experts), ("embed", None), init="fan_in"),
        "w_gate": ParamSpec((e, cfg.d_model, cfg.d_ff), ("experts", "embed", "mlp"), init="fan_in"),
        "w_up": ParamSpec((e, cfg.d_model, cfg.d_ff), ("experts", "embed", "mlp"), init="fan_in"),
        "w_down": ParamSpec((e, cfg.d_ff, cfg.d_model), ("experts", "mlp", "embed"), init="fan_in"),
    }


def route(cfg: MoEConfig, logits: torch.Tensor):
    """logits [..., E_real] -> (gates [..., K] renormalized, experts [..., K]
    int64). The top-k is the first k of a stable descending sort, so exact
    ties keep the lower expert index first, as ``jax.lax.top_k``."""
    probs = torch.softmax(logits.to(cfg.router_dtype), dim=-1)
    sorted_probs, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = sorted_probs[..., :cfg.top_k], order[..., :cfg.top_k]
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    return gates, experts


def _positions_in_expert(experts_flat: torch.Tensor, n_experts: int) -> torch.Tensor:
    """experts_flat [..., M] expert ids -> [..., M] rank of each slot within
    its expert (per row of the leading axes). The stable sort keeps earlier
    slots at lower rank (position-priority dropping)."""
    m = experts_flat.shape[-1]
    order = torch.argsort(experts_flat, dim=-1, stable=True)
    sorted_e = torch.gather(experts_flat, -1, order)
    counts = torch.zeros((*experts_flat.shape[:-1], n_experts), dtype=torch.int64,
                         device=experts_flat.device)
    counts.scatter_add_(-1, experts_flat, torch.ones_like(experts_flat))
    starts = torch.cumsum(counts, dim=-1) - counts
    pos_sorted = torch.arange(m, device=experts_flat.device) - torch.gather(starts, -1, sorted_e)
    return torch.zeros_like(experts_flat).scatter_(-1, order, pos_sorted)


def apply(params: dict, cfg: MoEConfig, x: torch.Tensor):
    """x [B, S, D] -> (y [B, S, D], aux_loss f32 scalar).

    Tokens are grouped by ``group_size``, falling back to one group of all
    tokens when it does not divide (as the reference: a decode batch of 8
    on qwen3 gets capacity 1 and drops tokens)."""
    b, s, d = x.shape
    t = b * s
    sg = cfg.group_size if t % cfg.group_size == 0 else t
    g = t // sg
    k, e, c = cfg.top_k, cfg.e_pad, cfg.capacity(sg)

    xg = constrain(x.reshape(g, sg, d), ("batch", None, "act_embed"))
    logits = xg @ params["router"].to(xg.dtype)
    gates, experts = route(cfg, logits)  # [g, sg, k]

    # load-balancing aux loss (Switch-style): E * sum_e f_e * p_e
    probs = torch.softmax(logits.to(cfg.router_dtype), dim=-1)
    frac = F.one_hot(experts[..., 0], cfg.n_experts).to(cfg.router_dtype).mean(dim=(0, 1))
    aux_loss = cfg.n_experts * torch.sum(frac * probs.mean(dim=(0, 1)))

    # per-group dispatch bookkeeping: slots in token-major, k-minor order
    def dispatch(e_slots):
        pos = _positions_in_expert(e_slots, e)
        kept = pos < c
        dest = torch.where(kept, e_slots * c + pos, e * c)  # sentinel = e * c
        # slot of each (expert, capacity) cell; only the sentinel column takes
        # duplicate writes, and it is discarded
        slot_of_cell = torch.full((e_slots.shape[0], e * c + 1), sg * k, dtype=torch.int64,
                                  device=e_slots.device)
        slot_of_cell.scatter_(1, dest, torch.arange(sg * k, device=e_slots.device).expand(
            e_slots.shape[0], -1))
        return kept, dest, slot_of_cell[:, :e * c]

    rows = ("batch", None)
    kept, dest, slot_of_cell = run_local("moe dispatch", dispatch,
                                         (experts.reshape(g, sg * k),), (rows,), [rows] * 3)

    # gather expert inputs: [g, e, c, d]
    token_of_cell = torch.clamp(slot_of_cell // k, max=sg - 1)  # sentinel-safe
    cell_valid = (slot_of_cell < sg * k)[..., None]
    x_exp = torch.gather(xg, 1, token_of_cell[..., None].expand(-1, -1, d))
    x_exp = torch.where(cell_valid, x_exp, 0).reshape(g, e, c, d)
    x_exp = constrain(x_exp, ("batch", "act_experts", None, "act_embed"))

    # expert FFN (SwiGLU), batched over experts: [e, g*c, d]
    xe = x_exp.transpose(0, 1).reshape(e, g * c, d)
    h = F.silu(torch.bmm(xe, params["w_gate"].to(x.dtype)))
    h = h * torch.bmm(xe, params["w_up"].to(x.dtype))
    y_exp = torch.bmm(h, params["w_down"].to(x.dtype))  # [e, g*c, d]

    # combine: gather each slot's output, weight by gate, sum over k
    y_exp = constrain(y_exp.reshape(e, g, c, d).transpose(0, 1),
                      ("batch", "act_experts", None, "act_embed"))
    y_flat = y_exp.reshape(g, e * c, d)
    safe_dest = torch.clamp(dest, max=e * c - 1)
    y_slots = torch.gather(y_flat, 1, safe_dest[..., None].expand(-1, -1, d))
    y_slots = torch.where(kept[..., None], y_slots, 0).reshape(g, sg, k, d)
    y = torch.einsum("gskd,gsk->gsd", y_slots, gates.to(x.dtype))
    y = constrain(y, ("batch", None, "act_embed"))
    return y.reshape(b, s, d), aux_loss


def dense_reference(params: dict, cfg: MoEConfig, x: torch.Tensor) -> torch.Tensor:
    """Exact no-capacity reference: every token through its top-k experts."""
    logits = x @ params["router"].to(x.dtype)
    gates, experts = route(cfg, logits)  # [b, s, k]
    h = F.silu(torch.einsum("bsd,edf->bsef", x, params["w_gate"].to(x.dtype)))
    h = h * torch.einsum("bsd,edf->bsef", x, params["w_up"].to(x.dtype))
    y_all = torch.einsum("bsef,efd->bsed", h, params["w_down"].to(x.dtype))
    onehot = F.one_hot(experts, cfg.e_pad).to(x.dtype)  # [b, s, k, e]
    w = torch.einsum("bske,bsk->bse", onehot, gates.to(x.dtype))
    return torch.einsum("bsed,bse->bsd", y_all, w)
