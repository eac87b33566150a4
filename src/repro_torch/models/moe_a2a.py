"""Expert-parallel MoE with explicit all-to-all dispatch: PyTorch port of
``repro.models.moe_a2a``.

Under pure GSPMD the combine-gather across expert-sharded buffers lowers to
a full [tokens, slots, d] all-reduce; this is the production pattern
instead. Per rank of the mesh (the reference's ``shard_map`` body, here on
each rank's local tensors and ``torch.distributed`` collectives on the
mesh's groups):

  1. take this rank's slice of its data shard's tokens (replicated across
     "model"), route top-k;
  2. first-level capacity dispatch BY DESTINATION RANK -> [tp, cap, d] send
     buffer, exchanged with ``all_to_all_single`` on the "model" group (the
     tokens, then their local expert ids);
  3. second-level local dispatch into per-local-expert capacity buffers,
     batched SwiGLU over the rank's e_loc experts;
  4. scatter back -> reverse all-to-all -> combine with the locally kept
     gates; all-gather the token slices back across "model".

The aux loss is averaged over the "model" and data groups.

Differentiable: the float exchanges go through autograd collectives
(``_AllToAll``, whose backward is the reverse all-to-all; ``_AllGather``,
whose backward is a reduce-scatter; ``_AllReduce``, whose backward is an
all-reduce: ``torch.distributed.nn.functional``'s are deprecated, and its
all-gather's backward fails on a gloo subgroup), and the gradients are the
reference's ``jax.grad`` of its ``shard_map`` (``check_rep=False``): there
the cotangent of an output replicated over ``n`` ranks (``y`` over
"model", ``aux`` over every axis) is divided by ``n`` before the body's
transpose (``_replicated_out``), and an input's gradient is summed over the
ranks it is replicated on (the ``Partial`` gradient placements of
``apply``'s local parts). ``collectives`` counts the collective calls this
module makes in the forward (three all-to-alls, one all-gather and one
all-reduce a mesh axis, per layer call that does not fall back).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models import moe as moe_lib
from repro_torch.models.moe import MoEConfig, _positions_in_expert
from repro_torch.sharding.rules import local_part, mesh_shape, to_global

collectives = 0


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of dim 0 goes to rank j of ``group``; chunk j of the result
    came from rank j (the reference's untiled ``all_to_all`` on a leading
    [tp, ...] axis). Differentiable for a float ``x``."""
    global collectives
    collectives += 1
    return _AllToAll.apply(x, group)


class _AllToAll(torch.autograd.Function):
    """``dist.all_to_all_single`` of ``x``'s equal chunks; the backward is
    the reverse all-to-all of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


class _AllGather(torch.autograd.Function):
    """The group's ``x`` concatenated along dim 0 in rank order; the
    backward sums each rank's slice of the gradient over the group (a
    reduce-scatter, here one all-to-all and a sum, which every backend
    has)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, g):
        recv = torch.empty_like(g)
        dist.all_to_all_single(recv, g.contiguous(), group=ctx.group)
        n = dist.get_world_size(ctx.group)
        return recv.reshape(n, g.shape[0] // n, *g.shape[1:]).sum(dim=0), None


class _AllReduce(torch.autograd.Function):
    """The sum of ``x`` over the group; the backward sums the gradient over
    it too (the transpose of a psum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReplicatedOut(torch.autograd.Function):
    """Identity; the gradient divided by ``n``, the count of ranks the
    output is replicated on (the reference's shard_map transpose)."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _replicated_out(x: torch.Tensor, n: int) -> torch.Tensor:
    if n == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _ReplicatedOut.apply(x, n)


def route(logits: torch.Tensor):
    """(probs, probs sorted descending, expert order) of f32 router logits
    [t, E]; the order is a stable sort, so the first k are ``lax.top_k``'s
    (lower expert index first on exact ties)."""
    probs = torch.softmax(logits, dim=-1)
    sorted_probs, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, sorted_probs, order


def _local_moe(cfg: MoEConfig, tp: int, shard: int, model_group, dp_groups, x, router,
               w_gate, w_up, w_down):
    """Per-rank body. x: [t_rep, d] (tokens replicated across "model");
    expert weights: this rank's shards [e_loc, d, f]. Returns (y [t_rep, d],
    aux f32)."""
    global collectives
    t_rep, d = x.shape
    e_loc = w_gate.shape[0]
    k = cfg.top_k
    t_loc = t_rep // tp
    x_my = x[shard * t_loc:(shard + 1) * t_loc]
    dev = x.device

    # ---- route my token slice
    probs, sorted_probs, order = route((x_my @ router.to(x.dtype)).float())
    gates, experts = sorted_probs[:, :k], order[:, :k]          # [t_loc, k]
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)

    # ---- level 1: dispatch by destination rank
    slots = t_loc * k
    dest = (experts // e_loc).reshape(slots)
    cap = max(1, math.ceil(slots * cfg.capacity_factor / tp))
    pos = _positions_in_expert(dest, tp)                        # rank within dest
    keep = pos < cap
    cell = torch.where(keep, dest * cap + pos, tp * cap)        # sentinel = tp*cap
    token_of_slot = torch.arange(slots, device=dev) // k
    send_x = torch.zeros((tp * cap + 1, d), dtype=x.dtype, device=dev)
    send_x[cell] = x_my[token_of_slot]                           # only the sentinel repeats
    send_x = send_x[:-1]
    send_eid = torch.full((tp * cap + 1,), e_loc, dtype=torch.int64, device=dev)
    send_eid[cell] = (experts % e_loc).reshape(slots)            # e_loc = invalid marker
    send_eid = send_eid[:-1]

    recv_x = _all_to_all(send_x, model_group)                    # [tp*cap, d]
    recv_eid = _all_to_all(send_eid, model_group)

    # ---- level 2: local dispatch into per-expert capacity buffers
    n_recv = tp * cap
    c2 = max(1, math.ceil(n_recv * cfg.capacity_factor / max(e_loc, 1)))
    pos2 = _positions_in_expert(recv_eid, e_loc + 1)            # +1 bin for invalid
    valid2 = (recv_eid < e_loc) & (pos2 < c2)
    cell2 = torch.where(valid2, recv_eid * c2 + pos2, e_loc * c2)
    x_exp = torch.zeros((e_loc * c2 + 1, d), dtype=x.dtype, device=dev)
    x_exp[cell2] = recv_x
    x_exp = x_exp[:-1].reshape(e_loc, c2, d)

    h = F.silu(torch.bmm(x_exp, w_gate.to(x.dtype)))
    h = h * torch.bmm(x_exp, w_up.to(x.dtype))
    y_exp = torch.bmm(h, w_down.to(x.dtype))                    # [e_loc, c2, d]

    # ---- scatter back to wire slots, reverse all-to-all
    y_wire = y_exp.reshape(e_loc * c2, d)[torch.clamp(cell2, max=e_loc * c2 - 1)]
    y_wire = torch.where(valid2[:, None], y_wire, 0)
    y_back = _all_to_all(y_wire, model_group)                    # [tp*cap, d]

    # ---- combine at source with the locally kept gates
    y_slot = y_back[torch.clamp(cell, max=tp * cap - 1)]
    y_slot = torch.where(keep[:, None], y_slot, 0).reshape(t_loc, k, d)
    y_my = torch.einsum("tkd,tk->td", y_slot, gates.to(x.dtype))

    # ---- reassemble the replicated token block across "model"
    y = _replicated_out(_AllGather.apply(y_my, model_group), tp)
    collectives += 1

    # aux loss: the per-rank estimate averaged over every mesh axis
    frac = F.one_hot(experts[:, 0], cfg.n_experts).float().mean(dim=0)
    aux = cfg.n_experts * torch.sum(frac * probs.mean(dim=0))
    n = 1
    for group in (model_group, *dp_groups):
        aux = _AllReduce.apply(aux, group)
        collectives += 1
        n *= dist.get_world_size(group)
    return y, _replicated_out(aux / n, n)


def _local(t: torch.Tensor, mesh, placements, grad_placements) -> torch.Tensor:
    """``local_part`` of ``t``; a plain ``t`` that requires grad is first
    taken as a replicated DTensor, so that its gradient is the sum of every
    rank's."""
    if not isinstance(t, DTensor) and torch.is_grad_enabled() and t.requires_grad:
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return local_part(t, mesh, placements, grad_placements)


def apply(params: dict, cfg: MoEConfig, x: torch.Tensor, mesh, model_axis: str = "model"):
    """x [B, S, D] -> (y [B, S, D], aux). Runs the a2a dispatch on ``mesh``
    (a ``DeviceMesh``); tokens must divide by dp*tp, else the gspmd path
    (``moe.apply``) serves, as the reference. ``x`` and the params may be
    DTensors on ``mesh`` or plain (global) tensors; ``y`` comes back
    sharded over the data axes like the tokens, ``aux`` replicated."""
    b, s, d = x.shape
    shape = mesh_shape(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in shape)
    dp = math.prod(shape[a] for a in dp_axes)
    tp = shape[model_axis]
    t = b * s
    if t % (dp * tp) != 0:  # tiny decode batches: the gspmd path handles them
        return moe_lib.apply(params, cfg, x)
    names = list(shape)
    tokens = tuple(Shard(0) if a in dp_axes else Replicate() for a in names)
    experts = tuple(Shard(0) if a == model_axis else Replicate() for a in names)
    # each input's gradient sums over the ranks it is replicated on
    on_model = tuple(Partial() if a == model_axis else p for a, p in zip(names, tokens))
    on_data = tuple(Partial() if a in dp_axes else p for a, p in zip(names, experts))
    x_loc = _local(x.reshape(t, d), mesh, tokens, on_model)
    w = [_local(params[n], mesh, experts, on_data) for n in ("w_gate", "w_up", "w_down")]
    router = _local(params["router"], mesh, (Replicate(),) * len(names),
                    (Partial(),) * len(names))
    shard = mesh.get_local_rank(model_axis)
    y, aux = _local_moe(cfg, tp, shard, mesh.get_group(model_axis),
                        [mesh.get_group(a) for a in dp_axes], x_loc, router, *w)
    # y is this rank's data shard (a size-1 axis holds all of it: Replicate)
    y_at = [Shard(0) if a in dp_axes and shape[a] > 1 else Replicate() for a in names]
    y = DTensor.from_local(y, mesh, y_at, run_check=False,
                           shape=torch.Size((t, d)), stride=(d, 1))
    aux = DTensor.from_local(aux, mesh, [Replicate()] * len(names), run_check=False)
    if not isinstance(x, DTensor):  # a plain (global) x gets plain global results
        y, aux = to_global(y), to_global(aux)
    return y.reshape(b, s, d), aux
