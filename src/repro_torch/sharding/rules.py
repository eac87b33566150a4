"""Logical-axis -> mesh-axis sharding rules, PyTorch port of
``repro.sharding.rules`` on ``torch.distributed`` DTensors.

Models annotate parameters (``ParamSpec.axes``) and activations
(``constrain(x, ("batch", "seq", "embed"))``) with *logical* axis names
only. A ``Rules`` object, built from a profile name and a mesh, maps them to
mesh axes: ``spec_for`` gives the reference's per-dim spec (a tuple of
``None``, a mesh axis or a tuple of mesh axes, the reference's
``PartitionSpec`` entries), ``sharding_for`` the DTensor placements of that
spec on the mesh (``Shard(d)`` on each mesh dim that tensor dim ``d`` maps
to, ``Replicate()`` elsewhere; a dim mapped to ``("pod", "data")`` takes
both, in mesh order, which is the reference's major-to-minor order).

Divisibility fallback, as the reference: a dim whose size does not divide
by the product of its mesh axes is replicated and recorded in
``Rules.fallbacks``.

Placement never copies a weight: ``place`` takes each rank's slice of a
global tensor as a view and wraps it with ``DTensor.from_local``
(``distribute_tensor`` copies, and qwen3-moe's 61 GB of bf16 weights plus a
copy do not fit on one 80 GB card).

Where DTensor cannot run an op, or where it must not decide how (the
Hopper kernels, the ToMe merge's sorts and scatters, convolutions), the
model calls ``run_local``: the op runs on each rank's local tensors, and its
result is wrapped back with the operands' placements. It allows sharding
only on the dims the op treats independently (batch rows, attention heads)
or declares with a ``Halo`` (a convolution's rows: each rank's block gets
its neighbours' edge rows first, ``halo_exchange``), and raises on any
other: a sharded operand is never gathered silently.

Profiles:
  tp       TP on "model" for hidden/head/vocab/expert dims; DP on batch.
  fsdp_tp  tp + weights' embed/vocab dims sharded over "data" (ZeRO-3).
  ep_tp    tp + experts on "model" (expert parallelism); attention TP.
  dp       pure data parallel (params replicated).
"""
from __future__ import annotations

import contextvars
import dataclasses
import math
from typing import Any, Callable, Mapping, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.param import ParamSpec, tree_map
from repro_torch.runtime import hlo_bytes

# Mesh axes are ("pod", "data", "model") or ("data", "model"); "pod" folds into
# data-parallelism whenever present.
BATCH_AXES = ("pod", "data")

_BASE = {
    # weight dims
    "embed": None,
    "mlp": "model",
    "heads": "model",
    "kv": "model",
    "vocab": "model",
    "experts": None,
    "patch": None,
    "pos": None,
    "layers": None,
    "stack": None,
    "conv_in": None,
    "conv_out": "model",
    "kh": None,
    "kw": None,
    # activation dims
    "batch": BATCH_AXES,
    "seq": None,
    "act_seq_kv": "model",  # KV-cache sequence dim: flash-decoding style split-S
    "act_vocab": "model",   # logits vocab dim (vocab-TP cross entropy)
    "act_spatial": None,    # conv activation height (spatial partitioning)
    "act_embed": None,
    "act_heads": "model",
    "act_kv": "model",
    "act_mlp": "model",
    "act_experts": None,
    "act_conv_out": "model",
}

PROFILES: dict[str, dict[str, Any]] = {
    "dp": {**{k: None for k in _BASE}, "batch": BATCH_AXES},
    "tp": dict(_BASE),
    "fsdp_tp": {**_BASE, "embed": "data", "vocab": ("model",), "experts": None},
    "ep_tp": {**_BASE, "experts": "model", "act_experts": "model",
              "mlp": None, "act_mlp": None},
    "fsdp_ep_tp": {**_BASE, "embed": "data", "experts": "model",
                   "act_experts": "model", "mlp": None, "act_mlp": None},
    # spatial partitioning for convs: activations split along H on "model",
    # weights replicated
    "spatial": {**{k: None for k in _BASE}, "batch": BATCH_AXES,
                "act_spatial": "model"},
    # MoE experiments: EP weights without forced expert-sharded activations...
    "ep_tp_noact": {**_BASE, "experts": "model", "act_experts": None,
                    "mlp": None, "act_mlp": None},
    # ...and per-expert-hidden TP instead of EP
    "moe_mlp_tp": {**_BASE, "experts": None, "act_experts": None},
}


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis: size}`` in mesh order, of a ``DeviceMesh`` or of a shape
    given as such a mapping (``spec_for`` reads nothing else)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass
class Rules:
    mapping: dict[str, Any]
    mesh: Any  # a DeviceMesh, or {axis: size} for spec_for alone

    def __post_init__(self):
        self.fallbacks: list[tuple[Any, Any, str]] = []

    @property
    def shape(self) -> dict[str, int]:
        return mesh_shape(self.mesh)

    def _mesh_axes(self, logical: Any) -> tuple[str, ...]:
        if logical is None:
            return ()
        m = self.mapping.get(logical, None)
        if m is None:
            return ()
        if isinstance(m, str):
            m = (m,)
        return tuple(a for a in m if a in self.shape)

    def spec_for(self, shape: tuple[int, ...], axes: tuple[Any, ...]) -> tuple:
        if len(shape) != len(axes):
            raise ValueError(f"shape {tuple(shape)} vs axes {axes} rank mismatch")
        sizes = self.shape
        used: set[str] = set()
        dims = []
        for size, logical in zip(shape, axes):
            mesh_axes = tuple(a for a in self._mesh_axes(logical) if a not in used)
            if mesh_axes:
                total = math.prod(sizes[a] for a in mesh_axes)
                if size % total != 0:
                    self.fallbacks.append((logical, mesh_axes, f"{size} % {total} != 0"))
                    mesh_axes = ()
            used.update(mesh_axes)
            if not mesh_axes:
                dims.append(None)
            elif len(mesh_axes) == 1:
                dims.append(mesh_axes[0])
            else:
                dims.append(mesh_axes)
        return tuple(dims)

    def sharding_for(self, shape, axes) -> tuple:
        """The DTensor placements of ``spec_for(shape, axes)``, one per mesh
        dim. A tensor dim of size 1 (which divides only by mesh dims of size
        1) is left replicated: the same data, and DTensor refuses the views
        that drop a sharded singleton (a B=1 activation into a matmul)."""
        shape = tuple(shape)
        return self.placements(self.spec_for(shape, tuple(axes)), shape)

    def placements(self, spec: tuple, shape) -> tuple:
        """The DTensor placements of a ``spec_for`` spec of a tensor of
        ``shape`` (``sharding_for`` without the logical axes)."""
        return spec_placements(spec, shape, self.shape)

    def named(self, spec: tuple) -> "NamedSharding":
        """``spec`` on the rules' mesh."""
        return NamedSharding(spec, self.mesh)

    def place(self, x: torch.Tensor, axes: tuple[Any, ...]) -> DTensor:
        """The global tensor ``x`` (every rank holds all of it) as a DTensor
        placed by ``axes``: each rank keeps its slice as a view, no copy."""
        return place(x, self.mesh, self.sharding_for(x.shape, axes))

    def constrain(self, x: torch.Tensor, axes: tuple[Any, ...]) -> DTensor:
        """``x`` redistributed to ``sharding_for(x.shape, axes)``; a plain
        tensor is taken as the global value (``place``). Under autograd the
        gradient is brought to the same placements, as the transpose of the
        reference's ``with_sharding_constraint`` constrains the cotangent
        (else DTensor's backward may carry a split it cannot view, such as
        an uneven one of a spatial dim, into the next op)."""
        placements = self.sharding_for(x.shape, axes)
        if not isinstance(x, DTensor):
            return place(x, self.mesh, placements)
        if torch.is_grad_enabled() and x.requires_grad:
            return _Constrain.apply(x, placements)
        return redistribute(x, placements)


class _Constrain(torch.autograd.Function):
    """``x`` redistributed to ``placements``, and its gradient too."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        if tuple(x.placements) == tuple(placements):
            return x.view_as(x)
        return redistribute(x, placements)

    @staticmethod
    def backward(ctx, g):
        return redistribute(g, ctx.placements), None


def hold_grad_placements(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is; under autograd a DTensor's gradient is brought to
    ``x``'s placements (where DTensor's backward would carry a split it
    cannot view, such as one inside a head, into the op before)."""
    if isinstance(x, DTensor) and torch.is_grad_enabled() and x.requires_grad:
        return _Constrain.apply(x, tuple(x.placements))
    return x


def spec_placements(spec: tuple, shape, sizes: Mapping[str, int]) -> tuple:
    """The DTensor placements, one per mesh dim of ``sizes`` ({axis: size}
    in mesh order), of a ``spec_for`` spec of a tensor of ``shape``. A
    tensor dim of size 1 is left replicated (see ``Rules.sharding_for``)."""
    out = []
    for name in sizes:
        dim = next((d for d, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)), None)
        out.append(Replicate() if dim is None or shape[dim] == 1 else Shard(dim))
    return tuple(out)


class NamedSharding(tuple):
    """A ``spec_for`` spec on its mesh, the counterpart of the reference's
    ``NamedSharding(mesh, PartitionSpec)``: it compares and iterates as the
    spec tuple, ``.mesh`` is the mesh and ``placements(shape)`` the DTensor
    placements of a tensor of ``shape``. Trees of these are a sharded
    bundle's ``in_shardings`` and ``out_shardings``, which ``data.place``
    and ``Checkpointer.restore(shardings=)`` take."""

    def __new__(cls, spec, mesh):
        self = super().__new__(cls, spec)
        self.mesh = mesh
        return self

    def placements(self, shape) -> tuple:
        return spec_placements(self, shape, mesh_shape(self.mesh))


def shard_slices(shape, mesh, placements: Sequence) -> tuple[slice, ...]:
    """This rank's index (a tuple of slices) into a global array of
    ``shape`` under ``placements``, in mesh order, so two mesh dims sharding
    one tensor dim split it major to minor. Basic slicing: on a tensor or a
    numpy array it is a view."""
    idx = [slice(0, n) for n in shape]
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            start, stop = idx[p.dim].start, idx[p.dim].stop
            chunk = (stop - start) // n
            if chunk * n != stop - start:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not divide "
                                 f"by mesh dim {i} of size {n}")
            idx[p.dim] = slice(start + coord[i] * chunk, start + (coord[i] + 1) * chunk)
    return tuple(idx)


def place(x: torch.Tensor, mesh, placements: Sequence) -> DTensor:
    """``x``'s slice on this rank under ``placements`` (a view,
    ``shard_slices``), wrapped as a DTensor without a copy or a check."""
    local = x[shard_slices(x.shape, mesh, placements)]
    return DTensor.from_local(local, mesh, list(placements), run_check=False)


_active: contextvars.ContextVar[Rules | None] = contextvars.ContextVar(
    "active_sharding_rules", default=None)


class use_rules:
    """Activate ``rules`` in this scope (None deactivates). While rules are
    active, plain tensors that meet DTensors in an op are taken as
    replicated global values (DTensor's implicit replication), as a jitted
    reference program treats its constants. Only the outermost active scope
    enters it: its exit turns implicit replication off for the process, so
    a nested scope's exit must not."""

    def __init__(self, rules: Rules | None):
        self.rules = rules

    def __enter__(self):
        outer = _active.get()
        self._token = _active.set(self.rules)
        self._implicit = None
        if self.rules is not None and outer is None:
            from torch.distributed.tensor.experimental import implicit_replication
            self._implicit = implicit_replication()
            self._implicit.__enter__()
        return self.rules

    def __exit__(self, *exc):
        if self._implicit is not None:
            self._implicit.__exit__(*exc)
        _active.reset(self._token)


def current_rules() -> Rules | None:
    return _active.get()


def constrain(x: torch.Tensor, axes: tuple[Any, ...]) -> torch.Tensor:
    """Annotate activation sharding; identity when no rules are active."""
    r = current_rules()
    if r is None:
        return x
    return r.constrain(x, axes)


def params_sharding(specs_tree, rules: Rules):
    """Placements tree matching a ParamSpec tree."""
    return tree_map(lambda s: rules.sharding_for(s.shape, s.axes), specs_tree)


def place_params(params: dict, specs_tree, rules: Rules) -> dict:
    """A param tree placed per the rules' mesh: each rank's slice of each
    leaf as a view of the caller's tensor (no copy), wrapped as a DTensor."""
    placements = params_sharding(specs_tree, rules)

    def walk(p, s):
        if isinstance(s, ParamSpec) or not isinstance(s, Mapping):
            return place(p, rules.mesh, s)
        return {k: walk(p[k], s[k]) for k in s}

    return {k: walk(params[k], placements[k]) for k in placements}


def make_rules(profile: str, mesh) -> Rules:
    if profile not in PROFILES:
        raise KeyError(f"unknown sharding profile {profile!r}; have {list(PROFILES)}")
    return Rules(dict(PROFILES[profile]), mesh)


# ---------------------------------------------------------------------------
# the local boundary
# ---------------------------------------------------------------------------


def to_global(x):
    """A DTensor as the plain global tensor (a plain tensor as itself). No
    collective where every sharded mesh dim has size 1."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    if all(mesh.size(i) == 1 or isinstance(p, Replicate)
           for i, p in enumerate(x.placements)):
        return x.to_local()
    return x.full_tensor()


def redistribute(x: DTensor, placements: Sequence) -> DTensor:
    """``x`` in ``placements``. Where it differs only on mesh dims of size 1
    (whose one rank holds the global value under any placement) it is
    relabelled without a collective."""
    mesh = x.device_mesh
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    if all(mesh.size(i) == 1 for i, (a, b) in enumerate(zip(x.placements, placements))
           if a != b):
        return DTensor.from_local(x.to_local(), mesh, placements, run_check=False,
                                  shape=x.shape, stride=x.stride())
    return x.redistribute(mesh, placements)


def replicated(x: torch.Tensor) -> torch.Tensor:
    """A DTensor replicated on every mesh dim (a pending sum is reduced, a
    shard gathered); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return redistribute(x, [Replicate()] * x.device_mesh.ndim)


def local_part(t: torch.Tensor, mesh, placements: Sequence,
               grad_placements: Sequence | None = None) -> torch.Tensor:
    """This rank's local tensor of ``t`` under ``placements``. A DTensor is
    redistributed where a mesh dim of size > 1 differs (a dim of size 1
    holds the global data under any placement); a plain tensor is taken as
    the global value and sliced (views). ``grad_placements`` (default:
    ``placements``) says what the local tensor's gradient is: ``Partial()``
    on a mesh dim where each rank's gradient is only its share of a sum."""
    if not isinstance(t, DTensor):
        return place(t, mesh, placements).to_local()
    want = tuple(p if mesh.size(i) > 1 else t.placements[i]
                 for i, p in enumerate(placements))
    if tuple(t.placements) != want:
        t = t.redistribute(mesh, want)
    if grad_placements is not None:
        grad_placements = tuple(g if mesh.size(i) > 1 else t.placements[i]
                                for i, g in enumerate(grad_placements))
    return t.to_local(grad_placements=grad_placements)


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(stride))


@dataclasses.dataclass(frozen=True)
class Halo:
    """A ``run_local`` role of a dim that the op computes with a halo (a
    convolution's or a pool's rows). Where a mesh dim splits it, each
    rank's block gets ``before`` rows of the previous rank's block and
    ``after`` of the next's first, and ``fill`` (the op's padding value)
    past the first and last block; the result keeps the split."""
    role: str
    before: int
    after: int
    fill: float = 0.0


def _role(r):
    return r.role if isinstance(r, Halo) else r


def _swap(to_prev, to_next, n_prev: int, n_next: int, dim: int, group, like: torch.Tensor):
    """Point-to-point over ``group``: ``to_prev`` goes to the previous rank
    and ``to_next`` to the next (None: nothing that way); ``n_prev`` rows
    along ``dim`` come from the previous rank and ``n_next`` from the next.
    Returns (from the previous, from the next), None where no rank is there
    or nothing comes."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    ops, got = [], [None, None]

    def receive(side, n, peer):
        shape = list(like.shape)
        shape[dim] = n
        got[side] = like.new_empty(shape)
        ops.append(dist.P2POp(dist.irecv, got[side], dist.get_global_rank(group, peer), group))

    if rank > 0:
        if to_prev is not None:
            ops.append(dist.P2POp(dist.isend, to_prev.contiguous(),
                                  dist.get_global_rank(group, rank - 1), group))
        if n_prev:
            receive(0, n_prev, rank - 1)
    if rank + 1 < size:
        if to_next is not None:
            ops.append(dist.P2POp(dist.isend, to_next.contiguous(),
                                  dist.get_global_rank(group, rank + 1), group))
        if n_next:
            receive(1, n_next, rank + 1)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got


def _rows_bytes(x: torch.Tensor, dim: int, n: int) -> float:
    return x.numel() // max(x.shape[dim], 1) * n * x.element_size()


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, before, after, fill, group):
        h = x.shape[dim]
        if before > h or after > h:
            raise ValueError(f"a halo of ({before}, {after}) rows is wider than a block of {h}")
        ctx.args = (dim, before, after, group)
        sends = [_rows_bytes(x, dim, n) for n in (before, after) if n]
        top, bottom = hlo_bytes.permutes(group, sends, lambda: _swap(
            x.narrow(dim, 0, after) if after else None,
            x.narrow(dim, h - before, before) if before else None, before, after, dim, group, x))

        def edge(n):
            shape = list(x.shape)
            shape[dim] = n
            return x.new_full(shape, fill)
        parts = ([top if top is not None else edge(before)] if before else []) + [x] + \
            ([bottom if bottom is not None else edge(after)] if after else [])
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        dim, before, after, group = ctx.args
        h = g.shape[dim] - before - after
        mid = g.narrow(dim, before, h).clone()
        sends = [_rows_bytes(g, dim, n) for n in (before, after) if n]
        from_prev, from_next = hlo_bytes.permutes(group, sends, lambda: _swap(
            g.narrow(dim, 0, before) if before else None,
            g.narrow(dim, before + h, after) if after else None, after, before, dim, group, g))
        if from_prev is not None:
            mid.narrow(dim, 0, after).add_(from_prev)
        if from_next is not None:
            mid.narrow(dim, h - before, before).add_(from_next)
        return mid, None, None, None, None, None


def halo_exchange(x: torch.Tensor, dim: int, before: int, after: int, fill: float,
                  group) -> torch.Tensor:
    """``x``, this rank's block of a dim split over ``group`` in rank order,
    with ``before`` rows of the previous rank's block and ``after`` of the
    next's around it along ``dim``; ``fill`` past the first and last
    block. Batched point-to-point sends (gloo, NCCL and the fake backend
    all have them), counted as the reference's ``collective-permute``
    (``hlo_bytes.permutes``). Its backward is the transpose: each halo's
    gradient goes back to the rank that owns those rows and is added there."""
    if not before and not after:
        return x
    return _HaloExchange.apply(x, dim, before, after, fill, group)


def run_local(name: str, fn: Callable, operands: Sequence, roles: Sequence,
              out_roles: Sequence):
    """``fn(*locals)`` on each rank's local tensors of ``operands``.

    ``roles`` gives, per operand, one label per dim: a dim labelled (e.g.
    ``"batch"``, ``"heads"``) is one ``fn`` treats independently, and may be
    sharded; a ``Halo`` labels one ``fn`` computes from neighbouring rows,
    which may be sharded on one mesh dim and reaches ``fn`` with its halo
    (``halo_exchange``); ``None`` marks a dim that must not be. Non-tensor operands
    (``None``, ints) pass as they are, a plain tensor is taken as the global
    value; with no DTensor operand, ``fn`` runs on the operands unchanged. For
    each mesh dim of size > 1 the labelled role sharded on it is brought
    to every operand that has the role (a replicated operand is sliced, a
    pending sum is reduced); an operand sharded on an unlabelled dim, two
    roles on one mesh dim, or a role whose size does not divide, raise.
    ``out_roles`` labels ``fn``'s output (or, as a list, each of its
    outputs); outputs come back as DTensors on the operands' mesh, sharded
    where their role is.

    Under autograd: an operand left replicated on a mesh dim over which the
    work is split (it lacks the role sharded there) gets, on each rank, only
    that rank's share of its gradient; it leaves the boundary as a pending
    sum (``Partial``), reduced where it meets its param's placements."""
    dts = [t for t in operands if isinstance(t, DTensor)]
    if not dts:
        return fn(*operands)
    mesh = dts[0].device_mesh
    mesh_role: list[str | None] = [None] * mesh.ndim
    for t, r in zip(operands, roles):
        if not isinstance(t, DTensor):
            continue
        for i, p in enumerate(t.placements):
            if mesh.size(i) == 1 or not isinstance(p, Shard):
                continue
            role = _role(r[p.dim])
            if role is None:
                raise ValueError(
                    f"{name}: an operand of shape {tuple(t.shape)} is sharded on dim "
                    f"{p.dim} (mesh dim {i}), which {name} does not treat independently; "
                    f"only {sorted({_role(x) for rr in roles for x in rr if x})} may be "
                    f"sharded")
            if mesh_role[i] not in (None, role):
                raise ValueError(f"{name}: mesh dim {i} shards both {mesh_role[i]!r} "
                                 f"and {role!r}")
            mesh_role[i] = role
    halos = {_role(x) for rr in roles for x in rr if isinstance(x, Halo)}
    for role in halos:
        if mesh_role.count(role) > 1:
            raise ValueError(f"{name}: {role!r} has a halo and is split by more than one "
                             f"mesh dim")

    def target(t, r):
        out, names = [], [_role(x) for x in r]
        for i in range(mesh.ndim):
            role = mesh_role[i]
            if mesh.size(i) == 1:  # the local data is the global data there
                out.append(t.placements[i] if isinstance(t, DTensor) else Replicate())
            elif role is not None and role in names:
                d = names.index(role)
                if t.shape[d] % mesh.size(i):
                    raise ValueError(f"{name}: {role} dim {d} of {tuple(t.shape)} does "
                                     f"not divide by mesh dim {i} of size {mesh.size(i)}")
                out.append(Shard(d))
            else:
                out.append(Replicate())
        return tuple(out)

    def grad_at(t, r):
        return tuple(Partial() if mesh.size(i) > 1 and mesh_role[i] is not None
                     and isinstance(p, Replicate) else p
                     for i, p in enumerate(target(t, r)))

    def with_halos(x, r):
        for i, role in enumerate(mesh_role):
            for d, h in enumerate(r):
                if mesh.size(i) > 1 and isinstance(h, Halo) and h.role == role:
                    x = halo_exchange(x, d, h.before, h.after, h.fill, mesh.get_group(i))
        return x

    local = [with_halos(local_part(t, mesh, target(t, r), grad_at(t, r)), r)
             if isinstance(t, torch.Tensor) else t for t, r in zip(operands, roles)]
    out = fn(*local)

    def wrap(y, r):
        placements, shape = [], list(y.shape)
        for i in range(mesh.ndim):
            role = mesh_role[i]
            if mesh.size(i) > 1 and role is not None and role in r:
                d = r.index(role)
                placements.append(Shard(d))
                shape[d] *= mesh.size(i)
            else:
                placements.append(Replicate())
        return DTensor.from_local(y, mesh, placements, run_check=False,
                                  shape=torch.Size(shape), stride=_contiguous_stride(shape))

    if isinstance(out, tuple):
        return tuple(wrap(y, r) for y, r in zip(out, out_roles))
    return wrap(out, out_roles)
