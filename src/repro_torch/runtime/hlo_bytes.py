"""Per-rank FLOP, byte and collective counts of a step, PyTorch port of
``repro.runtime.hlo_bytes`` (which derives HBM bytes from compiled HLO text;
the port has no HLO and counts the ATen operations it dispatches instead).

``Counter`` is one ``TorchDispatchMode`` (a ``CommDebugMode``, whose
collective counts it keeps) entered around a step:

- **FLOPs**: ``torch.utils.flop_counter.flop_registry`` (matmuls,
  convolutions, attention) on each operation's *local* operands. A DTensor
  operation is let through (``NotImplemented``, as ``CommDebugMode`` does)
  and counted when DTensor re-dispatches it on the rank's local tensors,
  after any redistribution, so a sharded product counts this rank's share
  and not the global one. DTensor's own shape propagation (an operation
  run on fake global-shaped tensors, ``ShardingPropagator``'s tensor-meta
  step) is not counted.
- **Bytes**: operand plus result bytes of every operation on local tensors
  (an in-place operation reads and writes its target), except views and
  aliases (``Tensor.view``, ``expand``, ``permute``, ``transpose``,
  ``slice``, ``select``, ``as_strided``, ``alias``, ``detach``, ... any
  schema that returns a view), allocations (``empty``), ``prim`` queries
  and waits on collectives. Unlike the reference's TPU projection,
  ``_to_copy`` (casts), ``expand`` materialisations and other copies are
  counted: in eager PyTorch on the card they are real passes over memory.
- **Collectives**: every functional and c10d collective the step issues
  (DTensor redistributions included), as ``Collective`` records of the op,
  the group's size and global ranks, and the operand bytes, for
  ``roofline.collective_bytes``. Point-to-point sends and receives are
  reported by their caller (``permutes``: a halo exchange is the
  reference's ``collective-permute``).
- **Kernels**: the Hopper kernels are called through ctypes, which no
  dispatch mode sees, and their plain versions (the CPU and fake routes)
  materialise tensors the kernels never write. So ``kernels.ops`` reports
  each call with ``kernel(name, cost)``: the kernel's own FLOPs and bytes
  (inputs read once, outputs written once) are added, and dispatch counting
  is paused inside the call, on every route. The count of a step is then
  the same on a fake world, on the CPU and on the card.

``Counter.calls`` keeps every counted call (kind, bytes, FLOPs, shapes) for
``runtime.hloprof``. With ``memory=True`` it also keeps the rank's peak of
live bytes (``peak_bytes``): the storages of the tensors given to ``track``
(the step's arguments) and of every counted operation's results, each
until it is freed; a kernel call adds its outputs, not what its plain
version allocates on the way.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from collections import defaultdict
from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.distributed.tensor.debug._comm_mode import c10d_collective_ops
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten
_NOT_COUNTED = frozenset({
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.detach.default, _aten.alias.default, _aten.lift_fresh.default,
    _aten._unsafe_view.default,  # a view whose schema does not say so
    torch.ops._c10d_functional.wait_tensor.default,
})

# op packet name -> (ring-model op, index of the operand argument): the
# functional collectives (DTensor's), then the c10d ones (torch.distributed's)
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_coalesced": ("all-gather", 0),
    "all_reduce": ("all-reduce", 0),
    "all_reduce_coalesced": ("all-reduce", 0),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "all_to_all_single": ("all-to-all", 0),
    "shard_dim_alltoall": ("all-to-all", 0),
    "broadcast": ("broadcast", 0),
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "reduce_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_coalesced_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "alltoall_base_": ("all-to-all", 1),
    "alltoall_": ("all-to-all", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "broadcast_": ("broadcast", 0),
    "scatter_": ("broadcast", 1),
    "gather_": ("broadcast", 0),
}


@dataclasses.dataclass
class Collective:
    op: str                  # the ring model's name: "all-gather", "all-reduce", ...
    n: int                   # group size
    bytes: float             # operand bytes on this rank
    ranks: tuple[int, ...]   # the group's global ranks
    kind: str = ""           # the op ("c10d.alltoall_base_", "_c10d_functional.all_reduce", ...)


@dataclasses.dataclass
class Call:
    kind: str                # the op's name ("aten.mm", "kernel.flash_attention", ...)
    bytes: float
    flops: float
    shapes: str


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _on_meta(args) -> bool:
    return any(isinstance(t, torch.Tensor) and t.device.type == "meta"
               for t in tree_leaves(args))


def _group(args, kwargs):
    """The process group of a collective's arguments (a boxed c10d group or
    a functional collective's group name)."""
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a)
            except RuntimeError:
                continue
    name = kwargs.get("group_name", args[-1] if args and isinstance(args[-1], str) else None)
    return dist.distributed_c10d._resolve_process_group(name)


def _product_dtype(args) -> str:
    for t in tree_leaves(args):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            return str(t.dtype).removeprefix("torch.")
    return "float32"


def _active() -> list["Counter"]:
    """The counters on the dispatch mode stack."""
    return [m for m in _get_current_dispatch_mode_stack() if isinstance(m, Counter)]


@contextlib.contextmanager
def _paused():
    counters = _active()
    for c in counters:
        c._paused += 1
    try:
        yield
    finally:
        for c in counters:
            c._paused -= 1


def _pause_in(owner, name: str) -> None:
    """Wrap ``owner.name`` so that no active counter counts inside it."""
    fn = getattr(owner, name, None)
    if fn is None or getattr(fn, "_not_counted", False):
        return

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _paused():
            return fn(*args, **kwargs)
    wrapped._not_counted = True
    setattr(owner, name, wrapped)


class Counter(CommDebugMode):
    """Counts one rank's FLOPs, bytes and collectives in its scope (see the
    module's docstring). ``flops`` and ``bytes`` are totals,
    ``flops_by_dtype`` splits the FLOPs by their operands' dtype,
    ``by_kind``/``count`` aggregate bytes and calls by op, ``kernels``
    counts the kernel calls reported, ``collectives`` lists the
    ``Collective`` records, ``calls`` every counted ``Call``."""

    def __init__(self, memory: bool = False):
        super().__init__()
        self.memory = memory
        self.live_bytes = 0.0
        self.peak_bytes = 0.0
        self._live: dict[int, float] = {}
        self.flops = 0.0
        self.bytes = 0.0
        self.flops_by_dtype: dict[str, float] = defaultdict(float)
        self.by_kind: dict[str, float] = defaultdict(float)
        self.count: dict[str, int] = defaultdict(int)
        self.kernels: dict[str, int] = defaultdict(int)
        self.collectives: list[Collective] = []
        self.calls: list[Call] = []
        self._paused = 0

    def __enter__(self):
        _pause_in(ShardingPropagator, "_propagate_tensor_meta_non_cached")
        return super().__enter__()

    def track(self, *tensors) -> None:
        """Count the storages of ``tensors`` live until they are freed."""
        if not self.memory:
            return
        for t in tree_leaves(tensors):
            if not isinstance(t, torch.Tensor):
                continue
            if isinstance(t, DTensor):
                t = t.to_local()
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            # the tensor's own bytes: a fake tensor's storage may report
            # the size of the global tensor it was sliced from
            self._live[key] = float(t.numel() * t.element_size())
            self.live_bytes += self._live[key]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0.0)

    def add(self, kind: str, flops: float, nbytes: float, dtype: str, shapes: str = ""):
        self.flops += flops
        self.bytes += nbytes
        if flops:
            self.flops_by_dtype[dtype] += flops
        self.by_kind[kind] += nbytes
        self.count[kind] += 1
        self.calls.append(Call(kind, nbytes, flops, shapes))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator) or any(t is DTensor for t in types):
            return super().__torch_dispatch__(func, types, args, kwargs)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if (self._paused or func in _NOT_COUNTED or func.is_view
                or func.namespace == "prim" or _on_meta(args)):
            return out
        packet = func._overloadpacket
        if packet in self.comm_registry or packet in c10d_collective_ops:
            op, i = _COLLECTIVE_OPS[packet.__name__]
            group = _group(args, kwargs)
            ranks = tuple(dist.get_process_group_ranks(group))
            self.collectives.append(Collective(op, len(ranks), float(_nbytes(args[i])), ranks,
                                               str(packet)))
            return out
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        if func in (_aten.copy_.default, _aten.fill_.Scalar, _aten.zero_.default):
            nbytes = _nbytes(args[1:]) + _nbytes(out)  # the target is written, not read
        else:
            nbytes = _nbytes((args, kwargs)) + _nbytes(out)
        shapes = ", ".join(f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}"
                           for t in tree_leaves(args) if isinstance(t, torch.Tensor))
        self.add(str(packet), flops, float(nbytes), _product_dtype(args), shapes)
        self.track(out)
        return out


def permutes(group, operand_bytes: Sequence[float], fn: Callable[[], object]):
    """``fn()``, a point-to-point exchange over ``group`` that every rank
    makes alike (a halo exchange): every active ``Counter`` records one
    ``collective-permute``, the reference's op for it, for each entry of
    ``operand_bytes`` (the bytes each rank sends one way), and counts
    nothing dispatched inside (the sends and receives). A rank at an edge of
    the group sends one way only; the record is the program's, as XLA's op
    is, so the count is the same whichever rank is counted."""
    counters = _active()
    if not counters:
        return fn()
    ranks = tuple(dist.get_process_group_ranks(group))
    for c in counters:
        c.collectives.extend(Collective("collective-permute", len(ranks), float(b), ranks,
                                        "c10d.send") for b in operand_bytes)
    with _paused():
        return fn()


def kernel(name: str, cost: Callable[[], tuple[float, float, torch.dtype]],
           fn: Callable[[], object]):
    """``fn()``, one kernel call: every active ``Counter`` adds the kernel's
    ``cost()`` = (FLOPs, bytes, product dtype) once, counts no operation
    dispatched inside, and tracks the call's outputs. Without a counter,
    ``cost`` is not evaluated."""
    counters = _active()
    if not counters:
        return fn()
    flops, nbytes, dtype = cost()
    for c in counters:
        c.add(f"kernel.{name}", flops, nbytes, str(dtype).removeprefix("torch."))
        c.kernels[name] += 1
    with _paused():
        out = fn()
    for c in counters:
        c.track(out)
    return out
