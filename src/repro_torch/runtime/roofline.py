"""Roofline terms of one step on the H100, PyTorch port of
``repro.runtime.roofline``.

  compute    = sum over dtypes of counted FLOPs / the card's peak for it
  memory     = counted bytes / HBM bandwidth
  collective = sum over collective calls of wire bytes / the group's link rate

The counts are per rank, from ``runtime.hlo_bytes.Counter`` (the
reference's come from ``compiled.cost_analysis()`` and the compiled HLO
text). Collective wire bytes keep the reference's ring-model coefficients,
expressed on what the port observes of each call, its operand bytes and
its group size n:

  all-gather         operand_bytes * (n-1)     (= result bytes * (n-1)/n)
  all-reduce         2 * operand_bytes * (n-1)/n  (reduce-scatter + all-gather)
  reduce-scatter     operand_bytes * (n-1)/n
  all-to-all         operand_bytes * (n-1)/n
  collective-permute operand_bytes             (a broadcast is charged so too)

Hardware constants, NVIDIA H100 SXM5 80GB (data sheet, dense):
989 TFLOP/s bf16/fp16 on the tensor cores, 67 TFLOP/s f32 outside them (the
port's f32 flash kernels run on the tensor cores in 3xTF32, three TF32
products at 495 TFLOP/s for each f32 one; an f32 count is still charged at
the f32 peak), 3.35 TB/s of HBM3. Links: NVLink 4 with NVSwitch inside an
8-GPU HGX node, 450 GB/s a direction per GPU; between nodes 8 x 400 Gb/s
NICs a node, 50 GB/s a GPU.

The collective term is per mesh axis. Ranks are laid out row-major on the
mesh (``init_device_mesh``), "model" innermost, 8 GPUs a node: a group
whose ranks all sit in one node runs at NVLink's rate, a group that spans
nodes at the network's. On the (16, 16) production mesh both axes cross
nodes: a "model" group of 16 spans 2 nodes, and "data" groups have stride
16, one rank a node; on (2, 16, 16) "pod" does too. So every collective of
those meshes is charged at 50 GB/s. The reference's credit of two ICI
links a mesh axis (its torus wrap-around) has no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable

PEAK_FLOPS = 989e12          # bf16/fp16 dense, tensor cores
PEAK_F32_FLOPS = 67e12       # f32, CUDA cores
HBM_BW = 3.35e12             # HBM3
NVLINK_BW = 450e9            # a direction per GPU, inside a node
NET_BW = 50e9                # a GPU's share of the node's 8 x 400 Gb/s NICs
GPUS_PER_NODE = 8

_LOW_PRECISION = ("bfloat16", "float16", "float8_e4m3fn", "float8_e5m2", "int8")


def peak_for(dtype: str) -> float:
    """The card's peak FLOP rate for products in ``dtype`` (a name such as
    ``"bfloat16"``)."""
    return PEAK_FLOPS if dtype in _LOW_PRECISION else PEAK_F32_FLOPS


def link_bw(ranks: Iterable[int]) -> float:
    """The per-GPU rate of a collective over the global ``ranks``: NVLink
    when they share one node, else the network."""
    nodes = {r // GPUS_PER_NODE for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else NET_BW


def wire_bytes(op: str, operand_bytes: float, n: int) -> float:
    """Ring-model bytes a rank puts on the wire for one call of ``op`` on
    ``operand_bytes`` in a group of ``n``."""
    ring = (n - 1) / max(n, 1)
    if op == "all-gather":
        return operand_bytes * (n - 1)
    if op == "all-reduce":
        return 2 * operand_bytes * ring
    if op in ("reduce-scatter", "all-to-all"):
        return operand_bytes * ring
    return operand_bytes  # collective-permute, broadcast


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float
    by_op: dict[str, float]
    counts: dict[str, int]
    seconds: float = 0.0   # sum of each call's wire bytes over its link rate


def collective_bytes(records: Iterable) -> CollectiveStats:
    """Wire bytes per op over collective ``records``, each with ``op``,
    ``n`` (group size), ``bytes`` (operand bytes) and ``ranks`` (the group's
    global ranks; empty for one in-node group), as
    ``hlo_bytes.Collective``."""
    by_op: dict[str, float] = {}
    counts: dict[str, int] = {}
    seconds = 0.0
    for r in records:
        wire = wire_bytes(r.op, r.bytes, r.n)
        by_op[r.op] = by_op.get(r.op, 0.0) + wire
        counts[r.op] = counts.get(r.op, 0) + 1
        seconds += wire / link_bw(r.ranks)
    return CollectiveStats(sum(by_op.values()), by_op, counts, seconds)


@dataclasses.dataclass
class Roofline:
    name: str
    chips: int
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    wire_bytes_per_device: float
    model_flops_total: float
    collectives: dict[str, float]
    collective_counts: dict[str, int]
    memory_per_device: dict[str, float]
    raw_cost_bytes_per_device: float = 0.0  # the counted bytes, as they were counted
    flops_by_dtype: dict[str, float] | None = None  # per-device FLOPs by product dtype
    collective_s: float | None = None       # wire time at each group's link rate

    @property
    def t_compute(self) -> float:
        if not self.flops_by_dtype:
            return self.hlo_flops_per_device / PEAK_FLOPS
        return sum(f / peak_for(d) for d, f in self.flops_by_dtype.items())

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        if self.collective_s is None:  # no group known: the network's rate
            return self.wire_bytes_per_device / NET_BW
        return self.collective_s

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        hlo_total = self.hlo_flops_per_device * self.chips
        return self.model_flops_total / hlo_total if hlo_total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-achievable fraction of peak if the program ran at its
        dominant-term bound: (model_flops/chips/peak) / t_bound."""
        if self.t_bound == 0:
            return 0.0
        return (self.model_flops_total / self.chips / PEAK_FLOPS) / self.t_bound

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name, "chips": self.chips,
            "hlo_flops_per_device": self.hlo_flops_per_device,
            "hlo_bytes_per_device": self.hlo_bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "model_flops_total": self.model_flops_total,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collectives": self.collectives,
            "collective_counts": self.collective_counts,
            "memory_per_device": self.memory_per_device,
            "raw_cost_bytes_per_device": self.raw_cost_bytes_per_device,
            "flops_by_dtype": self.flops_by_dtype or {},
        }


def analyze(name: str, counts, chips: int, model_flops: float, hlo_scale: float = 1.0,
            memory: dict[str, float] | None = None) -> Roofline:
    """The ``Roofline`` of a step from one rank's ``counts`` (a
    ``hlo_bytes.Counter`` after the step ran under it). The count already
    holds every layer (eager PyTorch has no rolled loop), so there is no
    ``layer_scale``; ``hlo_scale`` multiplies a count of one of the step's
    identical units (a microbatch, a sampler step) up to the step."""
    stats = collective_bytes(counts.collectives)
    return Roofline(
        name=name, chips=chips,
        hlo_flops_per_device=counts.flops * hlo_scale,
        hlo_bytes_per_device=counts.bytes * hlo_scale,
        wire_bytes_per_device=stats.wire_bytes * hlo_scale,
        model_flops_total=model_flops,
        collectives={k: v * hlo_scale for k, v in stats.by_op.items()},
        collective_counts={k: int(v * hlo_scale) for k, v in stats.counts.items()},
        memory_per_device=dict(memory or {}),
        raw_cost_bytes_per_device=counts.bytes * hlo_scale,
        flops_by_dtype={k: v * hlo_scale for k, v in counts.flops_by_dtype.items()},
        collective_s=stats.seconds * hlo_scale)
