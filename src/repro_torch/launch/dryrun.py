"""Multi-pod dry-run, PyTorch port of ``repro.launch.dryrun``.

For every (architecture x input shape) cell: build the step bundle on the
production mesh (single pod 16x16 = 256 ranks, multi-pod 2x16x16 = 512),
run one rank's step on a fake world, count its FLOPs, bytes, collectives
and peak of live bytes (``runtime.hlo_bytes.Counter``),
derive the H100 roofline terms (``runtime.roofline``) and write a JSON
record under ``experiments/torch/dryrun/``.

The fake world is the counterpart of the reference's lowering without
running: a process group of the ``fake`` backend (``FakeStore``) of 256 or
512 ranks in which this process is rank 0 and every collective returns at
once, ``FakeTensorMode`` for every tensor (parameters, batch, activations:
shapes and dtypes, no memory, no arithmetic), and the bundle's sharded
step run on this rank's local shards. Nothing runs on any device; the
counts are one rank's, at full size. Where a step repeats identical units
(``hlo_scale``: microbatches, sampler steps) one unit is counted
(``unit_fn``) and scaled, as the reference scales its rolled loops. A
scalar the program reads from data (``.item()``, ``int(t)``: the number
of passes of ToMe's deterministic scatter-add) has no value on a fake
tensor and reads 0 there, the least: such a count is then a lower bound.

One world per process: a fake world cannot share a process with another
world size or with the one-rank group ``make_host_mesh`` keeps, so
``--both-meshes`` and ``--all`` run each mesh in a subprocess.

Usage (the CPU, no device):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch vit-b16 --shape serve_b1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch vit-b16 --shape cls_224 --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import pathlib
import subprocess
import sys
import time
import traceback
from typing import Mapping

import torch
import torch.distributed as dist
from torch._subclasses import fake_impls
from torch._subclasses.fake_tensor import (DataDependentOutputException, FakeTensorMode,
                                           unset_fake_temporarily)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import placement_types
from torch.distributed.tensor.placement_types import _StridedShard

from repro_torch.configs import get_arch, list_archs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import SkipShape, StepBundle, build_bundle, place_inputs
from repro_torch.runtime import hlo_bytes, roofline

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "torch" / "dryrun"
MESH_NAMES = {False: "16x16", True: "2x16x16"}


def fake_world(world: int) -> None:
    """This process as rank 0 of a fake process group of ``world`` ranks
    (kept if it already is one of that size)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        raise RuntimeError(f"this process holds a {dist.get_backend()} group of "
                           f"{dist.get_world_size()} ranks; a fake world of {world} needs "
                           "a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def make_mesh(multi_pod: bool = False, mesh_shape: tuple[int, ...] | None = None):
    """The production mesh on a fake world of its size, or a ("data",
    "model") mesh of ``mesh_shape`` (e.g. (1, 1)) on one of that size."""
    if mesh_shape is None:
        fake_world(512 if multi_pod else 256)
        return make_production_mesh(multi_pod=multi_pod, device="cpu")
    names = ("pod", "data", "model")[-len(mesh_shape):]
    fake_world(math.prod(mesh_shape))
    return init_device_mesh("cpu", tuple(mesh_shape), mesh_dim_names=names)


@functools.cache
def _fake_mode() -> FakeTensorMode:
    """The process's one fake mode (a model's cached tensors made in one
    cell's mode must meet the next cell's in the same mode). Two DTensor
    helpers are adjusted for the fake world: the one that reads
    strided-shard offsets from an ``arange`` runs on real tensors, and a
    shard-to-shard redistribution is the all-to-all NCCL runs on the card
    (on a CPU mesh DTensor would gather instead, as gloo has no
    all-to-all). A scalar read from data reads 0 (the module's
    docstring)."""
    orig = getattr(_StridedShard, "local_shard_size_and_offset", None)
    if orig is not None:
        @functools.wraps(orig)
        def real(self, *args, **kwargs):
            with unset_fake_temporarily():
                return orig(self, *args, **kwargs)
        _StridedShard.local_shard_size_and_offset = real

    def all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._group_or_group_name(group))
    if hasattr(placement_types, "shard_dim_alltoall"):
        placement_types.shard_dim_alltoall = all_to_all

    scalar = torch.ops.aten._local_scalar_dense.default
    read = fake_impls.op_implementations_dict[scalar]

    def least(mode, func, arg):
        try:
            return read(mode, func, arg)
        except DataDependentOutputException:  # a value only data would give
            return False if arg.dtype == torch.bool else 0
    fake_impls.op_implementations_dict[scalar] = least
    return FakeTensorMode(allow_non_fake_inputs=True)


def _fake_args(args, fake: FakeTensorMode):
    """The bundle's abstract (meta) inputs as fake CPU tensors; a 0-d
    integer tensor (the optimizer's step, which seeds the diffusion losses'
    draws) is a fake constant, whose value the fake mode keeps."""
    def conv(x):
        if isinstance(x, Mapping):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        if isinstance(x, torch.Tensor):
            with fake:
                if x.dim() == 0 and not x.is_floating_point():
                    return torch.tensor(0, dtype=x.dtype)
                return torch.empty(x.shape, dtype=x.dtype, device="cpu")
        return x
    return tuple(conv(a) for a in args)


def _own(x):
    """Each rank's slice as a tensor of its own (a placed view keeps the
    global storage, which the memory tracker would charge)."""
    if isinstance(x, Mapping):
        return {k: _own(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_own(v) for v in x]
    if isinstance(x, DTensor):
        return DTensor.from_local(x.to_local().clone(), x.device_mesh, x.placements,
                                  run_check=False, shape=x.shape, stride=x.stride())
    if isinstance(x, torch.Tensor):
        return x.clone()
    return x


def count_bundle(bundle: StepBundle):
    """(counter, memory) of one unit of ``bundle`` (its ``unit_fn``, else
    its step) on this rank: the abstract inputs as fake tensors placed by
    the bundle's shardings, run under a ``Counter`` that tracks memory.
    ``memory`` holds the rank's argument bytes and its peak of live bytes."""
    fake = _fake_mode()
    args = _own(place_inputs(bundle, *_fake_args(bundle.abstract_inputs, fake)))
    fn = bundle.unit_fn or bundle.step_fn
    with fake, hlo_bytes.Counter(memory=True) as counter:
        counter.track(args)
        arg_bytes = counter.live_bytes
        fn(*args)
    peak = counter.peak_bytes
    memory = {"argument_size_in_bytes": arg_bytes, "temp_size_in_bytes": peak - arg_bytes,
              "peak_size_in_bytes": peak}
    return counter, memory


def analyze_bundle(name: str, bundle: StepBundle, mesh) -> tuple[roofline.Roofline, object]:
    """The bundle's ``Roofline`` on ``mesh`` (counted on this rank) and the
    counter."""
    counter, memory = count_bundle(bundle)
    rl = roofline.analyze(name, counter, mesh.size(), bundle.model_flops,
                          hlo_scale=bundle.hlo_scale, memory=memory)
    return rl, counter


def run_cell(arch: str, shape: str, multi_pod: bool = False, *, verbose: bool = True,
             mesh_shape: tuple[int, ...] | None = None, smoke: bool = False) -> dict:
    """One cell's record on the production mesh (or a ``mesh_shape`` mesh,
    e.g. (1, 1) to hold a count on the card against its fake-world count);
    ``smoke``: the arch's smoke config, as ``build_bundle(smoke=True)``."""
    t0 = time.time()
    mesh = make_mesh(multi_pod, mesh_shape)
    chips = mesh.size()
    mesh_name = "x".join(map(str, mesh_shape)) if mesh_shape else MESH_NAMES[multi_pod]
    cell = f"{arch}/{shape}{'/smoke' if smoke else ''}@{mesh_name}"
    try:
        bundle = build_bundle(arch, shape, mesh, smoke=smoke)
    except SkipShape as e:
        rec = {"cell": cell, "status": "skipped", "reason": e.reason}
        if verbose:
            print(f"[dryrun] {cell}: SKIPPED ({e.reason})")
        return rec
    rl, counter = analyze_bundle(cell, bundle, mesh)
    rec = {"cell": cell, "status": "ok", "mesh": mesh_name, "chips": chips,
           "compile_s": time.time() - t0, "notes": bundle.notes,
           "hlo_scale": bundle.hlo_scale, "kernel_calls": dict(counter.kernels),
           **rl.to_dict()}
    if verbose:
        mem = rl.memory_per_device
        print(f"[dryrun] {cell}: counted in {rec['compile_s']:.1f}s")
        print(f"  memory: { {k: f'{v/1e9:.3f} GB' for k, v in mem.items()} }")
        print(f"  counted: flops/device={rl.hlo_flops_per_device:.3e} "
              f"bytes/device={rl.hlo_bytes_per_device:.3e} kernels={dict(counter.kernels)}")
        print(f"  collectives: {rl.collective_counts} wire={rl.wire_bytes_per_device:.3e} B")
        print(f"  roofline (H100 data-sheet constants): compute={rl.t_compute*1e3:.3f}ms "
              f"memory={rl.t_memory*1e3:.3f}ms collective={rl.t_collective*1e3:.3f}ms -> "
              f"{rl.bottleneck}-bound, useful={rl.useful_flops_ratio:.3f} "
              f"frac={rl.roofline_fraction:.3f}")
    return rec


def save(rec: dict):
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    name = rec["cell"].replace("/", "_").replace("@", "_")
    (OUT_DIR / f"{name}.json").write_text(json.dumps(rec, indent=2))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="every arch x shape")
    ap.add_argument("--one-mesh", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]] = []
    if args.all:
        for a in list_archs():
            if a == "janus-vit-l384":
                continue  # paper model has its own shape set; not a graded cell
            for s in get_arch(a).shapes:
                cells.append((a, s.name))
    else:
        arch = get_arch(args.arch)
        shapes = [args.shape] if args.shape else [s.name for s in arch.shapes]
        cells = [(args.arch, s) for s in shapes]

    if (args.both_meshes or args.all) and not args.one_mesh:
        rc = 0
        for mp in (False, True):  # one fake world per process
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--one-mesh"]
            cmd += ["--all"] if args.all else ["--arch", args.arch] + (
                ["--shape", args.shape] if args.shape else [])
            rc |= subprocess.call(cmd + (["--multi-pod"] if mp else []))
        sys.exit(rc)

    failures = []
    for a, s in cells:
        try:
            rec = run_cell(a, s, args.multi_pod)
            save(rec)
        except Exception as e:
            traceback.print_exc()
            failures.append((a, s, args.multi_pod, repr(e)))
            save({"cell": f"{a}/{s}@{MESH_NAMES[args.multi_pod]}",
                  "status": "error", "error": repr(e)})
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("[dryrun] all cells OK")


if __name__ == "__main__":
    main()
