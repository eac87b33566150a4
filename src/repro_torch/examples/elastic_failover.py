"""Fault tolerance walkthrough, PyTorch port of ``examples/elastic_failover.py``:
heartbeat failure detection, the elastic mesh replan, a checkpoint saved
sharded on one mesh and restored with ``shardings=`` on the survivors' mesh;
straggler detection; and the Janus network failover (the scheduler drives the
split to device-only when the uplink dies) through the port's engine.

  PYTHONPATH=src python -m repro_torch.examples.elastic_failover --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.examples.elastic_failover \\
      --device cpu       # saves on (2, 2), one rank "fails", restores on (1, 2)

In one process the saving and the survivors' mesh are both (1, 1); under
``torchrun`` the saving mesh is the host mesh with "model" of 2 (when the
world divides), the last rank stops beating, and the survivors restore onto
``plan_elastic_mesh(survivors, model_parallel)``'s mesh, over the first ranks.
Without ``--device cpu`` it runs on ``cuda`` and raises if there is no card.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.checkpoint import Checkpointer
from repro_torch.core import bandwidth, engine, profiler, scheduler
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.fault_tolerance import (HeartbeatMonitor, StragglerDetector,
                                                 plan_elastic_mesh)
from repro_torch.sharding.rules import NamedSharding, place, to_global


def _tree(device) -> dict:
    """A small (params, moments)-like tree: a head-sharded weight, a
    data-sharded embedding, a replicated scalar."""
    gen = torch.Generator(device=device).manual_seed(0)
    return {"wq": torch.randn(16, 8, generator=gen, device=device),
            "table": torch.randn(8, 16, generator=gen, device=device),
            "step": torch.tensor(7, dtype=torch.int32, device=device)}


_SPECS = {"wq": (None, "model"), "table": ("data", None), "step": ()}


def elastic_restore(device, ckpt_dir: str) -> dict:
    """Save ``_tree`` sharded on the host mesh; the last rank fails; restore
    on the survivors' mesh. Returns the survivors' restored tree as global
    tensors (empty on a failed rank)."""
    world_mesh = make_host_mesh(model=2, device=device)
    world = dist.get_world_size()
    rank = dist.get_rank()
    lead = rank == 0
    full = _tree(device)
    sharded = {k: place(v, world_mesh, NamedSharding(_SPECS[k], world_mesh).placements(v.shape))
               for k, v in full.items()}
    ckpt = Checkpointer(ckpt_dir)
    ckpt.save(1, sharded, blocking=True)

    hb = HeartbeatMonitor([f"rank{r}" for r in range(world)], timeout_steps=2)
    failed: list = []
    for step in range(1, 4):
        for r in range(world - 1 if world > 1 else world):
            hb.beat(f"rank{r}", step)
        failed = hb.tick() or failed
    survivors = world - len(failed)
    model = world_mesh.size(1)
    plan = plan_elastic_mesh(survivors, model_parallel=model)
    if lead:
        print(f"[elastic] saved on mesh {tuple(world_mesh.shape)}; failed {failed}; "
              f"{survivors} survivors, TP={model} -> mesh (data={plan.data}, "
              f"model={plan.model}) = {plan.devices} devices")
    # every rank of the world joins the new mesh's groups; its members restore
    ranks = torch.arange(plan.devices).reshape(plan.data, plan.model)
    new_mesh = DeviceMesh(device.type, ranks, mesh_dim_names=("data", "model"))
    if rank >= plan.devices:
        return {}
    shardings = {k: NamedSharding(_SPECS[k], new_mesh) for k in _SPECS}
    restored, step = ckpt.restore({k: v for k, v in full.items()}, device=device,
                                  shardings=shardings)
    out = {k: to_global(v) for k, v in restored.items()}
    equal = all(torch.equal(out[k], full[k]) for k in full)
    if lead:
        print(f"[elastic] restored step {step} on mesh {tuple(new_mesh.shape)} with "
              f"shardings=: wq local {tuple(restored['wq'].to_local().shape)}, "
              f"every leaf bit-equal: {equal}")
    if not equal:
        raise AssertionError("elastic restore changed a value")
    return out


def stragglers() -> list:
    workers = [f"host{i}" for i in range(8)]
    sd = StragglerDetector(factor=1.5, patience=2)
    flagged: list = []
    for _ in range(3):
        flagged = sd.observe({w: (2.2 if w == "host3" else 1.0) for w in workers})
    return flagged


def uplink_failover(device) -> list:
    """The Janus scheduler's decisions when the uplink dies (split 25 =
    device-only: service continues, degraded)."""
    grid = range(32, 578, 32)
    prof = scheduler.ModelProfile(
        n_layers=24, x0=577, token_bytes=1024, raw_input_bytes=310_000,
        device=profiler.profile_platform(profiler.EDGE_PLATFORM, 1024, 4096, grid),
        cloud=profiler.profile_platform(profiler.CLOUD_PLATFORM, 1024, 4096, grid))
    eng = engine.JanusEngine(prof, engine.EngineConfig(sla_s=1.0), device=device)
    dead = bandwidth.NetworkTrace(np.full(5, 1e3), 0.042, "uplink-dead")
    st = eng.run_trace(dead, 5, "janus")
    return [(round(f.alpha, 2), f.split) for f in st.frames[1:3]]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_elastic"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    restored = elastic_restore(device, args.ckpt_dir)
    flagged = stragglers()
    decisions = uplink_failover(device)
    if dist.get_rank() == 0:
        print(f"[elastic] straggler flagged after patience: {sorted(flagged)}")
        print(f"[elastic] uplink dies -> scheduler decisions (alpha, split): {decisions} "
              "(split 25 = device-only: service continues degraded)")
    return {"restored": restored, "stragglers": flagged, "decisions": decisions}


if __name__ == "__main__":
    main()
