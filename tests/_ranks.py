"""Run a script as the ranks of one gloo process group, or the reference on
several host devices, each in a fresh interpreter (for the mesh tests).

``run_ranks`` starts ``n`` processes of ``script`` with ``RANK``,
``WORLD_SIZE``, ``INIT`` (a ``file://`` rendezvous in ``tmp``, so parallel
test workers never share a port) and ``OUT`` (``tmp``) in the environment;
each rank initialises the group itself, writes its results under ``OUT``
and destroys the group. ``run_reference`` runs a JAX script with
``XLA_FLAGS`` asking for ``n_devices`` host devices.
"""
import itertools
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
_WORLDS = itertools.count()

RANK_PRELUDE = """
import os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
OUT = os.environ["OUT"]
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=RANK, world_size=WORLD)
"""


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}"
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def run_ranks(script: str, n: int, tmp: pathlib.Path, timeout: float = 180.0,
              env: dict | None = None) -> None:
    """Run ``RANK_PRELUDE + script`` as ``n`` ranks (``env``: more variables);
    raise with a rank's output if any fails. The script ends with
    ``dist.destroy_process_group()``."""
    code = RANK_PRELUDE + script
    init = f"file://{tmp / f'rendezvous{next(_WORLDS)}'}"  # a new file for each world
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=_env(RANK=str(r), WORLD_SIZE=str(n), INIT=init, OUT=str(tmp),
                                       **(env or {})))
             for r in range(n)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n{out[-2000:]}\n{err[-4000:]}")


def run_reference(script: str, n_devices: int, tmp: pathlib.Path, timeout: float = 180.0,
                  env: dict | None = None) -> None:
    """Run a JAX ``script`` on ``n_devices`` host devices, ``OUT`` = ``tmp``
    (``env``: more variables)."""
    res = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, text=True, capture_output=True,
        timeout=timeout, env=_env(OUT=str(tmp), JAX_PLATFORMS="cpu",
                                  XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}",
                                  **(env or {})))
    if res.returncode != 0:
        raise AssertionError(f"reference run exited {res.returncode}:\n{res.stdout[-2000:]}\n"
                             f"{res.stderr[-4000:]}")
