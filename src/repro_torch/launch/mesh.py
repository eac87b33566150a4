"""Device meshes, PyTorch port of ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
device and starts no process group. Single pod: 16x16 ("data", "model") =
256 devices; multi-pod: 2x16x16 ("pod", "data", "model") = 512. The "pod"
axis folds into data parallelism (``sharding.rules.BATCH_AXES``).

The mesh's world is the default process group's. Under ``torchrun`` that
group comes from its environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``); with no group and no such environment,
``make_host_mesh`` starts a one-process group in this process (NCCL on
``cuda``, gloo on ``cpu``) through an in-memory store, and destroys it at
exit.
"""
from __future__ import annotations

import atexit
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.runtime.device import resolve_device


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _ensure_group(device: torch.device) -> None:
    """The default process group: the caller's, ``torchrun``'s, or a new
    one-process group on ``device``'s backend (destroyed at exit)."""
    if dist.is_initialized():
        return
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(_backend(device))
    else:
        dist.init_process_group(_backend(device), store=dist.HashStore(), rank=0,
                                world_size=1)
    atexit.register(_destroy)


def _destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production mesh: (16, 16) ("data", "model"), or with
    ``multi_pod`` (2, 16, 16) ("pod", "data", "model"). Raises unless the
    process group's world has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 512 if multi_pod else 256
    if not dist.is_initialized() or dist.get_world_size() != want:
        have = dist.get_world_size() if dist.is_initialized() else "no process group"
        raise RuntimeError(f"the production mesh {shape} needs a world of {want} ranks, "
                           f"have {have}")
    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device=None):
    """("data", "model") mesh over the process group's ranks (one device a
    rank): ``(n // model, model)`` with ``model = min(model, n)``, as the
    reference. ``device`` is ``cuda`` unless the caller passes ``"cpu"``
    (then the group is gloo); there is no fallback from one to the other."""
    device = resolve_device(device)
    _ensure_group(device)
    n = dist.get_world_size()
    model = min(model, n)
    if n % model:
        raise ValueError(f"model axis {model} does not divide the world of {n} ranks")
    return init_device_mesh(device.type, (n // model, model),
                            mesh_dim_names=("data", "model"))
