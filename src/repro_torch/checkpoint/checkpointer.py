"""Async checkpointing, PyTorch port of ``repro.checkpoint.checkpointer``.

The reference's on-disk format, so an f32 checkpoint can cross packages
either way (a bf16 one only from the reference to the port, see below):

    <dir>/step_<n>/
        index.json     tree structure + per-key shape and dtype + the step
        arrays.npz     one entry per leaf, keyed by its path ("0/blocks/attn/wq",
                       "1/m/...", "1/step" for a (params, opt) tuple)
        COMMIT         written last: a directory without it is partial and
                       ignored on restore

written under ``step_<n>.tmp`` and renamed into place. ``save`` copies the
leaves to the host on the calling thread and writes in a background thread
(one save in flight at a time); ``keep`` retains the latest k checkpoints.

bf16 leaves: numpy has no bfloat16 without ``ml_dtypes`` (which the machine
with the card lacks), so they are stored as their ``uint16`` bits and
``index.json`` says ``"bfloat16"``; ``restore`` reads the index and views
the bits back as ``torch.bfloat16``. Not copied from the reference: it saves
``ml_dtypes`` bf16 arrays through ``np.savez``, which come back as void
``|V2`` and which ``jnp.asarray`` then refuses, so its ``--resume`` fails on
every bf16 config. The port restores those files too (the index says
``"bfloat16"``; the ``|V2`` bytes are the same bits). The other way does
not work: the reference's restore reads no index and returns a port bf16
leaf as its ``uint16`` bits, integers, without an error.

``restore`` places every leaf on one ``device`` (``cuda`` unless the
caller passes ``device="cpu"``), or, with ``shardings=`` (a tree of
``NamedSharding`` matching the target, e.g. a sharded bundle's
``in_shardings[:2]``), as DTensors on their mesh: the elastic restore. That
mesh may differ from the one that saved: the files hold global arrays, and
each rank uploads only its own shard of each (a view of the host array).

On a mesh, ``save`` gathers each sharded (DTensor) leaf to its global value
(``full_tensor``, a collective every rank joins, on the calling thread); only
rank 0 of the process group copies it to the host and writes, and a
``blocking`` save returns on no rank before the checkpoint is committed (a
barrier after the write).
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.runtime.device import resolve_device
from repro_torch.sharding.rules import NamedSharding, shard_slices, to_global

_SEP = "/"


def _paths(tree, prefix: tuple = ()):
    """(path, leaf) in ``jax.tree_util.tree_leaves_with_path`` order: dict
    keys sorted, tuple and list items by index; a ``NamedSharding`` is a
    leaf."""
    if isinstance(tree, NamedSharding):
        yield _SEP.join(prefix), tree
    elif isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _paths(t, prefix + (str(i),))
    else:
        yield _SEP.join(prefix), tree


def _flatten(tree) -> dict[str, Any]:
    return dict(_paths(tree))


def _structure(tree):
    """The tree with every leaf as None (JSON for ``index.json``)."""
    if isinstance(tree, Mapping):
        return {str(k): _structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return [_structure(t) for t in tree]
    return None


def _rebuild(target, lookup: dict, prefix: tuple = ()):
    if isinstance(target, Mapping):
        return {k: _rebuild(v, lookup, prefix + (str(k),)) for k, v in target.items()}
    if isinstance(target, (tuple, list)):
        return type(target)(_rebuild(t, lookup, prefix + (str(i),))
                            for i, t in enumerate(target))
    return lookup[_SEP.join(prefix)]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A leaf's (global) values as numpy; bf16 as its uint16 bits."""
    t = to_global(t.detach()).to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(arr: np.ndarray, dtype_name: str, device: torch.device) -> torch.Tensor:
    if dtype_name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16)  # port: uint16; reference: |V2
        return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


class Checkpointer:
    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, *, blocking: bool = False) -> pathlib.Path:
        self.wait()  # one in-flight save at a time
        flat = _flatten(tree)
        ranks = dist.get_world_size() if dist.is_initialized() else 1
        path = self.dir / f"step_{step:08d}"
        if ranks > 1 and dist.get_rank() != 0:
            for v in flat.values():
                to_global(v.detach())  # joins rank 0's gather; no host copy here
            if blocking:
                dist.barrier()  # rank 0 has committed
            return path
        host = {k: _to_host(v) for k, v in flat.items()}  # gathers, device->host copy
        keys = {k: {"shape": list(v.shape), "dtype": _dtype_name(v.dtype)}
                for k, v in flat.items()}
        structure = _structure(tree)

        def _write():
            tmp = path.with_suffix(".tmp")
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "arrays.npz", **host)
            index = {"step": step, "treedef": structure, "keys": keys}
            (tmp / "index.json").write_text(json.dumps(index, indent=2))
            (tmp / "COMMIT").write_text("ok")
            if path.exists():
                shutil.rmtree(path)
            tmp.rename(path)
            self._gc()

        if blocking:
            _write()
            if ranks > 1:
                dist.barrier()
        else:
            def _run():
                try:
                    _write()
                except Exception as e:  # re-raised by wait() on the caller's thread
                    self._error = e
            self._thread = threading.Thread(target=_run, daemon=True)
            self._thread.start()
        return path

    def wait(self):
        """Join the in-flight save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and (p / "COMMIT").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target_tree, step: int | None = None, device=None, shardings=None):
        """Restore into the structure of ``target_tree`` (tensors, meta
        tensors included, or anything with a ``shape``) on ``device``.
        Leaves keep the checkpoint's dtype. ``shardings``: a matching tree
        of ``NamedSharding``; each leaf then comes back as a DTensor placed
        by its sharding on its mesh (this rank's shard only). Returns
        (tree, step)."""
        device = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        path = self.dir / f"step_{step:08d}"
        index = json.loads((path / "index.json").read_text())["keys"]
        flat_target = _flatten(target_tree)
        flat_sh = _flatten(shardings) if shardings is not None else None
        with np.load(path / "arrays.npz") as data:
            missing = set(flat_target) - set(data.files)
            if missing:
                raise KeyError(f"checkpoint at step {step} missing keys: {sorted(missing)[:5]}")
            restored = {}
            for k, tgt in flat_target.items():
                arr = data[k]
                if tuple(arr.shape) != tuple(tgt.shape):
                    raise ValueError(f"{k}: ckpt shape {arr.shape} != target {tuple(tgt.shape)}")
                if flat_sh is None:
                    restored[k] = _from_host(arr, index[k]["dtype"], device)
                    continue
                sh = flat_sh[k]
                placements = sh.placements(arr.shape)
                local = _from_host(arr[shard_slices(arr.shape, sh.mesh, placements)],
                                   index[k]["dtype"], device)
                restored[k] = DTensor.from_local(local, sh.mesh, list(placements),
                                                 run_check=False)
        return _rebuild(target_tree, restored), step
