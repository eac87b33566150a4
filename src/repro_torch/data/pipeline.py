"""Synthetic data pipeline, PyTorch port of ``repro.data.pipeline``.

Deterministic per-(seed, step) host batches for every family (classification
images, LM token streams, diffusion latents, flux's text embeddings): the
same numpy generator, ``default_rng((seed << 32) ^ step)``, so the port's
batches equal the reference's bit for bit. ``place`` copies a host batch to
one device, or, given a sharded bundle's batch shardings, places it on their
mesh: each rank uploads only its own shard, a view of the host array taken by
the shardings' placements, and wraps it as a DTensor (the counterpart of the
reference's ``make_array_from_callback``, which its multi-host branch uses).

The generator is stateless in the step index, so a resumed run continues
the stream exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.runtime.device import resolve_device
from repro_torch.sharding.rules import shard_slices


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    n_classes: int = 1000


class SyntheticData:
    def __init__(self, cfg: DataConfig = DataConfig()):
        self.cfg = cfg

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.cfg.seed << 32) ^ step)

    def images(self, step: int, batch: int, res: int, channels: int = 3):
        rng = self._rng(step)
        x = rng.standard_normal((batch, res, res, channels), dtype=np.float32)
        y = rng.integers(0, self.cfg.n_classes, size=(batch,), dtype=np.int32)
        return {"images": x, "labels": y}

    def tokens(self, step: int, batch: int, seq: int, vocab: int):
        rng = self._rng(step)
        return {"tokens": rng.integers(0, vocab, size=(batch, seq), dtype=np.int32)}

    def latents(self, step: int, batch: int, res: int, channels: int = 4):
        rng = self._rng(step)
        return {"latents": rng.standard_normal((batch, res, res, channels),
                                               dtype=np.float32),
                "labels": rng.integers(0, self.cfg.n_classes, size=(batch,),
                                       dtype=np.int32)}

    def flux_batch(self, step: int, batch: int, res: int, txt_len: int,
                   t5_dim: int, clip_dim: int, channels: int = 16):
        rng = self._rng(step)
        return {"latents": rng.standard_normal((batch, res, res, channels),
                                               dtype=np.float32),
                "txt": rng.standard_normal((batch, txt_len, t5_dim),
                                           dtype=np.float32),
                "vec": rng.standard_normal((batch, clip_dim), dtype=np.float32)}


def place(batch: dict, device=None, shardings: dict | None = None) -> dict:
    """Host batch -> tensors on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``; raises if no card is there), dtypes kept. With
    ``shardings`` (a dict of ``NamedSharding`` by key, a sharded bundle's
    ``in_shardings[2]``) every leaf is a DTensor on their mesh holding this
    rank's shard, the only part of the host array it copies."""
    device = resolve_device(device)
    if shardings is None:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in batch.items()}
    out = {}
    for k, v in batch.items():
        sh = shardings[k]
        placements = sh.placements(v.shape)
        local = np.ascontiguousarray(v[shard_slices(v.shape, sh.mesh, placements)])
        out[k] = DTensor.from_local(torch.from_numpy(local).to(device), sh.mesh,
                                    list(placements), run_check=False)
    return out
