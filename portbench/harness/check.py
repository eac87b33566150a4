"""How ``correct`` is decided: the logits that the timed path put on the
host are held against the plain reference (``reference/<name>.py``), run
after the window on the same weights and images, in float32 with TF32 off,
in blocks of frames.

Numbers compared, each with its limit:

- ``frames_without_logits``: dispatched frames whose logits never came (0).
- ``logit_rel_err_max``: over a sample of the window's done frames, drawn
  from the seed with every frame kind in it, the largest relative error
  ||program - reference|| / ||reference|| of a frame's logits. The limit is
  the traffic file's ``check.rel_err_limit``. A non-finite logit reads as
  infinity.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from harness.traffic import Frame
from harness.weights import sub_seed


def reference_module(cfg: dict):
    return importlib.import_module(f"reference.{cfg['reference']}")


def sample(frames: list[Frame], logits: dict, count: int, seed: int) -> list[Frame]:
    """``count`` done frames drawn from the seed, each kind in proportion
    and every kind that was done at least once."""
    rng = np.random.Generator(np.random.PCG64(sub_seed(seed, 3)))
    done = [f for f in frames if f.fid in logits]
    kinds = sorted({f.kind for f in done})
    picked = []
    for k in kinds:
        of_kind = [f for f in done if f.kind == k]
        n = min(len(of_kind), max(1, round(count * len(of_kind) / len(done))))
        picked += [of_kind[i] for i in rng.choice(len(of_kind), n, replace=False)]
    return sorted(picked, key=lambda f: f.fid)


def reference_logits(cfg: dict, params: dict, pool: torch.Tensor, schedules: list,
                     frames: list[Frame], block: int, quant=None) -> dict[int, np.ndarray]:
    """The reference's logits of ``frames``, by frame id, computed a block
    of frames of one kind at a time."""
    ref = reference_module(cfg)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        with torch.inference_mode():
            for kind in sorted({f.kind for f in frames}):
                group = [f for f in frames if f.kind == kind]
                for lo in range(0, len(group), block):
                    part = group[lo:lo + block]
                    idx = torch.tensor([f.image for f in part], device=pool.device)
                    lg = ref.forward(params, cfg, pool.index_select(0, idx), schedules[kind],
                                     quant=quant).cpu().numpy()
                    out.update({f.fid: lg[i] for i, f in enumerate(part)})
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return out


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    if not np.all(np.isfinite(got)):
        return float("inf")
    return float(np.linalg.norm(got.astype(np.float64) - want)
                 / np.linalg.norm(want.astype(np.float64)))


def judge(dispatched: int, returned: int, sampled: dict[int, np.ndarray],
          want: dict[int, np.ndarray], limit: float) -> tuple[bool, dict]:
    worst = max((rel_err(sampled[k], want[k]) for k in want), default=float("inf"))
    checks = {"frames_without_logits": {"value": dispatched - returned, "limit": 0},
              "logit_rel_err_max": {"value": worst, "limit": limit}}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
