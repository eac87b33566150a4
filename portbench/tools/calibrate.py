"""Readings that the limits of ``correct`` are set from, for one cell, in
one process on the card:

    python portbench/tools/calibrate.py --workload <cell> --seeds 1 2 3 --seconds 5 [--control 3]

For each seed: the cell's weights and images, a short window of its traffic
through the timed path, and the largest relative logit error of the sampled
frames against the float32 reference (the program's reading). For the first
``--control`` seeds also the control: the reference itself computed with
float8 e4m3 operands (``reference.vit_tome.fp8_rows``), held against the
float32 reference on the same frames (the control's reading), and judged
as a run judges the program (``control_correct``, which has to be false).
For every seed, how far apart the reference puts different inputs: the
smallest relative gap between the reference logits of two sampled frames
with different images (``ref_gap_min``), and between one image's logits
under two different schedules of the mix (``ref_gap_kinds_min``, over the
first ``GAP_IMAGES`` sampled images), and, by kind, between a merged frame's
logits and the same image's unmerged ones (``ref_gap_unmerged``): an answer
given to the wrong frame, at the wrong schedule or without its merges reads
at least that. Prints one JSON line per seed.
The benchmark's own runs never run the control.
"""
import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import check, serve, spec  # noqa: E402
from harness.main import vit_config  # noqa: E402
from harness.traffic import Frame, Source, validate  # noqa: E402
from harness.weights import make_images, make_params  # noqa: E402


GAP_IMAGES = 8


def gaps(logits: np.ndarray) -> np.ndarray:
    """``[i, j]``: ||logits[j] - logits[i]|| / ||logits[i]||, the error that
    row i's frame reads when it is given row j's answer."""
    x = logits.astype(np.float64)
    sq = (x * x).sum(1)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * x @ x.T, 0.0)
    return np.sqrt(d2) / np.sqrt(sq)[:, None]


def readings(cell: str, seed: int, seconds: float, control: bool, device: torch.device,
             cfg: dict | None = None, traffic: dict | None = None) -> dict:
    bench = spec.load_benchmark()
    w = spec.workload(bench, cell)
    cfg = cfg or spec.config(bench, w["config"])
    traffic = traffic or spec.traffic(w["traffic"])
    validate(traffic, cfg)
    torch.set_grad_enabled(False)
    params = make_params(cfg, seed, device)
    pool = make_images(cfg, traffic["image_pool"], seed, device)
    tier = serve.CloudTier(vit_config(cfg), params, pool, traffic)
    warm = Source(traffic, seed, stream=4)
    for n in traffic["warmup_batches"][:1]:
        tier.dispatch([warm.next(0.0) for _ in range(n)])
    window = serve.run_window(tier, traffic, Source(traffic, seed), seconds)
    picked = check.sample(window.frames, window.logits, traffic["check"]["frames"], seed)
    schedules = tier.schedules
    del tier
    want = check.reference_logits(cfg, params, pool, schedules, picked, traffic["check"]["block"])
    errs = {f.fid: check.rel_err(window.logits[f.fid], want[f.fid]) for f in picked}
    kinds = {f.fid: f.kind for f in picked}
    out = {"cell": cell, "seed": seed, "frames": len(picked), "done": len(window.logits),
           "program": max(errs.values()),
           "program_by_kind": {k: max(e for f, e in errs.items() if kinds[f] == k)
                               for k in sorted(set(kinds.values()))},
           "program_median": float(np.median(list(errs.values())))}
    ids = sorted(want)
    g = gaps(np.stack([want[i] for i in ids]))
    image_of = {f.fid: f.image for f in picked}
    images = np.array([image_of[i] for i in ids])
    g[images[:, None] == images[None, :]] = np.inf   # the same image: the same input, or a kind
    out["ref_gap_min"] = float(g.min())
    if len(schedules) > 1:
        imgs = sorted({f.image for f in picked})[:GAP_IMAGES]
        every = [Frame(len(schedules) * n + k, k, im, 0.0)
                 for n, im in enumerate(imgs) for k in range(len(schedules))]
        per = check.reference_logits(cfg, params, pool, schedules, every,
                                     traffic["check"]["block"])
        gk = gaps(np.stack([per[f.fid] for f in every]))
        same = np.array([f.image for f in every])
        sched = [schedules[f.kind] for f in every]
        gk[same[:, None] != same[None, :]] = np.inf
        gk[[[a == b for b in sched] for a in sched]] = np.inf   # the same input
        out["ref_gap_kinds_min"] = float(gk.min())
        unmerged = [k for k, sc in enumerate(schedules) if not any(sc)]
        if unmerged:   # a merged frame answered as if it had not merged
            col = [i for i, f in enumerate(every) if f.kind == unmerged[0]]
            out["ref_gap_unmerged"] = {
                k: float(min(gk[i, c] for i, f in enumerate(every) if f.kind == k
                             for c in col if every[c].image == f.image))
                for k in range(len(schedules)) if k != unmerged[0]}
    if control:
        from reference.vit_tome import fp8_rows
        low = check.reference_logits(cfg, params, pool, schedules, picked,
                                     traffic["check"]["block"], quant=fp8_rows)
        cerr = [check.rel_err(low[f.fid], want[f.fid]) for f in picked]
        ok, _ = check.judge(len(picked), len(picked), low, want,
                            traffic["check"]["rel_err_limit"])
        out.update(control=max(cerr), control_min_frame=min(cerr),
                   control_median=float(np.median(cerr)), control_correct=ok)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", type=int, default=3, help="seeds that also run the control")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        r = readings(args.workload, seed, args.seconds, i < args.control, torch.device("cuda"))
        r["s"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
