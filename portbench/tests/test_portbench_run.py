"""A run of each cell on the CPU at a tiny size, with the kernels' plain
versions: the result line's shape, the check, and the faults the check has
to catch. The card-only test runs a real cell for a few seconds."""
import json
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from harness import main, spec
from tiny import tiny

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
ROOT = pathlib.Path(__file__).resolve().parents[2]


def run_tiny(cell, traced=False, seconds=0.6, **kw):
    bench, cfg, tr = tiny(cell, **kw)
    return main.run(bench, cell, 2**31 + 5, seconds, traced, torch.device("cpu"),
                    time.perf_counter(), cfg=cfg, traffic=tr, log=lambda *_: None)


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_shape(cell):
    bench = spec.load_benchmark()
    for traced in (False, True):
        result, lines = run_tiny(cell, traced)
        assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert list(result)[-1] == "checks"
        assert result["correct"] is True and result["failed"] == 0
        assert result["attempted"] > 0
        assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        want = {m["name"] for m in spec.metrics_for(bench, cell, traced)}
        # a CPU run has no device trace: the device-trace readers return nothing
        host = {m["name"] for m in spec.metrics_for(bench, cell, traced)
                if m["source"] != "device_trace"}
        assert host <= set(result["metrics"]) <= want
        for m in result["metrics"].values():
            assert set(m) == {"value", "unit"} and m["value"] == m["value"]
        assert [ln.split()[1] for ln in lines] == list(result["checks"])
        json.loads(json.dumps(result))


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out", "answers_swapped"])
def test_check_catches_faults(fault, monkeypatch):
    from repro_torch.core import engine
    original = engine.run_cloud_batch

    def broken(cache, cfg, params, plans, buckets=None):
        original(cache, cfg, params, plans, buckets)
        if fault == "answer_altered":        # one answer changed where it is produced
            plans[0].logits = plans[0].logits * 1.1
        elif fault == "half_left_out":       # half the micro-batch never answered
            for p in plans[len(plans) // 2:]:
                p.logits = None
        elif len(plans) > 1:                 # two frames' answers exchanged
            plans[0].logits, plans[1].logits = plans[1].logits, plans[0].logits

    monkeypatch.setattr(engine, "run_cloud_batch", broken)
    result, _ = run_tiny("vit-l384.offload-4g")
    assert result["correct"] is False


def test_control_fails_the_limit():
    """The control, the reference computed with float8 operands in the
    program's place, reads above the cell's limit; the program itself, in
    bf16 on the plain path, below it."""
    from harness import check
    from reference import vit_tome

    bench, cfg, tr = tiny("vit-l384.offload-4g", dtype="bfloat16")
    cfg.update(hidden_size=128, num_attention_heads=2, head_dim=64, intermediate_size=512,
               num_classes=100)
    result, _ = main.run(bench, "vit-l384.offload-4g", 7, 0.5, False, torch.device("cpu"),
                         time.perf_counter(), cfg=cfg, traffic=tr, log=lambda *_: None)
    assert result["correct"] is True
    from harness.weights import make_images, make_params
    from harness.traffic import Source
    params = make_params(cfg, 7, torch.device("cpu"))
    pool = make_images(cfg, 16, 7, torch.device("cpu"))
    src = Source(dict(tr, image_pool=16), 7)
    frames = [src.next(0.0) for _ in range(16)]
    schedules = [tuple(k["schedule"]) for k in tr["mix"]]
    want = check.reference_logits(cfg, params, pool, schedules, frames, 8)
    low = check.reference_logits(cfg, params, pool, schedules, frames, 8, quant=vit_tome.fp8_rows)
    ok, checks = check.judge(16, 16, low, want, tr["check"]["rel_err_limit"])
    assert not ok and checks["logit_rel_err_max"]["value"] > tr["check"]["rel_err_limit"]


def test_calibrate_gaps():
    """The gap an answer given to the wrong frame reads, row by row."""
    import numpy as np
    sys.path.insert(0, str(ROOT / "portbench" / "tools"))
    from calibrate import gaps
    x = np.array([[3.0, 4.0], [3.0, 4.0], [0.0, 5.0]])
    g = gaps(x)
    assert g[0, 1] == pytest.approx(0.0, abs=1e-7) and g[0, 2] == pytest.approx(np.sqrt(10) / 5)
    assert g[2, 0] == pytest.approx(np.sqrt(10) / 5)


def test_no_card_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          CELLS[0], "--seed", "12345", "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
