"""The port's benchmark harness (``repro_torch.benchmarks``) against the
reference's (``benchmarks/``), on the CPU.

The numpy benches (planner, workload, fleet-scale, chaos, fleet) run the
port's control plane and serving layer: every field outside the wall clock
equals the reference bench's at the same flags, the reference run as a
script in a subprocess. The paper tables' rows equal the reference's with
the scheduler's measured wall time billed as 0 on both sides. The port's
gate passes the port's workload and chaos artifacts against the committed
baselines and fails a doctored one. The execute bench reproduces the
committed execute baseline's structure with f32 parity. The kernel bounds
reproduce PERF.md's. Without a card the kernel and execute benches refuse
to run. No bench writes a reference file.
"""
import hashlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (port module, reference script, flags, artifact file, wall-clock keys dropped)
NUMPY_BENCHES = {
    "workload": ("workload_bench", ["--smoke"], "BENCH_workload.json", ("sim_wall_s",)),
    "fleet_scale": ("fleet_scale_bench", ["--smoke"], "BENCH_fleet_scale.json",
                    ("wall_s", "wall_per_frame_us", "wall_off_s", "wall_on_s",
                     "overhead_ratio")),
    "chaos": ("chaos_bench", [], "BENCH_chaos.json", ("wall_s",)),
    "planner": ("planner_bench", ["--states", "8", "--reps", "1", "--fleet-streams", "4",
                                  "--fleet-frames", "5"], "BENCH_planner.json",
                ("legacy_us_per_decision", "vectorized_us_per_decision", "speedup",
                 "step_us_per_decision", "fleet_wall_s", "fleet_speedup")),
    "fleet": ("fleet_bench", ["--streams", "8", "--networks", "wifi", "--frames", "10"],
              "fleet_bench.json", ("sim_wall_s",)),
}


def _reference_files() -> dict[str, str]:
    files = sorted(ROOT.glob("BENCH_*.json")) + sorted(
        (ROOT / "benchmarks" / "baselines").iterdir())
    return {str(p.relative_to(ROOT)): hashlib.sha256(p.read_bytes()).hexdigest() for p in files}


def _flags(name: str, out_dir: pathlib.Path) -> list[str]:
    _, flags, artifact, _ = NUMPY_BENCHES[name]
    flags = flags + ["--out", str(out_dir / artifact)]
    if name == "chaos":
        flags += ["--trace-out", str(out_dir / "BENCH_chaos_trace.json")]
    return flags


@pytest.fixture(scope="module")
def reference_snapshot():
    return _reference_files()


@pytest.fixture(scope="module")
def numpy_runs(tmp_path_factory, reference_snapshot):
    """Every numpy bench run by the reference (scripts, concurrently, in
    subprocesses) and by the port (in this process) into two directories."""
    ref_dir, port_dir = tmp_path_factory.mktemp("ref"), tmp_path_factory.mktemp("port")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "benchmarks" / f"{mod}.py"), *_flags(name, ref_dir)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (mod, *_) in NUMPY_BENCHES.items()}
    import importlib
    for name, (mod, *_) in NUMPY_BENCHES.items():
        importlib.import_module(f"repro_torch.benchmarks.{mod}").main(_flags(name, port_dir))
    for name, proc in procs.items():
        out, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"reference {name}: {out[-2000:]}"
    return ref_dir, port_dir


def _without(obj, keys):
    if isinstance(obj, dict):
        return {k: _without(v, keys) for k, v in obj.items() if k not in keys}
    if isinstance(obj, list):
        return [_without(v, keys) for v in obj]
    return obj


@pytest.mark.parametrize("name", list(NUMPY_BENCHES))
def test_numpy_bench_equals_reference(numpy_runs, name):
    ref_dir, port_dir = numpy_runs
    artifact, wall_keys = NUMPY_BENCHES[name][2], NUMPY_BENCHES[name][3]
    ref = json.loads((ref_dir / artifact).read_text())
    port = json.loads((port_dir / artifact).read_text())
    assert _without(port, wall_keys) == _without(ref, wall_keys)
    if name == "chaos":  # the recovery cell's Chrome trace, byte for byte
        assert (port_dir / "BENCH_chaos_trace.json").read_bytes() == \
            (ref_dir / "BENCH_chaos_trace.json").read_bytes()
        assert port["chaos"]["cells"][0]["telemetry"]["reconcile"]["ok"]


def test_workload_smoke_equals_committed_baseline(numpy_runs):
    _, port_dir = numpy_runs
    port = json.loads((port_dir / "BENCH_workload.json").read_text())
    base = json.loads((ROOT / "benchmarks" / "baselines" / "BENCH_workload.json").read_text())
    assert _without(port, ("sim_wall_s",)) == _without(base, ("sim_wall_s",))


def test_paper_tables_equal_reference(monkeypatch):
    """Every table but ``table2_overhead`` (both of whose columns are wall
    clock): names and both columns equal, with the scheduler's measured wall
    time (``JanusEngine.overhead_s``, billed into fig. 7's latencies) set to 0
    in both packages."""
    monkeypatch.syspath_prepend(str(ROOT))
    from benchmarks import paper_tables as ref_tables
    from repro.core import engine as ref_engine
    from repro_torch.benchmarks import paper_tables
    from repro_torch.core import engine

    monkeypatch.setattr(ref_engine.JanusEngine, "overhead_s", lambda self, step: 0.0)
    monkeypatch.setattr(engine.JanusEngine, "overhead_s", lambda self, step: 0.0)
    assert [f.__name__ for f in paper_tables.ALL] == [f.__name__ for f in ref_tables.ALL]
    for fn, ref_fn in zip(paper_tables.ALL, ref_tables.ALL):
        if fn.__name__ == "table2_overhead":
            assert [r[0] for r in fn()] == [r[0] for r in ref_fn()]
            continue
        assert fn() == ref_fn(), fn.__name__


BASELINES = ROOT / "benchmarks" / "baselines"


def _gate(**fresh) -> int:
    """The port gate over ``fresh`` artifacts; an artifact a test does not
    exercise is the committed baseline itself, which passes against itself."""
    from repro_torch.benchmarks import check_regression
    paths = {"planner": BASELINES / "BENCH_planner.json",
             "workload": BASELINES / "BENCH_workload.json",
             "fleet-scale": BASELINES / "BENCH_fleet_scale.json",
             "execute": BASELINES / "BENCH_execute.json"}
    paths.update({name.replace("_", "-"): path for name, path in fresh.items()})
    return check_regression.main([arg for name, path in paths.items()
                                  for arg in (f"--{name}", str(path))])


def test_gate_passes_port_artifacts_and_fails_a_doctored_one(numpy_runs, tmp_path):
    _, port_dir = numpy_runs
    workload, chaos = port_dir / "BENCH_workload.json", port_dir / "BENCH_chaos.json"
    assert _gate(workload=workload, fleet_scale=chaos) == 0
    doctored = json.loads(workload.read_text())
    doctored["rows"][0]["violation_ratio"] += 0.1
    bad = tmp_path / "BENCH_workload.json"
    bad.write_text(json.dumps(doctored))
    assert _gate(workload=bad, fleet_scale=chaos) == 1
    # a missing artifact fails the presence check
    assert _gate(workload=workload, fleet_scale=chaos, planner=tmp_path / "absent.json") == 1


def test_gate_reports_the_execute_wall_ratio_without_gating_it(tmp_path, capsys):
    """The execute baseline's walls time XLA on a CPU: the port's gate prints
    the ratio and does not fail on it; parity and the retrace bounds stay
    gated."""
    base = json.loads((ROOT / "benchmarks" / "baselines" / "BENCH_execute.json").read_text())
    slow = json.loads(json.dumps(base))
    for r in slow["modes"]:
        r["episode_wall_s"] *= 100.0
    path = tmp_path / "BENCH_execute.json"
    path.write_text(json.dumps(slow))
    assert _gate(execute=path) == 0
    assert "reported, not gated" in capsys.readouterr().out
    slow["modes"][-1]["parity_max_abs_diff"] = 1e-3
    path.write_text(json.dumps(slow))
    assert _gate(execute=path) == 1


def test_execute_bench_reproduces_the_committed_baseline():
    from repro_torch.benchmarks import execute_bench

    base = json.loads((ROOT / "benchmarks" / "baselines" / "BENCH_execute.json").read_text())
    art = execute_bench.run(8, 1, (1, 2, 4), device="cpu")
    for key in ("cloud_entry_counts", "shared_suffixes", "bucket_table"):
        assert art[key] == base[key], key
    assert [r["mode"] for r in art["modes"]] == [r["mode"] for r in base["modes"]]
    for r, b in zip(art["modes"], base["modes"]):
        assert r["traces"] == b["traces"], r["mode"]
        assert r["parity_max_abs_diff"] <= execute_bench.PARITY_ATOL == 2e-6
        assert r["parity_ok"]
        for key in ("edges_at_split", "bucket_cells", "n_edges"):
            assert r.get(key) == b.get(key), (r["mode"], key)
    assert art["config"]["backend"] == "cpu"
    assert art["parity_atol"] == base["parity_atol"]


def test_kernel_bounds_reproduce_perf_md():
    """PERF.md §6's bounds: flash_attention_mma at ViT B=8 with the bias
    0.0113 ms (bytes), tome_scores B=8 0.00127 ms (f32 operations),
    decode_attention_mma at starcoder2's decode 0.0027 ms (bytes), the flash
    backward at the vit-l16 train call 0.1103 ms (bf16 operations), the f32
    decode kernel at starcoder2's f32 decode 0.0054 ms and over the full
    8192 and 32768 caches 0.0401 and 0.0200 ms (bytes); flash_attention_mma
    at flux-dev gen_1024's two calls 1.0553 and 0.4690 ms (bf16 operations),
    the qwen3-moe causal prefill 0.0801 ms and the vit-l16 train forward
    0.0452 ms (bytes), dit-s2 with the bias 0.1042 ms (bf16 operations), the
    Janus path's B=1 frame 0.0014 ms (bytes)."""
    from repro_torch.benchmarks import kernel_bench, timing

    cases = {c.label: c for c in kernel_bench.CASES}
    for label, want, by in (("vit_b8_bias_bf16", 0.0113, "bytes"),
                            ("vit_b8_f32", 0.00127, "operations"),
                            ("starcoder2_decode_bf16", 0.0027, "bytes"),
                            ("vit_l16_train_bwd_bf16", 0.1103, "operations"),
                            ("starcoder2_decode_f32", 0.0054, "bytes"),
                            ("long_cache_b8_f32", 0.0401, "bytes"),
                            ("long_cache_b1_f32", 0.0200, "bytes"),
                            ("flux_gen1024_bf16", 1.0553, "operations"),
                            ("flux_1536_bf16", 0.4690, "operations"),
                            ("qwen3_prefill_causal_bf16", 0.0801, "bytes"),
                            ("vit_l16_train_fwd_bf16", 0.0452, "bytes"),
                            ("dit_s2_bias_bf16", 0.1042, "operations"),
                            ("vit_b1_bias_bf16", 0.0014, "bytes")):
        ms, got_by = cases[label].bound()
        assert got_by == by and ms == pytest.approx(want, rel=0.01), label
    # the moved helper: 2·B·Na·Nb·D f32 operations against the bytes
    ms, by = timing.bound(2.0 * 8 * 289 * 288 * 64, (8 * 289 * 64 + 8 * 288 * 64) * 4.0
                          + 8 * 289 * 8, timing.PEAK_F32)
    assert by == "operations" and ms == pytest.approx(0.00127, rel=0.01)
    assert [c.kernel() for c in kernel_bench.CASES] == [
        "tome_scores", "flash_attention", "decode_attention", "flash_attention_mma",
        "flash_attention_mma", "decode_attention_mma", "flash_attention_mma_bwd",
        "flash_attention_mma_bwd", "flash_attention_bwd", "flash_attention_bwd"] + [
        "decode_attention"] * 5 + ["flash_attention_mma"] * 6


def test_kernel_bench_times_giant_plain_flash_versions_back_to_back():
    """A plain flash version whose f32 scores pass 2 GiB (flux-dev gen_1024's
    8.2 GB, its [16,24,1536,128] call's 3.6 GB) stalls the host on its
    allocations, so it is timed back to back; every other row's plain version
    is queued."""
    from repro_torch.benchmarks import kernel_bench

    back_to_back = [c.label for c in kernel_bench.CASES if not c.plain_queued()]
    assert back_to_back == ["flux_gen1024_bf16", "flux_1536_bf16"]


def test_benches_refuse_to_time_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.benchmarks import execute_bench, kernel_bench, run

    with pytest.raises(RuntimeError, match="is_available"):
        kernel_bench.main([])
    with pytest.raises(RuntimeError, match="is_available"):
        kernel_bench.rows()
    with pytest.raises(RuntimeError, match="cuda"):
        execute_bench.main(["--smoke"])
    with pytest.raises(RuntimeError, match="cuda"):
        run.main([])


def test_run_on_the_cpu_marks_the_kernel_rows_unmeasured(capsys):
    from repro_torch.benchmarks import run

    run.main(["--device", "cpu"])
    # the CSV rows (the fleet-scale frontier also prints its progress lines)
    lines = [line for line in capsys.readouterr().out.splitlines() if "," in line]
    assert lines[0] == "name,us_per_call,derived"
    assert "kernel/NOT_MEASURED,0,needs the card" in lines
    assert [line for line in lines if line.startswith("kernel/")] == [
        "kernel/NOT_MEASURED,0,needs the card"]
    sections = [line.split("/")[0] for line in lines[1:]]
    order = [s for i, s in enumerate(sections) if i == 0 or sections[i - 1] != s]
    assert order == ["table1", "fig2", "fig5", "fig7", "fig8", "fig9", "table2", "kernel",
                     "planner", "workload", "fleet_scale", "roofline"]
    assert all(np.isfinite(float(line.split(",")[1])) for line in lines[1:])


def test_no_bench_wrote_a_reference_file(reference_snapshot, numpy_runs):
    """Runs after the benches of this file: the root BENCH_*.json and
    benchmarks/baselines/ are byte-identical to before, and the benches'
    default artifacts lie under the git-ignored experiments/torch/bench/."""
    from repro_torch.benchmarks import common

    assert _reference_files() == reference_snapshot
    assert common.OUT_DIR == ROOT / "experiments" / "torch" / "bench"
    assert "experiments/torch/" in (ROOT / ".gitignore").read_text().split()
