"""The port's serving examples (``repro_torch.examples.quickstart``,
``fleet_serving``, ``janus_serving_e2e``, ``workload_scenarios``) run to
their end on the CPU with ``--device cpu``, their reports held against the
reference's: each run's serve CLI arguments through
``repro.launch.serve.main``, with ``time.perf_counter`` frozen (the planner's
measured overhead then bills 0 on both sides), line for line but the
port's ``device=cpu`` tag. Frames are cut (``--frames``) to keep the runs
short; the arguments are otherwise the reference examples'. The quickstart's
profiler fit and schedule lines are the reference's (they are numpy);
its split run equals its monolithic one. Without ``--device cpu`` each
example raises: there is no card here.
"""
import json
import time

import pytest

from repro.core import bandwidth as jbandwidth
from repro.core import profiler as jprofiler
from repro.core import scheduler as jscheduler
from repro.launch import serve as jserve

from repro_torch.examples import fleet_serving, janus_serving_e2e, quickstart, workload_scenarios
import torch

# -n 6 workers, each running 8 intra-op threads on 8 cores, oversubscribe the CPU
# (a 2 s case took 150 s among six copies): one thread a worker
torch.set_num_threads(1)


def _lines(fn, capsys, monkeypatch) -> list[str]:
    monkeypatch.setattr(time, "perf_counter", lambda: 0.0)
    fn()
    monkeypatch.undo()
    return [line.replace(" device=cpu", "") for line in capsys.readouterr().out.splitlines()]


def _reference(runs) -> None:
    for title, argv in runs:
        print(f"\n=== {title} ===")
        jserve.main(argv)


@pytest.mark.parametrize("module,frames", [(fleet_serving, 6), (janus_serving_e2e, 2)],
                         ids=["fleet_serving", "janus_serving_e2e"])
def test_serving_example_matches_reference(module, frames, capsys, monkeypatch):
    port = _lines(lambda: module.main(["--frames", str(frames), "--device", "cpu"]), capsys,
                  monkeypatch)
    ref = _lines(lambda: _reference(module.runs(frames)), capsys, monkeypatch)
    assert port == ref and len(port) > 10


def test_workload_scenarios_match_reference(tmp_path, capsys, monkeypatch):
    port = _lines(lambda: workload_scenarios.main(["--frames", "6", "--device", "cpu"]), capsys,
                  monkeypatch)
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(workload_scenarios.spec(6)))
    ref = _lines(lambda: _reference(workload_scenarios.runs(6, str(path))), capsys, monkeypatch)
    assert port == ref
    assert sum(line.startswith("=== ") for line in port) == 9


def test_workload_runs_are_the_reference_examples():
    """The scenario arguments at the reference example's 30 frames."""
    import pathlib
    src = (pathlib.Path(__file__).resolve().parents[1] / "examples" /
           "workload_scenarios.py").read_text()
    for title, argv in workload_scenarios.runs(30, "spec.json"):
        assert f'=== {title} ===' in src
        for flag in argv:
            if flag.startswith("--") and flag != "--workload":
                assert f'"{flag}"' in src, flag


def test_quickstart_matches_reference(capsys):
    err = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert err < 1e-3 and out[-1] == "quickstart OK"
    cfg = quickstart.CFG
    grid = range(8, cfg.num_tokens + 1, 8)
    profile = jscheduler.ModelProfile(
        n_layers=cfg.n_layers, x0=cfg.num_tokens, token_bytes=cfg.d_model,
        raw_input_bytes=64 * 64 * 3 * 0.7,
        device=jprofiler.profile_platform(jprofiler.EDGE_PLATFORM, cfg.d_model, cfg.d_ff, grid),
        cloud=jprofiler.profile_platform(jprofiler.CLOUD_PLATFORM, cfg.d_model, cfg.d_ff, grid))
    want = [f"profiler fit: device r={profile.device.r:.4f} cloud r={profile.cloud.r:.4f}"]
    trace = jbandwidth.synthetic_trace("4g", "driving", steps=5, seed=0)
    for step in range(5):
        bw = trace.at(step)
        dec = jscheduler.schedule(profile, bw, trace.rtt_s, sla_s=0.05)
        want.append(f"step {step}: bw={bw/1e6:6.2f} Mbps -> alpha={dec.alpha:.2f} "
                    f"split={dec.split} predicted={dec.predicted_latency_s*1e3:.1f} ms "
                    f"(SLA {'ok' if dec.meets_sla else 'MISS'})")
    assert out[:6] == want


@pytest.mark.parametrize("module", [quickstart, fleet_serving, janus_serving_e2e,
                                    workload_scenarios],
                         ids=["quickstart", "fleet_serving", "janus_serving_e2e",
                              "workload_scenarios"])
def test_examples_need_a_card_without_device_cpu(module):
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        module.main(["--frames", "1"] if module is not quickstart else [])
