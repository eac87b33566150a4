"""One function per paper table/figure (deliverable d), PyTorch port of
``benchmarks/paper_tables.py`` on the port's numpy control plane.

Each returns rows of (name, us_per_call, derived) where us_per_call is the
relevant latency metric and derived is the headline comparison the paper
reports (delta / speedup / violation reduction). The ``derived`` column
equals the reference's (``table2_overhead``'s columns both come from the
wall clock).
"""
from __future__ import annotations

import time

from repro_torch.benchmarks.common import SIM_DEVICE, VIDEO_MAE, VITL384, paper_profile
from repro_torch.core import bandwidth, engine, profiler, pruning, scheduler


def _stack_latency(platform, counts, m=VITL384):
    return sum(platform.layer_latency(t, m["d"], m["dff"]) for t in counts)


def table1_pruning_strategies():
    """Table I: No / Linear / Exponential declining pruning latency on the
    edge device and the cloud server (paper: 653.3/432.0/403.2 edge,
    32.3/24.2/22.5 cloud, ms)."""
    m = VITL384
    amax = pruning.alpha_max(m["n"], m["x0"])
    exp = pruning.make_schedule("exponential", amax, m["n"], m["x0"])
    cum = pruning.cumulative(exp)
    lin_alpha = cum / sum(m["n"] - l for l in range(1, m["n"] + 1))
    lin = pruning.make_schedule("linear", lin_alpha, m["n"], m["x0"])
    rows = []
    for kind, sched in (("none", [0] * m["n"]), ("linear", lin), ("exponential", exp)):
        counts = pruning.token_counts(m["x0"], sched)[:-1]
        for plat, pname in ((profiler.EDGE_PLATFORM, "edge"),
                            (profiler.CLOUD_PLATFORM, "cloud")):
            t = _stack_latency(plat, counts)
            base = _stack_latency(plat, [m["x0"]] * m["n"])
            rows.append((f"table1/{kind}/{pname}", t * 1e6, round(t - base, 6)))
    return rows


def fig2_latency_breakdown():
    """Fig. 2: ViT-B query breakdown (comm 4g/5g/wifi; compute cpu/gpu/cloud)."""
    rows = []
    frame_bytes = 224 * 224 * 3 * 0.35  # LZW'd frame
    for net, kind in (("4g", bandwidth.NETWORKS["4g"]),
                      ("5g", bandwidth.NETWORKS["5g"]),
                      ("wifi", bandwidth.NETWORKS["wifi"])):
        t = frame_bytes * 8 / kind.mean_up_bps + kind.rtt_s
        rows.append((f"fig2/comm/{net}", t * 1e6, kind.mean_up_bps))
    vitb = dict(d=768, dff=3072, x0=197, n=12)
    for plat, name in ((profiler.EDGE_PLATFORM, "device_gpu"),
                       (profiler.CLOUD_PLATFORM, "cloud_gpu")):
        t = sum(plat.layer_latency(vitb["x0"], vitb["d"], vitb["dff"])
                for _ in range(vitb["n"]))
        rows.append((f"fig2/compute/{name}", t * 1e6, vitb["n"]))
    return rows


def fig5_profiler_linearity():
    """Fig. 5: layer latency vs tokens is linear (r > 0.85) on both platforms."""
    rows = []
    for m, mname in ((VITL384, "vitl384"), (dict(VITL384, x0=197), "vitb")):
        grid = range(32, m["x0"] + 1, 32)
        for plat, pname in ((profiler.EDGE_PLATFORM, "edge"),
                            (profiler.CLOUD_PLATFORM, "cloud")):
            prof = profiler.profile_platform(plat, m["d"], m["dff"], grid)
            rows.append((f"fig5/{mname}/{pname}",
                         prof.predict(m["x0"]) * 1e6, round(prof.r, 4)))
    return rows


def _run_policies(profile, sla_s, trace, frames, fixed_r):
    eng = engine.JanusEngine(profile, engine.EngineConfig(
        sla_s=sla_s, baseline_fixed_r=fixed_r), device=SIM_DEVICE)
    return {p: eng.run_trace(trace, frames, p)
            for p in ("janus", "device", "cloud", "mixed")}


def fig7_overall_performance():
    """Fig. 7: throughput / violation ratio / accuracy across network
    scenarios x {image recognition, video classification}, per baseline —
    the paper's headline "up to" numbers are the best of these (throughput up
    to 5.15x vs Cloud-Only; violation reduction up to 98.7% vs Device-Only)."""
    rows = []
    scenarios = [("4g", "driving"), ("4g", "walking"), ("5g", "driving"),
                 ("5g", "static")]
    tasks = [("image", VITL384, 0.3), ("video", VIDEO_MAE, 0.6)]
    for task, model, sla in tasks:
        prof = paper_profile(model)
        for net, mob in scenarios:
            trace = bandwidth.synthetic_trace(net, mob, steps=120, seed=11)
            stats = _run_policies(prof, sla, trace, 120, model["fixed_r"])
            j = stats["janus"]
            for base in ("device", "cloud", "mixed"):
                s = stats[base]
                speedup = j.avg_throughput_fps / max(s.avg_throughput_fps, 1e-9)
                rows.append((f"fig7/{task}/{net}-{mob}/speedup_vs_{base}",
                             j.avg_latency_s * 1e6, round(speedup, 2)))
                if s.violation_ratio > 0:
                    red = 1 - j.violation_ratio / s.violation_ratio
                    rows.append((f"fig7/{task}/{net}-{mob}/violation_reduction_vs_{base}",
                                 j.violation_ratio * 1e6, round(red, 3)))
            acc_gain = j.avg_accuracy - max(stats[p].avg_accuracy
                                            for p in ("device", "cloud", "mixed"))
            rows.append((f"fig7/{task}/{net}-{mob}/accuracy_gain",
                         j.avg_accuracy * 1e6, round(acc_gain, 5)))
    return rows


def fig8_trace_walkthrough():
    """Fig. 8: per-step decisions on an LTE-driving trace: cloud-only when the
    network is good, split+prune when it degrades."""
    prof = paper_profile()
    trace = bandwidth.synthetic_trace("4g", "driving", steps=40, seed=8)
    eng = engine.JanusEngine(prof, engine.EngineConfig(sla_s=0.3), device=SIM_DEVICE)
    st = eng.run_trace(trace, 40, "janus")
    n_cloud = sum(1 for f in st.frames if f.split == 0)
    n_split = sum(1 for f in st.frames if 0 < f.split <= prof.n_layers)
    n_pruned = sum(1 for f in st.frames if f.alpha > 0)
    return [("fig8/frames_cloud_only", n_cloud * 1e6 / 40, n_cloud),
            ("fig8/frames_split", n_split * 1e6 / 40, n_split),
            ("fig8/frames_pruned", n_pruned * 1e6 / 40, n_pruned)]


def fig9_bandwidth_sensitivity():
    """Fig. 9: latency + chosen (alpha, split) vs bandwidth; Cloud-Only only
    meets the SLA past ~44 Mbps while Janus always does."""
    rows = []
    prof = paper_profile()
    cloud_ok_at = None
    for bw_mbps in (2, 5, 10, 20, 30, 44, 60, 100):
        bw = bw_mbps * 1e6
        dec = scheduler.schedule(prof, bw, 0.02, sla_s=0.3)
        rows.append((f"fig9/image/bw{bw_mbps}Mbps/alpha{dec.alpha:.2f}_split{dec.split}",
                     dec.predicted_latency_s * 1e6, int(dec.meets_sla)))
        # cloud-only latency at this bandwidth
        counts = [prof.x0] * prof.n_layers
        t_cloud = (prof.raw_input_bytes * 8 / bw + 0.02 + prof.cloud_embed_s
                   + sum(prof.cloud.predict(c) for c in counts) + prof.head_s)
        if cloud_ok_at is None and t_cloud <= 0.3:
            cloud_ok_at = bw_mbps
    rows.append(("fig9/cloud_only_meets_sla_at_Mbps", 0.0, cloud_ok_at))
    return rows


def table2_overhead():
    """Table II: Janus system overhead share of E2E latency (< 0.21%)."""
    rows = []
    prof = paper_profile()
    for net, sla in (("wifi", 0.5), ("5g", 0.5), ("4g", 0.5)):
        trace = bandwidth.synthetic_trace(net, "walking", steps=60, seed=2)
        eng = engine.JanusEngine(prof, engine.EngineConfig(sla_s=sla), device=SIM_DEVICE)
        t0 = time.perf_counter()
        [scheduler.schedule(prof, trace.at(i), trace.rtt_s, sla)
         for i in range(60)]
        sched_time = (time.perf_counter() - t0) / 60
        st = eng.run_trace(trace, 60, "janus")
        share = sched_time / max(st.avg_latency_s, 1e-9)
        rows.append((f"table2/{net}/system_overhead_share",
                     sched_time * 1e6, round(share * 100, 4)))
    return rows


ALL = [table1_pruning_strategies, fig2_latency_breakdown, fig5_profiler_linearity,
       fig7_overall_performance, fig8_trace_walkthrough,
       fig9_bandwidth_sensitivity, table2_overhead]
