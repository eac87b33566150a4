#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. It imports nothing of JAX or of the reference
package ``repro``; it puts ``src`` on ``sys.path`` itself. Phases, in order,
each failing the run on any failed check:

1. device:  the card's name and power limit (nvidia-smi) and torch's name;
2. build:   nvcc builds every kernel library from ``src/repro_torch/kernels/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card at the
            main path's shapes, and timed beside its plain version, one
            library call computing the same function, and its bound;
4. path:    ViT-L@384 bf16 (random weights from a seeded generator) serves a
            6-frame 4G-driving trace through ``JanusEngine(execute=True)`` and
            one split inference at α=0.5, mid split; the kernels' launch
            counters are zeroed just before and read just after;
5. batch:   ``run_cloud_batch`` on 8 mixed-α plans at a shared split, exact
            and bucketed, which must agree; the launch counters are zeroed
            before each and must show the counts the stacked forwards imply;
   trace:   torch.profiler over one device partition and one cloud batch:
            kernel time on the card, idle share, top kernels;
6. parity:  ViT-L@384 in f32, ``vit.forward_janus`` through the kernels
            against the plain path on the card: logits within tolerance and
            identical merge indices per merge layer.

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``. Without a card, or outside a checkout, it
exits nonzero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# the tensor cores, HBM3 bandwidth.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

FLASH_F32 = dict(atol=2e-5, rtol=1e-4)
FLASH_BF16 = dict(atol=2e-2, rtol=0.0)
TOME_MAX = dict(atol=2e-5, rtol=1e-3)   # tests/test_kernels.py:29-30
BATCH_BF16 = dict(atol=0.1, rtol=0.05)  # bucketed vs exact logits, bf16, 6 layers
PARITY_F32 = dict(atol=1e-3, rtol=1e-3)  # kernels vs plain, f32, 24 layers


def fail(msg: str) -> None:
    print(f"[FAIL] {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[device] nvidia-smi: {smi} | torch: {torch.cuda.get_device_name(0)} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    from repro_torch.kernels import _build
    build_s = _build.build_all()
    print(f"[build] nvcc sm_90a, {len(_build.SOURCES)} libraries in {build_s:.1f} s "
          f"-> {_build.BUILD_DIR}")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    from repro_torch.runtime.device import parity_numerics
    parity_numerics()  # f32 plain versions and f32 phases must not use TF32
    rows = kernel_phase(torch)
    model = _vit_l(torch, torch.bfloat16)
    path_counts = path_phase(torch, *model)
    batch_phase(torch, *model)
    trace_phase(torch, *model)
    del model
    parity_phase(torch)

    for row in rows:
        row["launches"] = row["path_launches"] = path_counts[row["name"]]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def time_ms(torch, fn, iters: int = 30) -> float:
    """Mean ms per call over ``iters`` back-to-back calls, CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# --------------------------------------------------------------------- kernels

def kernel_phase(torch) -> list[dict]:
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import tome_scores as tome_mod

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    h, s, d = 16, 577, 64
    flash_err = {torch.float32: 0.0, torch.bfloat16: 0.0}

    def flash_case(label, b, dtype, sq=s, sk=s, pads=0, kv=False, causal=False):
        q = torch.randn((b, h, sq, d), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((b, h, sk, d), generator=gen, device=dev).to(dtype) for _ in "kv")
        sizes = torch.randint(1, 5, (b, sk), generator=gen, device=dev).float()
        if pads:
            sizes[:, sk - pads:] = 0.0  # bucket pads: log(0) = -inf
        bias = torch.log(sizes)
        kv_len = torch.randint(sk // 2, sk + 1, (b,), generator=gen, device=dev,
                               dtype=torch.int32) if kv else None
        out = flash_mod.flash_attention(q, k, v, bias=bias, kv_len=kv_len, causal=causal)
        exp = ref.flash_attention_ref(q, k, v, bias=bias, kv_len=kv_len, causal=causal)
        torch.cuda.synchronize()
        tol = FLASH_F32 if dtype == torch.float32 else FLASH_BF16
        err = (out.float() - exp.float()).abs().max().item()
        flash_err[dtype] = max(flash_err[dtype], err)
        ok = bool(torch.isfinite(out).all()) and torch.allclose(out.float(), exp.float(), **tol)
        print(f"[kernels] flash_attention {label}: B={b} H={h} Sq={sq} Sk={sk} D={d} "
              f"{str(dtype)[6:]} max_abs_err={err:.3e} tol={tol} {'ok' if ok else 'FAIL'}")
        check(ok, f"flash_attention {label} disagrees with its plain version")
        return q, k, v, bias

    for b in (1, 8):
        for dtype in (torch.bfloat16, torch.float32):
            flash_case("prop-attn bias", b, dtype)
    flash_case("bucket pads (-inf bias)", 8, torch.bfloat16, sq=592, sk=592, pads=15)
    flash_case("kv_len", 8, torch.bfloat16, kv=True)
    flash_case("causal", 2, torch.float32, sq=300, sk=577, causal=True)

    tome_err = 0.0

    def tome_case(b, nb_len):
        a = F.normalize(torch.randn((b, 289, d), generator=gen, device=dev), dim=-1)
        bb = F.normalize(torch.randn((b, 288, d), generator=gen, device=dev), dim=-1)
        nbl = torch.randint(100, 289, (b,), generator=gen, device=dev,
                            dtype=torch.int32) if nb_len else None
        m, i = tome_mod.tome_scores(a, bb, nbl)
        mr, ir = ref.tome_scores_ref(a, bb, nbl)
        torch.cuda.synchronize()
        scores = torch.einsum("bnd,bmd->bnm", a, bb)
        if nbl is not None:
            col = torch.arange(288, device=dev)
            scores = scores.masked_fill(col[None, None, :] >= nbl[:, None, None], -torch.inf)
        at_idx = torch.gather(scores, 2, i.long()[..., None])[..., 0]
        err = (m - mr).abs().max().item()
        exact = int((i == ir).sum())
        ok = (torch.allclose(m, mr, **TOME_MAX)
              and torch.allclose(at_idx, scores.amax(-1), **TOME_MAX))
        print(f"[kernels] tome_scores B={b} Na=289 Nb=288 D={d} nb_len={nb_len}: "
              f"max_abs_err={err:.3e} argmax equal {exact}/{i.numel()} "
              f"(others tie at the chosen index) {'ok' if ok else 'FAIL'}")
        check(ok, "tome_scores disagrees with its plain version")
        return max(err, (at_idx - scores.amax(-1)).abs().max().item()), a, bb

    for b in (1, 8):
        for nb_len in (False, True):
            err, a, bb = tome_case(b, nb_len)
            tome_err = max(tome_err, err)

    # timings at the main path's largest calls: the cloud batch of 8 frames
    rows = []
    for b in (1, 8):
        q, k, v, bias = flash_case("timed", b, torch.bfloat16)
        mask = bias[:, None, None, :].to(q.dtype)
        ms = time_ms(torch, lambda: flash_mod.flash_attention(q, k, v, bias=bias))
        plain = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, bias=bias))
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        flops = 4.0 * b * h * s * s * d
        nbytes = 4 * q.numel() * q.element_size() + bias.numel() * 4
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16)
        print(f"[kernels] flash_attention B={b} bf16 timing: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:90",
        max_abs_err=max(flash_err.values()), max_err=max(flash_err.values()),
        tol={"f32": FLASH_F32, "bf16": FLASH_BF16},
        ms=ms, kernel_ms=ms, plain_ms=plain, library_ms=lib,
        library="torch.nn.functional.scaled_dot_product_attention(attn_mask=bias)",
        bound_ms=b_ms, bound_us=b_ms * 1e3, bound_by=b_by))
    for b in (1, 8):
        _, a, bb = tome_case(b, False)
        ms = time_ms(torch, lambda: tome_mod.tome_scores(a, bb))
        plain = time_ms(torch, lambda: ref.tome_scores_ref(a, bb))
        lib = time_ms(torch, lambda: torch.bmm(a, bb.transpose(1, 2)).max(-1))
        flops = 2.0 * b * 289 * 288 * d
        nbytes = (a.numel() + bb.numel()) * 4 + b * 289 * 8
        b_ms, b_by = bound(flops, nbytes, PEAK_F32)
        print(f"[kernels] tome_scores B={b} f32 timing: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bmm+max {lib:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    rows.append(dict(
        name="tome_scores", route="cuda",
        source="src/repro_torch/kernels/csrc/tome_scores.cu",
        replaces="src/repro/kernels/tome_scores.py:49",
        max_abs_err=tome_err, max_err=tome_err,
        tol={"max": TOME_MAX, "argmax": "exact or equal score at the chosen index"},
        ms=ms, kernel_ms=ms, plain_ms=plain, library_ms=lib,
        library="torch.bmm(a, b.transpose(1, 2)).max(-1)",
        bound_ms=b_ms, bound_us=b_ms * 1e3, bound_by=b_by))
    return rows


# ------------------------------------------------------------------------ path

def _vit_l(torch, dtype):
    from repro_torch.configs import janus_vit_l384
    from repro_torch.models import param, vit
    cfg = dataclasses.replace(janus_vit_l384.CONFIG, dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = param.init_params(vit.specs(cfg), gen, "cuda")
    images = torch.randn((1, cfg.img_res, cfg.img_res, 3), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    return cfg, params, images


def _merge_layers(cfg, alpha) -> int:
    from repro_torch.core import pruning
    sched = pruning.make_schedule("exponential", alpha, cfg.n_layers, cfg.num_tokens)
    return sum(1 for r in sched if r > 0)


def path_phase(torch, cfg, params, images) -> dict[str, int]:
    from repro_torch.configs import janus_vit_l384
    from repro_torch.core import bandwidth, engine, pruning
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import tome_scores as tome_mod
    from repro_torch.launch.serve import make_profile

    def sync_now():
        torch.cuda.synchronize()
        return time.perf_counter()

    class TimedEngine(engine.JanusEngine):
        """JanusEngine recording each frame's wall ms of the device partition,
        the host wire step (quantize + LZW + decode, with its copies) and the
        cloud partition, each closed by a synchronize."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.frame_ms: list[dict] = []

        def _execute_device(self, dec, images):
            t0, self._host = sync_now(), 0.0
            out = super()._execute_device(dec, images)
            self.frame_ms.append({"device": (sync_now() - t0 - self._host) * 1e3,
                                  "host": self._host * 1e3, "cloud": 0.0})
            return out

        def _wire(self, x):
            t0 = sync_now()
            out = super()._wire(x)
            self._host += sync_now() - t0
            return out

        def finish_execution(self, plan):
            t0 = sync_now()
            super().finish_execution(plan)
            self.frame_ms[-1]["cloud"] = (sync_now() - t0) * 1e3

    print(f"[path] ViT-L@384 bf16: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{cfg.n_heads} heads, {cfg.num_tokens} tokens; f32 master weights on "
          f"{torch.cuda.get_device_name(0)}")
    eng = TimedEngine(make_profile(janus_vit_l384.CONFIG),
                      engine.EngineConfig(sla_s=0.3, execute=True,
                                          include_scheduler_overhead=False),
                      model_cfg=cfg, params=params, device="cuda")
    trace = bandwidth.synthetic_trace("4g", "driving", steps=6, seed=0)
    fixed = tuple(pruning.make_schedule("exponential", 0.5, cfg.n_layers, cfg.num_tokens))

    flash_mod.launches = tome_mod.launches = 0
    stats = eng.run_trace(trace, 6, images=images)
    t0 = sync_now()
    x, sizes = engine.device_forward(params, cfg, images, fixed, 12)
    t1 = sync_now()
    x, payload = engine.wire_roundtrip(x, cfg.dtype, quantize=True)
    t2 = sync_now()
    logits = engine.cloud_forward(params, cfg, x, sizes, fixed, 12)
    t3 = sync_now()
    counts = {"flash_attention": flash_mod.launches, "tome_scores": tome_mod.launches}

    for i, (f, ms) in enumerate(zip(stats.frames, eng.frame_ms)):
        print(f"[path] frame {i}: alpha={f.alpha:.2f} split={f.split} "
              f"payload_bytes={f.payload_bytes:.0f} device_ms={ms['device']:.2f} "
              f"host_ms={ms['host']:.2f} cloud_ms={ms['cloud']:.2f} "
              f"modelled_latency_ms={f.latency_s * 1e3:.1f}")
    print(f"[path] split_inference alpha=0.50 split=12 (tokens {cfg.num_tokens}->"
          f"{x.shape[1]}): payload_bytes={payload.nbytes} device_ms={(t1 - t0) * 1e3:.2f} "
          f"host_ms={(t2 - t1) * 1e3:.2f} cloud_ms={(t3 - t2) * 1e3:.2f}")
    for f in stats.frames:
        check(f.logits is not None and tuple(f.logits.shape) == (1, cfg.n_classes)
              and bool(torch.isfinite(f.logits.float()).all()), "non-finite path logits")
    check(bool(torch.isfinite(logits.float()).all()), "non-finite split_inference logits")
    exp_flash = cfg.n_layers * (len(stats.frames) + 1)
    exp_tome = sum(_merge_layers(cfg, f.alpha) for f in stats.frames) + _merge_layers(cfg, 0.5)
    print(f"[path] launches: flash_attention={counts['flash_attention']} "
          f"(schedule implies {exp_flash}), tome_scores={counts['tome_scores']} "
          f"(schedule implies {exp_tome}); plan cache traces={eng.plan_cache.traces_by_kind}")
    check(counts["flash_attention"] == exp_flash > 0, "flash_attention launch count")
    check(counts["tome_scores"] == exp_tome > 0, "tome_scores launch count")
    return counts


# ----------------------------------------------------------------------- batch

def batch_phase(torch, cfg, params, images) -> None:
    from repro_torch.configs import janus_vit_l384
    from repro_torch.core import engine, planner, pruning
    from repro_torch.core.bucketing import BucketingConfig, BucketTable
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import tome_scores as tome_mod
    from repro_torch.launch.serve import make_profile

    split = 18
    alphas = (0.05, 0.07, 0.09, 0.11, 0.13, 0.15, 0.17, 0.19)

    def plans():
        out = []
        for a in alphas:
            sched = tuple(pruning.make_schedule("exponential", a, cfg.n_layers, cfg.num_tokens))
            x, sizes = engine.device_forward(params, cfg, images, sched, split)
            out.append(engine.ExecPlan(sched, split, x=x, sizes=sizes))
        return out

    exact = plans()
    check(len({p.schedule[split:] for p in exact}) == 1
          and len({p.x.shape[1] for p in exact}) == len(alphas), "batch geometry precondition")
    grid = planner.tables_for(make_profile(janus_vit_l384.CONFIG)).alpha_grid
    table = BucketTable.build(cfg, grid, config=BucketingConfig(n_edges=2))
    c_exact, c_bucket = engine.CompiledPlanCache(), engine.CompiledPlanCache()
    # each stacked forward runs layers [split, N): one flash launch per layer
    # and one tome_scores launch per merge layer of the shared suffix
    per_forward = (cfg.n_layers - split, sum(1 for r in exact[0].schedule[split:] if r > 0))

    def check_launches(label, n_forwards):
        got = (flash_mod.launches, tome_mod.launches)
        exp = (per_forward[0] * n_forwards, per_forward[1] * n_forwards)
        print(f"[batch] {label} launches: flash_attention={got[0]}, tome_scores={got[1]} "
              f"({n_forwards} stacked forwards imply {exp[0]}, {exp[1]})")
        check(got == exp and exp[0] > 0 and exp[1] > 0, f"{label} cloud batch launch counts")

    flash_mod.launches = tome_mod.launches = 0
    t0 = time.perf_counter()
    engine.run_cloud_batch(c_exact, cfg, params, exact)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    check_launches("exact", len({(p.schedule, tuple(p.x.shape[1:])) for p in exact}))
    bucketed = plans()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    flash_mod.launches = tome_mod.launches = 0
    engine.run_cloud_batch(c_bucket, cfg, params, bucketed, buckets=table)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    check_launches("bucketed", len({table.edge_for(split, p.x.shape[1]) for p in bucketed}))
    err = max((p.logits.float() - q.logits.float()).abs().max().item()
              for p, q in zip(exact, bucketed))
    ok = all(torch.allclose(p.logits.float(), q.logits.float(), **BATCH_BF16)
             for p, q in zip(exact, bucketed))
    n_padded = c_bucket.traces_by_kind.get("cloud_padded", 0)
    edges = table.edges_by_split[split]
    print(f"[batch] split={split} alphas={alphas} tokens={[p.x.shape[1] for p in exact]} "
          f"edges={edges}: exact {c_exact.traces_by_kind} {(t1 - t0) * 1e3:.1f} ms, "
          f"bucketed {c_bucket.traces_by_kind} {(t3 - t2) * 1e3:.1f} ms, "
          f"max|bucketed-exact|={err:.3e} tol={BATCH_BF16} {'ok' if ok else 'FAIL'}")
    check(ok, "bucketed cloud batch disagrees with the exact one")
    check(n_padded <= len(edges), "cloud_padded traces exceed the edge count")


# ----------------------------------------------------------------------- trace

def trace_phase(torch, cfg, params, images) -> None:
    """Where a frame's device time goes: torch.profiler over one device
    partition (B=1, α=0.27, all 24 layers: the trace's usual decision) and
    one bucketed cloud batch of 8 at split 18. Prints the wall time, the sum
    of kernel time on the card, the idle share and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import engine, pruning

    sched27 = tuple(pruning.make_schedule("exponential", 0.27, cfg.n_layers, cfg.num_tokens))
    sched15 = tuple(pruning.make_schedule("exponential", 0.15, cfg.n_layers, cfg.num_tokens))
    x, sizes = engine.device_forward(params, cfg, images.expand(8, -1, -1, -1), sched15, 18)
    edge = 577
    xp, sp = engine._pad_tokens(x, sizes, edge)
    cache = engine.CompiledPlanCache()
    cloud = cache.cloud_padded_fn(cfg, sched15[18:], 18, xp)
    cases = {
        "device partition B=1": lambda: engine.device_forward(params, cfg, images, sched27,
                                                               cfg.n_layers),
        "cloud batch B=8 split 18 (padded)": lambda: cloud(params, xp, sp),
    }
    for label, fn in cases.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels: dict[str, list[float]] = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                kernels.setdefault(ev.name, []).append(ev.time_range.elapsed_us() / 1e3)
        busy_ms = sum(sum(v) for v in kernels.values())
        n = sum(len(v) for v in kernels.values())
        if n == 0:
            print(f"[trace] {label}: wall {wall_ms:.2f} ms; the profiler saw no kernel on "
                  "the card (device time not measured)")
            continue
        print(f"[trace] {label}: wall {wall_ms:.2f} ms, kernels on the card {busy_ms:.2f} ms "
              f"in {n} launches, idle share {1 - busy_ms / wall_ms:.3f}")
        top = sorted(kernels.items(), key=lambda kv: -sum(kv[1]))[:8]
        for name, ts in top:
            print(f"[trace]   {sum(ts):8.3f} ms {len(ts):5d}x  {name[:90]}")


# ---------------------------------------------------------------------- parity

def parity_phase(torch) -> None:
    from repro_torch.core import pruning, tome
    from repro_torch.kernels import ops
    from repro_torch.models import vit

    cfg, params, images = _vit_l(torch, torch.float32)
    alpha = 0.27  # the planner grid's largest α: merges at all 24 layers
    sched = tuple(pruning.make_schedule("exponential", alpha, cfg.n_layers, cfg.num_tokens))
    matching = tome.bipartite_soft_matching

    def forward_recording():
        """vit.forward_janus itself, with tome.bipartite_soft_matching wrapped
        to record each merge layer's indices and metric."""
        record = []

        def recording(metric, r, **kw):
            idx = matching(metric, r, **kw)
            record.append((idx, metric))
            return idx

        tome.bipartite_soft_matching = recording
        try:
            logits = vit.forward_janus(params, cfg, images, sched)
        finally:
            tome.bipartite_soft_matching = matching
        check(len(record) == sum(1 for r in sched if r > 0), "merge layers recorded")
        return logits, record

    t0 = time.perf_counter()
    logits_k, rec_k = forward_recording()
    with ops.plain_versions():
        logits_p, rec_p = forward_recording()
    torch.cuda.synchronize()
    flips = []
    merge_layers = [layer for layer, r in enumerate(sched) if r > 0]
    for layer, (ik, _), (ip, mp) in zip(merge_layers, rec_k, rec_p):
        if all(torch.equal(a, b) for a, b in zip(ik, ip)):
            continue
        # the plain path's similarity gap at the top-r boundary of this layer
        a, b = mp.float()[:, ::2], mp.float()[:, 1::2]
        a = a / (a.norm(dim=-1, keepdim=True) + 1e-6)
        b = b / (b.norm(dim=-1, keepdim=True) + 1e-6)
        node_max = torch.einsum("bnd,bmd->bnm", a, b).amax(-1)[:, 1:].sort(descending=True)
        r = sched[layer]
        gap = (node_max.values[:, r - 1] - node_max.values[:, r]).abs().min().item()
        flips.append((layer, gap))
        print(f"[parity] layer {layer}: merge indices differ (r={r}, boundary gap {gap:.3e})")
    err = (logits_k - logits_p).abs().max().item()
    ok = not flips and torch.allclose(logits_k, logits_p, **PARITY_F32)
    print(f"[parity] ViT-L@384 f32 alpha={alpha} schedule={list(sched)}: kernels vs plain "
          f"max|dlogits|={err:.3e} tol={PARITY_F32}, merge indices identical at "
          f"{len(merge_layers) - len(flips)}/{len(merge_layers)} merge layers, "
          f"{time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
    check(ok, "f32 whole-path parity failed")


if __name__ == "__main__":
    sys.exit(main())
