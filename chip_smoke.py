#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. It imports nothing of JAX or of the reference
package ``repro``; it puts ``src`` on ``sys.path`` itself. Phases, in order,
each failing the run on any failed check:

1. device:  the card's name and power limit (nvidia-smi) and torch's name;
2. build:   nvcc builds every kernel library from ``src/repro_torch/kernels/csrc``
            and prints each kernel's ptxas registers, spills and shared memory;
            the tensor-core kernels and tome_scores must not spill;
3. kernels: each kernel against its plain PyTorch version on the card at the
            main paths' shapes, and timed beside its plain version, one
            library call computing the same function, and its bound. Flash
            attention has two kernels, chosen by (dtype, head dim): the
            tensor-core one (bf16 at D 64 and 128) and the CUDA-core one (f32,
            and bf16 at D 16 and 32); both are timed at ViT B=1, ViT B=8 and
            the LM prefill shape, the CUDA-core one also in bf16 beside the
            tensor-core one. tome_scores at B=1 and B=8. decode_attention has
            two kernels too, chosen by dtype: the tensor-core one (bf16) and
            the CUDA-core one (f32), both timed at the LM decode shape and two
            longer caches, the CUDA-core one also in bf16 beside the
            tensor-core one, and the tensor-core one also with the L2 flushed
            before each call. tome_scores and decode_attention are timed with
            the calls queued behind a sleep kernel (the card's time per call,
            the host's per-call overhead hidden) and back to back as queued
            by the host;
4. path:    ViT-L@384 bf16 (random weights from a seeded generator) serves a
            6-frame 4G-driving trace through ``JanusEngine(execute=True)`` and
            one split inference at α=0.5, mid split; the kernels' launch
            counters are zeroed just before and read just after, and every
            flash launch must be the tensor-core kernel's (168);
5. batch:   ``run_cloud_batch`` on 8 mixed-α plans at a shared split, exact
            and bucketed, which must agree; the launch counters are zeroed
            before each and must show the counts the stacked forwards imply;
   trace:   torch.profiler over one device partition and one cloud batch:
            kernel time on the card, idle share, top kernels;
6. parity:  ViT-L@384 in f32, ``vit.forward_janus`` through the kernels
            (flash on the CUDA-core kernel, counted) against the plain path
            on the card: logits within tolerance and identical merge indices
            per merge layer;
7. lm:      starcoder2-3b bf16 at full width and depth (random weights from
            a seeded generator) serves 8 prompts of 1024 tokens through
            ``lm.prefill`` and 64 greedy ``lm.decode_step``s on a cache of
            capacity 2048; the launch counters are zeroed just before and
            read just after (flash 30 and decode 1920, all on the tensor-core
            kernels, tome_scores 0);
   lm trace: torch.profiler over one decode step and over the prefill;
8. lm parity: starcoder2-3b in f32, prefill of 2 x 256 tokens and 8
            teacher-forced decode steps through the kernels (counted: flash 30
            and decode 240, all on the CUDA-core kernels) against the plain
            versions on the card: logits within tolerance at every step.

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``. Without a card, or outside a checkout, it
exits nonzero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import re
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
DECODE_F32 = dict(atol=2e-5, rtol=1e-4)  # tests/test_kernels.py:113
DECODE_BF16 = dict(atol=2e-2, rtol=0.0)  # f32 math on both sides, one rounding of the output
BATCH_BF16 = dict(atol=0.1, rtol=0.05)  # bucketed vs exact logits, bf16, 6 layers
PARITY_F32 = dict(atol=1e-3, rtol=1e-3)  # kernels vs plain, f32 whole paths (ViT 24, LM 30 layers)


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
        for line in ptxas_summary(_build.build_log(name)):
            print(f"[build] {name}: {line}")
    # instantiations: flash_mma D 64/128; tome D 16/32/64/128; decode_mma the
    # split and combine passes at D 64/128
    for name, n_lines in (("flash_attention_mma", 2), ("tome_scores", 4),
                          ("decode_attention_mma", 4)):
        lines = ptxas_summary(_build.build_log(name))
        check(len(lines) == n_lines and all(" 0 B spill stores, 0 B spill loads" in line
                                            for line in lines),
              f"{name} spills (or ptxas printed another number of lines for it)")

    from repro_torch.runtime.device import parity_numerics
    parity_numerics()  # f32 plain versions and f32 phases must not use TF32
    rows = kernel_phase(torch) + decode_kernel_phase(torch)
    model = _vit_l(torch, torch.bfloat16)
    paths = {"vit": path_phase(torch, *model), "vit_batch": batch_phase(torch, *model)}
    trace_phase(torch, *model)
    del model
    paths["vit_f32_parity"] = parity_phase(torch)
    torch.cuda.empty_cache()
    paths["lm"] = lm_phase(torch)
    torch.cuda.empty_cache()
    paths["lm_f32_parity"] = lm_parity_phase(torch)

    for row in rows:
        name = row["name"]
        row["path_launches"] = {path: counts[name] for path, counts in paths.items()}
        row["launches"] = sum(row["path_launches"].values())
        check(row["launches"] > 0, f"{name} was launched on no path")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel instantiation of nvcc's -Xptxas -v output:
    ``name<type,D>: registers, spill stores/loads, shared memory``."""
    out, name, spill = [], "?", (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d+([a-z_]+_kernel)I(\w*?)EEv", line)
        if m:
            args = re.sub(r"^f", "f32,", m.group(2).replace("13__nv_bfloat16", "bf16,"))
            args = re.sub(r"Li(\d+)E?", r"\1,", args).rstrip(",")
            name = f"{m.group(1)}<{args}>"
        elif "spill stores" in line:
            spill = tuple(int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {regs} registers, {spill[0]} B spill stores, {spill[1]} B "
                       f"spill loads, {smem.group(1) if smem else 0} B smem")
    return out


def zero_counts() -> None:
    from repro_torch.kernels import decode_attention, flash_attention, tome_scores
    for mod in (decode_attention, flash_attention, tome_scores):
        mod.launches = 0
    flash_attention.launches_mma = decode_attention.launches_mma = 0


def read_counts() -> dict[str, int]:
    """Launches per kernel since ``zero_counts``; the flash and decode
    wrappers' totals split into their tensor-core and CUDA-core kernels."""
    from repro_torch.kernels import decode_attention, flash_attention, tome_scores
    return {"flash_attention_mma": flash_attention.launches_mma,
            "flash_attention": flash_attention.launches - flash_attention.launches_mma,
            "tome_scores": tome_scores.launches,
            "decode_attention_mma": decode_attention.launches_mma,
            "decode_attention": decode_attention.launches - decode_attention.launches_mma}


def time_ms(torch, fn, iters: int = 30, queued: bool = False) -> float:
    """Mean ms per call over ``iters`` back-to-back calls, CUDA events.

    With ``queued`` the calls are enqueued behind a sleep kernel that
    outlasts the host's enqueueing, so the events time the card alone: the
    host's per-call overhead (Python, allocation, the launch) is hidden. If
    the sleep ended before the host had enqueued every call, it is doubled
    and the run repeated."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000  # ~10 ms at the H100's clock
    for _ in range(6):
        if queued:
            torch.cuda._sleep(cycles)
            slept = torch.cuda.Event()
            slept.record()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        if not queued or not slept.query():  # the card was still asleep: all queued
            end.synchronize()
            return start.elapsed_time(end) / iters
        end.synchronize()
        cycles *= 2
    fail("time_ms: the host could not queue the calls within the sleep")


def device_us(torch, fn, iters: int = 20) -> dict[str, float]:
    """Mean µs on the card per launch of each kernel that ``fn`` launches
    (the port's by their names, others by a prefix), by torch.profiler over
    ``iters`` calls after one warm call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times: dict[str, list[float]] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            m = PORT_KERNEL.search(ev.name)
            times.setdefault(m.group(0) if m else ev.name[:40], []).append(
                ev.time_range.elapsed_us())
    return {name: sum(ts) / len(ts) for name, ts in times.items()}


def fmt_us(times: dict[str, float]) -> str:
    return ", ".join(f"{name} {us:.2f} us" for name, us in times.items())


def time_cold_ms(torch, fn, iters: int = 20, flush_mb: int = 256) -> float:
    """Mean ms per call with the L2 cache flushed before each call: a
    ``flush_mb`` MB buffer is written outside the timed events (that write
    also outlasts the host's enqueueing of the call)."""
    buf = torch.empty(flush_mb << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        buf.fill_(1)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def cuda_core_flash(torch, flash_mod, q, k, v, bias, causal):
    """The CUDA-core flash kernel on a bf16 call that ``kernel_for`` routes to
    the tensor-core one: its C entry called directly, for a side-by-side time
    in one run (not counted; never on a path)."""
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    err = flash_mod._fn(flash_mod.CUDA_CORE)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
        None, out.data_ptr(), b, h, sq, k.shape[2], d, 1, int(causal),
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"CUDA-core flash kernel launch failed: cudaError {err}")
    return out


def cuda_core_decode(torch, decode_mod, q, k, v, lengths):
    """The CUDA-core decode kernel on a bf16 call that ``kernel_for`` routes
    to the tensor-core one, with its own split count: its C entry called
    directly, for a side-by-side time in one run (not counted; never on a
    path)."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    nsplit = decode_mod.n_splits(b, hq, hkv, s, decode_mod.CUDA_CORE)
    rows = b * hq * nsplit
    part = torch.empty(rows * (d + 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    err = decode_mod._fn(decode_mod.CUDA_CORE)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), part.data_ptr(),
        part.data_ptr() + rows * d * 4, part.data_ptr() + rows * (d + 1) * 4, out.data_ptr(),
        b, hq, hkv, s, d, nsplit, 1, torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"CUDA-core decode kernel launch failed: cudaError {err}")
    return out


# --------------------------------------------------------------------- kernels

def kernel_phase(torch) -> list[dict]:
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import tome_scores as tome_mod

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    h, s, d = 16, 577, 64
    flash_err = {flash_mod.MMA: 0.0, flash_mod.CUDA_CORE: 0.0}

    def flash_inputs(b, dtype, sq=s, sk=s, pads=0, h=h, d=d):
        q = torch.randn((b, h, sq, d), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((b, h, sk, d), generator=gen, device=dev).to(dtype) for _ in "kv")
        sizes = torch.randint(1, 5, (b, sk), generator=gen, device=dev).float()
        if pads:
            sizes[:, sk - pads:] = 0.0  # bucket pads: log(0) = -inf
        return q, k, v, torch.log(sizes)

    def flash_case(label, b, dtype, sq=s, sk=s, pads=0, kv=False, causal=False, h=h, d=d,
                   with_bias=True):
        q, k, v, bias = flash_inputs(b, dtype, sq, sk, pads, h, d)
        kv_len = None
        if kv:  # random lengths, the first member fully masked
            kv_len = torch.randint(sk // 2, sk + 1, (b,), generator=gen, device=dev,
                                   dtype=torch.int32)
            kv_len[0] = 0
        kw = dict(bias=bias if with_bias else None, kv_len=kv_len, causal=causal)
        kernel = flash_mod.kernel_for(dtype, d)
        before = flash_mod.launches_mma
        out = flash_mod.flash_attention(q, k, v, **kw)
        exp = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        check((flash_mod.launches_mma - before) == (kernel == flash_mod.MMA),
              f"flash_attention {label} ran on another kernel than {kernel}")
        tol = FLASH_F32 if dtype == torch.float32 else FLASH_BF16
        err = (out.float() - exp.float()).abs().max().item()
        flash_err[kernel] = max(flash_err[kernel], err)
        ok = bool(torch.isfinite(out).all()) and torch.allclose(out.float(), exp.float(), **tol)
        if kv:
            ok = ok and bool(torch.all(out[0] == 0))
        print(f"[kernels] {kernel} {label}: B={b} H={h} Sq={sq} Sk={sk} D={d} "
              f"{str(dtype)[6:]} max_abs_err={err:.3e} tol={tol} {'ok' if ok else 'FAIL'}")
        check(ok, f"flash_attention {label} disagrees with its plain version")

    for b in (1, 8):
        for dtype in (torch.bfloat16, torch.float32):
            flash_case("prop-attn bias", b, dtype)
    flash_case("bucket pads (-inf bias)", 8, torch.bfloat16, sq=592, sk=592, pads=15)
    for dtype in (torch.bfloat16, torch.float32):
        flash_case("kv_len, one member 0", 8, dtype, kv=True)
        flash_case("causal Sq<Sk", 2, dtype, sq=300, sk=577, causal=True)
        flash_case("causal Sq>Sk", 2, dtype, sq=577, sk=300, causal=True)
        flash_case("ragged Sq=577 Sk=7", 2, dtype, sq=577, sk=7, pads=2)
        flash_case("ragged Sq=7 Sk=200 D=128", 2, dtype, sq=7, sk=200, h=4, d=128, kv=True)
        # starcoder2-3b prefill: 24 heads of 128
        flash_case("LM prefill causal", 8, dtype, sq=1024, sk=1024, causal=True, h=24, d=128,
                   with_bias=False)
    flash_case("small head dim", 2, torch.bfloat16, h=4, d=32)

    # timings at the paths' calls: a ViT frame (B=1) and the cloud batch of 8
    # frames, with the bias; the LM prefill, causal
    def flash_timings(kernel, dtype) -> list[dict]:
        out = []
        for label, b, hh, ss, dd, causal in (("ViT B=1", 1, h, s, d, False),
                                             ("ViT B=8", 8, h, s, d, False),
                                             ("LM prefill", 8, 24, 1024, 128, True)):
            q, k, v, bias = flash_inputs(b, dtype, ss, ss, 0, hh, dd)
            bias = None if causal else bias
            check(flash_mod.kernel_for(dtype, dd) == kernel, f"{kernel} timing route")
            iters = 10 if causal else 30
            ms = time_ms(torch, lambda: flash_mod.flash_attention(q, k, v, bias=bias,
                                                                  causal=causal), iters)
            plain = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, bias=bias,
                                                                   causal=causal), iters)
            mask = None if bias is None else bias[:, None, None, :].to(q.dtype)
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal), iters)
            # causal: S * (S + 1) / 2 (query, key) pairs of 4 * D flops
            pairs = ss * (ss + 1) / 2 if causal else ss * ss
            nbytes = 4 * q.numel() * q.element_size() + (0 if bias is None else bias.numel() * 4)
            b_ms, b_by = bound(4.0 * b * hh * dd * pairs, nbytes,
                               PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
            row = dict(shape=f"{label}: q,k,v [{b},{hh},{ss},{dd}] {str(dtype)[6:]}"
                             + (", causal" if causal else f", bias [{b},{ss}]"),
                       ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by)
            extra = ""
            if kernel == flash_mod.MMA:  # the CUDA-core kernel on the same bf16 call
                row["cuda_core_ms"] = time_ms(torch, lambda: cuda_core_flash(
                    torch, flash_mod, q, k, v, bias, causal), 10)
                extra = f", CUDA-core kernel {row['cuda_core_ms']:.4f} ms"
            print(f"[kernels] {kernel} {row['shape']} timing: kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, sdpa {lib:.4f} ms ({ms / lib:.2f}x), bound {b_ms:.4f} ms "
                  f"({b_by}){extra}")
            out.append(row)
            del q, k, v, bias, mask
        return out

    rows = []
    for kernel, dtype, source in ((flash_mod.MMA, torch.bfloat16, "flash_attention_mma.cu"),
                                  (flash_mod.CUDA_CORE, torch.float32, "flash_attention.cu")):
        timings = flash_timings(kernel, dtype)
        vit8 = timings[1]
        rows.append(dict(
            name=kernel, route="cuda", source=f"src/repro_torch/kernels/csrc/{source}",
            replaces="src/repro/kernels/flash_attention.py:90",
            serves="bf16 at D 64, 128" if kernel == flash_mod.MMA
            else "f32 at D 16-128, bf16 at D 16, 32",
            max_abs_err=flash_err[kernel], max_err=flash_err[kernel],
            tol={"f32": FLASH_F32, "bf16": FLASH_BF16},
            ms=vit8["ms"], kernel_ms=vit8["ms"], plain_ms=vit8["plain_ms"],
            library_ms=vit8["library_ms"],
            library="torch.nn.functional.scaled_dot_product_attention (attn_mask=bias, or "
                    "is_causal=True)",
            bound_ms=vit8["bound_ms"], bound_us=vit8["bound_ms"] * 1e3,
            bound_by=vit8["bound_by"], shape=vit8["shape"], timings=timings))

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

    one = torch.zeros(1, device=dev)
    floor = time_ms(torch, lambda: one.add_(1), queued=True)
    print(f"[kernels] launch floor: a 1-element add, queued: {floor:.4f} ms")
    tome_timings = []
    for b in (1, 8):
        _, a, bb = tome_case(b, False)

        def kernel():
            return tome_mod.tome_scores(a, bb)

        def library():
            return torch.bmm(a, bb.transpose(1, 2)).max(-1)

        ms, lib = time_ms(torch, kernel, queued=True), time_ms(torch, library, queued=True)
        plain = time_ms(torch, lambda: ref.tome_scores_ref(a, bb), queued=True)
        eager, lib_eager = time_ms(torch, kernel), time_ms(torch, library)
        dev_us, lib_us = device_us(torch, kernel), device_us(torch, library)
        b1 = bb[:, :1].contiguous()  # one column: what a call costs beside its FMAs
        fixed_us = device_us(torch, lambda: tome_mod.tome_scores(a, b1))
        flops = 2.0 * b * 289 * 288 * d
        nbytes = (a.numel() + bb.numel()) * 4 + b * 289 * 8
        b_ms, b_by = bound(flops, nbytes, PEAK_F32)
        print(f"[kernels] tome_scores B={b} Na=289 Nb=288 D={d} f32 timing, queued: kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, bmm+max {lib:.4f} ms ({ms / lib:.2f}x), "
              f"bound {b_ms:.6f} ms ({b_by}); back to back from the host: kernel {eager:.4f} "
              f"ms, bmm+max {lib_eager:.4f} ms; on the card per launch (profiler): "
              f"{fmt_us(dev_us)}; with Nb=1 {fmt_us(fixed_us)}; bmm+max {fmt_us(lib_us)}")
        tome_timings.append(dict(shape=f"a [{b},289,{d}], b [{b},288,{d}] f32", ms=ms,
                                 plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                                 host_ms=eager, library_host_ms=lib_eager, device_us=dev_us,
                                 nb1_device_us=fixed_us, library_device_us=lib_us))
    b8 = tome_timings[1]
    rows.append(dict(
        name="tome_scores", route="cuda",
        source="src/repro_torch/kernels/csrc/tome_scores.cu",
        replaces="src/repro/kernels/tome_scores.py:49",
        max_abs_err=tome_err, max_err=tome_err,
        tol={"max": TOME_MAX, "argmax": "exact or equal score at the chosen index"},
        ms=b8["ms"], kernel_ms=b8["ms"], plain_ms=b8["plain_ms"], library_ms=b8["library_ms"],
        library="torch.bmm(a, b.transpose(1, 2)).max(-1)", timing="queued",
        bound_ms=b8["bound_ms"], bound_us=b8["bound_ms"] * 1e3, bound_by=b8["bound_by"],
        shape=b8["shape"], timings=tome_timings))
    return rows


def decode_kernel_phase(torch) -> list[dict]:
    """decode_attention's two kernels against the plain version (lengths 1,
    ragged inside a tile, full; group 12 as starcoder2-3b and 2 as internlm2;
    D 64 and 128): bf16 on the tensor-core kernel, f32 on the CUDA-core one.
    Then each timed at the LM path's last decode step and at two longer
    caches, beside the plain version and SDPA with a length mask; the
    tensor-core one also beside the CUDA-core kernel on the same bf16 call
    and, at the path's shape, with the L2 flushed before each call."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as decode_mod
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    err_max = {decode_mod.MMA: 0.0, decode_mod.CUDA_CORE: 0.0}

    def inputs(b, hq, hkv, s, d, dtype):
        q = torch.randn((b, hq, d), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype) for _ in "kv")
        return q, k, v

    def checked(q, k, v, lengths, label):
        kernel = decode_mod.kernel_for(q.dtype, q.shape[-1])
        before = decode_mod.launches_mma
        out = decode_mod.decode_attention(q, k, v, lengths)
        exp = ref.decode_attention_ref(q, k, v, lengths)
        torch.cuda.synchronize()
        check((decode_mod.launches_mma - before) == (kernel == decode_mod.MMA),
              f"decode_attention {label} ran on another kernel than {kernel}")
        tol = DECODE_F32 if q.dtype == torch.float32 else DECODE_BF16
        err = (out.float() - exp.float()).abs().max().item()
        err_max[kernel] = max(err_max[kernel], err)
        ok = bool(torch.isfinite(out).all()) and torch.allclose(out.float(), exp.float(), **tol)
        print(f"[kernels] {kernel} {label}: max_abs_err={err:.3e} tol={tol} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{kernel} disagrees with its plain version ({label})")
        return kernel, exp

    s = 1500
    lengths = torch.tensor([1, 1061, s], dtype=torch.int32, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        for hq, hkv in ((24, 2), (16, 8)):
            for d in (64, 128):
                q, k, v = inputs(3, hq, hkv, s, d, dtype)
                checked(q, k, v, lengths, f"B=3 Hq={hq} Hkv={hkv} S={s} D={d} "
                                          f"{str(dtype)[6:]} lengths={lengths.tolist()}")

    timings = {decode_mod.MMA: [], decode_mod.CUDA_CORE: []}
    for b, s, n in ((8, 2048, 1088), (8, 8192, 8192), (1, 32768, 32768)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = inputs(b, 24, 2, s, 128, dtype)
            lens = torch.full((b,), n, dtype=torch.int32, device=dev)
            shape = f"q [{b},24,128], k/v [{b},{s},2,128] {str(dtype)[6:]}, length {n}"
            kernel, exp = checked(q, k, v, lens, shape)
            kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))  # [B, Hkv, S, D]
            mask = (torch.arange(s, device=dev) < lens[:, None])[:, None, None, :]

            def wrapper():
                return decode_mod.decode_attention(q, k, v, lens)

            def library():
                return F.scaled_dot_product_attention(q[:, :, None], kt, vt, attn_mask=mask,
                                                      enable_gqa=True)

            lib_err = (library()[:, :, 0].float() - exp.float()).abs().max().item()
            ms, lib = time_ms(torch, wrapper, queued=True), time_ms(torch, library, queued=True)
            plain = time_ms(torch, lambda: ref.decode_attention_ref(q, k, v, lens), queued=True)
            row = dict(shape=shape, ms=ms, plain_ms=plain, library_ms=lib,
                       host_ms=time_ms(torch, wrapper), library_host_ms=time_ms(torch, library),
                       device_us=device_us(torch, wrapper))
            # the valid cache read once, q read and the output written once
            nbytes = (2 * b * n * 2 * 128 + 2 * q.numel()) * q.element_size() + b * 4
            row["bound_ms"], row["bound_by"] = bound(
                4.0 * b * 24 * n * 128, nbytes,
                PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
            extra = ""
            if kernel == decode_mod.MMA:  # the CUDA-core kernel on the same bf16 call
                row["cuda_core_ms"] = time_ms(torch, lambda: cuda_core_decode(
                    torch, decode_mod, q, k, v, lens), queued=True)
                extra = f", CUDA-core kernel {row['cuda_core_ms']:.4f} ms"
                if s == LM_CAPACITY:
                    row["cold_l2_ms"] = time_cold_ms(torch, wrapper)
                    row["cuda_core_cold_l2_ms"] = time_cold_ms(torch, lambda: cuda_core_decode(
                        torch, decode_mod, q, k, v, lens))
                    extra += (f"; L2 flushed before each call: kernel {row['cold_l2_ms']:.4f} "
                              f"ms, CUDA-core kernel {row['cuda_core_cold_l2_ms']:.4f} ms")
            print(f"[kernels] {kernel} {shape} timing, queued: kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, sdpa(enable_gqa, mask) {lib:.4f} ms ({ms / lib:.2f}x; "
                  f"max|sdpa-plain|={lib_err:.2e}), bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}, {nbytes / 1e6:.1f} MB), splits "
                  f"{decode_mod.n_splits(b, 24, 2, s, kernel)}{extra}; back to back from the "
                  f"host: kernel {row['host_ms']:.4f} ms, sdpa {row['library_host_ms']:.4f} ms; "
                  f"on the card per launch (profiler): {fmt_us(row['device_us'])}")
            timings[kernel].append(row)
            del q, k, v, kt, vt
    rows = []
    for kernel, source, serves in (
            (decode_mod.MMA, "decode_attention_mma.cu", "bf16 at D 64, 128"),
            (decode_mod.CUDA_CORE, "decode_attention.cu", "f32 at D 64, 128")):
        path = timings[kernel][0]
        rows.append(dict(
            name=kernel, route="cuda", source=f"src/repro_torch/kernels/csrc/{source}",
            replaces="src/repro/kernels/decode_attention.py:66", serves=serves,
            max_abs_err=err_max[kernel], max_err=err_max[kernel],
            tol={"f32": DECODE_F32, "bf16": DECODE_BF16},
            ms=path["ms"], kernel_ms=path["ms"], plain_ms=path["plain_ms"],
            library_ms=path["library_ms"],
            library="torch.nn.functional.scaled_dot_product_attention(enable_gqa=True, "
                    "attn_mask=length mask)", timing="queued",
            bound_ms=path["bound_ms"], bound_us=path["bound_ms"] * 1e3,
            bound_by=path["bound_by"], shape=path["shape"], timings=timings[kernel]))
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

    zero_counts()
    stats = eng.run_trace(trace, 6, images=images)
    t0 = sync_now()
    x, sizes = engine.device_forward(params, cfg, images, fixed, 12)
    t1 = sync_now()
    x, payload = engine.wire_roundtrip(x, cfg.dtype, quantize=True)
    t2 = sync_now()
    logits = engine.cloud_forward(params, cfg, x, sizes, fixed, 12)
    t3 = sync_now()
    counts = read_counts()

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
    print(f"[path] launches: flash_attention_mma={counts['flash_attention_mma']}, CUDA-core "
          f"flash_attention={counts['flash_attention']} (schedule implies {exp_flash} bf16 "
          f"calls, all tensor-core), tome_scores={counts['tome_scores']} (schedule implies "
          f"{exp_tome}), decode_attention(_mma)={counts['decode_attention']}/"
          f"{counts['decode_attention_mma']}; plan cache traces={eng.plan_cache.traces_by_kind}")
    check(counts["flash_attention_mma"] == exp_flash > 0, "flash_attention_mma launch count")
    check(counts["flash_attention"] == 0, "the bf16 ViT path launched the CUDA-core flash kernel")
    check(counts["tome_scores"] == exp_tome > 0, "tome_scores launch count")
    check(counts["decode_attention"] == counts["decode_attention_mma"] == 0,
          "the ViT path launched decode_attention")
    return counts


# ----------------------------------------------------------------------- batch

def batch_phase(torch, cfg, params, images) -> dict[str, int]:
    from repro_torch.configs import janus_vit_l384
    from repro_torch.core import engine, planner, pruning
    from repro_torch.core.bucketing import BucketingConfig, BucketTable
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
        got = read_counts()
        exp = (per_forward[0] * n_forwards, per_forward[1] * n_forwards)
        print(f"[batch] {label} launches: flash_attention_mma={got['flash_attention_mma']}, "
              f"CUDA-core flash_attention={got['flash_attention']}, tome_scores="
              f"{got['tome_scores']} ({n_forwards} stacked forwards imply {exp[0]} bf16 flash "
              f"calls, all tensor-core, and {exp[1]})")
        check((got["flash_attention_mma"], got["tome_scores"]) == exp and exp[0] > 0
              and exp[1] > 0 and got["flash_attention"] == got["decode_attention"] == 0
              and got["decode_attention_mma"] == 0,
              f"{label} cloud batch launch counts")
        return got

    zero_counts()
    t0 = time.perf_counter()
    engine.run_cloud_batch(c_exact, cfg, params, exact)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts = check_launches("exact", len({(p.schedule, tuple(p.x.shape[1:])) for p in exact}))
    bucketed = plans()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    zero_counts()
    engine.run_cloud_batch(c_bucket, cfg, params, bucketed, buckets=table)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    bucket_counts = check_launches("bucketed",
                                   len({table.edge_for(split, p.x.shape[1]) for p in bucketed}))
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
    return {name: counts[name] + bucket_counts[name] for name in counts}


# ----------------------------------------------------------------------- trace

def trace_phase(torch, cfg, params, images) -> None:
    """Where a frame's device time goes: torch.profiler over one device
    partition (B=1, α=0.27, all 24 layers: the trace's usual decision) and
    one bucketed cloud batch of 8 at split 18."""
    from repro_torch.core import engine, pruning

    sched27 = tuple(pruning.make_schedule("exponential", 0.27, cfg.n_layers, cfg.num_tokens))
    sched15 = tuple(pruning.make_schedule("exponential", 0.15, cfg.n_layers, cfg.num_tokens))
    x, sizes = engine.device_forward(params, cfg, images.expand(8, -1, -1, -1), sched15, 18)
    edge = 577
    xp, sp = engine._pad_tokens(x, sizes, edge)
    cache = engine.CompiledPlanCache()
    cloud = cache.cloud_padded_fn(cfg, sched15[18:], 18, xp)
    profile_once(torch, "device partition B=1",
                 lambda: engine.device_forward(params, cfg, images, sched27, cfg.n_layers))
    profile_once(torch, "cloud batch B=8 split 18 (padded)", lambda: cloud(params, xp, sp))


PORT_KERNEL = re.compile(r"\b(flash_mma_fwd|flash_fwd|tome_scores|decode_mma_partial|"
                         r"decode_mma_combine|decode_partial|decode_combine)_kernel\b")


def profile_once(torch, label: str, fn) -> None:
    """torch.profiler over one call of ``fn`` after one warm call: prints the
    wall time, the sum of kernel time on the card, the idle share, the top 8
    kernels and every other kernel of the port as ``[trace]`` lines."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
        return
    print(f"[trace] {label}: wall {wall_ms:.2f} ms, kernels on the card {busy_ms:.2f} ms "
          f"in {n} launches, idle share {1 - busy_ms / wall_ms:.3f}")
    ranked = sorted(kernels.items(), key=lambda kv: -sum(kv[1]))
    for i, (name, ts) in enumerate(ranked):  # the top 8, then the port's own kernels
        if i < 8 or PORT_KERNEL.search(name):
            print(f"[trace]   {sum(ts):8.3f} ms {len(ts):5d}x  {name[:90]}")


# ---------------------------------------------------------------------- parity

def parity_phase(torch) -> dict[str, int]:
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
    zero_counts()
    logits_k, rec_k = forward_recording()
    counts = read_counts()
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
    n_merge = len(merge_layers)
    print(f"[parity] launches of the kernel run: {counts} (implies CUDA-core flash "
          f"{cfg.n_layers}, tome_scores {n_merge})")
    check(ok, "f32 whole-path parity failed")
    check(counts == {"flash_attention_mma": 0, "flash_attention": cfg.n_layers,
                     "tome_scores": n_merge, "decode_attention_mma": 0, "decode_attention": 0},
          "f32 ViT launch counts")
    return counts


# -------------------------------------------------------------------------- lm

LM_BATCH, LM_PROMPT, LM_STEPS, LM_CAPACITY = 8, 1024, 64, 2048


def _starcoder2(torch, dtype):
    from repro_torch.configs import starcoder2_3b
    from repro_torch.models import lm, param
    cfg = dataclasses.replace(starcoder2_3b.CONFIG, dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return cfg, param.init_params(lm.specs(cfg), gen, "cuda", dtype=dtype)


def lm_phase(torch) -> dict[str, int]:
    """starcoder2-3b bf16 serving: prefill of 8 x 1024 random tokens into a
    cache of capacity 2048, then 64 greedy decode steps, each closed by a
    synchronize; the launch counters are zeroed just before and read just
    after. Then torch.profiler over one decode step and over the prefill."""
    from repro_torch.models import lm, param

    cfg, params = _starcoder2(torch, torch.bfloat16)
    weights_gb = sum(t.numel() * t.element_size() for t in param.flatten(params).values()) / 1e9
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), dtype=torch.int32, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    print(f"[lm] starcoder2-3b bf16: {cfg.n_layers} layers, d={cfg.d_model}, {cfg.n_heads} q "
          f"heads over {cfg.n_kv} kv heads of {cfg.hd}, d_ff={cfg.d_ff}, vocab={cfg.vocab}; "
          f"weights {weights_gb:.3f} GB on {torch.cuda.get_device_name(0)}")
    # warm-up outside the counted run: cuBLAS handles, allocator, kernel libraries
    logits, cache = lm.prefill(params, cfg, tokens[:, :64], max_len=128)
    lm.decode_step(params, cfg, logits.argmax(-1).int(), cache, 64)
    del logits, cache
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    t0 = time.perf_counter()
    logits, cache = lm.prefill(params, cfg, tokens, max_len=LM_CAPACITY)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = logits[:, -1].argmax(-1, keepdim=True).int()
    finite, step_ms = [torch.isfinite(logits).all()], []
    for i in range(LM_STEPS):
        t0 = time.perf_counter()
        logits, cache = lm.decode_step(params, cfg, tok, cache, LM_PROMPT + i)
        tok = logits[:, -1].argmax(-1, keepdim=True).int()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        finite.append(torch.isfinite(logits).all())
    counts = read_counts()

    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = sorted(step_ms)
    print(f"[lm] prefill B={LM_BATCH} x {LM_PROMPT} tokens into a cache of {LM_CAPACITY} "
          f"({cache['k'].numel() * 2 * cache['k'].element_size() / 1e6:.0f} MB): "
          f"{prefill_ms:.2f} ms ({LM_BATCH * LM_PROMPT / prefill_ms * 1e3:.0f} prompt tokens/s)")
    print(f"[lm] decode {LM_STEPS} greedy steps of B={LM_BATCH} (cache length "
          f"{LM_PROMPT + 1}..{LM_PROMPT + LM_STEPS}): per step median "
          f"{steps[len(steps) // 2]:.2f} ms, max {steps[-1]:.2f} ms, first {step_ms[0]:.2f} ms; "
          f"{LM_BATCH * LM_STEPS / sum(step_ms) * 1e3:.1f} generated tokens/s")
    print(f"[lm] weights {weights_gb:.3f} GB, max_memory_allocated {peak_gb:.3f} GB")
    exp = {"flash_attention_mma": cfg.n_layers, "flash_attention": 0,
           "decode_attention_mma": cfg.n_layers * LM_STEPS, "decode_attention": 0,
           "tome_scores": 0}
    print(f"[lm] launches: {counts} (prefill and {LM_STEPS} steps imply {exp})")
    check(tuple(logits.shape) == (LM_BATCH, 1, cfg.vocab), "decode logits shape")
    check(bool(torch.stack(finite).all()), "non-finite LM logits")
    check(counts == exp, "LM path launch counts")

    profile_once(torch, f"lm decode step B={LM_BATCH} at cache length {LM_PROMPT + LM_STEPS + 1}",
                 lambda: lm.decode_step(params, cfg, tok, cache, LM_PROMPT + LM_STEPS))
    del cache
    profile_once(torch, f"lm prefill B={LM_BATCH} x {LM_PROMPT} tokens",
                 lambda: lm.prefill(params, cfg, tokens, max_len=LM_CAPACITY))
    return counts


def lm_parity_phase(torch) -> dict[str, int]:
    """starcoder2-3b in f32 on the card, through the kernels against the
    plain versions: prefill of 2 x 256 tokens, then 8 teacher-forced decode
    steps (both runs get the same tokens, so a near-tie cannot make them
    diverge). Logits must agree at every step."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    cfg, params = _starcoder2(torch, torch.float32)
    prompt, steps = 256, 8
    tokens = torch.randint(0, cfg.vocab, (2, prompt + steps), dtype=torch.int32, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(2))

    def run():
        logits, cache = lm.prefill(params, cfg, tokens[:, :prompt], max_len=prompt + steps)
        out = [logits]
        for i in range(steps):
            logits, cache = lm.decode_step(params, cfg, tokens[:, prompt + i:prompt + i + 1],
                                           cache, prompt + i)
            out.append(logits)
        return out, cache

    t0 = time.perf_counter()
    zero_counts()
    lk, ck = run()
    counts = read_counts()
    with ops.plain_versions():
        lp, cp = run()
    torch.cuda.synchronize()
    errs = [(a - b).abs().max().item() for a, b in zip(lk, lp)]
    cache_err = max((ck[n] - cp[n]).abs().max().item() for n in "kv")
    ok = all(torch.allclose(a, b, **PARITY_F32) for a, b in zip(lk, lp)) and torch.allclose(
        ck["k"], cp["k"], **PARITY_F32) and torch.allclose(ck["v"], cp["v"], **PARITY_F32)
    print(f"[lm parity] starcoder2-3b f32, all {cfg.n_layers} layers, B=2 prompt {prompt} + "
          f"{steps} teacher-forced steps: kernels vs plain max|dlogits| prefill {errs[0]:.3e}, "
          f"decode steps {' '.join(f'{e:.2e}' for e in errs[1:])}, max|dcache| "
          f"{cache_err:.3e}, tol={PARITY_F32}, |logits| max {lp[-1].abs().max().item():.2f}, "
          f"{time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
    exp = {"flash_attention_mma": 0, "flash_attention": cfg.n_layers,
           "decode_attention_mma": 0, "decode_attention": cfg.n_layers * steps,
           "tome_scores": 0}
    print(f"[lm parity] launches of the kernel run: {counts} (implies {exp})")
    check(ok, "f32 LM parity failed")
    check(counts == exp, "f32 LM launch counts")
    return counts


if __name__ == "__main__":
    sys.exit(main())
