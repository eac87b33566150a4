#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. It imports nothing of JAX or of the reference
package ``repro``; it puts ``src`` on ``sys.path`` itself. Phases, in order,
each failing the run on any failed check:

1. device:  the card's name and power limit (nvidia-smi) and torch's name;
2. build:   nvcc builds every kernel library from ``src/repro_torch/kernels/csrc``
            and prints each kernel's ptxas registers, stack frame, spills and
            shared memory; the tensor-core kernels and tome_scores must not
            spill (the tensor-core flash backward not at D=64: its D=128
            spill is printed), nor the 3xTF32 flash kernels at D <= 64, nor
            the f32 decode kernel at any instantiation; the dynamic shared
            memory and blocks per SM of those, of the tensor-core flash
            forward, of tome_scores' large-grid route and of the one-launch
            tensor-core decode kernel are printed for each instantiation,
            ptxas may not serialise the forward's wgmmas, and the last two
            may keep no stack frame;
3. kernels: each kernel against its plain PyTorch version on the card at the
            main paths' shapes, and timed beside its plain version, one
            library call computing the same function, and its bound. Flash
            attention has two kernels, chosen by (dtype, head dim): the
            tensor-core one (bf16 at D 64 and 128) and the route still named
            CUDA-core (f32, and bf16 at D 16 and 32; 3xTF32 on the tensor
            cores, and at its f32 ViT and vision calls a 1xTF32 forward must
            read above the f32 limit); both are timed at ViT B=1, ViT B=8 and
            the LM prefill shape, the CUDA-core one also in bf16 beside the
            tensor-core one; the tensor-core one also at the two MoE prefills
            (qwen3 [8,32,1024,128], granite [8,24,1024,64], causal) and at
            the diffusion paths' calls (dit-s2 [4,6,4096,64] with and without
            the log-size bias, and at the Janus forward's second and last
            lengths, 3141 and 2044, with it; flux-dev [16,24,1536,128] and
            [4,24,4608,128]); both at the vision paths' vit-b16 and vit-l16
            calls ([128,12,197,64], [128,16,197,64]). bf16 flash is held to
            FLASH_BF16 and to a share of max|plain|, and at each diffusion and
            vision call three wrong kernels made from the plain version must
            read above that share. tome_scores at B=1 and B=8 and at dit-s2's
            first, second and last merge layers ([4,2048,64] against
            [4,2048,64], [4,1571,64] against [4,1570,64], [4,1022,64]
            against [4,1022,64]), where the large-grid route serves and
            must give the small-grid route's (max, index) bit for bit.
            decode_attention has
            two kernels too, chosen by dtype: the tensor-core one (bf16) and
            the CUDA-core one (f32), both timed at the LM decode shape, the
            MoE decode shapes (group 8 at D=128, group 3 at D=64) and two
            longer caches, and at the LM decode shape also with the L2
            flushed before each call; the profiler must see one kernel a
            tensor-core decode call. tome_scores and decode_attention are timed with
            the calls queued behind a sleep kernel (the card's time per call,
            the host's per-call overhead hidden) and back to back as queued
            by the host;
   bench:   the port's benches (``repro_torch.benchmarks``): the execute
            bench (per_stream, stacked_exact, bucketed_e1/e2/e4 at N=16, 2
            reps) at the reference's 50-token ViT in f32 (its structure
            against the committed ``benchmarks/baselines/BENCH_execute.json``)
            and at ViT-L@384 in bf16 (split 18, within BATCH_BF16): frames/s,
            traces, parity, and launches equal to what the geometry implies;
            then every ``kernel_bench`` row (kernel, plain version, library
            call, bound);
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
   fleet:   the serving layer on the same model: ``workload.build_runtime`` of
            8 camera streams x 12 frames (Poisson 10 fps, wifi driving, device
            tiers phone/jetson/laptop) through one cloud tier (capacity 2,
            micro-batches of up to 8) with ``execute=True``, once bucketed (run
            A, telemetry on) and once exact (run B), which must agree; the
            launch counters are zeroed before each and must equal what the
            executed plans imply (device partitions' layers plus each stacked
            cloud forward's layers, and their merge layers), all on the
            tensor-core flash kernel. Run C: a one-stream fleet against
            ``JanusEngine.run_trace`` on one trace. Then the CLI's fleet mode
            (``repro_torch.launch.serve --streams 4 --execute``, the reduced
            ViT) and torch.profiler over run A;
   vit forward: the vanilla ``vit.forward`` (no merging) at B=8 bf16: 24
            tensor-core flash launches, finite logits;
6. parity:  ViT-L@384 in f32, ``vit.forward_janus`` through the kernels
            (flash on the CUDA-core kernel, counted) against the plain path
            on the card: logits within tolerance and identical merge indices
            per merge layer; then ``vit.forward`` likewise;
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
            versions on the card: logits within tolerance at every step;
9. moe:     qwen3-moe-30b-a3b bf16 at all 48 layers and full widths (61 GB of
            random weights drawn on the card) serves as ``lm`` does (flash 48,
            decode 48 x 64), traced with the MoE layers' share of kernel time;
   moe_cache: the same weights on the per-layer int8 cache (scale 0.05),
            prefill and 16 steps (int8 buffers, flash 48, decode 48 x 16);
   moe:     granite-moe-3b-a800m bf16 at full size (experts padded 40 -> 48,
            D=64), prefill and 16 steps (flash 32, decode 32 x 16);
10. moe_parity: qwen3-moe-30b-a3b in f32 at 4 of its 48 layers, full widths,
            2 x 256 + 8 teacher-forced tokens through the kernels against the
            plain versions, on the stacked f32 cache and on the per-layer int8
            cache: routes identical (or a near-tie, printed), then logits
            within tolerance;
11. dit:    dit-s2 bf16 at gen_1024 (B=4, 1024 px, 4096 tokens; the registry's
            config, adaLN-zero leaves redrawn so no block is gated to the
            identity) sampled over all 50 DDIM steps by ``diffusion.dit_sample``,
            dense and with the Janus ToMe schedule at alpha_max (4096 -> 2043
            tokens): s/step, images/s, launches (flash_mma 12 a step,
            tome_scores 12 a step in the Janus run); traced forwards;
12. flux:   flux-dev bf16 at full size (57 blocks, 23.80 GB of weights drawn
            on the card) sampled by ``diffusion.flux_sample``: gen_fast whole
            (B=16, 512 px, 4 steps), gen_1024 (B=4, 1024 px) cut to 2 of its
            50 steps; s/step, model TFLOP/s (the reference's flux_fwd_flops),
            peak memory, launches (flash_mma 57 a step); then one traced
            gen_1024 forward with flash_mma's share of kernel time;
13. diffusion parity: f32, kernels against plain versions: dit-s2
            ``forward_janus`` at gen_fast (merge indices identical at every
            merge layer, then the output) and flux-dev cut to 2 double + 4
            single blocks at full width, B=2 at 512 px;
14. vision: the registry's vit-b16, vit-l16 (``vit.forward``), swin-b (224
            and 384 px, window 12) and resnet-152 at their serving shapes in
            bf16: images/s, and bf16 logits against f32 logits of the same
            weights within a stated tolerance; ViT launches flash_mma a layer.
   spatial: resnet-152 ``serve_b128`` (bf16, full size) through
            ``build_bundle(..., profile_override="spatial")`` on the (1,1)
            NCCL mesh, logits bit-equal to the unmeshed bundle's; then every
            distinct convolution and pool that reads a neighbour's rows under
            a split along H, at that batch and resolution, cut into 2 and 4
            row blocks with their halos (``resnet.row_blocks``) through the
            ranks' local op against the unsplit op (bf16 and f32, within
            SPATIAL_OF_MAX of max|unsplit|; the pool bit-equal), with times.
15. train:  the flash backward kernels (the tensor-core one at the train
            call [32,16,577,64] bf16 and at [2,24,1024,128] causal, the
            CUDA-core one at the f32 train parity's [4,16,577,64] and at an
            f32 D=16 call) through the autograd Function against autograd
            of the plain version (the launch counters must move, the plain
            backward must not run) and against the plain backward on the
            same inputs, and two wrong backwards that must read above the
            limit, with kernel_bench's times of the same calls (the kernel,
            the plain backward, SDPA's backward) and the bound; then
            vit-l16 at ``cls_384`` with
            ``--full`` (304 M parameters, bf16 params, f32 moments, global
            batch 64 in 2 microbatches, remat) through
            ``repro_torch.launch.train.main``: 4 steps with a checkpoint at
            step 2, the step-4 checkpoint restored bit for bit, ``--resume``
            for 2 more; step ms, images/s, model TFLOP/s, peak memory;
            flash_mma launches exactly 2 (forward and remat) x 24 x 2 a step,
            flash_mma_bwd 24 x 2;
            one profiled step (idle share, the flash backward's share); one
            bf16 step's gradients with the kernels against the plain versions
            (loss, gradient norm, cosine, least leaf cosine) and an f32 step
            of vit-l16 cut to 4 layers at B=4 (every gradient leaf, at three
            seeds), each also run with the wrong backwards (and bf16 with a wrong
            forward), which must break a limit.
16. train mesh: the same run (seed, 4 steps, checkpoint at 2, ``--resume``
            for 2) through ``launch.train.main([... "--mesh"])`` on the (1,1)
            NCCL host mesh under vit-l16's train profile ``tp``: losses
            against ``[train]``'s (bit-equal: the same aten ops on the local
            tensors), flash_mma exactly 2 x 24 x 2 a step, the step-4
            checkpoint restored with ``shardings=`` bit for bit and placed as
            the bundle's ``in_shardings``, ``compressed_psum_mean`` of one
            step's gradients over the one-rank "data" group equal to the int8
            round trip; step ms against ``[train]``'s, peak memory, and one
            profiled step's idle share.
17. roofline: the dry-run tooling against the card: one vit-l16 cls_384
            train step counted with the per-rank counter
            (``runtime.hlo_bytes``) on the (1,1) mesh, its FLOPs equal to
            ``launch.dryrun.run_cell``'s count of the same bundle on a fake
            (1,1) world (a subprocess), its bytes beside them with the
            difference explained, its H100 roofline terms and the share of
            the bound ``[train]``'s measured median step reaches; then the
            hill-climb cell vit-l16/serve_b128 (B=128, bf16) variants v0,
            v1, v2, v3 and v6 on the card: ms a batch, images/s, counted
            terms, launches (flash_mma 24, tome_scores one a merge layer),
            every flash_mma and tome_scores call of each run against its
            plain version, v0 bit-equal to ``vit.forward``, v3 within
            VISION_BF16_REL of v0.

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``. Without a card, or outside a checkout, it
exits nonzero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:  # the timing helpers, peaks and kernel tolerances are the package's
    from repro_torch.benchmarks.execute_bench import BATCH_BF16
    from repro_torch.benchmarks.kernel_bench import (DECODE_BF16, DECODE_F32, FLASH_BF16,
                                                     FLASH_BF16_REL, FLASH_BWD_BF16_OF_MAX,
                                                     FLASH_BWD_F32_OF_MAX, FLASH_F32, TOME_MAX,
                                                     Case, flash_close, tome_close)
    from repro_torch.benchmarks.timing import (PEAK_BF16, PEAK_F32, PEAK_TF32, bound,
                                                time_cold_ms, time_ms)
except ModuleNotFoundError:
    sys.exit(f"chip_smoke: no src/repro_torch beside {__file__}; run it from a checkout")

PARITY_F32 = dict(atol=1e-3, rtol=1e-3)  # kernels vs plain, f32 whole paths (ViT 24, LM 30, MoE 4 layers)


# the MoE prefills' flash calls, GQA repeated outside: (label, heads, head dim)
MOE_PREFILL = (("qwen3 prefill causal", 32, 128), ("granite prefill causal", 24, 64))
# the diffusion paths' flash calls, non-causal: (label, B, heads, S, head dim,
# log-size bias). dit-s2's Janus forward at gen_1024 attends 4096, 3141, ...,
# 2044 tokens (DIT_ALPHA_SCHEDULE), its dense forward 4096.
DIFFUSION_FLASH = (("dit gen_1024 janus", 4, 6, 4096, 64, True),
                   ("dit gen_1024 janus layer 1", 4, 6, 3141, 64, True),
                   ("dit gen_1024 janus layer 11", 4, 6, 2044, 64, True),
                   ("dit gen_1024 dense", 4, 6, 4096, 64, False),
                   ("flux gen_fast", 16, 24, 1536, 128, False),
                   ("flux gen_1024", 4, 24, 4608, 128, False))
# [vision]'s vit.forward calls, 128 images of 197 tokens, no bias: bf16 on the
# tensor-core kernel, f32 (its reference logits) on the CUDA-core one
VISION_FLASH = (("vit-b16 serve_b128", 128, 12, 197, 64, False),
                ("vit-l16 serve_b128", 128, 16, 197, 64, False))
# [train]'s vit.forward calls: vit-l16 at cls_384, a microbatch of 32 images of
# 577 tokens, no bias (accum 2 of the global batch of 64), forward and remat
TRAIN_FLASH = (("vit-l16 cls_384 train", 32, 16, 577, 64, False),)
# tome_scores calls: ViT B=1 and B=8 (289 x 288), dit-s2's merges at gen_1024:
# the first (4096 tokens), the second (3141) and the last (2044)
TOME_SHAPES = ((1, 289, 288), (8, 289, 288), (4, 2048, 2048), (4, 1571, 1570), (4, 1022, 1022))


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
    # instantiations: flash_mma D=64 with one consumer warpgroup, D=128 with
    # one and two; tome's small-grid route at D 16/32/64/128 and its
    # large-grid route at D 64/128; decode_mma (one kernel) at D 64/128
    for name, n_lines in (("flash_attention_mma", 3), ("tome_scores", 6),
                          ("decode_attention_mma", 2)):
        lines = ptxas_summary(_build.build_log(name))
        check(len(lines) == n_lines and all(" 0 B spill stores, 0 B spill loads" in line
                                            for line in lines),
              f"{name} spills (or ptxas printed another number of lines for it)")
    # the backward kernels: two passes each; the tensor-core one must not
    # spill at any D (flash_mma_bwd_occupancy; the 3xTF32 one's check is
    # flash_tf32_occupancy's)
    for name, n_lines in (("flash_attention_mma_bwd", 4), ("flash_attention_bwd", 16)):
        lines = ptxas_summary(_build.build_log(name))
        check(len(lines) == n_lines, f"ptxas printed {len(lines)} lines for {name}")
        spills = [line for line in lines if " 0 B spill stores, 0 B spill loads" not in line]
        print(f"[build] {name}: {len(spills)} of {n_lines} instantiations spill"
              + (": " + "; ".join(line.split(":")[0] for line in spills) if spills else ""))
    flash_mma_fwd_occupancy()
    flash_mma_bwd_occupancy()
    flash_tf32_occupancy()
    decode_occupancy()
    tome_decode_mma_occupancy()

    from repro_torch.runtime.device import parity_numerics
    parity_numerics()  # f32 plain versions and f32 phases must not use TF32
    from repro_torch.benchmarks import kernel_bench
    t0 = time.perf_counter()
    bench = kernel_bench.measure()  # [bench] prints these; [kernels] takes its path shapes' times
    bench_s = time.perf_counter() - t0
    rows = kernel_phase(torch, bench) + decode_kernel_phase(torch, bench)
    paths = bench_phase(torch, bench, bench_s)
    model = _vit_l(torch, torch.bfloat16)
    paths.update(vit=path_phase(torch, *model), vit_batch=batch_phase(torch, *model))
    trace_phase(torch, *model)
    paths["fleet"], paths["fleet_cli"], run_a = fleet_phase(torch, *model)
    paths["mesh_fleet"] = mesh_phase(torch, *model, run_a)
    del run_a
    paths["vit_forward"] = vit_forward_phase(torch, *model[:2])
    del model
    paths["vit_f32_parity"], paths["vit_forward_f32_parity"] = parity_phase(torch)
    torch.cuda.empty_cache()
    paths["lm"] = lm_phase(torch)
    torch.cuda.empty_cache()
    paths["lm_f32_parity"] = lm_parity_phase(torch)
    torch.cuda.empty_cache()
    paths["moe_qwen3"], paths["moe_qwen3_cache"], paths["mesh_moe_a2a"] = moe_phase(torch)
    torch.cuda.empty_cache()
    paths["moe_granite"] = granite_phase(torch)
    torch.cuda.empty_cache()
    paths["moe_f32_parity"], paths["moe_f32_parity_int8"], paths["mesh_a2a_f32_parity"] = \
        moe_parity_phase(torch)
    torch.cuda.empty_cache()
    paths["dit"], paths["dit_janus"] = dit_phase(torch)
    torch.cuda.empty_cache()
    paths["flux_gen_fast"], paths["flux_gen_1024"] = flux_phase(torch)
    torch.cuda.empty_cache()
    paths["dit_f32_parity"], paths["flux_f32_parity"] = diffusion_parity_phase(torch)
    torch.cuda.empty_cache()
    paths.update(vision_phase(torch))
    torch.cuda.empty_cache()
    paths["spatial"] = spatial_phase(torch, smi)
    torch.cuda.empty_cache()
    train_paths, train_run = train_phase(torch, bench)
    paths.update(train_paths)
    rows += train_run["bwd_rows"]
    torch.cuda.empty_cache()
    paths["train_mesh"] = train_mesh_phase(torch, train_run)
    torch.cuda.empty_cache()
    paths.update(roofline_phase(torch, train_run))

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


def flash_mma_fwd_occupancy() -> None:
    """The tensor-core flash forward (``flash_attention_mma``, wgmma and
    TMA): each instantiation's dynamic shared memory and the blocks of it an
    SM holds at once, from the library's occupancy entry
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), beside its ptxas
    line (D=64 with one consumer warpgroup, D=128 with one and two), and
    the warpgroups the launch rule gives kernel_bench's flash_attention_mma
    rows. No instantiation may spill, and ptxas may not serialise its wgmmas
    (C7511: the products would then run one at a time)."""
    import ctypes
    from repro_torch.benchmarks import kernel_bench
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention_mma")
    log = _build.build_log("flash_attention_mma")
    lines = ptxas_summary(log)
    check(len(lines) == 3, f"ptxas printed {len(lines)} lines for flash_attention_mma")
    for line in lines:
        kernel, d, w = re.match(r"(\w+)<(\d+),(\d+)>", line).groups()
        smem, blocks = ctypes.c_int(), ctypes.c_int()
        err = lib.flash_attention_mma_fwd_occupancy(int(d), int(w), ctypes.byref(smem),
                                                    ctypes.byref(blocks))
        check(err == 0, f"flash_attention_mma_fwd_occupancy({d}, {w}): cudaError {err}")
        print(f"[build] flash_attention_mma: {kernel}<{d},{w}> {smem.value} B dynamic shared "
              f"memory, {blocks.value} blocks/SM")
        check(" 0 B spill stores, 0 B spill loads" in line, f"flash_attention_mma spills: {line}")
    serialised = [line.strip() for line in log.splitlines() if "C7511" in line]
    check(not serialised, "ptxas serialises flash_attention_mma's wgmmas: " + "; ".join(serialised))
    rule = {}
    for case in kernel_bench.CASES:
        if case.kernel() == "flash_attention_mma":
            rule[case.label] = lib.flash_attention_mma_fwd_warpgroups(*case.shape)
    print(f"[build] flash_attention_mma: consumer warpgroups a block by the launch rule: {rule}")


def flash_mma_bwd_occupancy() -> None:
    """The tensor-core flash backward (``flash_attention_mma_bwd``, wgmma and
    TMA): each pass's ptxas line at D 64 and 128 (``ptxas_summary``), its
    dynamic shared memory and the blocks of it an SM holds at once, from the
    library's occupancy entry (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    and the host's time to encode one call's tensor maps at the two train
    calls of kernel_bench; no instantiation may spill."""
    import ctypes
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention_mma_bwd")
    lines = ptxas_summary(_build.build_log("flash_attention_mma_bwd"))
    check(len(lines) == 4, f"ptxas printed {len(lines)} lines for flash_attention_mma_bwd")
    for line in lines:
        kernel, d = re.match(r"(\w+)<(\d+)>", line).groups()
        smem, blocks = ctypes.c_int(), ctypes.c_int()
        err = lib.flash_attention_mma_bwd_occupancy(int(d), int(kernel.endswith("dkdv_kernel")),
                                                    ctypes.byref(smem), ctypes.byref(blocks))
        check(err == 0, f"flash_attention_mma_bwd_occupancy({d}): cudaError {err}")
        print(f"[build] flash_attention_mma_bwd: {kernel}<{d}> {smem.value} B dynamic shared "
              f"memory, {blocks.value} blocks/SM")
        check(" 0 B spill stores, 0 B spill loads" in line,
              f"flash_attention_mma_bwd spills: {line}")
    lib.flash_attention_mma_bwd_encode_ns.argtypes = [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_double)]
    for b, h, s, d in ((32, 16, 577, 64), (2, 24, 1024, 128)):
        ns = ctypes.c_double()
        err = lib.flash_attention_mma_bwd_encode_ns(b, h, s, s, d, 1000, ctypes.byref(ns))
        check(err == 0, f"flash_attention_mma_bwd_encode_ns: error {err}")
        print(f"[build] flash_attention_mma_bwd: tensor maps of a call at [{b},{h},{s},{d}] "
              f"encoded in {ns.value / 1e3:.2f} us on the host")


def flash_tf32_occupancy() -> None:
    """The 3xTF32 flash kernels (forward, and the backward's dQ and dK/dV
    passes): each instantiation's ptxas line (``ptxas_summary``), its dynamic
    shared memory and the blocks of it an SM holds at once, from its
    library's occupancy entry (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
    none may spill at D <= 64."""
    import ctypes
    from repro_torch.kernels import _build
    for name, entry, n_lines in (("flash_attention", "flash_attention_fwd_occupancy", 8),
                                 ("flash_attention_bwd", "flash_attention_bwd_occupancy", 16)):
        occupancy = getattr(_build.load(name), entry)
        lines = ptxas_summary(_build.build_log(name))
        check(len(lines) == n_lines, f"ptxas printed {len(lines)} lines for {name}")
        for line in lines:
            kernel, dtype, d = re.match(r"(\w+)<(f32|bf16),(\d+)>", line).groups()
            args = [int(d), int(dtype == "bf16")]
            if name == "flash_attention_bwd":
                args.append(int(kernel == "flash_bwd_dkdv_kernel"))
            smem, blocks = ctypes.c_int(), ctypes.c_int()
            err = occupancy(*args, ctypes.byref(smem), ctypes.byref(blocks))
            check(err == 0, f"{entry}{tuple(args)}: cudaError {err}")
            print(f"[build] {name}: {kernel}<{dtype},{d}> {smem.value} B dynamic shared memory, "
                  f"{blocks.value} blocks/SM")
            check(int(d) > 64 or " 0 B spill stores, 0 B spill loads" in line,
                  f"{name} spills: {line}")


def decode_occupancy() -> None:
    """The f32 decode kernel (``decode_attention``): each instantiation's
    ptxas line (``ptxas_summary``: the split pass at D 64/128 and 1 to 4
    heads a lane, and the combine at D 64/128), and the split pass's dynamic
    shared memory and blocks per SM from the library's occupancy entry
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); none may spill or
    keep an array in local memory (a stack frame)."""
    import ctypes
    from repro_torch.kernels import _build
    lib = _build.load("decode_attention")
    lines = ptxas_summary(_build.build_log("decode_attention"))
    check(len(lines) == 10, f"ptxas printed {len(lines)} lines for decode_attention")
    frames = re.findall(r"(\d+) bytes stack frame", _build.build_log("decode_attention"))
    check(len(frames) == 10 and not any(int(f) for f in frames),
          f"decode_attention keeps local memory: stack frames {frames}")
    for line in lines:
        check(" 0 B spill stores, 0 B spill loads" in line, f"decode_attention spills: {line}")
        m = re.match(r"decode_partial_kernel<(\d+),(\d+)>", line)
        if m is None:
            continue
        smem, blocks = ctypes.c_int(), ctypes.c_int()
        err = lib.decode_attention_occupancy(int(m.group(1)), int(m.group(2)),
                                             ctypes.byref(smem), ctypes.byref(blocks))
        check(err == 0, f"decode_attention_occupancy{m.groups()}: cudaError {err}")
        print(f"[build] decode_attention: decode_partial_kernel<{m.group(1)},{m.group(2)}> "
              f"{smem.value} B dynamic shared memory, {blocks.value} blocks/SM")


def tome_decode_mma_occupancy() -> None:
    """tome_scores' large-grid route (D 64 and 128) and the one-launch
    tensor-core decode kernel (``decode_attention_mma``, D 64 and 128): each
    instantiation's ptxas line (``ptxas_summary``), its dynamic shared memory
    and the blocks of it an SM holds at once, from the libraries' occupancy
    entries (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``). None may
    spill or keep a stack frame, and ptxas may serialise nothing (C7511)."""
    import ctypes
    from repro_torch.kernels import _build
    for name, entry, pattern in (
            ("tome_scores", "tome_scores_large_occupancy", r"tome_scores_large_kernel<(\d+)>"),
            ("decode_attention_mma", "decode_attention_mma_occupancy",
             r"decode_mma_kernel<(\d+)>")):
        lib, log = _build.load(name), _build.build_log(name)
        lines = [line for line in ptxas_summary(log) if re.match(pattern, line)]
        check(len(lines) == 2, f"ptxas printed {len(lines)} lines for {pattern}")
        serialised = [line.strip() for line in log.splitlines() if "C7511" in line]
        check(not serialised, f"ptxas serialises {name}: " + "; ".join(serialised))
        for line in lines:
            check(" 0 B stack frame, 0 B spill stores, 0 B spill loads" in line,
                  f"{name} spills or keeps a stack frame: {line}")
            d = int(re.match(pattern, line).group(1))
            smem, blocks = ctypes.c_int(), ctypes.c_int()
            err = getattr(lib, entry)(d, ctypes.byref(smem), ctypes.byref(blocks))
            check(err == 0, f"{entry}({d}): cudaError {err}")
            print(f"[build] {name}: {line.split(':')[0]} {smem.value} B dynamic shared memory, "
                  f"{blocks.value} blocks/SM")


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel instantiation of nvcc's -Xptxas -v output:
    ``name<type,D>: registers, stack frame, spill stores/loads, shared
    memory``."""
    out, name, spill, frame = [], "?", (0, 0), 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d+([a-z_]+_kernel)I(\w*?)EEv", line)
        if m:
            args = re.sub(r"^f", "f32,", m.group(2).replace("13__nv_bfloat16", "bf16,"))
            args = re.sub(r"Li(\d+)E?", r"\1,", args).rstrip(",")
            name = f"{m.group(1)}<{args}>"
        elif "spill stores" in line:
            spill = tuple(int(n) for n in re.findall(r"(\d+) bytes spill", line))
            found = re.search(r"(\d+) bytes stack frame", line)
            frame = int(found.group(1)) if found else 0
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {regs} registers, {frame} B stack frame, {spill[0]} B spill "
                       f"stores, {spill[1]} B spill loads, {smem.group(1) if smem else 0} B smem")
    return out


def zero_counts() -> None:
    """Zero the kernels' launch counters, and ``moe_a2a``'s collectives."""
    from repro_torch.kernels import decode_attention, flash_attention, tome_scores
    from repro_torch.models import moe_a2a
    for mod in (decode_attention, flash_attention, tome_scores):
        mod.launches = 0
    flash_attention.launches_mma = decode_attention.launches_mma = 0
    tome_scores.launches_large = 0
    flash_attention.launches_bwd = flash_attention.launches_bwd_mma = 0
    moe_a2a.collectives = 0


def read_counts() -> dict[str, int]:
    """Launches per kernel since ``zero_counts``; the flash and decode
    wrappers' totals split into their tensor-core and CUDA-core kernels, and
    the flash backward's calls likewise."""
    from repro_torch.kernels import decode_attention, flash_attention, tome_scores
    fa = flash_attention
    return {"flash_attention_mma": fa.launches_mma,
            "flash_attention": fa.launches - fa.launches_mma,
            "flash_attention_mma_bwd": fa.launches_bwd_mma,
            "flash_attention_bwd": fa.launches_bwd - fa.launches_bwd_mma,
            "tome_scores": tome_scores.launches,
            "decode_attention_mma": decode_attention.launches_mma,
            "decode_attention": decode_attention.launches - decode_attention.launches_mma}


def _device_times(torch, fn, iters: int) -> dict[str, list[float]]:
    """µs on the card of every launch of each kernel that ``fn`` launches
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
    return times


def device_us(torch, fn, iters: int = 20) -> dict[str, float]:
    """Mean µs on the card per launch of each kernel that ``fn`` launches."""
    return {name: sum(ts) / len(ts) for name, ts in _device_times(torch, fn, iters).items()}


def fmt_us(times: dict[str, float]) -> str:
    return ", ".join(f"{name} {us:.2f} us" for name, us in times.items())


def cuda_core_flash(torch, flash_mod, q, k, v, bias, causal):
    """The CUDA-core flash kernel on a bf16 call that ``kernel_for`` routes to
    the tensor-core one: its C entry called directly, for a side-by-side time
    in one run (not counted; never on a path)."""
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    err = flash_mod._fn(flash_mod.CUDA_CORE)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
        None, out.data_ptr(), None, b, h, sq, k.shape[2], d, 1, int(causal),
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"CUDA-core flash kernel launch failed: cudaError {err}")
    return out


# --------------------------------------------------------------------- kernels

def bench_row(bench: list[dict], case) -> dict | None:
    """kernel_bench's record of the same call as ``case`` (a
    ``kernel_bench.Case``), or None: [kernels] takes such a call's times from
    it rather than timing the call a second time (a row that forced a
    tome_scores route is not the path's call)."""
    for r in bench:
        if (r["kernel"], tuple(r["shape"]), r["dtype"], r["causal"], r["bias"],
                r["length"], r.get("forced_route")) == (case.kernel(), case.shape,
                                                    str(case.dtype)[6:], case.causal,
                                                    case.bias, case.length, None):
            return r
    return None


def kernel_phase(torch, bench: list[dict]) -> list[dict]:
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

    def wrong_readings(label, q, k, v, kw, exp, scale):
        """What three plainly wrong kernels would read at this call, each made
        from the plain version, as a share of max|plain|: the bf16 limit must
        reject every one of them."""
        drop = torch.zeros(k.shape[0], k.shape[2], device=dev)
        drop[:, :64] = -torch.inf
        bias = kw["bias"]
        wrong = {"key tile 0 dropped": ref.flash_attention_ref(
            q, k, v, bias=drop if bias is None else bias + drop, causal=kw["causal"])}
        swapped = exp.clone()
        swapped[:, 0, :64] = exp[:, 1, :64]
        wrong["query tile 0 of head 0 = head 1's"] = swapped
        if bias is not None:
            wrong["bias ignored"] = ref.flash_attention_ref(q, k, v, causal=kw["causal"])
        rel = {name: (w.float() - exp.float()).abs().max().item() / scale
               for name, w in wrong.items()}
        print(f"[kernels] flash_attention_mma {label}: a wrong kernel would read "
              + ", ".join(f"{name} {r:.3e}" for name, r in rel.items())
              + f" of max|plain| (limit {FLASH_BF16_REL})")
        check(min(rel.values()) > FLASH_BF16_REL,
              f"the bf16 flash limit does not reject a wrong kernel at {label}")

    def wrong_tf32_reading(label, q, k, v, kw, exp):
        """What a 1xTF32 forward (the plain version with TF32 matmuls) would
        read at this f32 call: the f32 limit, which the 3xTF32 kernel meets,
        must reject it."""
        from repro_torch.runtime.device import parity_numerics
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            wrong = ref.flash_attention_ref(q, k, v, **kw)
        finally:
            parity_numerics()
        err = (wrong - exp).abs().max().item()
        over = ((wrong - exp).abs() / (FLASH_F32["atol"] + FLASH_F32["rtol"] * exp.abs())).max()
        print(f"[kernels] flash_attention {label}: a wrong kernel would read 1xTF32 (the plain "
              f"version with TF32 matmuls) max_abs_err {err:.3e}, {over.item():.2f} x the f32 "
              f"limit {FLASH_F32}")
        check(not torch.allclose(wrong, exp, **FLASH_F32),
              f"the f32 flash limit does not reject a 1xTF32 forward at {label}")

    def flash_case(label, b, dtype, sq=s, sk=s, pads=0, kv=False, causal=False, h=h, d=d,
                   with_bias=True, wrong=False):
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
        scale = exp.float().abs().max().item()
        flash_err[kernel] = max(flash_err[kernel], err)
        ok = bool(torch.isfinite(out).all()) and torch.allclose(out.float(), exp.float(), **tol)
        limit = ""
        if dtype == torch.bfloat16:
            ok = ok and err <= FLASH_BF16_REL * scale
            limit = f" and {FLASH_BF16_REL} x max|plain|"
        if kv:
            ok = ok and bool(torch.all(out[0] == 0))
        print(f"[kernels] {kernel} {label}: B={b} H={h} Sq={sq} Sk={sk} D={d} "
              f"{str(dtype)[6:]} max_abs_err={err:.3e} ({err / scale:.3e} of max|plain| "
              f"{scale:.3e}) tol={tol}{limit} {'ok' if ok else 'FAIL'}")
        check(ok, f"flash_attention {label} disagrees with its plain version")
        if wrong and dtype == torch.float32:
            wrong_tf32_reading(label, q, k, v, kw, exp)
        elif wrong:
            wrong_readings(label, q, k, v, kw, exp, scale)

    for b in (1, 8):
        for dtype in (torch.bfloat16, torch.float32):
            flash_case("prop-attn bias", b, dtype, wrong=dtype == torch.float32)
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
    for label, b, hh, ss, dd, with_bias in DIFFUSION_FLASH + VISION_FLASH + TRAIN_FLASH:
        flash_case(label, b, torch.bfloat16, sq=ss, sk=ss, h=hh, d=dd, with_bias=with_bias,
                   wrong=True)
    for label, b, hh, ss, dd, with_bias in VISION_FLASH:
        flash_case(label, b, torch.float32, sq=ss, sk=ss, h=hh, d=dd, with_bias=with_bias,
                   wrong=True)
    for label, hh, dd in MOE_PREFILL:
        flash_case(label, 8, torch.bfloat16, sq=1024, sk=1024, causal=True, h=hh, d=dd,
                   with_bias=False)

    # timings at the paths' calls: a ViT frame (B=1) and the cloud batch of 8
    # frames, with the bias; the LM prefill, causal
    def flash_timings(kernel, dtype) -> list[dict]:
        out = []
        shapes = [("ViT B=1", 1, h, s, d, False, True), ("ViT B=8", 8, h, s, d, False, True),
                  ("LM prefill", 8, 24, 1024, 128, True, False)]
        if kernel == flash_mod.MMA:  # the MoE prefills and the diffusion paths: bf16 only
            shapes += [(label, 8, hh, 1024, dd, True, False) for label, hh, dd in MOE_PREFILL]
            shapes += [(label, b, hh, ss, dd, False, with_bias)
                       for label, b, hh, ss, dd, with_bias in DIFFUSION_FLASH + TRAIN_FLASH]
        shapes += [(label, b, hh, ss, dd, False, with_bias)
                   for label, b, hh, ss, dd, with_bias in VISION_FLASH]
        for label, b, hh, ss, dd, causal, with_bias in shapes:
            case = Case(label, "flash", (b, hh, ss, dd), dtype, causal=causal, bias=with_bias)
            check(case.kernel() == kernel, f"{kernel} timing route")
            q, k, v, bias = flash_inputs(b, dtype, ss, ss, 0, hh, dd)
            bias = bias if with_bias else None
            shared = bench_row(bench, case)
            if shared is not None:  # kernel_bench timed this call, queued
                ms, plain, lib = shared["ms"], shared["plain_ms"], shared["library_ms"]
                timing = f"kernel_bench {shared['label']}, queued"
            else:
                iters = 10 if causal or ss > 1024 else 30
                ms = time_ms(lambda: flash_mod.flash_attention(q, k, v, bias=bias,
                                                               causal=causal), iters)
                plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, bias=bias,
                                                                causal=causal), iters)
                mask = None if bias is None else bias[:, None, None, :].to(q.dtype)
                lib = time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, is_causal=causal), iters)
                timing = "back to back"
            b_ms, b_by = case.bound()
            row = dict(shape=f"{label}: q,k,v [{b},{hh},{ss},{dd}] {str(dtype)[6:]}"
                             + (", causal" if causal else "")
                             + (f", bias [{b},{ss}]" if with_bias else ""),
                       ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                       timing=timing)
            extra = ""
            if kernel == flash_mod.MMA:  # the CUDA-core kernel on the same bf16 call
                row["cuda_core_ms"] = time_ms(lambda: cuda_core_flash(
                    torch, flash_mod, q, k, v, bias, causal), 10)
                extra = f", CUDA-core kernel {row['cuda_core_ms']:.4f} ms"
            else:  # 3xTF32: three TF32 passes on the tensor cores
                t_ms, t_by = bound(3 * case.flops(), case.nbytes(), PEAK_TF32)
                extra = f"; 3xTF32 bound {t_ms:.4f} ms ({t_by})"
            print(f"[kernels] {kernel} {row['shape']} timing ({timing}): kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, sdpa {lib:.4f} ms ({ms / lib:.2f}x), bound {b_ms:.4f} ms "
                  f"({b_by}){extra}")
            out.append(row)
            del q, k, v, bias
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
            tol={"f32": FLASH_F32, "bf16": FLASH_BF16, "bf16_of_max_plain": FLASH_BF16_REL},
            ms=vit8["ms"], kernel_ms=vit8["ms"], plain_ms=vit8["plain_ms"],
            library_ms=vit8["library_ms"],
            library="torch.nn.functional.scaled_dot_product_attention (attn_mask=bias, or "
                    "is_causal=True)",
            bound_ms=vit8["bound_ms"], bound_us=vit8["bound_ms"] * 1e3,
            bound_by=vit8["bound_by"], shape=vit8["shape"], timings=timings))

    tome_err = 0.0

    def tome_case(b, nb_len, na=289, nb=288):
        a = F.normalize(torch.randn((b, na, d), generator=gen, device=dev), dim=-1)
        bb = F.normalize(torch.randn((b, nb, d), generator=gen, device=dev), dim=-1)
        nbl = torch.randint(100, nb + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32) if nb_len else None
        m, i = tome_mod.tome_scores(a, bb, nbl)
        mr, ir = ref.tome_scores_ref(a, bb, nbl)
        torch.cuda.synchronize()
        scores = torch.einsum("bnd,bmd->bnm", a, bb)
        if nbl is not None:
            col = torch.arange(nb, device=dev)
            scores = scores.masked_fill(col[None, None, :] >= nbl[:, None, None], -torch.inf)
        at_idx = torch.gather(scores, 2, i.long()[..., None])[..., 0]
        err = (m - mr).abs().max().item()
        exact = int((i == ir).sum())
        ok = (torch.allclose(m, mr, **TOME_MAX)
              and torch.allclose(at_idx, scores.amax(-1), **TOME_MAX))
        print(f"[kernels] tome_scores B={b} Na={na} Nb={nb} D={d} nb_len={nb_len}: "
              f"max_abs_err={err:.3e} argmax equal {exact}/{i.numel()} "
              f"(others tie at the chosen index) {'ok' if ok else 'FAIL'}")
        check(ok, "tome_scores disagrees with its plain version")
        return max(err, (at_idx - scores.amax(-1)).abs().max().item()), a, bb

    for b, na, nb in TOME_SHAPES:
        for nb_len in (False, True):
            err, a, bb = tome_case(b, nb_len, na, nb)
            tome_err = max(tome_err, err)
        # the two routes: the same fmaf chains, the same (max, index) bit for bit
        nbl = torch.randint(1, nb + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
        small, large = (tome_mod.tome_scores(a, bb, nbl, route=r)
                        for r in (tome_mod.SMALL, tome_mod.LARGE))
        same = all(torch.equal(x, y) for x, y in zip(small, large))
        print(f"[kernels] tome_scores B={b} Na={na} Nb={nb}: the path takes the "
              f"{tome_mod.route_for(b, na, nb, d)} route; small and large routes with nb_len "
              f"{'bit-equal' if same else 'DIFFER'}")
        check(same, f"tome_scores' routes differ at B={b} Na={na} Nb={nb}")

    one = torch.zeros(1, device=dev)
    floor = time_ms(lambda: one.add_(1), queued=True)
    print(f"[kernels] launch floor: a 1-element add, queued: {floor:.4f} ms")
    tome_timings = []
    for b, na, nb in TOME_SHAPES:
        _, a, bb = tome_case(b, False, na, nb)

        def kernel():
            return tome_mod.tome_scores(a, bb)

        def library():
            return torch.bmm(a, bb.transpose(1, 2)).max(-1)

        case = Case(f"B={b}", "tome", (b, na, nb, d), torch.float32)
        shared = bench_row(bench, case)
        if shared is not None:  # kernel_bench timed this call, queued
            ms, plain, lib = shared["ms"], shared["plain_ms"], shared["library_ms"]
        else:
            ms, lib = time_ms(kernel, queued=True), time_ms(library, queued=True)
            plain = time_ms(lambda: ref.tome_scores_ref(a, bb), queued=True)
        eager, lib_eager = time_ms(kernel), time_ms(library)
        dev_us, lib_us = device_us(torch, kernel), device_us(torch, library)
        b1 = bb[:, :1].contiguous()  # one column: what a call costs beside its FMAs
        fixed_us = device_us(torch, lambda: tome_mod.tome_scores(a, b1))
        b_ms, b_by = case.bound()
        print(f"[kernels] tome_scores B={b} Na={na} Nb={nb} D={d} f32 timing, queued"
              + (f" (kernel_bench {shared['label']})" if shared else "") + ": kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, bmm+max {lib:.4f} ms ({ms / lib:.2f}x), "
              f"bound {b_ms:.6f} ms ({b_by}); back to back from the host: kernel {eager:.4f} "
              f"ms, bmm+max {lib_eager:.4f} ms; on the card per launch (profiler): "
              f"{fmt_us(dev_us)}; with Nb=1 {fmt_us(fixed_us)}; bmm+max {fmt_us(lib_us)}")
        tome_timings.append(dict(shape=f"a [{b},{na},{d}], b [{b},{nb},{d}] f32", ms=ms,
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


def decode_kernel_phase(torch, bench: list[dict]) -> list[dict]:
    """decode_attention's two kernels against the plain version (lengths 1,
    ragged inside a tile, full; group 12 as starcoder2-3b, 2 as internlm2, 8
    as qwen3-moe and 3 as granite-moe; D 64 and 128): bf16 on the
    tensor-core kernel, f32 on the CUDA-core one. Then each timed at
    starcoder2-3b's last decode step, the MoE paths' last steps and two
    longer caches, beside the plain version and SDPA with a length mask,
    and at starcoder2-3b's shape also with the L2 flushed before each call
    (kernel_bench's rows where it timed the same call)."""
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
        for hq, hkv in ((24, 2), (16, 8), (32, 4), (24, 8)):  # groups 12, 2, 8, 3
            for d in (64, 128):
                q, k, v = inputs(3, hq, hkv, s, d, dtype)
                checked(q, k, v, lengths, f"B=3 Hq={hq} Hkv={hkv} S={s} D={d} "
                                          f"{str(dtype)[6:]} lengths={lengths.tolist()}")

    timings = {decode_mod.MMA: [], decode_mod.CUDA_CORE: []}
    both = (torch.bfloat16, torch.float32)
    # starcoder2-3b's path and two longer caches; then the MoE paths: qwen3
    # (group 8) after 64 steps, granite (group 3) after 16
    for b, s, n, hq, hkv, dd, dtypes in (
            (8, 2048, 1088, 24, 2, 128, both), (8, 8192, 8192, 24, 2, 128, both),
            (1, 32768, 32768, 24, 2, 128, both),
            (8, 2048, 1088, 32, 4, 128, both), (8, 2048, 1040, 24, 8, 64, both)):
        for dtype in dtypes:
            q, k, v = inputs(b, hq, hkv, s, dd, dtype)
            lens = torch.full((b,), n, dtype=torch.int32, device=dev)
            shape = (f"q [{b},{hq},{dd}], k/v [{b},{s},{hkv},{dd}] {str(dtype)[6:]}, "
                     f"length {n}")
            kernel, exp = checked(q, k, v, lens, shape)
            kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))  # [B, Hkv, S, D]
            mask = (torch.arange(s, device=dev) < lens[:, None])[:, None, None, :]

            def wrapper():
                return decode_mod.decode_attention(q, k, v, lens)

            def library():
                return F.scaled_dot_product_attention(q[:, :, None], kt, vt, attn_mask=mask,
                                                      enable_gqa=True)

            lib_err = (library()[:, :, 0].float() - exp.float()).abs().max().item()
            case = Case(shape, "decode", (b, hq, hkv, s, dd), dtype, length=n)
            shared = bench_row(bench, case)
            if shared is not None:  # kernel_bench timed this call, queued
                ms, plain, lib = shared["ms"], shared["plain_ms"], shared["library_ms"]
            else:
                ms, lib = time_ms(wrapper, queued=True), time_ms(library, queued=True)
                plain = time_ms(lambda: ref.decode_attention_ref(q, k, v, lens), queued=True)
            row = dict(shape=shape, ms=ms, plain_ms=plain, library_ms=lib,
                       host_ms=time_ms(wrapper), library_host_ms=time_ms(library),
                       device_us=device_us(torch, wrapper))
            if kernel == decode_mod.MMA:  # the splits are combined in the same launch
                check(list(row["device_us"]) == ["decode_mma_kernel"],
                      f"{kernel} {shape}: the profiler saw {row['device_us']}, not one "
                      "kernel a call")
            row["bound_ms"], row["bound_by"] = case.bound()
            extra = ""
            if (s, hq, hkv) == (LM_CAPACITY, 24, 2):
                row["cold_l2_ms"] = (shared["cold_l2_ms"] if shared is not None
                                     else time_cold_ms(wrapper))
                extra = f"; L2 flushed before each call: kernel {row['cold_l2_ms']:.4f} ms"
            print(f"[kernels] {kernel} {shape} timing, queued"
                  + (f" (kernel_bench {shared['label']})" if shared else "")
                  + f": kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, sdpa(enable_gqa, mask) {lib:.4f} ms ({ms / lib:.2f}x; "
                  f"max|sdpa-plain|={lib_err:.2e}), bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}, {case.nbytes() / 1e6:.1f} MB), splits "
                  f"{decode_mod.n_splits(b, hq, hkv, s, dd, kernel)}{extra}; back to back from the "
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


# ----------------------------------------------------------------------- bench

def recording(module, name: str, calls: dict, key=None):
    """A context in which ``module.name`` runs as before and records its
    calls: ``calls[k] = [args, kwargs, n]``, the first call with the key
    ``k = key(args, kwargs)`` and how many calls had it. With no ``key``
    every call is kept, under its index."""
    fn = getattr(module, name)

    def rec(*args, **kwargs):
        k = len(calls) if key is None else key(args, kwargs)
        if k in calls:
            calls[k][2] += 1
        else:
            calls[k] = [args, kwargs, 1]
        return fn(*args, **kwargs)
    return swapped_in(module, name, rec)


def flash_signature(args, kwargs) -> tuple:
    """What picks a flash_attention call's kernel and code path: the shapes,
    the dtype, which of bias and kv_len it has, and causal."""
    q, k = args[:2]
    return (tuple(q.shape), tuple(k.shape), q.dtype, kwargs.get("bias") is not None,
            kwargs.get("kv_len") is not None, kwargs.get("causal", False))


def _tome_args(args, kwargs):
    return (*args, kwargs.get("nb_len"))[:3]


def tome_signature(args, kwargs) -> tuple:
    a, b, nb_len = _tome_args(args, kwargs)
    return tuple(a.shape), tuple(b.shape), nb_len is not None


def check_flash_calls(label: str, calls: dict) -> tuple[int, float]:
    """Each recorded flash_attention call against its plain version on its
    inputs (the kernel launched again; the counts were read before):
    ``kernel_bench.flash_close``'s limits. Returns (calls, max_abs_err)."""
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ref
    worst = 0.0
    for (q, k, v), kwargs, _ in calls.values():
        err, ok = flash_close(flash_mod.flash_attention(q, k, v, **kwargs),
                              ref.flash_attention_ref(q, k, v, **kwargs))
        check(ok, f"{label} flash_attention {flash_signature((q, k), kwargs)}: "
                  f"max_abs_err {err:.3e}")
        worst = max(worst, err)
    return sum(n for *_, n in calls.values()), worst


def check_tome_calls(label: str, calls: dict) -> tuple[int, float]:
    """Each recorded tome_scores call against its plain version on its
    inputs: ``kernel_bench.tome_close``'s limits. Returns (calls,
    max_abs_err)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import tome_scores as tome_mod
    worst = 0.0
    for args, kwargs, _ in calls.values():
        a, b, nb_len = _tome_args(args, kwargs)
        err, ok = tome_close(a, b, nb_len, tome_mod.tome_scores(a, b, nb_len),
                             ref.tome_scores_ref(a, b, nb_len))
        check(ok, f"{label} tome_scores a {tuple(a.shape)} b {tuple(b.shape)} nb_len "
                  f"{nb_len is not None}: max_abs_err {err:.3e}")
        worst = max(worst, err)
    return sum(n for *_, n in calls.values()), worst


def bench_phase(torch, bench: list[dict], bench_s: float) -> dict[str, dict[str, int]]:
    """The port's benches on the card: ``execute_bench.run`` at the
    reference's 50-token ViT (f32) and at ViT-L@384 (bf16), N=16 and 2 reps
    each, with the launch counters zeroed before and read after each run and
    held against what the geometry implies, and the first flash_attention
    and tome_scores call of each distinct shape of the run held against its
    plain version; then every ``kernel_bench`` row (``bench``, measured at
    the start of this run in ``bench_s`` seconds)."""
    from repro_torch.benchmarks import execute_bench
    from repro_torch.core import pruning
    from repro_torch.core.bucketing import BucketingConfig, BucketTable
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import tome_scores as tome_mod

    t0 = time.perf_counter()
    n, reps, edges = 16, 2, (1, 2, 4)
    baseline = json.loads((ROOT / "benchmarks" / "baselines" / "BENCH_execute.json").read_text())
    paths = {}
    for name in ("vit50", "vit-l384"):
        model = execute_bench.MODELS[name]
        cfg, split = model.cfg, model.split
        flash_calls, tome_calls = {}, {}
        zero_counts()
        with recording(flash_mod, "flash_attention", flash_calls, flash_signature), \
                recording(tome_mod, "tome_scores", tome_calls, tome_signature):
            art = execute_bench.run(n, reps, edges, model_name=name, device="cuda")
        counts = read_counts()
        scheds = [tuple(pruning.make_schedule("exponential", model.alphas[i % len(model.alphas)],
                                              cfg.n_layers, cfg.num_tokens)) for i in range(n)]
        entry = [pruning.token_counts(cfg.num_tokens, sc)[split] for sc in scheds]
        suffix_merges = sum(1 for r in scheds[0][split:] if r > 0)
        # stacked cloud forwards a round: one a plan, one a distinct geometry,
        # one a bucket edge reached
        forwards = {"per_stream": n, "stacked_exact": len(set(zip(scheds, entry)))}
        for k in edges:
            table = BucketTable.build(cfg, model.alphas, config=BucketingConfig(n_edges=k))
            forwards[f"bucketed_e{k}"] = len({table.edge_for(split, c) for c in entry})
        cloud_forwards = (reps + 1) * sum(forwards.values())
        exp_flash = n * split + cloud_forwards * (cfg.n_layers - split)
        exp_tome = sum(1 for sc in scheds for r in sc[:split] if r > 0) \
            + cloud_forwards * suffix_merges
        kernel = "flash_attention_mma" if cfg.dtype == torch.bfloat16 else "flash_attention"
        other = "flash_attention" if kernel == "flash_attention_mma" else "flash_attention_mma"
        for r in art["modes"]:
            print(f"[bench] execute {name} {r['mode']}: episode {r['episode_frames_per_s']:.1f} "
                  f"frames/s ({r['episode_wall_s'] * 1e3:.2f} ms), steady "
                  f"{r['steady_frames_per_s']:.1f} frames/s ({r['steady_wall_s'] * 1e3:.3f} ms), "
                  f"first round {r['compile_s'] * 1e3:.2f} ms, traces {r['traces']}, "
                  f"{r['dispatches_per_round']} forwards a round, parity "
                  f"{r['parity_max_abs_diff']:.3e} {'ok' if r['parity_ok'] else 'FAIL'}")
            check(r["parity_ok"], f"execute bench {name} {r['mode']}: parity outside "
                                  f"atol {art['parity_atol']} rtol {art['parity_rtol']}")
            check(r["dispatches_per_round"] == forwards[r["mode"]],
                  f"execute bench {name} {r['mode']}: forwards a round")
            if r["mode"].startswith("bucketed"):
                check(set(r["traces"]) == {"cloud_padded"}
                      and r["traces"]["cloud_padded"] <= len(r["edges_at_split"]),
                      f"execute bench {name} {r['mode']}: cloud_padded traces exceed the edges")
            else:
                check(r["traces"] == {"cloud": len(set(entry))},
                      f"execute bench {name} {r['mode']}: one trace a token count")
        if name == "vit50":  # the reference's geometry: its committed baseline's structure
            for key in ("cloud_entry_counts", "shared_suffixes", "bucket_table"):
                check(art[key] == baseline[key], f"execute bench vit50 {key} != the baseline's")
            check([r["traces"] for r in art["modes"]] == [r["traces"] for r in baseline["modes"]],
                  "execute bench vit50 traces != the baseline's")
        print(f"[bench] execute {name} ({art['config']['dtype']}, split {split}, entry counts "
              f"{art['cloud_entry_counts']}) launches: {kernel}={counts[kernel]}, "
              f"{other}={counts[other]}, tome_scores={counts['tome_scores']} (the geometry "
              f"implies {exp_flash} and {exp_tome}: {n} device partitions, {cloud_forwards} "
              f"stacked cloud forwards)")
        check(counts[kernel] == exp_flash > 0 and counts[other] == 0
              and counts["tome_scores"] == exp_tome > 0
              and counts["decode_attention"] == counts["decode_attention_mma"] == 0,
              f"execute bench {name} launch counts")
        n_flash, flash_err = check_flash_calls(f"[bench] execute {name}", flash_calls)
        n_tome, tome_err = check_tome_calls(f"[bench] execute {name}", tome_calls)
        biased = sum(n for (_, kw, n) in flash_calls.values() if kw.get("bias") is not None)
        nb_lens = sum(n for key, (*_, n) in tome_calls.items() if key[2])
        qs = sorted({key[0] for key in flash_calls})
        print(f"[bench] execute {name}: the kernels against their plain versions on the card, "
              f"the first call of each shape: {kernel} {len(flash_calls)} shapes of "
              f"{n_flash} calls (q {qs[0]} .. {qs[-1]}, {biased} calls with a bias) "
              f"max_abs_err {flash_err:.3e} (tol "
              f"{FLASH_F32 if cfg.dtype == torch.float32 else FLASH_BF16}"
              f"{'' if cfg.dtype == torch.float32 else f' and {FLASH_BF16_REL} x max|plain|'}); "
              f"tome_scores {len(tome_calls)} shapes of {n_tome} calls ({nb_lens} with nb_len) "
              f"max_abs_err {tome_err:.3e} (tol {TOME_MAX}) ok")
        check(n_flash == counts[kernel] and n_tome == counts["tome_scores"],
              f"execute bench {name}: recorded calls {n_flash}, {n_tome} != launches")
        paths[f"bench_execute_{name}"] = counts
    for r in bench:
        print(f"[bench] {r['name']}: {r['dtype']} {r['shape']}"
              + (" causal" if r["causal"] else "") + (" bias" if r["bias"] else "")
              + (f" length {r['length']}" if r["length"] else "")
              + f", queued: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x), bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}), max_abs_err {r['max_abs_err']:.3e} "
              f"tol {r['tol']} ok")
    print(f"[bench] {time.perf_counter() - t0 + bench_s:.1f} s (kernel_bench {bench_s:.1f} s, "
          f"measured at the start of the run)")
    return paths


def vit_forward_phase(torch, cfg, params) -> dict[str, int]:
    """The vanilla ViT-L@384 (``vit.forward``: all 24 blocks, no merging; the
    baseline Janus is measured against) in bf16 on 8 random images: one
    tensor-core flash launch a layer, nothing else, finite logits."""
    from repro_torch.models import vit

    images = torch.randn((8, cfg.img_res, cfg.img_res, 3), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(4))
    vit.forward(params, cfg, images)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    logits = vit.forward(params, cfg, images)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    exp = _expect(flash_attention_mma=cfg.n_layers)
    print(f"[vit forward] ViT-L@384 bf16 vit.forward B=8: {ms:.2f} ms, logits "
          f"{tuple(logits.shape)}, launches {counts} (implies {exp})")
    check(tuple(logits.shape) == (8, cfg.n_classes), "vit.forward logits shape")
    check(bool(torch.isfinite(logits).all()), "non-finite vit.forward logits")
    check(counts == exp, "vit.forward launch counts")
    return counts


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


PORT_KERNEL = re.compile(r"\b(flash_mma_fwd|flash_fwd|flash_mma_bwd_dq|flash_mma_bwd_dkdv|"
                         r"flash_bwd_dq|flash_bwd_dkdv|tome_scores|tome_scores_large|"
                         r"decode_mma|decode_partial|decode_combine)_kernel\b")
DECODE_MMA_KERNEL = re.compile(r"\bdecode_mma_kernel\b")


FLASH_BWD_KERNEL = re.compile(r"\bflash_(mma_)?bwd_(dq|dkdv)_kernel\b")
MOE_RANGE = "moe.apply"
FLASH_BWD_RANGE = "flash_attention.backward"
RANGES = (MOE_RANGE, FLASH_BWD_RANGE)  # profiler ranges of this script, not kernels


def profile_once(torch, label: str, fn, moe_split: bool = False):
    """torch.profiler over one call of ``fn`` after one warm call: prints the
    wall time, the sum of kernel time on the card, the idle share, the top 8
    kernels and every other kernel of the port as ``[trace]`` lines, and
    returns (the profile, kernel ms, wall ms). With
    ``moe_split`` each ``moe.apply`` call runs inside a profiler range, and
    a line splits the kernel time under those ranges into the expert GEMMs
    (the ``bmm`` calls of ``apply`` itself) and the rest of the MoE layer
    (router, top-k sort, positions, scatter, gathers, SwiGLU, combine)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import moe

    fn()
    torch.cuda.synchronize()
    apply = moe.apply

    def ranged(*args, **kw):
        with record_function(MOE_RANGE):
            return apply(*args, **kw)

    if moe_split:
        moe.apply = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        moe.apply = apply
    busy_ms = report_profile(label, prof, wall_ms)
    if moe_split:
        report_moe_split(label, prof, busy_ms)
    return prof, busy_ms, wall_ms


def report_moe_split(label: str, prof, busy_ms: float) -> None:
    from torch.autograd import DeviceType

    spans = [ev for ev in prof.events()
             if ev.name == MOE_RANGE and ev.device_type == DeviceType.CPU]
    moe_ms = sum(ev.device_time_total for ev in spans) / 1e3
    gemm_ms = sum(ch.device_time_total for ev in spans for ch in ev.cpu_children
                  if ch.name == "aten::bmm") / 1e3
    if not spans or moe_ms == 0 or not busy_ms:
        print(f"[trace] {label}: MoE layers' kernel time not measured ({len(spans)} "
              "ranges; the profiler linked no kernel to them)")
        return
    print(f"[trace] {label}: MoE layers {moe_ms:.3f} ms of {busy_ms:.3f} ms kernel time "
          f"({moe_ms / busy_ms:.3f}) in {len(spans)} calls: expert GEMMs {gemm_ms:.3f} ms "
          f"({gemm_ms / busy_ms:.3f}), dispatch and the rest {moe_ms - gemm_ms:.3f} ms "
          f"({(moe_ms - gemm_ms) / busy_ms:.3f})")


def report_profile(label: str, prof, wall_ms: float) -> float:
    """The ``[trace]`` lines of one profiled window: wall, kernel time on the
    card, launches, idle share, the top 8 kernels and the port's own.
    Returns the kernel time, ms."""
    from torch.autograd import DeviceType

    kernels: dict[str, list[float]] = {}
    for ev in prof.events():
        # a profiler range (moe.apply) also appears on the card's timeline,
        # spanning its kernels: it is not a kernel
        if ev.device_type == DeviceType.CUDA and ev.name not in RANGES:
            kernels.setdefault(ev.name, []).append(ev.time_range.elapsed_us() / 1e3)
    busy_ms = sum(sum(v) for v in kernels.values())
    n = sum(len(v) for v in kernels.values())
    if n == 0:
        print(f"[trace] {label}: wall {wall_ms:.2f} ms; the profiler saw no kernel on "
              "the card (device time not measured)")
        return 0.0
    print(f"[trace] {label}: wall {wall_ms:.2f} ms, kernels on the card {busy_ms:.2f} ms "
          f"in {n} launches, idle share {1 - busy_ms / wall_ms:.3f}")
    ranked = sorted(kernels.items(), key=lambda kv: -sum(kv[1]))
    for i, (name, ts) in enumerate(ranked):  # the top 8, then the port's own kernels
        if i < 8 or PORT_KERNEL.search(name):
            print(f"[trace]   {sum(ts):8.3f} ms {len(ts):5d}x  {name[:90]}")
    return busy_ms


# ----------------------------------------------------------------------- fleet

FLEET_STREAMS, FLEET_FRAMES = 8, 12


def _fleet_spec(workload):
    """The fleet phase's traffic: 8 camera streams x 12 frames, Poisson 10
    fps with at most 4 frames in flight, wifi driving, device tiers
    phone/jetson/laptop round-robin, one cloud tier of 2 executors taking
    micro-batches of up to 8. wifi offloads most frames to the cloud, so
    streams co-batch; driving and the tiers make Algorithm 1 prune some of
    them (α=0.27), so the cloud forwards merge tokens too."""
    return workload.WorkloadSpec(
        name="fleet-smoke", n_streams=FLEET_STREAMS, n_frames=FLEET_FRAMES, seed=3,
        network=workload.NetworkConfig("synthetic", "wifi", "driving"),
        tiers=("phone", "jetson", "laptop"),
        arrivals=workload.ArrivalConfig(kind="poisson", rate_fps=10.0, max_inflight=4),
        capacity=2, max_batch=8)


class FleetMeter:
    """Records, while installed, what each executed plan implies and how long
    each partition took: the device partitions (``JanusEngine._execute_device``,
    less the host wire step ``_wire``) and every ``run_cloud_batch`` call that
    runs cloud layers (the fleet's dispatches and the single-stream engine's
    inline cloud runs, not a device-only frame's head), each closed by a
    synchronize. The implied launches are one flash call per layer
    run and one tome_scores call per merge layer run, per stacked forward."""

    def __init__(self, torch, cfg):
        self.torch, self.cfg = torch, cfg
        self.reset()

    def reset(self):
        self.implied = {"flash": 0, "tome": 0}
        self.device_ms, self.wire_ms, self.cloud_ms, self.stacked = [], [], [], []

    def _now(self):
        self.torch.cuda.synchronize()
        return time.perf_counter()

    def _layers(self, schedule, lo, hi):
        self.implied["flash"] += hi - lo
        self.implied["tome"] += sum(1 for r in schedule[lo:hi] if r > 0)

    def __enter__(self):
        from repro_torch.core import engine
        from repro_torch.serving import simcore
        meter, n = self, self.cfg.n_layers
        self._saved = (engine.JanusEngine._execute_device, engine.JanusEngine._wire,
                       engine.run_cloud_batch, simcore.run_cloud_batch)
        execute_device, wire, run_cloud_batch, _ = self._saved

        def timed_execute_device(eng, dec, images):
            t0, meter._wire_s = meter._now(), 0.0
            plan, payload = execute_device(eng, dec, images)
            layers = n if plan.split == n + 1 else plan.split
            meter.device_ms.append((layers, (meter._now() - t0 - meter._wire_s) * 1e3))
            meter._layers(plan.schedule, 0, layers)
            return plan, payload

        def timed_wire(eng, x):
            t0 = meter._now()
            out = wire(eng, x)
            meter._wire_s += meter._now() - t0
            meter.wire_ms.append((meter._now() - t0) * 1e3)
            return out

        def timed_run_cloud_batch(cache, cfg, params, plans, buckets=None):
            groups: dict[tuple, int] = {}
            for p in plans:
                if p is None or p.logits is not None:
                    continue
                s = n if p.split == n + 1 else p.split
                key = (p.schedule, s, p.x.shape[1]) if buckets is None else \
                    (p.schedule[s:], s, buckets.edge_for(s, p.x.shape[1]))
                groups[key] = groups.get(key, 0) + p.x.shape[0]
            for key, rows in groups.items():
                suffix = key[0][key[1]:] if buckets is None else key[0]
                meter._layers(suffix, 0, n - key[1])
                if key[1] < n:  # not a device-only frame's head
                    meter.stacked.append(rows)
            t0 = meter._now()
            run_cloud_batch(cache, cfg, params, plans, buckets=buckets)
            if any(key[1] < n for key in groups):
                meter.cloud_ms.append((meter._now() - t0) * 1e3)

        engine.JanusEngine._execute_device = timed_execute_device
        engine.JanusEngine._wire = timed_wire
        engine.run_cloud_batch = simcore.run_cloud_batch = timed_run_cloud_batch
        return self

    def __exit__(self, *exc):
        from repro_torch.core import engine
        from repro_torch.serving import simcore
        (engine.JanusEngine._execute_device, engine.JanusEngine._wire,
         engine.run_cloud_batch, simcore.run_cloud_batch) = self._saved
        return False


def _median(xs) -> float:
    return sorted(xs)[len(xs) // 2] if xs else float("nan")


def fleet_phase(torch, cfg, params, images) -> tuple[dict[str, int], dict[str, int], dict]:
    """The serving layer on the card (see the module docstring). Returns the
    launch counts of runs A + B + C, those of the CLI's fleet mode, and run
    A's frames, launch counts, wall s and idle share (for ``mesh_phase``)."""
    import collections

    from repro_torch.configs import janus_vit_l384
    from repro_torch.core import bandwidth, engine
    from repro_torch.core.bucketing import BucketingConfig
    from repro_torch.launch import serve
    from repro_torch.serving import fleet, telemetry, workload

    profile = serve.make_profile(janus_vit_l384.CONFIG)
    eng_cfg = engine.EngineConfig(sla_s=0.3, execute=True, include_scheduler_overhead=False)
    spec = _fleet_spec(workload)
    meter = FleetMeter(torch, cfg)

    def build(bucketing):
        return workload.build_runtime(spec, profile, eng_cfg, model_cfg=cfg, params=params,
                                      bucketing=bucketing, device="cuda")

    def counted_run(label, rt, tel=None):
        meter.reset()
        zero_counts()
        with meter:
            t0 = time.perf_counter()
            fs = rt.run(images=images, telemetry=tel)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = read_counts()
        n_done = len(fs.all_frames)
        full = [ms for layers, ms in meter.device_ms if layers > 0]
        embed = [ms for layers, ms in meter.device_ms if layers == 0]
        print(f"[fleet] run {label}: wall {wall:.3f} s, {n_done} executed frames, "
              f"{n_done / wall:.2f} frames/s; device partition median "
              f"{_median(full):.2f} ms ({len(full)}x with layers), "
              f"{_median(embed):.2f} ms ({len(embed)}x embed only), cloud batch "
              f"median {_median(meter.cloud_ms):.2f} ms ({len(meter.cloud_ms)}x), host wire "
              + (f"median {_median(meter.wire_ms):.2f} ms ({len(meter.wire_ms)}x)"
                 if meter.wire_ms else "none (no frame split mid-model)")
              + f"; stacked forwards {collections.Counter(meter.stacked)}; "
              f"plan cache traces {rt.plan_cache.traces_by_kind}")
        print(f"[fleet] run {label} launches: flash_attention_mma="
              f"{counts['flash_attention_mma']}, CUDA-core flash_attention="
              f"{counts['flash_attention']}, tome_scores={counts['tome_scores']} (the executed "
              f"plans imply {meter.implied['flash']} bf16 flash calls, all tensor-core, and "
              f"{meter.implied['tome']}), decode_attention(_mma)={counts['decode_attention']}/"
              f"{counts['decode_attention_mma']}")
        check(counts["flash_attention_mma"] == meter.implied["flash"] > 0
              and counts["tome_scores"] == meter.implied["tome"] > 0,
              f"fleet run {label}: launches differ from what the executed plans imply")
        check(counts["flash_attention"] == counts["decode_attention"]
              == counts["decode_attention_mma"] == 0,
              f"fleet run {label} launched a CUDA-core flash or a decode kernel")
        for st, dropped in zip(fs.per_stream, fs.dropped_per_stream):
            check(len(st.frames) + dropped == spec.n_frames,
                  f"fleet run {label}: frames not conserved")
        for f in fs.all_frames:
            check(f.logits is not None and tuple(f.logits.shape) == (1, cfg.n_classes)
                  and bool(torch.isfinite(f.logits.float()).all()),
                  f"fleet run {label}: an executed frame without finite logits")
        return fs, counts, wall

    # run A: bucketed, telemetry on; run B: exact
    rt_a = build(BucketingConfig(n_edges=2))
    tel = telemetry.Telemetry(telemetry.TelemetryConfig(stream_sample=1))
    fs_a, counts_a, wall_a = counted_run("A (bucketed)", rt_a, tel)
    stacked_a = max(meter.stacked, default=0)
    rt_b = build(None)
    fs_b, counts_b, _ = counted_run("B (exact)", rt_b)
    err = 0.0
    for fa, fb in zip(fs_a.all_frames, fs_b.all_frames):
        check((fa.alpha, fa.split, fa.payload_bytes) == (fb.alpha, fb.split, fb.payload_bytes)
              and (fa.latency_s, fa.queue_s, fa.violated, fa.accuracy, fa.bandwidth_bps)
              == (fb.latency_s, fb.queue_s, fb.violated, fb.accuracy, fb.bandwidth_bps),
              "fleet runs A and B disagree on the timing plane")
        check(torch.allclose(fa.logits.float(), fb.logits.float(), **BATCH_BF16),
              "fleet runs A and B disagree on the logits")
        err = max(err, (fa.logits.float() - fb.logits.float()).abs().max().item())
    check(len(fs_a.all_frames) == len(fs_b.all_frames)
          and fs_a.batch_sizes == fs_b.batch_sizes, "fleet runs A and B differ in shape")
    rec = tel.reconcile(fs_a)
    n_padded = rt_a.plan_cache.traces_by_kind.get("cloud_padded", 0)
    print(f"[fleet aggregate] run A frames={len(fs_a.all_frames)} "
          f"viol%={100*fs_a.violation_ratio:.1f} p50={fs_a.p50_latency_s*1e3:.1f}ms "
          f"p99={fs_a.p99_latency_s*1e3:.1f}ms queue={fs_a.avg_queue_s*1e3:.2f}ms "
          f"drop%={100*fs_a.drop_ratio:.1f} cloud_util={100*fs_a.cloud_utilization:.1f}% "
          f"avg_batch={fs_a.avg_batch_size:.2f} fps={fs_a.aggregate_fps:.1f} "
          f"accuracy={fs_a.avg_accuracy:.4f}")
    print(f"[fleet] splits {dict(sorted(collections.Counter(f.split for f in fs_a.all_frames).items()))}, "
          f"alphas {dict(sorted(collections.Counter(round(f.alpha, 2) for f in fs_a.all_frames).items()))}, "
          f"cloud micro-batch sizes {dict(sorted(collections.Counter(fs_a.batch_sizes).items()))}")
    print(f"[fleet] A vs B: decisions, payloads and timing plane identical, "
          f"max|logits A-B|={err:.3e} tol={BATCH_BF16}; largest stacked cloud forward "
          f"{stacked_a} frames; cloud_padded traces {n_padded} <= bucket cells "
          f"{rt_a.buckets.n_cells}; telemetry spans={tel.spans_total} reconcile="
          f"{'ok' if rec['ok'] else 'MISMATCH ' + repr(rec)}")
    check(stacked_a > 1, "no cloud forward of the fleet stacked more than one frame")
    check(rec["ok"], "fleet telemetry does not reconcile")
    check(n_padded <= rt_a.buckets.n_cells, "cloud_padded traces exceed the bucket cells")

    # the simulator alone on the same traffic (timing plane, no model math)
    rt_sim = workload.build_runtime(spec, profile, dataclasses.replace(eng_cfg, execute=False),
                                    device="cuda")
    t0 = time.perf_counter()
    fs_sim = rt_sim.run()
    sim_s = time.perf_counter() - t0
    print(f"[fleet] simcore alone (execute off, same traffic): {sim_s * 1e6 / len(fs_sim.all_frames):.1f} "
          f"us per frame; fleet run A {wall_a * 1e6 / len(fs_a.all_frames):.1f} us per frame")

    # run C: a one-stream fleet against the single-stream engine
    trace = bandwidth.synthetic_trace("5g", "walking", steps=8, seed=5)
    meter.reset()
    zero_counts()
    with meter:
        st_engine = engine.JanusEngine(profile, eng_cfg, model_cfg=cfg, params=params,
                                       device="cuda").run_trace(trace, 8, images=images)
        rt_c = fleet.FleetRuntime(profile, eng_cfg, [fleet.StreamSpec(trace, 8)],
                                  cloud=fleet.CloudTierConfig(max_batch=1), model_cfg=cfg,
                                  params=params, device="cuda")
        st_fleet = rt_c.run(images=images).per_stream[0]
    counts_c = read_counts()
    check(counts_c["flash_attention_mma"] == meter.implied["flash"]
          and counts_c["tome_scores"] == meter.implied["tome"]
          and counts_c["flash_attention"] == 0, "fleet run C launch counts")
    same = [f.latency_s for f in st_fleet.frames] == [f.latency_s for f in st_engine.frames] \
        and [f.payload_bytes for f in st_fleet.frames] == [f.payload_bytes for f in st_engine.frames]
    bit_equal = all(torch.equal(a.logits, b.logits)
                    for a, b in zip(st_fleet.frames, st_engine.frames))
    print(f"[fleet] run C: one-stream fleet vs run_trace on {trace.name}, 8 frames "
          f"(splits {[f.split for f in st_fleet.frames]}): latencies and payloads "
          f"{'equal' if same else 'DIFFER'}, logits {'bit-equal' if bit_equal else 'DIFFER'}; "
          f"launches {counts_c}")
    check(len(st_fleet.frames) == len(st_engine.frames) == 8 and same and bit_equal,
          "the one-stream fleet differs from the single-stream engine")

    # the CLI's fleet mode on the card (the reduced ViT, as the reference CLI)
    zero_counts()
    serve.main(["--streams", "4", "--frames", "5", "--execute", "--bucket-edges", "2"])
    counts_cli = read_counts()
    print(f"[fleet] CLI --streams 4 --frames 5 --execute --bucket-edges 2: launches {counts_cli}")
    check(counts_cli["flash_attention"] > 0, "the CLI's fleet mode launched no kernel")

    # where run A's time goes: torch.profiler (CUDA activity only: a fleet run
    # is ~10^5 launches) over a fresh run A
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    rt_t = build(BucketingConfig(n_edges=2))
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rt_t.run(images=images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = report_profile(f"fleet run A (telemetry off), {len(fs_a.all_frames)} frames",
                             prof, wall_ms)
    run_a = {"frames": fs_a.all_frames, "counts": counts_a, "wall": wall_a,
             "idle": 1 - busy_ms / wall_ms}
    return ({name: counts_a[name] + counts_b[name] + counts_c[name] for name in counts_a},
            counts_cli, run_a)


def mesh_phase(torch, cfg, params, images, run_a: dict) -> dict[str, int]:
    """Run A's fleet (``_fleet_spec``, bucketed, telemetry on) with
    ``mesh_rules`` on the (1,1) host mesh (a one-rank NCCL group), once
    under ``dp`` and once under ``tp``: the params placed as views, every
    partition on DTensors, the kernels behind the local boundary. Each run's
    executed frames must have run A's latencies and logits within
    ``BATCH_BF16``, and launch exactly run A's flash_mma and tome_scores
    (which the plans imply); before it, a warm-up run and a profiled run of
    each (its idle share).
    Returns the launch counts of the two counted runs."""
    from repro_torch.configs import janus_vit_l384
    from repro_torch.core import engine
    from repro_torch.core.bucketing import BucketingConfig
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import telemetry, workload
    from repro_torch.sharding.rules import make_rules
    from torch.distributed.tensor import DTensor
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    profile = serve.make_profile(janus_vit_l384.CONFIG)
    eng_cfg = engine.EngineConfig(sla_s=0.3, execute=True, include_scheduler_overhead=False)
    spec = _fleet_spec(workload)
    mesh = make_host_mesh(device="cuda")
    meter = FleetMeter(torch, cfg)
    frames_a, counts_a = run_a["frames"], run_a["counts"]
    n_a = len(frames_a)
    total: dict[str, int] = {}
    for name in ("dp", "tp"):
        rules = make_rules(name, mesh)

        def build():
            return workload.build_runtime(spec, profile, eng_cfg, model_cfg=cfg, params=params,
                                          bucketing=BucketingConfig(n_edges=2),
                                          mesh_rules=rules, device="cuda")

        rt = build()
        check(isinstance(rt.params["blocks"]["attn"]["wq"], DTensor)
              and rt.params["blocks"]["attn"]["wq"].to_local().data_ptr()
              == params["blocks"]["attn"]["wq"].data_ptr(), f"mesh {name}: params not views")
        # one run to fill DTensor's sharding-propagation caches (the earlier
        # phases warmed run A's path likewise), then the profiled run
        build().run(images=images)
        rt_t = build()
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rt_t.run(images=images)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = report_profile(f"mesh {name} fleet run A (telemetry off), {n_a} frames", prof,
                                 wall_ms)
        tel = telemetry.Telemetry(telemetry.TelemetryConfig(stream_sample=1))
        meter.reset()
        zero_counts()
        with meter:
            t0 = time.perf_counter()
            fs = rt.run(images=images, telemetry=tel)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = read_counts()
        frames = fs.all_frames
        check(len(frames) == n_a, f"mesh {name}: {len(frames)} executed frames, run A {n_a}")
        same_latency = all(f.latency_s == a.latency_s for f, a in zip(frames, frames_a))
        err = max((f.logits.float() - a.logits.float()).abs().max().item()
                  for f, a in zip(frames, frames_a))
        bit_equal = all(torch.equal(f.logits, a.logits) for f, a in zip(frames, frames_a))
        print(f"[mesh] fleet run A under {name} on {mesh}: wall {wall:.3f} s, "
              f"{n_a / wall:.2f} frames/s (run A {run_a['wall']:.3f} s, "
              f"{n_a / run_a['wall']:.2f}); idle share {1 - busy_ms / wall_ms:.3f} (run A "
              f"{run_a['idle']:.3f}); launches a frame flash_mma "
              f"{counts['flash_attention_mma'] / n_a:.2f}, tome_scores "
              f"{counts['tome_scores'] / n_a:.2f} (run A {counts_a['flash_attention_mma'] / n_a:.2f}, "
              f"{counts_a['tome_scores'] / n_a:.2f}); latencies "
              f"{'equal' if same_latency else 'DIFFER'}, max|logits - run A| {err:.3e} "
              f"({'bit-equal' if bit_equal else 'not bit-equal'}, tol {BATCH_BF16}); "
              f"plan cache traces {rt.plan_cache.traces_by_kind}")
        check(same_latency, f"mesh {name}: latencies differ from run A's")
        check(all(torch.allclose(f.logits.float(), a.logits.float(), **BATCH_BF16)
                  for f, a in zip(frames, frames_a)), f"mesh {name}: logits differ from run A's")
        check(counts["flash_attention_mma"] == counts_a["flash_attention_mma"]
              == meter.implied["flash"] and counts["tome_scores"] == counts_a["tome_scores"]
              == meter.implied["tome"], f"mesh {name}: launches differ from run A's")
        check(counts["flash_attention"] == counts["decode_attention"]
              == counts["decode_attention_mma"] == 0,
              f"mesh {name} launched a CUDA-core flash or a decode kernel")
        for key, n in counts.items():
            total[key] = total.get(key, 0) + n
    return total


# ---------------------------------------------------------------------- parity

def _recording_matches(fn):
    """``fn()`` with ``tome.bipartite_soft_matching`` wrapped to record each
    merge layer's indices and metric: (output, record)."""
    from repro_torch.core import tome

    matching = tome.bipartite_soft_matching
    record = []

    def recording(metric, r, **kw):
        idx = matching(metric, r, **kw)
        record.append((idx, metric))
        return idx

    tome.bipartite_soft_matching = recording
    try:
        return fn(), record
    finally:
        tome.bipartite_soft_matching = matching


def parity_phase(torch) -> tuple[dict[str, int], dict[str, int]]:
    """ViT-L@384 in f32 on the card, through the kernels against the plain
    versions: ``vit.forward_janus`` at alpha 0.27 (logits, and the merge
    indices of every merge layer), then the vanilla ``vit.forward``. Returns
    the launch counts of the two kernel runs."""
    from repro_torch.core import pruning
    from repro_torch.kernels import ops
    from repro_torch.models import vit

    cfg, params, images = _vit_l(torch, torch.float32)
    alpha = 0.27  # the planner grid's largest α: merges at all 24 layers
    sched = tuple(pruning.make_schedule("exponential", alpha, cfg.n_layers, cfg.num_tokens))

    def forward_recording():
        logits, record = _recording_matches(
            lambda: vit.forward_janus(params, cfg, images, sched))
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
    check(counts == _expect(flash_attention=cfg.n_layers, tome_scores=n_merge),
          "f32 ViT launch counts")

    zero_counts()
    forward_k = vit.forward(params, cfg, images)
    forward_counts = read_counts()
    with ops.plain_versions():
        forward_p = vit.forward(params, cfg, images)
    torch.cuda.synchronize()
    err = (forward_k - forward_p).abs().max().item()
    ok = torch.allclose(forward_k, forward_p, **PARITY_F32)
    exp = _expect(flash_attention=cfg.n_layers)
    print(f"[parity] ViT-L@384 f32 vit.forward B=1: kernels vs plain max|dlogits|={err:.3e} "
          f"tol={PARITY_F32}, launches of the kernel run {forward_counts} (implies {exp}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "f32 vit.forward parity failed")
    check(forward_counts == exp, "f32 vit.forward launch counts")
    return counts, forward_counts


# -------------------------------------------------------------------------- lm

LM_BATCH, LM_PROMPT, LM_STEPS, LM_CAPACITY = 8, 1024, 64, 2048


def _lm(torch, module, dtype, **replace):
    """A model of the port's LM family at its CONFIG's widths, random weights
    drawn on the card from seed 0 (``replace`` cuts depth or sets options)."""
    from repro_torch.models import lm, param
    cfg = dataclasses.replace(module.CONFIG, dtype=dtype, **replace)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return cfg, param.init_params(lm.specs(cfg), gen, "cuda", dtype=dtype)


def _cache_buffers(cache) -> list:
    return list(cache.values()) if isinstance(cache, dict) else [
        t for layer in cache for t in layer.values()]


def _describe(cfg) -> str:
    moe = cfg.moe
    ffn = (f"{moe.n_experts} experts (padded to {moe.e_pad}) top-{moe.top_k} of d_ff "
           f"{moe.d_ff}, groups of {moe.group_size}" if moe else f"d_ff={cfg.d_ff}")
    return (f"{cfg.n_layers} layers, d={cfg.d_model}, {cfg.n_heads} q heads over {cfg.n_kv} kv "
            f"heads of {cfg.hd}{', qk-norm' if cfg.qk_norm else ''}, {ffn}, vocab={cfg.vocab}; "
            f"cache {cfg.cache_layout}, {str(cfg.cache_dtype)[6:]}")


def serve_phase(torch, tag: str, name: str, cfg, params, steps: int) -> tuple[dict, dict]:
    """LM serving through ``lm.prefill`` and ``lm.decode_step``: prefill of
    8 x 1024 random tokens into a cache of capacity 2048, then ``steps``
    greedy decode steps, each closed by a synchronize; the launch counters
    are zeroed just before and read just after, and must be exactly one
    tensor-core flash launch a layer and one tensor-core decode launch a
    layer and step. Under sharding rules the logits come back as DTensors and
    are read as global tensors. Returns (counts, state: the last token, the
    cache, the prompt, the greedy tokens [B, steps + 1] and the timings)."""
    from repro_torch.models import lm, param
    from repro_torch.sharding.rules import to_global

    weights_gb = _weights_gb(param, params)
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), dtype=torch.int32, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    print(f"[{tag}] {name} {str(cfg.dtype)[6:]}: {_describe(cfg)}; weights {weights_gb:.3f} GB "
          f"on {torch.cuda.get_device_name(0)}")
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
    logits = to_global(logits)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = logits[:, -1].argmax(-1, keepdim=True).int()
    finite, step_ms, generated = [torch.isfinite(logits).all()], [], [tok]
    for i in range(steps):
        t0 = time.perf_counter()
        logits, cache = lm.decode_step(params, cfg, tok, cache, LM_PROMPT + i)
        logits = to_global(logits)
        tok = logits[:, -1].argmax(-1, keepdim=True).int()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        finite.append(torch.isfinite(logits).all())
        generated.append(tok)
    counts = read_counts()

    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    buffers = _cache_buffers(cache)
    ordered = sorted(step_ms)
    print(f"[{tag}] prefill B={LM_BATCH} x {LM_PROMPT} tokens into a cache of {LM_CAPACITY} "
          f"({sum(t.numel() * t.element_size() for t in buffers) / 1e6:.0f} MB in "
          f"{len(buffers)} buffers): {prefill_ms:.2f} ms "
          f"({LM_BATCH * LM_PROMPT / prefill_ms * 1e3:.0f} prompt tokens/s)")
    print(f"[{tag}] decode {steps} greedy steps of B={LM_BATCH} (cache length "
          f"{LM_PROMPT + 1}..{LM_PROMPT + steps}): per step median "
          f"{ordered[len(ordered) // 2]:.2f} ms, max {ordered[-1]:.2f} ms, first "
          f"{step_ms[0]:.2f} ms; {LM_BATCH * steps / sum(step_ms) * 1e3:.1f} generated tokens/s")
    print(f"[{tag}] step ms: {' '.join(f'{t:.2f}' for t in step_ms)}")
    print(f"[{tag}] weights {weights_gb:.3f} GB, max_memory_allocated {peak_gb:.3f} GB")
    exp = _expect(flash_attention_mma=cfg.n_layers, decode_attention_mma=cfg.n_layers * steps)
    print(f"[{tag}] launches: {counts} (prefill and {steps} steps imply {exp})")
    check(tuple(logits.shape) == (LM_BATCH, 1, cfg.vocab), f"{name} decode logits shape")
    check(bool(torch.stack(finite).all()), f"non-finite {name} logits")
    check(all(t.dtype == cfg.cache_dtype for t in buffers), f"{name} cache dtype")
    check(counts == exp, f"{name} launch counts")
    return counts, {"tok": tok, "cache": cache, "tokens": tokens, "steps": steps,
                    "generated": torch.cat(generated, dim=1), "prefill_ms": prefill_ms,
                    "step_ms": ordered[len(ordered) // 2],
                    "tok_s": LM_BATCH * steps / sum(step_ms) * 1e3, "peak_gb": peak_gb}


def trace_serving(torch, tag: str, cfg, params, state: dict, moe_split: bool = False) -> None:
    """torch.profiler over one decode step at the next cache position, then
    (the cache freed) over the prefill; ``moe_split`` splits the MoE layers'
    kernel time (``profile_once``)."""
    from repro_torch.models import lm

    from torch.autograd import DeviceType

    index = LM_PROMPT + state["steps"]
    tok, cache, tokens = state.pop("tok"), state.pop("cache"), state.pop("tokens")
    label = f"{tag} decode step B={LM_BATCH} at cache length {index + 1}"
    prof, _, _ = profile_once(torch, label,
                              lambda: lm.decode_step(params, cfg, tok, cache, index), moe_split)
    decode = [ev for ev in prof.events()
              if ev.device_type == DeviceType.CUDA and DECODE_MMA_KERNEL.search(ev.name)]
    if cfg.dtype == torch.bfloat16 and any(ev.device_type == DeviceType.CUDA
                                           for ev in prof.events()):
        print(f"[trace] {label}: decode_attention_mma {len(decode)} kernels on the card for "
              f"{cfg.n_layers} layers (one launch a call: the splits combined in it)")
        check(len(decode) == cfg.n_layers, f"{tag}: {len(decode)} decode kernels in a step of "
                                           f"{cfg.n_layers} layers")
    del cache
    profile_once(torch, f"{tag} prefill B={LM_BATCH} x {LM_PROMPT} tokens",
                 lambda: lm.prefill(params, cfg, tokens, max_len=LM_CAPACITY), moe_split)


def lm_phase(torch) -> dict[str, int]:
    """starcoder2-3b bf16 serving (``serve_phase``, 64 steps), then
    torch.profiler over one decode step and over the prefill."""
    from repro_torch.configs import starcoder2_3b

    cfg, params = _lm(torch, starcoder2_3b, torch.bfloat16)
    counts, state = serve_phase(torch, "lm", "starcoder2-3b", cfg, params, LM_STEPS)
    trace_serving(torch, "lm", cfg, params, state)
    return counts


def moe_phase(torch) -> tuple[dict[str, int], dict[str, int], dict[str, int]]:
    """qwen3-moe-30b-a3b bf16 at all 48 layers and full widths (61 GB of
    weights on the card): ``serve_phase`` with 64 steps on the stacked bf16
    cache, traced, then (``moe_cache``) the same weights on the per-layer
    int8 cache (scale 0.05) for 16 steps, then (``mesh_moe_phase``) the same
    weights through ``moe_a2a`` on the (1,1) mesh."""
    from repro_torch.configs import qwen3_moe_30b_a3b

    t0 = time.perf_counter()
    cfg, params = _lm(torch, qwen3_moe_30b_a3b, torch.bfloat16)
    torch.cuda.synchronize()
    print(f"[moe] qwen3-moe-30b-a3b init on the card: {time.perf_counter() - t0:.1f} s, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    counts, state = serve_phase(torch, "moe", "qwen3-moe-30b-a3b", cfg, params, LM_STEPS)
    gspmd = {k: state[k] for k in ("prefill_ms", "step_ms", "tok_s", "peak_gb")}
    trace_serving(torch, "moe qwen3", cfg, params, state, moe_split=True)
    torch.cuda.empty_cache()
    cache_cfg = dataclasses.replace(cfg, cache_layout="per_layer", cache_quant_scale=0.05)
    cache_counts, state = serve_phase(torch, "moe_cache", "qwen3-moe-30b-a3b", cache_cfg, params,
                                      16)
    check(len(state["cache"]) == cfg.n_layers, "per-layer cache: one buffer pair a layer")
    del state
    torch.cuda.empty_cache()
    return counts, cache_counts, mesh_moe_phase(torch, cfg, params, gspmd)


A2A_COLLECTIVES = 6  # a layer: 3 all-to-alls, 1 all-gather, 1 all-reduce per mesh axis (2)


def mesh_moe_phase(torch, cfg, params, gspmd: dict) -> dict[str, int]:
    """qwen3-moe-30b-a3b bf16, the ``[moe]`` weights (no second init), with
    ``moe_impl="a2a"`` under ``ep_tp`` rules on the (1,1) host mesh (a
    one-rank NCCL group): the params placed as views (memory before and
    after), ``serve_phase``'s traffic (B=8 x 1024 + 64 greedy steps on the
    stacked cache: flash_mma at the prefill, decode_mma at each step, one
    ``moe_a2a.apply`` a layer), its collectives counted (``moe_a2a``'s
    counter, and the profiler's NCCL ranges over one decode step), then the
    same path under ``plain_versions()``, whose routes and greedy tokens are
    printed beside the served run's: in bf16 a route flips wherever one
    rounding step of a router logit crosses the top-k boundary (the first
    difference is printed with the plain run's logit gap in bf16 steps), so
    the kernels are judged against the plain versions on this path in f32,
    by ``moe_parity_phase``'s a2a run. Returns the served run's launch
    counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm, moe_a2a
    from repro_torch.sharding.rules import make_rules, place_params, to_global, use_rules

    acfg = dataclasses.replace(cfg, moe_impl="a2a")
    rules = make_rules("ep_tp", make_host_mesh(device="cuda"))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    placed = place_params(params, lm.specs(cfg), rules)
    after = torch.cuda.memory_allocated()
    print(f"[mesh] qwen3-moe-30b-a3b a2a, ep_tp on {rules.mesh}: memory_allocated "
          f"{before / 1e9:.3f} GB before placing the weights, {after / 1e9:.3f} GB after "
          f"(views, no copy)")
    check(after == before, "placing the qwen3 weights allocated memory")

    route, routes, gaps = moe_a2a.route, [], []

    def recording_route(logits):
        probs, sorted_probs, order = route(logits)
        k = acfg.moe.top_k
        routes.append(order[:, :k])
        if gaps is not None:  # the plain run: the k-th - (k+1)-th logit, in bf16 steps
            top = logits.gather(1, order[:, k - 1:k + 1])
            gaps.append((top[:, 0] - top[:, 1]) / 2.0 ** (torch.floor(torch.log2(
                top[:, 0].abs())) - 7))
        return probs, sorted_probs, order

    n_calls = acfg.n_layers * (1 + LM_STEPS)
    moe_a2a.route = recording_route
    gaps = None
    try:
        with use_rules(rules):
            counts, state = serve_phase(torch, "mesh", "qwen3-moe-30b-a3b a2a", acfg, placed,
                                        LM_STEPS)
            collectives = moe_a2a.collectives
            routes_k = routes[-n_calls:]  # the served run's; serve_phase warms up first
            index = LM_PROMPT + LM_STEPS
            tok, cache = state.pop("tok"), state.pop("cache")
            prof, busy_ms, wall_ms = profile_once(
                torch, f"mesh qwen3 a2a decode step B={LM_BATCH} at cache length {index + 1}",
                lambda: lm.decode_step(placed, acfg, tok, cache, index))
            del cache
            profile_once(torch, f"mesh qwen3 a2a prefill B={LM_BATCH} x {LM_PROMPT} tokens",
                         lambda: lm.prefill(placed, acfg, state["tokens"], max_len=LM_CAPACITY))
            routes.clear()
            gaps = []
            with ops.plain_versions():
                logits, cache = lm.prefill(placed, acfg, state["tokens"], max_len=LM_CAPACITY)
                tok = to_global(logits)[:, -1].argmax(-1, keepdim=True).int()
                plain = [tok]
                for i in range(LM_STEPS):
                    logits, cache = lm.decode_step(placed, acfg, tok, cache, LM_PROMPT + i)
                    tok = to_global(logits)[:, -1].argmax(-1, keepdim=True).int()
                    plain.append(tok)
            del cache, logits
            routes_p = list(routes)
    finally:
        moe_a2a.route = route
    torch.cuda.synchronize()

    implied = n_calls * A2A_COLLECTIVES
    from torch.autograd import DeviceType
    nccl: dict[str, int] = {}
    for ev in prof.events():
        if ev.name.split(":")[0] in ("nccl", "gloo") and ev.device_type == DeviceType.CPU:
            nccl[ev.name] = nccl.get(ev.name, 0) + 1
    step_a2a = sum(n for key, n in nccl.items() if key.endswith(":all_to_all"))
    print(f"[mesh] a2a collectives: {collectives} in the prefill and {LM_STEPS} steps "
          f"(the code implies {acfg.n_layers} layers x {A2A_COLLECTIVES} x {1 + LM_STEPS} "
          f"calls = {implied}); collective ranges the profiler saw in one decode step: {nccl} "
          f"(all-to-all implied {3 * acfg.n_layers})")
    check(collectives == implied, "a2a collective count")
    check(step_a2a == 3 * acfg.n_layers, "the profiler's NCCL all-to-alls in a decode step")

    check(len(routes_k) == len(routes_p) == len(gaps) == n_calls, "a2a routes recorded")
    got, want = state["generated"], torch.cat(plain, dim=1)
    same = int((got == want).all(dim=0).sum())
    first = next((call for call, (ek, ep) in enumerate(zip(routes_k, routes_p))
                  if not torch.equal(ek, ep)), None)
    if first is None:
        print(f"[mesh] bf16 kernels vs plain: routes identical, greedy tokens identical at "
              f"{same}/{got.shape[1]} positions")
    else:
        differ = (routes_k[first] != routes_p[first]).any(dim=-1)
        where = "prefill" if first < acfg.n_layers else f"step {first // acfg.n_layers - 1}"
        print(f"[mesh] bf16 kernels vs plain (not judged in bf16; the f32 a2a parity "
              f"judges): first route difference at the {where}, layer "
              f"{first % acfg.n_layers}, {int(differ.sum())} of {differ.numel()} tokens, the "
              f"plain run's k-th vs (k+1)-th router logit gap there at most "
              f"{gaps[first][differ].max().item():.2f} bf16 steps; greedy tokens identical at "
              f"{same}/{got.shape[1]} positions")
    print(f"[mesh] qwen3 a2a vs [moe] gspmd ({torch.cuda.get_device_name(0)}, same weights "
          f"and prompts): prefill "
          f"{state['prefill_ms']:.2f} vs {gspmd['prefill_ms']:.2f} ms, step median "
          f"{state['step_ms']:.2f} vs {gspmd['step_ms']:.2f} ms, {state['tok_s']:.1f} vs "
          f"{gspmd['tok_s']:.1f} generated tokens/s, peak {state['peak_gb']:.3f} vs "
          f"{gspmd['peak_gb']:.3f} GB; decode step idle share {1 - busy_ms / wall_ms:.3f}")
    check(state["peak_gb"] < 80.0, "a2a serving peak memory")
    return counts


def granite_phase(torch) -> dict[str, int]:
    """granite-moe-3b-a800m bf16 at full size (32 layers, experts padded
    40 -> 48, D=64, tied embeddings): ``serve_phase`` with 16 steps."""
    from repro_torch.configs import granite_moe_3b_a800m

    cfg, params = _lm(torch, granite_moe_3b_a800m, torch.bfloat16)
    counts, _ = serve_phase(torch, "moe", "granite-moe-3b-a800m", cfg, params, 16)
    return counts


def lm_parity_phase(torch) -> dict[str, int]:
    """starcoder2-3b in f32 on the card, through the kernels against the
    plain versions: prefill of 2 x 256 tokens, then 8 teacher-forced decode
    steps (both runs get the same tokens, so a near-tie cannot make them
    diverge). Logits must agree at every step."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    from repro_torch.configs import starcoder2_3b

    cfg, params = _lm(torch, starcoder2_3b, torch.float32)
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
    exp = _expect(flash_attention=cfg.n_layers, decode_attention=cfg.n_layers * steps)
    print(f"[lm parity] launches of the kernel run: {counts} (implies {exp})")
    check(ok, "f32 LM parity failed")
    check(counts == exp, "f32 LM launch counts")
    return counts


NEAR_TIE = 1e-5   # a route flip where the plain run's top-k margin is below this: a near-tie
INT8_NEAR = 1e-3  # an int8 flip must lie this close to a rounding boundary (|x/scale|)


def moe_parity_phase(torch) -> tuple[dict[str, int], dict[str, int], dict[str, int]]:
    """qwen3-moe-30b-a3b in f32 on the card, cut to 4 of its 48 layers at
    full widths (12.5 GB; all 48 in f32 would take 122 GB), through the
    kernels against the plain versions: prefill of 2 x 256 tokens, then 8
    teacher-forced steps, once on the stacked f32 cache, once on the
    per-layer int8 cache (scale 0.05), and once (``[mesh]``) with
    ``moe_impl="a2a"`` under ``ep_tp`` rules on the (1,1) host mesh (the
    params placed as views; routes recorded in ``moe_a2a.route``), where
    with identical routes each step's greedy token (the argmax of its
    logits) must also be the plain run's.

    Routes first: the top-k experts of every token at every layer and call.
    A route that differs where the plain run's margin between the k-th and
    (k+1)-th router probability is under ``NEAR_TIE`` is a near-tie: it is
    printed with its margin, and that run's logits are not compared. Any
    other route difference fails. With identical routes, the logits of the
    prefill and of every step are held to ``PARITY_F32``. On the int8 cache
    an entry may be one step apart where its unrounded ``|x/scale|`` lies
    within ``INT8_NEAR`` of a rounding boundary; the entries written after
    the first such flip are downstream of it and not judged (counted)."""
    from repro_torch.configs import qwen3_moe_30b_a3b
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers, lm, moe, moe_a2a, param
    from repro_torch.sharding.rules import make_rules, place_params, to_global, use_rules

    cfg, params = _lm(torch, qwen3_moe_30b_a3b, torch.float32, n_layers=4)
    rules = make_rules("ep_tp", make_host_mesh(device="cuda"))
    placed = place_params(params, lm.specs(cfg), rules)
    weights_gb = sum(t.numel() * t.element_size()
                     for t in param.flatten(params).values()) / 1e9
    prompt, steps, n_layers = 256, 8, cfg.n_layers
    tokens = torch.randint(0, cfg.vocab, (2, prompt + steps), dtype=torch.int32, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(2))
    route, quantize, a2a_route = moe.route, layers._quantize, moe_a2a.route

    def run(c):
        """Logits of the prefill and of each step, the cache, the routes
        ((experts, the top-k margin) a token, per call) and the int8
        entries' unrounded ``x / scale`` in write order."""
        routes, unrounded = [], []

        def recording_route(mcfg, logits):
            gates, experts = route(mcfg, logits)
            probs = torch.softmax(logits.to(mcfg.router_dtype), dim=-1)
            top = probs.sort(dim=-1, descending=True).values
            margin = top[..., mcfg.top_k - 1] - top[..., mcfg.top_k]
            routes.append((experts.reshape(-1, mcfg.top_k), margin.reshape(-1)))
            return gates, experts

        def recording_quantize(t, scale, dtype):
            if scale is not None:
                unrounded.append(t.float() / scale)
            return quantize(t, scale, dtype)

        def recording_a2a_route(logits):
            probs, sorted_probs, order = a2a_route(logits)
            k = c.moe.top_k
            routes.append((order[:, :k], sorted_probs[:, k - 1] - sorted_probs[:, k]))
            return probs, sorted_probs, order

        a2a = c.moe_impl == "a2a"
        moe.route, layers._quantize = recording_route, recording_quantize
        moe_a2a.route = recording_a2a_route
        try:
            with use_rules(rules if a2a else None):
                p = placed if a2a else params
                logits, cache = lm.prefill(p, c, tokens[:, :prompt], max_len=prompt + steps)
                out = [to_global(logits)]
                for i in range(steps):
                    logits, cache = lm.decode_step(p, c, tokens[:, prompt + i:prompt + i + 1],
                                                   cache, prompt + i)
                    out.append(to_global(logits))
        finally:
            moe.route, layers._quantize, moe_a2a.route = route, quantize, a2a_route
        if isinstance(cache, dict):
            cache = {n: to_global(t) for n, t in cache.items()}
        return out, cache, routes, unrounded

    def stacked(cache):
        if isinstance(cache, dict):
            return cache["k"], cache["v"]
        return tuple(torch.stack([layer[n] for layer in cache]) for n in "kv")

    def shadow(unrounded):
        """[L, B, S, kv, hd] of the unrounded k and v, from the write order:
        the prefill's k, v a layer, then each step's k, v a layer."""
        it = iter(unrounded)
        out = [torch.zeros((n_layers, 2, prompt + steps, cfg.n_kv, cfg.hd), device="cuda")
               for _ in "kv"]
        for l in range(n_layers):
            for buf in out:
                buf[l, :, :prompt] = next(it)
        for i in range(steps):
            for l in range(n_layers):
                for buf in out:
                    buf[l, :, prompt + i] = next(it)
        return out

    print(f"[moe_parity] qwen3-moe-30b-a3b f32: {_describe(cfg)} (cut from 48 layers: 48 in "
          f"f32 need 122 GB); weights {weights_gb:.3f} GB; B=2, prompt {prompt} + {steps} "
          f"teacher-forced steps")
    all_counts = []
    for label, c in (("stacked f32 cache", cfg),
                     ("per-layer int8 cache", dataclasses.replace(
                         cfg, cache_layout="per_layer", cache_quant_scale=0.05)),
                     ("a2a, ep_tp on the (1,1) mesh", dataclasses.replace(cfg, moe_impl="a2a"))):
        t0 = time.perf_counter()
        zero_counts()
        lk, ck, rk, uk = run(c)
        counts = read_counts()
        with ops.plain_versions():
            lp, cp, rp, _ = run(c)
        torch.cuda.synchronize()
        check(len(rk) == len(rp) == n_layers * (1 + steps), f"{label}: routes recorded")

        near_tie, downstream = None, 0
        for call, ((ek, _), (ep, margin)) in enumerate(zip(rk, rp)):
            differ = (ek != ep).any(dim=-1)
            if not bool(differ.any()):
                continue
            if near_tie is not None:
                downstream += int(differ.sum())
                continue
            where = "prefill" if call < n_layers else f"step {call // n_layers - 1}"
            for token, m in zip(differ.nonzero()[:, 0].tolist(), margin[differ].tolist()):
                print(f"[moe_parity] {label}: {where} layer {call % n_layers} token {token}: "
                      f"route differs, plain top-k margin {m:.3e}")
                check(m < NEAR_TIE, f"{label}: a route differs away from a near-tie "
                                    f"(margin {m:.3e} >= {NEAR_TIE})")
            near_tie = call
        n_routes = sum(e.shape[0] for e, _ in rk)

        errs = [(a - b).abs().max().item() for a, b in zip(lk, lp)]
        (kk, vk), (kp, vp) = stacked(ck), stacked(cp)
        if c.cache_quant_scale is None:
            cache_err = max((kk - kp).abs().max().item(), (vk - vp).abs().max().item())
            cache_ok = (torch.allclose(kk, kp, **PARITY_F32)
                        and torch.allclose(vk, vp, **PARITY_F32))
            cache_note = f"max|dcache| {cache_err:.3e}"
        else:
            flips = int((kk != kp).sum() + (vk != vp).sum())
            judged, first_flip = judged_entries(kk != kp, vk != vp, prompt)
            cache_ok = True
            for a, b, x in zip((kk, vk), (kp, vp), shadow(uk)):
                differ = (a != b) & judged[:, None, :, None, None]
                step = (a.int() - b.int()).abs()[differ]
                gap = ((x.abs() % 1.0) - 0.5).abs()[differ]
                cache_ok = cache_ok and bool((step == 1).all()) and bool((gap < INT8_NEAR).all())
            cache_note = (f"int8 entries one step apart {flips} of "
                          f"{kk.numel() + vk.numel()}, first at position {first_flip} "
                          f"(one step, within {INT8_NEAR} of a rounding boundary: {cache_ok})")
        if near_tie is not None:
            logits_ok = True
            verdict = (f"near-tie at call {near_tie} ({downstream} route differences "
                       "downstream of it): logits not compared")
        else:
            logits_ok = all(torch.allclose(a, b, **PARITY_F32) for a, b in zip(lk, lp))
            verdict = f"routes identical ({n_routes} token-layers)"
            if c.moe_impl == "a2a":
                greedy = [torch.equal(a.argmax(-1), b.argmax(-1)) for a, b in zip(lk, lp)]
                logits_ok = logits_ok and all(greedy)
                verdict += f", greedy tokens identical at {sum(greedy)}/{len(greedy)} calls"
        ok = logits_ok and cache_ok
        print(f"[moe_parity] {label}: kernels vs plain: {verdict}; max|dlogits| prefill "
              f"{errs[0]:.3e}, steps {' '.join(f'{e:.2e}' for e in errs[1:])}; {cache_note}; "
              f"tol={PARITY_F32}; |logits| max {lp[-1].abs().max().item():.2f}; "
              f"{time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
        exp = _expect(flash_attention=n_layers, decode_attention=n_layers * steps)
        print(f"[moe_parity] {label}: launches of the kernel run: {counts} (implies {exp})")
        check(ok, f"qwen3 f32 MoE parity failed ({label})")
        check(counts == exp, f"qwen3 f32 MoE launch counts ({label})")
        all_counts.append(counts)
        del lk, ck, lp, cp, rk, rp, uk
    return all_counts[0], all_counts[1], all_counts[2]


def judged_entries(differ_k, differ_v, prompt: int):
    """Which int8 cache positions, per layer, are not downstream of a flip:
    ([L, S] bool, the first flipped position, or S). Prefill entries never
    are (the prefill attends over unquantized k/v). A decode step's entries
    are downstream of every flip at an earlier position, and of one at its
    own position in an earlier layer."""
    flip_at = (differ_k | differ_v).any(dim=4).any(dim=3).any(dim=1)  # [L, S]
    n_layers, s = flip_at.shape
    positions = flip_at.any(dim=0).nonzero()[:, 0]
    first = int(positions.min()) if positions.numel() else s
    judged = flip_at.new_zeros(flip_at.shape)
    judged[:, :max(prompt, first)] = True
    if prompt <= first < s:
        judged[:int(flip_at[:, first].nonzero()[:, 0].min()) + 1, first] = True
    return judged, first


# ------------------------------------------------------------------- diffusion

DIT_ALPHA_SCHEDULE = [955, 512, 274, 147, 78, 42, 22, 12, 6, 3, 1, 1]  # dit-s2 at 4096 tokens
FLUX_PARAMS = 11_901_414_464
FLUX_STEPS = {"gen_fast": 4, "gen_1024": 2}  # gen_1024 cut to 2 of its 50 steps
PEAK_BF16_NAME = "989 TFLOP/s (H100 SXM bf16 dense)"


def _redraw_zeros(torch, specs, params, seed: int, std: float = 0.02) -> None:
    """adaLN-zero initialises the modulations and final projections to zero,
    which gates every block to the identity and makes the output exactly 0:
    no kernel error could show. Redraw every ``init="zeros"`` leaf from
    N(0, std^2) on the card (a stacked leaf a layer at a time)."""
    from repro_torch.models import param

    gen = torch.Generator(device="cuda").manual_seed(seed)
    flat = param.flatten(params)
    for key, spec in param.flatten(specs).items():
        if spec.init != "zeros":
            continue
        t = flat[key]
        for part in (t if spec.axes and spec.axes[0] == "layers" else [t]):
            part.copy_(std * torch.randn(part.shape, generator=gen, device="cuda"))


def _n_params(param, params) -> int:
    return sum(t.numel() for t in param.flatten(params).values())


def _weights_gb(param, params) -> float:
    return sum(t.numel() * t.element_size() for t in param.flatten(params).values()) / 1e9


def _dit(torch, dtype, shape_name: str):
    """dit-s2 at a registry shape: (cfg, params drawn on the card with the
    zero leaves redrawn, shape)."""
    from repro_torch import configs
    from repro_torch.models import dit, param

    arch = configs.get_arch("dit-s2")
    shape = arch.shape(shape_name)
    cfg = dataclasses.replace(configs.config_for_shape(arch, shape), dtype=dtype)
    specs = dit.specs(cfg)
    params = param.init_params(specs, torch.Generator(device="cuda").manual_seed(0), "cuda",
                               dtype=dtype)
    _redraw_zeros(torch, specs, params, 1)
    return cfg, params, shape


def _dit_schedule(cfg) -> list[int]:
    from repro_torch.core import pruning
    alpha = pruning.alpha_max(cfg.n_layers, cfg.num_tokens)
    return pruning.make_schedule("exponential", alpha, cfg.n_layers, cfg.num_tokens)


def _nz(counts: dict[str, int]) -> dict[str, int]:
    """The nonzero launch counts, for printing."""
    return {name: n for name, n in counts.items() if n}


def _expect(**counts) -> dict[str, int]:
    exp = {"flash_attention_mma": 0, "flash_attention": 0, "flash_attention_mma_bwd": 0,
           "flash_attention_bwd": 0, "tome_scores": 0, "decode_attention_mma": 0,
           "decode_attention": 0}
    exp.update(counts)
    return exp


def dit_phase(torch) -> tuple[dict[str, int], dict[str, int]]:
    """dit-s2 bf16 at gen_1024 (B=4, 1024 px, 4096 tokens) sampled over all
    50 DDIM steps through ``diffusion.dit_sample``, dense and with the Janus
    schedule at alpha_max (4096 -> 2043 tokens); the launch counters are
    zeroed just before each run and read just after (flash_mma 12 a step,
    tome_scores one a merge layer and step). Then torch.profiler over one
    dense and one Janus forward."""
    from repro_torch.kernels import tome_scores as tome_mod
    from repro_torch.models import dit, param
    from repro_torch.training import diffusion

    cfg, params, shape = _dit(torch, torch.bfloat16, "gen_1024")
    b, steps = shape.batch, shape.steps
    sched = _dit_schedule(cfg)
    check(sched == DIT_ALPHA_SCHEDULE, f"dit-s2 schedule {sched}")
    merges = sum(1 for r in sched if r > 0)
    y = torch.randint(0, cfg.n_classes, (b,), generator=torch.Generator(device="cuda")
                      .manual_seed(3), device="cuda")
    print(f"[dit] dit-s2 {str(cfg.dtype)[6:]} at {shape.name}: {cfg.img_res} px, latent "
          f"{cfg.latent_res}x{cfg.latent_res}x{cfg.latent_channels}, {cfg.num_tokens} tokens, "
          f"{cfg.n_layers} layers d={cfg.d_model} {cfg.n_heads} heads of {cfg.head_dim}; "
          f"{_n_params(param, params)} parameters ({_weights_gb(param, params):.3f} GB); "
          f"Janus schedule {sched} ({cfg.num_tokens} -> {cfg.num_tokens - sum(sched)} tokens)")
    for s in (None, sched):  # warm-up outside the counted runs
        diffusion.dit_sample(params, cfg, torch.Generator(device="cuda").manual_seed(2), y, 1, s)
    torch.cuda.synchronize()
    counts, finals = {}, {}
    for label, s in (("dense", None), ("janus", sched)):
        zero_counts()
        t0 = time.perf_counter()
        x = diffusion.dit_sample(params, cfg, torch.Generator(device="cuda").manual_seed(2), y,
                                 steps, s)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[label] = read_counts()
        large = tome_mod.launches_large
        exp = _expect(flash_attention_mma=cfg.n_layers * steps,
                      tome_scores=merges * steps if s else 0)
        finals[label] = x.float()
        print(f"[dit] {label} B={b} x {steps} steps: {wall:.3f} s, {wall / steps * 1e3:.2f} "
              f"ms/step, {b / wall:.3f} images/s; |x| max {x.float().abs().max().item():.4g}; "
              f"launches {_nz(counts[label])} (implies {_nz(exp)})")
        check(tuple(x.shape) == (b, cfg.latent_res, cfg.latent_res, cfg.latent_channels),
              f"dit {label} output shape")
        check(bool(torch.isfinite(x).all()), f"non-finite dit {label} samples")
        check(counts[label] == exp, f"dit {label} launch counts")
        print(f"[dit] {label}: tome_scores on its large-grid route {large} of "
              f"{counts[label]['tome_scores']} launches")
        check(large == counts[label]["tome_scores"], f"dit {label}: merges off the large route")
    gap = (finals["janus"] - finals["dense"]).abs().max() / finals["dense"].abs().max()
    print(f"[dit] Janus vs dense samples: max|d| / max|dense| {gap.item():.4f}")
    x0 = torch.randn((b, cfg.latent_res, cfg.latent_res, cfg.latent_channels), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(4)).to(cfg.dtype)
    t = torch.full((b,), 500.0, device="cuda")
    profile_once(torch, f"dit dense forward B={b} {cfg.num_tokens} tokens",
                 lambda: dit.forward(params, cfg, x0, t, y))
    profile_once(torch, f"dit janus forward B={b} {cfg.num_tokens} -> "
                        f"{cfg.num_tokens - sum(sched)} tokens",
                 lambda: dit.forward_janus(params, cfg, x0, t, y, sched))
    return counts["dense"], counts["janus"]


def flux_fwd_flops(cfg, batch: int) -> float:
    """A copy of the reference's ``launch.steps.flux_fwd_flops``: stream-aware
    (img-side double params see the image tokens, txt-side the text tokens,
    single blocks both) plus the joint attention's quadratic term."""
    d, ff = cfg.d_model, cfg.d_ff
    ni, nt = cfg.n_img_tokens, cfg.txt_len
    per_stream = 4 * d * d + 2 * d * ff + 6 * d * d  # qkvo + mlp + mod
    p_single = d * (3 * d + ff) + (d + ff) * d + 3 * d * d
    f = 2 * cfg.n_double * (per_stream * ni + per_stream * nt)
    f += 2 * cfg.n_single * p_single * (ni + nt)
    f += 2 * 2 * (cfg.n_double + cfg.n_single) * (ni + nt) ** 2 * d  # joint attn
    return f * batch


def _flux_inputs(torch, cfg, b: int, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    txt = torch.randn((b, cfg.txt_len, cfg.t5_dim), generator=gen, device="cuda")
    vec = torch.randn((b, cfg.clip_dim), generator=gen, device="cuda")
    return txt.to(cfg.dtype), vec.to(cfg.dtype)


def kernel_share(prof, pattern: str) -> tuple[float, int]:
    """(ms, launches) on the card of the kernels whose name contains ``pattern``."""
    from torch.autograd import DeviceType
    ts = [ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
          if ev.device_type == DeviceType.CUDA and pattern in ev.name]
    return sum(ts), len(ts)


def flux_phase(torch) -> tuple[dict[str, int], dict[str, int]]:
    """flux-dev bf16 at full size (19 double + 38 single blocks, d 3072, 24
    heads of 128; 23.80 GB of weights drawn on the card, zero leaves
    redrawn) sampled through ``diffusion.flux_sample``: gen_fast whole (B=16,
    512 px, 1024 + 512 tokens, 4 steps), then gen_1024 (B=4, 1024 px, 4096 +
    512 tokens) cut to 2 of its 50 steps; the counters are zeroed just before
    each and read just after (flash_mma 57 a step). Then torch.profiler over
    one gen_1024 forward: flash_mma's share of kernel time."""
    from repro_torch import configs
    from repro_torch.models import flux, param
    from repro_torch.training import diffusion

    arch = configs.get_arch("flux-dev")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    specs = flux.specs(arch.config)
    params = param.init_params(specs, torch.Generator(device="cuda").manual_seed(0), "cuda",
                               dtype=torch.bfloat16)
    _redraw_zeros(torch, specs, params, 1)
    torch.cuda.synchronize()
    n = _n_params(param, params)
    print(f"[flux] flux-dev bf16: {arch.config.n_double} double + {arch.config.n_single} single "
          f"blocks, d={arch.config.d_model}, {arch.config.n_heads} heads of "
          f"{arch.config.head_dim}; {n} parameters, {_weights_gb(param, params):.3f} GB; init on "
          f"the card {time.perf_counter() - t0:.1f} s, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    check(n == FLUX_PARAMS, f"flux-dev parameter count {n}")
    counts = {}
    for i, (shape_name, steps) in enumerate(FLUX_STEPS.items()):
        shape = arch.shape(shape_name)
        cfg, b = configs.config_for_shape(arch, shape), shape.batch
        txt, vec = _flux_inputs(torch, cfg, b, 5 + i)
        # warm-up outside the counted run: one forward of one member
        diffusion.flux_sample(params, cfg, torch.Generator(device="cuda").manual_seed(6),
                              txt[:1], vec[:1], 1)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        x = diffusion.flux_sample(params, cfg, torch.Generator(device="cuda").manual_seed(6),
                                  txt, vec, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[shape_name] = read_counts()
        exp = _expect(flash_attention_mma=(cfg.n_double + cfg.n_single) * steps)
        tflops = flux_fwd_flops(cfg, b) * steps / wall / 1e12
        cut = "" if steps == shape.steps else f" (cut from {shape.steps})"
        print(f"[flux] {shape_name} B={b} {cfg.img_res} px, {cfg.n_img_tokens} + {cfg.txt_len} "
              f"tokens, {steps} steps{cut}: {wall:.3f} s, {wall / steps * 1e3:.1f} ms/step, "
              f"{b / wall:.3f} images/s; model {tflops:.1f} TFLOP/s "
              f"({tflops * 1e12 / PEAK_BF16:.3f} of {PEAK_BF16_NAME}, flux_fwd_flops "
              f"{flux_fwd_flops(cfg, b):.4g} a forward); max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; |x| max "
              f"{x.float().abs().max().item():.4g}; launches {_nz(counts[shape_name])} "
              f"(implies {_nz(exp)})")
        check(tuple(x.shape) == (b, cfg.latent_res, cfg.latent_res, cfg.latent_channels),
              f"flux {shape_name} output shape")
        check(bool(torch.isfinite(x).all()), f"non-finite flux {shape_name} samples")
        check(counts[shape_name] == exp, f"flux {shape_name} launch counts")
        del x, txt, vec

    shape = arch.shape("gen_1024")
    cfg, b = configs.config_for_shape(arch, shape), shape.batch
    txt, vec = _flux_inputs(torch, cfg, b, 7)
    lat = torch.randn((b, cfg.latent_res, cfg.latent_res, cfg.latent_channels), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(8)).to(cfg.dtype)
    t = torch.full((b,), 0.5, device="cuda")
    g = torch.full((b,), 3.5, device="cuda")
    prof, busy_ms, wall_ms = profile_once(
        torch, f"flux gen_1024 forward B={b} {cfg.n_img_tokens} + {cfg.txt_len} tokens",
        lambda: flux.forward(params, cfg, lat, txt, vec, t, g))
    flash_ms, flash_n = kernel_share(prof, "flash_mma_fwd")
    if busy_ms:
        print(f"[trace] flux gen_1024 forward: flash_mma {flash_ms:.3f} ms in {flash_n} launches, "
              f"{flash_ms / busy_ms:.3f} of kernel time ({flash_ms / flash_n:.3f} ms a call); "
              f"model {flux_fwd_flops(cfg, b) / wall_ms / 1e9:.1f} TFLOP/s over the traced wall")
    return counts["gen_fast"], counts["gen_1024"]


def diffusion_parity_phase(torch) -> tuple[dict[str, int], dict[str, int]]:
    """f32 on the card, through the kernels against the plain versions:
    dit-s2 ``forward_janus`` at gen_fast (B=16, 1024 tokens, schedule at
    alpha_max; merge indices identical at every merge layer, then the
    output), and flux-dev cut to 2 double + 4 single blocks at full width,
    B=2 at 512 px (1024 + 512 tokens). Returns the kernel runs' counts."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import dit, flux, param

    cfg, params, shape = _dit(torch, torch.float32, "gen_fast")
    b = shape.batch
    sched = _dit_schedule(cfg)
    gen = torch.Generator(device="cuda").manual_seed(9)
    lat = torch.randn((b, cfg.latent_res, cfg.latent_res, cfg.latent_channels), generator=gen,
                      device="cuda")
    t = torch.linspace(0.0, 999.0, b, device="cuda")
    y = torch.randint(0, cfg.n_classes + 1, (b,), generator=gen, device="cuda")
    t0 = time.perf_counter()
    zero_counts()
    out_k, rec_k = _recording_matches(lambda: dit.forward_janus(params, cfg, lat, t, y, sched))
    dit_counts = read_counts()
    with ops.plain_versions():
        out_p, rec_p = _recording_matches(lambda: dit.forward_janus(params, cfg, lat, t, y,
                                                                    sched))
    torch.cuda.synchronize()
    same = sum(all(torch.equal(a, c) for a, c in zip(ik, ip))
               for (ik, _), (ip, _) in zip(rec_k, rec_p))
    merges = sum(1 for r in sched if r > 0)
    err = (out_k - out_p).abs().max().item()
    ok = same == merges == len(rec_k) and torch.allclose(out_k, out_p, **PARITY_F32)
    exp = _expect(flash_attention=cfg.n_layers, tome_scores=merges)
    print(f"[diffusion parity] dit-s2 f32 forward_janus at {shape.name} B={b}, "
          f"{cfg.num_tokens} tokens, schedule {sched}: merge indices identical at "
          f"{same}/{merges} merge layers; kernels vs plain max|d| {err:.3e} (|out| max "
          f"{out_p.abs().max().item():.3f}), tol={PARITY_F32}; launches of the kernel run "
          f"{_nz(dit_counts)} (implies {_nz(exp)}); {time.perf_counter() - t0:.1f} s "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "f32 dit forward_janus parity failed")
    check(dit_counts == exp, "f32 dit launch counts")
    del params, out_k, out_p, rec_k, rec_p
    torch.cuda.empty_cache()

    arch = configs.get_arch("flux-dev")
    cfg = dataclasses.replace(configs.config_for_shape(arch, arch.shape("gen_fast")),
                              n_double=2, n_single=4, dtype=torch.float32)
    specs = flux.specs(cfg)
    params = param.init_params(specs, torch.Generator(device="cuda").manual_seed(0), "cuda")
    _redraw_zeros(torch, specs, params, 1)
    b = 2
    txt, vec = _flux_inputs(torch, cfg, b, 10)
    lat = torch.randn((b, cfg.latent_res, cfg.latent_res, cfg.latent_channels), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(11))
    tv = torch.tensor([0.3, 0.9], device="cuda")
    g = torch.full((b,), 3.5, device="cuda")
    t0 = time.perf_counter()
    zero_counts()
    out_k = flux.forward(params, cfg, lat, txt, vec, tv, g)
    flux_counts = read_counts()
    with ops.plain_versions():
        out_p = flux.forward(params, cfg, lat, txt, vec, tv, g)
    torch.cuda.synchronize()
    err = (out_k - out_p).abs().max().item()
    ok = bool(torch.isfinite(out_k).all()) and torch.allclose(out_k, out_p, **PARITY_F32)
    exp = _expect(flash_attention=cfg.n_double + cfg.n_single)
    print(f"[diffusion parity] flux-dev f32 cut to {cfg.n_double} double + {cfg.n_single} "
          f"single blocks at full width ({_weights_gb(param, params):.3f} GB), B={b} "
          f"{cfg.img_res} px ({cfg.n_img_tokens} + {cfg.txt_len} tokens): kernels vs plain "
          f"max|d| {err:.3e} (|out| max {out_p.abs().max().item():.3f}), tol={PARITY_F32}; "
          f"launches of the kernel run {_nz(flux_counts)} (implies {_nz(exp)}); "
          f"{time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
    check(ok, "f32 flux parity failed")
    check(flux_counts == exp, "f32 flux launch counts")
    return dit_counts, flux_counts


# ---------------------------------------------------------------------- vision

# registry (architecture, shape) pairs: the serving shape at 224 px, and
# Swin-B's 384 px shape (config_for_shape picks CONFIG_384, window 12)
VISION = (("vit-b16", "serve_b128"), ("vit-l16", "serve_b128"), ("swin-b", "serve_b128"),
          ("swin-b", "cls_384"), ("resnet-152", "serve_b128"))
VISION_BF16_REL = 5e-2  # max|bf16 - f32 logits| / max|f32 logits| (CPU at B=2: 0.4-1.4e-2)


def _draw_bn_stats(torch, params, seed: int) -> None:
    """BatchNorm scale and var from U(0.5, 1.5), mean from N(0, 0.2^2): at
    init (mean 0, var 1) eval-mode BatchNorm is an affine no-op."""
    from repro_torch.models import param

    gen = torch.Generator(device="cuda").manual_seed(seed)
    for key, t in param.flatten(params).items():
        parent, leaf = key.split("/")[-2:]
        if not parent.startswith("bn"):
            continue
        if leaf in ("scale", "var"):
            t.copy_(torch.rand(t.shape, generator=gen, device="cuda") + 0.5)
        elif leaf == "mean":
            t.copy_(0.2 * torch.randn(t.shape, generator=gen, device="cuda"))


def vision_phase(torch) -> dict[str, dict[str, int]]:
    """The registry's vision families at their serving shapes, bf16 weights
    drawn on the card (BatchNorm statistics drawn too): images/s of the bf16
    forward (median of 3 after a warm-up), then the f32 forward of the same
    weights; logits within VISION_BF16_REL. ViT runs ``vit.forward``
    (flash_mma a layer in bf16, the CUDA-core flash kernel in f32); Swin's
    window attention and ResNet's convolutions launch none of the port's
    kernels. Returns each counted run's launches."""
    from repro_torch import configs
    from repro_torch.models import param, resnet, swin, vit

    family = {"vit": vit, "swin": swin, "resnet": resnet}
    out = {}
    for i, (name, shape_name) in enumerate(VISION):
        arch = configs.get_arch(name)
        shape = arch.shape(shape_name)
        cfg, b = configs.config_for_shape(arch, shape), shape.batch
        model = family[arch.family]
        p16 = param.init_params(model.specs(cfg), torch.Generator(device="cuda").manual_seed(i),
                                "cuda", dtype=torch.bfloat16)
        if arch.family == "resnet":
            _draw_bn_stats(torch, p16, 100 + i)
        images = torch.randn((b, cfg.img_res, cfg.img_res, cfg.in_channels), device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(50 + i))
        model.forward(p16, cfg, images)  # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            zero_counts()
            t0 = time.perf_counter()
            logits16 = model.forward(p16, cfg, images)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts = read_counts()
        p32 = param.tree_map(lambda a: a.float(), p16)
        zero_counts()
        logits32 = model.forward(p32, dataclasses.replace(cfg, dtype=torch.float32), images)
        torch.cuda.synchronize()
        counts32 = read_counts()
        n_attn = cfg.n_layers if arch.family == "vit" else 0
        exp16, exp32 = _expect(flash_attention_mma=n_attn), _expect(flash_attention=n_attn)
        rel = ((logits16.float() - logits32).abs().max() / logits32.abs().max()).item()
        top1 = (logits16.float().argmax(-1) == logits32.argmax(-1)).float().mean().item()
        wall = _median(walls)
        ok = (bool(torch.isfinite(logits16).all()) and rel <= VISION_BF16_REL
              and tuple(logits16.shape) == (b, cfg.n_classes))
        print(f"[vision] {name} {shape_name} ({cfg.img_res} px"
              f"{f', window {cfg.window}' if arch.family == 'swin' else ''}) bf16 B={b}: "
              f"{wall * 1e3:.2f} ms, {b / wall:.1f} images/s ({_n_params(param, p16)} "
              f"parameters); bf16 vs f32 logits of the same weights: max|d| / max|f32| "
              f"{rel:.4f} (tol {VISION_BF16_REL}), top-1 agree {top1:.3f}; launches bf16 "
              f"{_nz(counts)} (implies {_nz(exp16)}), f32 {_nz(counts32)} (implies "
              f"{_nz(exp32)}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{name} {shape_name} bf16 logits")
        check(counts == exp16 and counts32 == exp32, f"{name} {shape_name} launch counts")
        out[f"{name} {shape_name}"] = counts
        out[f"{name} {shape_name} f32"] = counts32
        del p16, p32, images, logits16, logits32
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- spatial

SPATIAL_ARCH, SPATIAL_SHAPE = "resnet-152", "serve_b128"
SPATIAL_PARTS = (2, 4)
# row blocks through the ranks' local op, concatenated, against the unsplit
# op: within this share of max|unsplit| (other shapes may take another cuDNN
# algorithm, and bf16 rounds each output: one bf16 ulp at the largest
# magnitude is 2^-8 of it); the max pool, which only compares, bit-equal
SPATIAL_OF_MAX = {"bfloat16": 2 ** -7, "float32": 1e-5}


def spatial_ops(cfg) -> list[tuple[str, int, int, int, int, int | None]]:
    """(label, H, k, stride, in channels, out channels; None for the pool)
    of every distinct convolution and pool of ``cfg``'s forward that reads
    rows of a neighbouring block (1x1/1 convolutions read none)."""
    h, w = cfg.img_res, cfg.width
    ops = [("stem 7x7/2", h, 7, 2, cfg.in_channels, w), ("max pool 3x3/2", h // 2, 3, 2, w, None)]
    h, cin = h // 4, w
    for i in range(len(cfg.depths)):
        cmid, s = w * 2 ** i, 1 if i == 0 else 2
        ops.append((f"stage{i} conv2 3x3/{s}", h, 3, s, cmid, cmid))
        if s == 2:
            ops.append((f"stage{i} proj 1x1/2", h, 1, 2, cin, cmid * cfg.expansion))
            ops.append((f"stage{i} rest conv2 3x3/1", h // 2, 3, 1, cmid, cmid))
        h, cin = h // s, cmid * cfg.expansion
    return ops


def _cuda_ms(torch, fn, iters: int = 5) -> float:
    """Median ms of ``fn`` on the card (CUDA events, after one warm call)."""
    fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return _median(times)


def spatial_phase(torch, smi: str) -> dict[str, int]:
    """resnet-152 ``serve_b128`` under the ``spatial`` profile. On the card's
    (1,1) NCCL mesh at full size: ``build_bundle(..., profile_override=
    "spatial")``'s logits bit-equal to the unmeshed bundle's. Then every
    distinct op that exchanges a halo on a split (``spatial_ops``), at the
    bundle's batch and resolution, cut into P = 2 and 4 row blocks where
    the ranks would split it (the output's H divides by P): each block with
    its halo cut from the global tensor (``resnet.row_blocks``, what
    ``halo_exchange`` delivers), through the local op the ranks run,
    concatenated, against the unsplit op, in bf16 (the bundle's dtype) and
    f32. The exchange itself runs only on gloo ranks (the card's mesh is
    (1,1)). Returns the counted forward's launches (none: the convolutions
    are cuDNN's)."""
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import param, resnet
    from repro_torch.sharding import rules

    t_phase = time.perf_counter()
    arch = configs.get_arch(SPATIAL_ARCH)
    shape = arch.shape(SPATIAL_SHAPE)
    cfg = configs.config_for_shape(arch, shape)
    mesh = make_host_mesh(device="cuda")
    b0 = steps.build_bundle(SPATIAL_ARCH, SPATIAL_SHAPE)
    b1 = steps.build_bundle(SPATIAL_ARCH, SPATIAL_SHAPE, mesh, profile_override="spatial")
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = param.init_params(resnet.specs(cfg), gen, "cuda", dtype=cfg.dtype)
    _draw_bn_stats(torch, params, 8)
    images = torch.randn((shape.batch, cfg.img_res, cfg.img_res, cfg.in_channels),
                         device="cuda", generator=gen)
    batch = {"images": images,
             "labels": torch.zeros(shape.batch, dtype=torch.int32, device="cuda")}
    placed = steps.place_inputs(b1, params, batch)
    want = b0.step_fn(params, batch)
    zero_counts()
    got = rules.to_global(b1.step_fn(*placed))
    torch.cuda.synchronize()
    counts = read_counts()
    same = torch.equal(got, want) and bool(torch.isfinite(want).all())
    ms0 = _cuda_ms(torch, lambda: b0.step_fn(params, batch), 3)
    ms1 = _cuda_ms(torch, lambda: b1.step_fn(*placed), 3)
    print(f"[spatial] {smi} | {SPATIAL_ARCH} {SPATIAL_SHAPE} {str(cfg.dtype)[6:]} B={shape.batch} "
          f"{cfg.img_res} px, profile spatial on the (1,1) NCCL mesh: logits "
          f"{tuple(got.shape)} bit-equal to the unmeshed bundle's: {same}; "
          f"{ms1:.2f} ms a forward (unmeshed {ms0:.2f} ms); launches {_nz(counts)} "
          f"{'ok' if same and counts == _expect() else 'FAIL'}")
    check(same, "[spatial] the (1,1) spatial bundle's logits differ from the unmeshed ones")
    check(counts == _expect(), "[spatial] resnet launched a kernel of the port")
    del params, placed, want, got, batch

    worst = {}
    for label, h, k, s, cin, cout in spatial_ops(cfg):
        for parts in SPATIAL_PARTS:
            if (h // s) % parts:
                print(f"[spatial] {label} at H={h}, P={parts}: the output's H "
                      f"{h // s} does not divide by {parts}, so the ranks gather H (fallback)")
                continue
            halo = resnet.halo_rows(h, k, s, parts)
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn((shape.batch, h, h, cin), device="cuda", generator=gen,
                                dtype=dtype)
                if cout is None:
                    whole = lambda: resnet.max_pool_local(x)  # noqa: E731
                    blocks = resnet.row_blocks(x, k, s, parts, fill=-torch.inf)

                    def split():
                        return torch.cat([resnet.max_pool_local(b, True) for b in blocks], 1)
                else:
                    wt = (torch.randn((k, k, cin, cout), device="cuda", generator=gen)
                          * (2 / (k * k * cin)) ** 0.5).to(dtype)
                    whole = lambda: resnet.conv_local(x, wt, s)  # noqa: E731
                    blocks = resnet.row_blocks(x, k, s, parts)

                    def split():
                        return torch.cat([resnet.conv_local(b, wt, s, True) for b in blocks], 1)
                y, yb = whole(), split()
                name = str(dtype)[6:]
                err = ((yb.float() - y.float()).abs().max() / y.float().abs().max()).item()
                limit = 0.0 if cout is None else SPATIAL_OF_MAX[name]
                ok = yb.shape == y.shape and err <= limit
                worst[name] = max(worst.get(name, 0.0), err)
                ms_whole, ms_split = _cuda_ms(torch, whole), _cuda_ms(torch, split)
                print(f"[spatial] {label} [{shape.batch},{h},{h},{cin}] {name} P={parts} halo "
                      f"{halo}: blocks vs whole max|d| / max|whole| {err:.3e} (tol {limit:g}); "
                      f"{ms_whole:.3f} ms whole, {ms_split:.3f} ms the {parts} blocks with "
                      f"their concatenation {'ok' if ok else 'FAIL'}")
                check(ok, f"[spatial] {label} P={parts} {name}: row blocks differ from the whole")
                del x, y, yb, blocks
    print(f"[spatial] {smi} | worst blocks vs whole: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f"; phase {time.perf_counter() - t_phase:.1f} s")
    return counts


# ----------------------------------------------------------------------- train

TRAIN_ARCH, TRAIN_SHAPE = "vit-l16", "cls_384"
TRAIN_STEPS, TRAIN_RESUME_STEPS, TRAIN_CKPT_EVERY = 4, 2, 2
# the flash backward's calls: the train path's, and an LM train shape's head dim
TRAIN_BWD = (("vit-l16 cls_384 train", 32, 16, 577, 64, False),
             ("LM train causal D=128", 2, 24, 1024, 128, True))
# dq/dk/dv against autograd of the plain version in f32 (and the backward
# kernels against the plain backward) within FLASH_BWD_BF16_OF_MAX (1e-2) or
# FLASH_BWD_F32_OF_MAX (1e-4) of max|g|: kernel_bench's, with their readings
# the f32 backward's calls on the CUDA-core kernel: the f32 train parity's
# [4,16,577,64] and a D=16 call (the smoke ViTs' head dim)
TRAIN_BWD_F32 = (("vit-l16 f32 train parity", 4, 16, 577, 64, False),
                 ("f32 D=16", 8, 4, 577, 16, False))
# one bf16 step's gradients, kernels against plain versions (two bf16 models
# that round attention at other places, 24 layers deep): the loss, the
# gradient norm, the cosine of the flat gradients, and the least cosine of a
# leaf whose plain norm is at least leaf_floor of the largest leaf's (the key
# biases' gradients are zero but for rounding)
TRAIN_BF16 = dict(loss_rel=1e-3, gnorm_rel=1e-3, cosine=0.999, leaf_cosine=0.9995,
                  leaf_floor=1e-3)
# f32 step, kernels against plain versions, every leaf: within of_max of the
# largest |g| of any leaf, and within of_leaf of its own max|g| unless that is
# below rounding_only of the largest (the key biases: zero but for rounding)
GRAD_F32 = dict(of_max=1e-5, of_leaf=1e-5, rounding_only=1e-6)


def wrong_flash_backwards(flash_mod) -> dict:
    """Two plainly wrong flash backwards made from the sound one, which the
    backward's and the train parity's limits must reject: dS without its
    rowsum(dO * O) term (dQ and dK wrong), and key tile 0's dK and dV
    dropped."""
    sound = flash_mod.backward

    def no_rowsum(q, k, v, out, dout, **kw):
        return sound(q, k, v, out.new_zeros(out.shape), dout, **kw)

    def key_tile_dropped(q, k, v, out, dout, **kw):
        dq, dk, dv, dbias = sound(q, k, v, out, dout, **kw)
        dk, dv = dk.clone(), dv.clone()
        dk[:, :, :64] = 0
        dv[:, :, :64] = 0
        return dq, dk, dv, dbias

    return {"rowsum(dO*O) dropped": no_rowsum, "key tile 0's dK, dV dropped": key_tile_dropped}


def wrong_flash_forward(torch, ref, flash_mod):
    """A plainly wrong flash forward: the plain version with key tile 0
    masked out (with the sound kernel's log-sum-exp, which the backward
    kernel needs)."""
    sound = flash_mod._forward

    def forward(q, k, v, bias, kv_len, causal, with_lse=False):
        drop = torch.zeros(k.shape[0], k.shape[2], device=k.device)
        drop[:, :64] = -torch.inf
        out = ref.flash_attention_ref(q, k, v, bias=drop if bias is None else bias + drop,
                                      kv_len=kv_len, causal=causal)
        return (out, sound(q, k, v, bias, kv_len, causal, True)[1]) if with_lse else out
    return forward


def swapped_in(module, name: str, fn):
    """A context in which ``module.name`` is ``fn``."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        old = getattr(module, name)
        setattr(module, name, fn)
        try:
            yield
        finally:
            setattr(module, name, old)
    return ctx()


def flash_backward_phase(torch, bench: list[dict]) -> tuple[dict[str, float], list[dict]]:
    """The flash backward kernels at the train calls: through the kernel's
    autograd Function against autograd of the plain version in f32 on the
    same inputs (bf16 within FLASH_BWD_BF16_OF_MAX of max|g|, f32 within
    FLASH_BWD_F32_OF_MAX; the launch counters must move and the plain
    backward must not run), the kernel backward against the plain backward
    ``ref.flash_attention_bwd_ref`` on the same inputs, and the two wrong
    backwards of ``wrong_flash_backwards`` above the limit. The times (the
    kernel's, the plain backward's, SDPA's backward) and the bound are
    ``kernel_bench``'s records of the same calls (``bench``). Returns the
    backward's ms per call at each shape and the two backward kernels' rows
    of the kernels JSON line. Launches here compare; they are on no path."""
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(30)
    ms_by_label, timings = {}, {name: [] for name in flash_mod.BWD.values()}
    errs = {name: 0.0 for name in flash_mod.BWD.values()}
    cases = ([(c, torch.bfloat16) for c in TRAIN_BWD]
             + [(c, torch.float32) for c in TRAIN_BWD_F32])
    for (label, b, h, s, d, causal), dtype in cases:
        case = Case(label, "flash_bwd", (b, h, s, d), dtype, causal=causal)
        name = case.kernel()
        shared = bench_row(bench, case)
        check(shared is not None, f"kernel_bench has no row for the flash backward {label}")
        limit = FLASH_BWD_BF16_OF_MAX if dtype == torch.bfloat16 else FLASH_BWD_F32_OF_MAX
        shape = (f"{label}: q,k,v [{b},{h},{s},{d}] {str(dtype)[6:]}"
                 + (", causal" if causal else ""))
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)
                   .requires_grad_() for _ in "qkv")
        dout = torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)
        before = flash_mod.launches_bwd, flash_mod.launches_bwd_mma

        def plain_backward(*a, **kw):
            raise AssertionError("the plain backward ran on a CUDA tensor")
        with swapped_in(ref, "flash_attention_bwd_ref", plain_backward):
            out = flash_mod.flash_attention(q, k, v, causal=causal)
            got = torch.autograd.grad(out, (q, k, v), dout)
        torch.cuda.synchronize()
        mma = name == flash_mod.BWD[flash_mod.MMA]
        moved = (flash_mod.launches_bwd - before[0], flash_mod.launches_bwd_mma - before[1])
        check(moved == (1, int(mma)), f"flash backward {label}: launches {moved}, not on {name}")
        pf = [t.detach().float().requires_grad_() for t in (q, k, v)]
        exp = torch.autograd.grad(ref.flash_attention_ref(*pf, causal=causal), pf, dout.float())

        def of_max(grads):
            return [((g.float() - e).abs().max() / e.abs().max()).item()
                    for g, e in zip(grads, exp)]
        rel = of_max(got)
        ok = all(torch.isfinite(g).all() for g in got) and max(rel) <= limit
        print(f"[train] flash backward {shape} on {name}: max|d| / max|g| dq {rel[0]:.3e} dk "
              f"{rel[1]:.3e} dv {rel[2]:.3e} against autograd of the plain version in f32 "
              f"(tol {limit}) {'ok' if ok else 'FAIL'}")
        check(ok, f"flash backward {label} disagrees with autograd of its plain version")
        qd, kd, vd = q.detach(), k.detach(), v.detach()
        od, lse = flash_mod._forward(qd, kd, vd, None, None, causal, True)
        kernel_g = flash_mod.backward(qd, kd, vd, od, dout, causal=causal, lse=lse)
        plain_g = ref.flash_attention_bwd_ref(qd, kd, vd, od, dout, causal=causal)
        torch.cuda.synchronize()
        err = max((a.float() - e.float()).abs().max().item() for a, e in
                  zip(kernel_g[:3], plain_g[:3]))
        scale = max(e.float().abs().max().item() for e in plain_g[:3])
        errs[name] = max(errs[name], err)
        ok = err <= limit * scale
        print(f"[train] flash backward {shape}: {name} against the plain backward on the same "
              f"inputs: max_abs_err {err:.3e} ({err / scale:.3e} of max|plain| {scale:.3e}, tol "
              f"{limit} of it) {'ok' if ok else 'FAIL'}")
        check(ok, f"{name} {label} disagrees with the plain backward")
        wrong = {wname: max(of_max(fn(qd, kd, vd, od, dout, causal=causal, lse=lse)[:3]))
                 for wname, fn in wrong_flash_backwards(flash_mod).items()}
        print(f"[train] flash backward {label}: a wrong backward would read "
              + ", ".join(f"{wname} {r:.3e}" for wname, r in wrong.items())
              + f" of max|g| (limit {limit})")
        check(min(wrong.values()) > limit,
              f"the flash backward's limit does not reject a wrong backward at {label}")
        ms, plain_ms, lib_ms = shared["ms"], shared["plain_ms"], shared["library_ms"]
        b_ms, b_by = case.bound()
        print(f"[train] flash backward {shape} timing (kernel_bench {shared['label']}, queued): "
              f"{name} {ms:.4f} ms a call; plain backward {plain_ms:.4f} ms; SDPA backward "
              f"{lib_ms:.4f} ms ({ms / lib_ms:.2f}x); bound {b_ms:.4f} ms ({b_by}, "
              f"{case.flops():.4e} FLOP, {case.nbytes():.4e} B; kernel at {b_ms / ms:.3f} of it)"
              + ("" if mma else "; 3xTF32 bound {:.4f} ms ({})".format(
                  *bound(3 * case.flops(), case.nbytes(), PEAK_TF32))))
        ms_by_label[label] = ms
        timings[name].append(dict(shape=shape, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                  bound_ms=b_ms, bound_by=b_by,
                                  timing=f"kernel_bench {shared['label']}, queued"))
        del q, k, v, dout, out, qd, kd, vd, od, lse, got, exp, pf, kernel_g, plain_g
        torch.cuda.empty_cache()
    rows = []
    for kernel, name in flash_mod.BWD.items():
        first = timings[name][0]
        rows.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces="src/repro/kernels/flash_attention.py:90",
            replaces_note="the gradient of that kernel's function; the reference "
                          "differentiates its jnp layers.sdpa with XLA (no Pallas backward)",
            serves="bf16 at D 64, 128" if kernel == flash_mod.MMA
            else "f32 at D 16-128, bf16 at D 16, 32",
            max_abs_err=errs[name], max_err=errs[name],
            tol={"bf16_of_max_g": FLASH_BWD_BF16_OF_MAX, "f32_of_max_g": FLASH_BWD_F32_OF_MAX},
            ms=first["ms"], kernel_ms=first["ms"], plain_ms=first["plain_ms"],
            library_ms=first["library_ms"],
            library="torch.autograd.grad of torch.nn.functional.scaled_dot_product_attention "
                    "(the backward alone, its graph retained)", timing=first["timing"],
            bound_ms=first["bound_ms"], bound_us=first["bound_ms"] * 1e3,
            bound_by=first["bound_by"], shape=first["shape"], timings=timings[name]))
    return ms_by_label, rows


def bf16_step_readings(param, loss_k, grads_k, loss_p, grads_p) -> dict:
    """A bf16 step's gradients (``grads_k``) against the plain step's: the
    loss and gradient norm as a share of the plain ones, the cosine of the
    flat gradients, and the least cosine of a leaf whose plain norm is at
    least ``TRAIN_BF16["leaf_floor"]`` of the largest leaf's; f64 sums."""
    fk, fp = param.flatten(grads_k), param.flatten(grads_p)
    dots = {}
    for key, y in fp.items():
        x, y = fk[key].double(), y.double()
        dots[key] = (float((x * y).sum()), float((x * x).sum()), float((y * y).sum()))
    dot, nk, np_ = (sum(t[i] for t in dots.values()) for i in range(3))
    floor = TRAIN_BF16["leaf_floor"] ** 2 * max(t[2] for t in dots.values())
    top = max(t[2] for t in dots.values()) ** 0.5
    leaf_cos = {key: d / max(a * b, 1e-300) ** 0.5 for key, (d, a, b) in dots.items()
                if b >= floor}
    shares = {key: t[2] ** 0.5 / top for key, t in dots.items()}
    least = min(leaf_cos, key=leaf_cos.get)
    lk, lp = float(loss_k), float(loss_p)
    return {"loss": lk, "loss_rel": abs(lk - lp) / abs(lp),
            "gnorm": nk ** 0.5, "gnorm_rel": abs(nk ** 0.5 - np_ ** 0.5) / np_ ** 0.5,
            "cosine": dot / (nk * np_) ** 0.5, "leaf_cosine": leaf_cos[least],
            "least_leaf": least, "n_leaves": len(leaf_cos), "leaf_cosines": leaf_cos,
            "norm_shares": shares}


def bf16_step_broken(r: dict) -> list[str]:
    """The ``TRAIN_BF16`` limits that readings ``r`` break."""
    return ([k for k in ("loss_rel", "gnorm_rel") if not r[k] <= TRAIN_BF16[k]]
            + [k for k in ("cosine", "leaf_cosine") if not r[k] >= TRAIN_BF16[k]])


def f32_step_readings(param, loss_k, grads_k, loss_p, grads_p) -> dict:
    """An f32 step's gradients against the plain step's, by ``GRAD_F32``:
    each leaf's max|d| as a share of the largest |g| of any leaf and, for
    the leaves above rounding, of its own max|g|."""
    fk, fp = param.flatten(grads_k), param.flatten(grads_p)
    top = max(float(g.abs().max()) for g in fp.values())
    r = {"loss_rel": abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)),
         "of_max": 0.0, "of_leaf": 0.0, "worst_leaf": "", "n_real": 0, "n": len(fp)}
    for key, e in fp.items():
        err, own = float((fk[key] - e).abs().max()), float(e.abs().max())
        r["of_max"] = max(r["of_max"], err / top)
        if own >= GRAD_F32["rounding_only"] * top:
            r["n_real"] += 1
            if err / own >= r["of_leaf"]:
                r["of_leaf"], r["worst_leaf"] = err / own, key
    return r


def f32_step_broken(r: dict) -> list[str]:
    """The ``GRAD_F32`` limits (and the loss's 1e-5) that readings ``r`` break."""
    return ([k for k in ("of_max", "of_leaf") if not r[k] <= GRAD_F32[k]]
            + ([] if r["loss_rel"] <= 1e-5 else ["loss_rel"]))


def train_parity_phase(torch, params, opt, batch, bundle) -> tuple[dict, dict]:
    """One bf16 step's gradients (both microbatches, before the update) from
    the trained params, through the kernels and under ``ops.plain_versions``;
    then vit-l16 cut to 4 layers at B=4 in f32, every gradient leaf, at
    three seeds (``f32_train_parity``). Each also runs with plainly wrong
    flash backwards (and the bf16 step with a wrong forward), which must
    break its limits. Returns the kernel runs' launches."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import steps
    from repro_torch.models import param

    def wrong():
        """(name, context) of each wrong backward."""
        return [(f"backward with {name}", swapped_in(flash_mod, "backward", fn))
                for name, fn in wrong_flash_backwards(flash_mod).items()]
    arch = configs.get_arch(TRAIN_ARCH)
    cfg = configs.config_for_shape(arch, arch.shape(TRAIN_SHAPE))

    def grads16():
        return steps.accumulated_grads(bundle.loss_fn, params, batch, opt["step"], bundle.accum)

    zero_counts()
    loss_k, grads_k = grads16()
    torch.cuda.synchronize()
    counts16 = read_counts()
    with ops.plain_versions():
        loss_p, grads_p = grads16()
    torch.cuda.synchronize()
    r = bf16_step_readings(param, loss_k, grads_k, loss_p, grads_p)
    del grads_k
    broken = bf16_step_broken(r)
    exp16 = _expect(flash_attention_mma=2 * cfg.n_layers * bundle.accum,
                    flash_attention_mma_bwd=cfg.n_layers * bundle.accum)
    print(f"[train parity] {TRAIN_ARCH} {TRAIN_SHAPE} bf16, one step's gradients (accum "
          f"{bundle.accum}) through the kernels vs the plain versions: loss {r['loss']:.6f} vs "
          f"{float(loss_p):.6f} (rel {r['loss_rel']:.3e}), gradient norm {r['gnorm']:.6f} (rel "
          f"{r['gnorm_rel']:.3e}), cosine {r['cosine']:.6f}, least cosine of {r['n_leaves']} "
          f"leaves {r['leaf_cosine']:.6f} ({r['least_leaf']}) (tol {TRAIN_BF16}); launches "
          f"{_nz(counts16)} (implies {_nz(exp16)}) {'FAIL ' + str(broken) if broken else 'ok'}")
    print("[train parity] bf16 leaves (cosine, plain norm / largest leaf's): " + ", ".join(
        f"{k} ({r['leaf_cosines'].get(k, float('nan')):.6f}, {share:.2e})"
        for k, share in r["norm_shares"].items()))
    check(not broken and counts16 == exp16, "bf16 train step: kernels vs plain versions")
    for name, ctx in wrong() + [("forward with key tile 0 dropped",
                               swapped_in(flash_mod, "_forward",
                                          wrong_flash_forward(torch, ref, flash_mod)))]:
        with ctx:
            loss_w, grads_w = grads16()
        w = bf16_step_readings(param, loss_w, grads_w, loss_p, grads_p)
        del grads_w
        broken = bf16_step_broken(w)
        print(f"[train parity] bf16 control, a {name}: loss rel {w['loss_rel']:.3e}, gradient "
              f"norm rel {w['gnorm_rel']:.3e}, cosine {w['cosine']:.6f}, least leaf cosine "
              f"{w['leaf_cosine']:.6f} ({w['least_leaf']}): breaks {broken}")
        check(bool(broken), f"the bf16 train parity's limits do not reject a {name}")
    del grads_p
    torch.cuda.empty_cache()

    return counts16, f32_train_parity(torch, cfg, wrong)


# (weights, data) seeds of the f32 train parity's runs; the wrong-backward
# controls run on the first
F32_PARITY_SEEDS = ((40, 41), (42, 43), (44, 45))


def f32_train_parity(torch, cfg, wrong) -> dict:
    """vit ``cfg`` cut to 4 layers at B=4 in f32: one step's gradients
    through the kernels against the plain versions, every leaf within
    ``GRAD_F32``, at each of ``F32_PARITY_SEEDS`` (the counters zeroed before
    each kernel run and read after it); then the wrong backwards of
    ``wrong()`` on the first seed's inputs, which must break a limit.
    Returns the first kernel run's launches."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import param, vit

    cfg = dataclasses.replace(cfg, n_layers=4, dtype=torch.float32)
    exp32 = _expect(flash_attention=2 * cfg.n_layers, flash_attention_bwd=cfg.n_layers)

    def loss_fn(p, b):
        return steps._ce_loss(vit.forward(p, cfg, b["images"]), b["labels"])

    first, readings = None, []
    for w_seed, d_seed in F32_PARITY_SEEDS:
        p32 = param.init_params(vit.specs(cfg), torch.Generator(device="cuda")
                                .manual_seed(w_seed), "cuda")
        gen = torch.Generator(device="cuda").manual_seed(d_seed)
        b32 = {"images": torch.randn((4, cfg.img_res, cfg.img_res, 3), generator=gen,
                                     device="cuda"),
               "labels": torch.randint(0, cfg.n_classes, (4,), generator=gen, device="cuda",
                                       dtype=torch.int32)}
        zero_counts()
        l_k, g_k = steps.value_and_grad(loss_fn, p32, b32)
        torch.cuda.synchronize()
        counts32 = read_counts()
        with ops.plain_versions():
            l_p, g_p = steps.value_and_grad(loss_fn, p32, b32)
        r = f32_step_readings(param, l_k, g_k, l_p, g_p)
        readings.append(r)
        broken = f32_step_broken(r)
        print(f"[train parity] {TRAIN_ARCH} f32 cut to {cfg.n_layers} layers, B=4 at "
              f"{cfg.img_res} px, seeds {w_seed}/{d_seed}: loss {float(l_k):.7f} vs "
              f"{float(l_p):.7f}; {r['n']} gradient leaves ({r['n_real']} above rounding), "
              f"worst {r['of_leaf']:.3e} of its max|g| ({r['worst_leaf']}), {r['of_max']:.3e} "
              f"of the largest (tol {GRAD_F32}); launches {_nz(counts32)} (implies "
              f"{_nz(exp32)}) {'FAIL ' + str(broken) if broken else 'ok'}")
        check(not broken and counts32 == exp32, "f32 train step: kernels vs plain versions")
        if first is None:
            first = counts32, p32, b32, g_p, l_p
        del g_k
    worst = max(readings, key=lambda r: r["of_leaf"] / GRAD_F32["of_leaf"])
    print(f"[train parity] f32 over {len(readings)} seeds: worst leaf "
          f"{worst['of_leaf']:.3e} of its max|g| ({worst['worst_leaf']}), "
          f"{worst['of_leaf'] / GRAD_F32['of_leaf']:.3f} of the limit; largest of_max "
          f"{max(r['of_max'] for r in readings):.3e}")
    counts32, p32, b32, g_p, l_p = first
    for name, ctx in wrong():
        with ctx:
            l_w, g_w = steps.value_and_grad(loss_fn, p32, b32)
        w = f32_step_readings(param, l_w, g_w, l_p, g_p)
        broken = f32_step_broken(w)
        print(f"[train parity] f32 control, a {name}: worst {w['of_leaf']:.3e} of its max|g| "
              f"({w['worst_leaf']}), {w['of_max']:.3e} of the largest: breaks {broken}")
        check(bool(broken), f"the f32 train parity's limits do not reject a {name}")
    return counts32


def profile_train_step(torch, bundle, params, opt, batch, calls_per_step: int,
                       bwd_call_ms: float) -> None:
    """torch.profiler over one train step after one warm step, each flash
    backward inside a profiler range: the step's idle share and the flash
    backward's share of its kernel time: its kernels by name (the wrapper
    launches them through ctypes, so the profiler links them to no range)
    and the PyTorch operations under the ranges (allocation, the dbias sum).
    The steps update params and opt."""
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    from repro_torch.kernels import flash_attention as flash_mod

    backward = flash_mod.backward

    def ranged(*args, **kw):
        with record_function(FLASH_BWD_RANGE):
            return backward(*args, **kw)

    flash_mod.backward = ranged
    try:
        prof, busy_ms, wall_ms = profile_once(
            torch, f"train {TRAIN_ARCH} {TRAIN_SHAPE} step",
            lambda: bundle.step_fn(params, opt, batch))
    finally:
        flash_mod.backward = backward
    spans = [ev for ev in prof.events()
             if ev.name == FLASH_BWD_RANGE and ev.device_type == DeviceType.CPU]
    ops_ms = sum(ev.device_time_total for ev in spans) / 1e3
    kernels = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA
               and FLASH_BWD_KERNEL.search(ev.name)]
    kernel_ms = sum(ev.time_range.elapsed_us() for ev in kernels) / 1e3
    bwd_ms = kernel_ms + ops_ms
    timed = calls_per_step * bwd_call_ms
    if kernels and busy_ms:
        share = (f"{bwd_ms:.3f} ms ({len(kernels)} kernel launches {kernel_ms:.3f} ms, "
                 f"operations in {len(spans)} ranges {ops_ms:.3f} ms), {bwd_ms / busy_ms:.3f} "
                 f"of kernel time")
    else:
        share = f"not measured by the profiler ({len(spans)} ranges, no backward kernel seen)"
    print(f"[trace] train {TRAIN_ARCH} {TRAIN_SHAPE} step: flash backward {share}; "
          f"timed alone, {calls_per_step} calls x {bwd_call_ms:.4f} ms = {timed:.3f} ms, "
          f"{timed / wall_ms:.3f} of the profiled step's wall")


def train_phase(torch, bench: list[dict]) -> tuple[dict[str, dict[str, int]], dict]:
    """vit-l16 at cls_384, full size, through ``launch.train.main`` on the
    card: train, checkpoint, restore, resume; then one profiled step and the
    parity steps. Returns each counted run's launches, and the run's losses,
    step times and peak memory for ``train_mesh_phase``."""
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import pipeline
    from repro_torch.launch import steps, train
    from repro_torch.models import param

    t_phase = time.perf_counter()
    bwd_ms, bwd_rows = flash_backward_phase(torch, bench)
    arch = configs.get_arch(TRAIN_ARCH)
    cfg = configs.config_for_shape(arch, arch.shape(TRAIN_SHAPE))
    bundle = steps.build_bundle(TRAIN_ARCH, TRAIN_SHAPE, None)
    ckdir = tempfile.mkdtemp(prefix="repro_torch_train_")
    common = ["--arch", TRAIN_ARCH, "--shape", TRAIN_SHAPE, "--full", "--ckpt-dir", ckdir,
              "--log-every", "1"]
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        first = train.main(common + ["--steps", str(TRAIN_STEPS),
                                     "--ckpt-every", str(TRAIN_CKPT_EVERY)])
        ck = Checkpointer(ckdir)
        saved = ck.all_steps()
        t0 = time.perf_counter()
        restored, at = ck.restore((first.params, first.opt), step=TRAIN_STEPS, device="cuda")
        restore_s = time.perf_counter() - t0
        mine, back = (param.flatten({"0": t[0], "1": t[1]})
                      for t in ((first.params, first.opt), restored))
        same = all(a.dtype == back[k].dtype and torch.equal(a, back[k]) for k, a in mine.items())
        bf16 = all(t.dtype == torch.bfloat16 for t in param.flatten(restored[0]).values())
        ckpt_gb = sum(t.numel() * t.element_size() for t in mine.values()) / 1e9
        print(f"[train] checkpoints {saved} in a temporary directory ({ckpt_gb:.3f} GB each); "
              f"step {at} restored in {restore_s:.2f} s: {len(mine)} leaves equal bit for bit, "
              f"params bf16 {bf16} {'ok' if same and bf16 else 'FAIL'}")
        check(saved == [TRAIN_CKPT_EVERY, TRAIN_STEPS] and at == TRAIN_STEPS and same and bf16,
              "train checkpoint: saved steps or restored values")
        del restored, back, mine
        n_params = _n_params(param, first.params)
        first.params = first.opt = None  # the card holds one model's state at a time
        torch.cuda.empty_cache()
        second = train.main(common + ["--steps", str(TRAIN_RESUME_STEPS), "--resume"])
        torch.cuda.synchronize()
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    n_steps = TRAIN_STEPS + TRAIN_RESUME_STEPS
    exp = _expect(flash_attention_mma=2 * cfg.n_layers * bundle.accum * n_steps,
                  flash_attention_mma_bwd=cfg.n_layers * bundle.accum * n_steps)
    med = first.median_step_s()
    # the second step of each run: warm, and no checkpoint write in flight (the
    # first run's step-2 save is written while its steps 2 and 3 run)
    quiet = [first.step_s[1], second.step_s[1]]
    losses = first.losses + second.losses
    ok = (second.start_step == TRAIN_STEPS and len(losses) == n_steps
          and all(l == l and abs(l) < float("inf") for l in losses))
    print(f"[train] {TRAIN_ARCH} {TRAIN_SHAPE} full ({n_params} parameters, bf16 params, f32 "
          f"moments, global batch {first.samples_per_step} in {first.accum} microbatches, "
          f"remat {cfg.remat}): {TRAIN_STEPS} steps + resume at step {second.start_step} for "
          f"{TRAIN_RESUME_STEPS}; losses {[round(l, 4) for l in losses]}; step "
          f"{med * 1e3:.2f} ms (median after the first; every step "
          f"{[round(t * 1e3, 2) for t in first.step_s + second.step_s]} ms; steps 1 and "
          f"{TRAIN_STEPS + 1}, no save in flight: {[round(t * 1e3, 2) for t in quiet]} ms), "
          f"{first.samples_per_step / med:.1f} images/s, model "
          f"{first.model_flops / med / 1e12:.2f} TFLOP/s ({first.model_flops:.4e} FLOP a step; "
          f"{first.model_flops / med / PEAK_BF16:.3f} of {PEAK_BF16_NAME}); peak memory "
          f"{peak_gb:.3f} GB; launches {_nz(counts)} (implies {_nz(exp)}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "train: resume step, or a loss that is not finite")
    check(counts == exp, f"train launches {counts} != {exp}")

    batch = pipeline.place(train.host_batch(arch, cfg, pipeline.SyntheticData(),
                                            n_steps, bundle.abstract_inputs[2]), "cuda")
    profile_train_step(torch, bundle, second.params, second.opt, batch,
                       cfg.n_layers * bundle.accum, bwd_ms[TRAIN_BWD[0][0]])
    counts16, counts32 = train_parity_phase(torch, second.params, second.opt, batch, bundle)
    print(f"[train] phase {time.perf_counter() - t_phase:.1f} s")
    run = {"losses": losses, "step_s": first.step_s + second.step_s, "median_s": med,
           "quiet_s": quiet, "peak_gb": peak_gb, "bwd_rows": bwd_rows}
    return {"train": counts, "train_bf16_parity": counts16, "train_f32_parity": counts32}, run


def train_mesh_phase(torch, unmeshed: dict) -> dict[str, int]:
    """``[train]``'s run on the (1,1) NCCL host mesh (``--mesh``): vit-l16
    ``cls_384`` under its train profile, params and moments DTensors placed
    as views, every op through DTensor dispatch, the flash kernel behind the
    local boundary. Checks the losses against ``unmeshed`` (``[train]``'s),
    the launches, the sharded checkpoint's restore with ``shardings=`` and
    ``compressed_psum_mean``; reports step wall, idle share and peak memory.
    Returns the counted run's launches."""
    import shutil
    import tempfile

    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import pipeline
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import param
    from repro_torch.optim import grad_compression as gc
    from repro_torch.sharding.rules import use_rules

    t_phase = time.perf_counter()
    arch = configs.get_arch(TRAIN_ARCH)
    cfg = configs.config_for_shape(arch, arch.shape(TRAIN_SHAPE))
    mesh = make_host_mesh(device="cuda")
    bundle = steps.build_bundle(TRAIN_ARCH, TRAIN_SHAPE, mesh)
    ckdir = tempfile.mkdtemp(prefix="repro_torch_train_mesh_")
    common = ["--arch", TRAIN_ARCH, "--shape", TRAIN_SHAPE, "--full", "--ckpt-dir", ckdir,
              "--log-every", "1", "--mesh"]
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        first = train.main(common + ["--steps", str(TRAIN_STEPS),
                                     "--ckpt-every", str(TRAIN_CKPT_EVERY)])
        ck = Checkpointer(ckdir)
        saved = ck.all_steps()
        t0 = time.perf_counter()
        restored, at = ck.restore(bundle.abstract_inputs[:2], step=TRAIN_STEPS, device="cuda",
                                  shardings=bundle.in_shardings[:2])
        restore_s = time.perf_counter() - t0
        mine, back = (param.flatten({"0": t[0], "1": t[1]})
                      for t in ((first.params, first.opt), restored))
        want = param.flatten({"0": bundle.in_shardings[0], "1": bundle.in_shardings[1]})
        placed = all(isinstance(t, DTensor) and tuple(t.placements)
                     == want[k].placements(t.shape) for k, t in back.items())
        same = all(isinstance(a, DTensor) and a.dtype == back[k].dtype
                   and torch.equal(a.to_local(), back[k].to_local()) for k, a in mine.items())
        print(f"[train mesh] checkpoints {saved} (sharded save, rank 0 writes); step {at} "
              f"restored with shardings= on {tuple(bundle.rules.shape.items())} in "
              f"{restore_s:.2f} s: {len(mine)} leaves equal bit for bit {same}, placed as "
              f"in_shardings {placed} {'ok' if same and placed else 'FAIL'}")
        check(saved == [TRAIN_CKPT_EVERY, TRAIN_STEPS] and at == TRAIN_STEPS and same
              and placed, "train mesh checkpoint: saved steps, restored values or placements")
        del restored, back, mine
        first.params = first.opt = None
        torch.cuda.empty_cache()
        second = train.main(common + ["--steps", str(TRAIN_RESUME_STEPS), "--resume"])
        torch.cuda.synchronize()
        counts = read_counts()  # the restore between the runs launches no kernel
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    n_steps = TRAIN_STEPS + TRAIN_RESUME_STEPS
    exp = _expect(flash_attention_mma=2 * cfg.n_layers * bundle.accum * n_steps,
                  flash_attention_mma_bwd=cfg.n_layers * bundle.accum * n_steps)
    losses = first.losses + second.losses
    ref = unmeshed["losses"]
    bit_equal = losses == ref
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    med = first.median_step_s()
    quiet = [first.step_s[1], second.step_s[1]]
    print(f"[train mesh] {TRAIN_ARCH} {TRAIN_SHAPE} full on the (1,1) mesh, profile "
          f"{arch.train_profile} (accum {bundle.accum}): losses {[round(l, 4) for l in losses]} "
          f"against [train]'s: {'bit-equal' if bit_equal else f'max rel {worst:.3e}'}; step "
          f"{med * 1e3:.2f} ms (median after the first; [train] {unmeshed['median_s'] * 1e3:.2f}, "
          f"{med / unmeshed['median_s']:.2f}x; every step "
          f"{[round(t * 1e3, 2) for t in first.step_s + second.step_s]} ms; quiet steps "
          f"{[round(t * 1e3, 2) for t in quiet]} against "
          f"{[round(t * 1e3, 2) for t in unmeshed['quiet_s']]}), "
          f"{first.samples_per_step / med:.1f} images/s; peak memory {peak_gb:.3f} GB "
          f"([train] {unmeshed['peak_gb']:.3f}); launches {_nz(counts)} (implies {_nz(exp)}) "
          f"{'ok' if counts == exp else 'FAIL'}")
    check(second.start_step == TRAIN_STEPS and len(losses) == n_steps,
          "train mesh: resume step or step count")
    # not bit-equal: held to the bf16 step criterion of train_parity_phase
    check(bit_equal or worst <= TRAIN_BF16["loss_rel"],
          f"train mesh: losses {losses} against [train]'s {ref}")
    check(counts == exp, f"train mesh launches {counts} != {exp}")

    params, opt = second.params, second.opt
    batch = pipeline.place(train.host_batch(arch, cfg, pipeline.SyntheticData(), n_steps,
                                            bundle.abstract_inputs[2]), "cuda",
                           bundle.in_shardings[2])
    with use_rules(bundle.rules):
        _, grads = steps.accumulated_grads(bundle.loss_fn, params, batch, opt["step"],
                                           bundle.accum)
    t0 = time.perf_counter()
    mean = gc.compressed_psum_mean(grads, mesh)
    torch.cuda.synchronize()
    psum_ms = (time.perf_counter() - t0) * 1e3
    flat_g, flat_m = param.flatten(grads), param.flatten(mean)
    exact = all(torch.equal(flat_m[k].to_local(),
                            gc.int8_decompress(*gc.int8_compress(g.to_local()), g.dtype))
                and flat_m[k].placements == g.placements for k, g in flat_g.items())
    print(f"[train mesh] compressed_psum_mean of one step's gradients ({len(flat_g)} leaves, "
          f"{next(iter(flat_g.values())).dtype}) over the one-rank \"data\" group in "
          f"{psum_ms:.1f} ms: the int8 round trip bit for bit, placements kept {exact} "
          f"{'ok' if exact else 'FAIL'}")
    check(exact, "train mesh: compressed_psum_mean is not the int8 round trip on one rank")
    del grads, mean, flat_g, flat_m
    torch.cuda.empty_cache()
    profile_once(torch, f"train mesh {TRAIN_ARCH} {TRAIN_SHAPE} step",
                 lambda: bundle.step_fn(params, opt, batch))
    print(f"[train mesh] phase {time.perf_counter() - t_phase:.1f} s")
    return counts


# -------------------------------------------------------------------- roofline

ROOFLINE_CELL = ("vit-l16", "serve_b128")
ROOFLINE_VARIANTS = ("v0_baseline", "v1_tome_a0.10", "v2_tome_a0.20", "v3_fused_qkv",
                     "v6_tome_amax_constrained")


def fake_world_count(arch: str, shape: str) -> dict:
    """``launch.dryrun.run_cell`` of ``arch/shape`` on a fake (1,1) world, in
    a process of its own (this one holds ``[train mesh]``'s NCCL group; a
    fake world needs its own), with no card visible to it."""
    code = ("import json; from repro_torch.launch import dryrun; "
            f"rec = dryrun.run_cell({arch!r}, {shape!r}, mesh_shape=(1, 1), verbose=False); "
            "print(json.dumps(rec))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    check(res.returncode == 0, f"fake-world count of {arch}/{shape} failed:\n"
                               f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    check(rec.get("status") == "ok", f"fake-world count of {arch}/{shape}: {rec}")
    return rec


def print_roofline(label: str, rl, extra: str = "") -> None:
    print(f"[roofline] {label}: counted {rl.hlo_flops_per_device:.6e} FLOP "
          f"({ {k: f'{v:.4e}' for k, v in (rl.flops_by_dtype or {}).items()} }), "
          f"{rl.hlo_bytes_per_device:.6e} B, wire {rl.wire_bytes_per_device:.4e} B; H100 "
          f"data-sheet terms t_compute {rl.t_compute * 1e3:.3f} ms, t_memory "
          f"{rl.t_memory * 1e3:.3f} ms, t_collective {rl.t_collective * 1e3:.3f} ms -> "
          f"{rl.bottleneck}-bound at {rl.t_bound * 1e3:.3f} ms; useful_flops_ratio "
          f"{rl.useful_flops_ratio:.4f}{extra}")


def _fuse_qkv(params: dict) -> dict:
    """``params`` with every attention's wq/wk/wv (and biases) as one
    ``wqkv`` (``bqkv``), the layout of ``fused_qkv=True`` (same weights)."""
    import torch
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = _fuse_qkv(v)
        elif k in ("wq", "bq"):
            pre = k[0]
            out[f"{pre}qkv"] = torch.cat([params[f"{pre}q"], params[f"{pre}k"],
                                          params[f"{pre}v"]], dim=-1)
        elif k not in ("wk", "wv", "bk", "bv"):
            out[k] = v
    return out


def roofline_phase(torch, train_run: dict) -> dict[str, dict[str, int]]:
    """The dry-run tooling held against the card. (1) One vit-l16 cls_384
    train step at full size counted on the card on the (1,1) mesh with the
    per-rank counter, against ``dryrun.run_cell``'s count of the same bundle
    on a fake (1,1) world, then its H100 roofline terms beside ``[train]``'s
    measured median step. (2) The hill-climb cell vit-l16/serve_b128 (B=128,
    224 px, bf16) on the card on the (1,1) mesh, five variants: ms a batch,
    counted terms, launches; v0 bit-equal to ``vit.forward``, v3 within
    VISION_BF16_REL of v0, and every flash_mma and tome_scores call of the
    ToMe variants held against its plain version. Returns each counted
    run's launches."""
    from repro_torch import configs
    from repro_torch.core import pruning
    from repro_torch.data import pipeline
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import tome_scores as tome_mod
    from repro_torch.launch import hillclimb, steps, train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import param, vit
    from repro_torch.optim import adamw
    from repro_torch.runtime import hlo_bytes, roofline
    from repro_torch.sharding.rules import to_global

    t_phase = time.perf_counter()
    out = {}
    mesh = make_host_mesh(device="cuda")

    # (1) the train step, counted on the card and on a fake world
    arch = configs.get_arch(TRAIN_ARCH)
    cfg = configs.config_for_shape(arch, arch.shape(TRAIN_SHAPE))
    bundle = steps.build_bundle(TRAIN_ARCH, TRAIN_SHAPE, mesh)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = param.init_params(vit.specs(cfg), gen, "cuda", dtype=cfg.dtype)
    params, opt = steps.place_inputs(bundle, params, adamw.init_state(params))
    batch = pipeline.place(train.host_batch(arch, cfg, pipeline.SyntheticData(), 0,
                                            bundle.abstract_inputs[2]), "cuda",
                           bundle.in_shardings[2])
    torch.cuda.synchronize()
    zero_counts()
    with hlo_bytes.Counter() as counter:
        params, opt, metrics = bundle.step_fn(params, opt, batch)
        loss = float(metrics["loss"])
    torch.cuda.synchronize()
    out["roofline train count"] = counts = read_counts()
    exp = _expect(flash_attention_mma=2 * cfg.n_layers * bundle.accum,
                  flash_attention_mma_bwd=cfg.n_layers * bundle.accum)
    check(counts == exp and loss == loss, f"[roofline] train count: launches {counts} != {exp} "
                                          f"or loss {loss}")
    del params, opt, batch, metrics
    torch.cuda.empty_cache()
    fake = fake_world_count(TRAIN_ARCH, TRAIN_SHAPE)
    rl = roofline.analyze(f"{TRAIN_ARCH}/{TRAIN_SHAPE}@1x1 card", counter, 1, bundle.model_flops)
    med = train_run["median_s"]
    print_roofline(f"{TRAIN_ARCH} {TRAIN_SHAPE} train step on the card, (1,1) mesh, accum "
                   f"{bundle.accum} (remat {cfg.remat})", rl,
                   f" against model_flops {bundle.model_flops:.6e}; [train]'s measured median "
                   f"step {med * 1e3:.2f} ms reaches {rl.t_bound / med:.4f} of the bound "
                   f"({rl.t_compute / med:.4f} of the compute term)")
    flops_equal = counter.flops == fake["hlo_flops_per_device"]
    d_bytes = counter.bytes - fake["hlo_bytes_per_device"]
    print(f"[roofline] the same bundle counted by dryrun.run_cell on a fake (1,1) world "
          f"(one microbatch's step x hlo_scale {fake['hlo_scale']}): "
          f"{fake['hlo_flops_per_device']:.6e} FLOP, {fake['hlo_bytes_per_device']:.6e} B, "
          f"kernel calls {fake['kernel_calls']} (card {dict(counter.kernels)}); FLOPs equal "
          f"{flops_equal}; bytes card - fake = {d_bytes:.6e} ({d_bytes / counter.bytes:+.4%}): "
          f"the fake count has the AdamW update {fake['hlo_scale']:g} times and no f32 "
          f"accumulation of microbatch gradients, the card's step one update and the "
          f"accumulation {'ok' if flops_equal else 'FAIL'}")
    check(flops_equal, "[roofline] FLOPs counted on the card != on the fake (1,1) world")
    check({k: v for k, v in counter.kernels.items()}
          == {k: v * fake["hlo_scale"] for k, v in fake["kernel_calls"].items()},
          "[roofline] kernel calls counted on the card != the fake world's x hlo_scale")
    del counter

    # (2) the hill-climb cell on the card
    a_name, s_name = ROOFLINE_CELL
    varc = dict(hillclimb.VARIANTS[f"{a_name}/{s_name}"])
    arch = configs.get_arch(a_name)
    shape = arch.shape(s_name)
    cfg = configs.config_for_shape(arch, shape)
    p0 = param.init_params(vit.specs(cfg), torch.Generator(device="cuda").manual_seed(7),
                           "cuda", dtype=cfg.dtype)
    images = torch.randn((shape.batch, cfg.img_res, cfg.img_res, 3), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(8))
    plain_logits = vit.forward(p0, cfg, images)
    logits = {}
    flash_calls, tome_calls = {}, {}

    for variant in ROOFLINE_VARIANTS:
        kw = varc[variant]
        b = steps.build_bundle(a_name, s_name, mesh, **kw)
        fused = kw.get("config_patch", {}).get("fused_qkv", False)
        args = steps.place_inputs(b, _fuse_qkv(p0) if fused else p0,
                                  {"images": images, "labels": torch.zeros(
                                      shape.batch, dtype=torch.int32, device="cuda")})
        b.step_fn(*args)  # warm-up
        ms = time_ms(lambda: b.step_fn(*args), 3)
        torch.cuda.synchronize()
        flash_calls.clear()
        tome_calls.clear()
        zero_counts()
        with hlo_bytes.Counter() as c, recording(flash_mod, "flash_attention", flash_calls), \
                recording(tome_mod, "tome_scores", tome_calls):
            y = b.step_fn(*args)
        torch.cuda.synchronize()
        counts = read_counts()
        out[f"roofline {a_name} {s_name} {variant}"] = counts
        logits[variant] = to_global(y)
        alpha = kw.get("janus_alpha")
        sched = (pruning.make_schedule("exponential", alpha, cfg.n_layers, cfg.num_tokens)
                 if alpha is not None else [0] * cfg.n_layers)
        exp = _expect(flash_attention_mma=cfg.n_layers,
                      tome_scores=sum(1 for r in sched if r > 0))
        rl = roofline.analyze(f"{a_name}/{s_name}#{variant}", c, 1, b.model_flops)
        print_roofline(f"{a_name} {s_name} {variant} ({kw}{b.notes}) on the card", rl,
                       f"; {ms:.3f} ms a batch of {shape.batch}, {shape.batch / ms * 1e3:.1f} "
                       f"images/s, {rl.t_bound * 1e3 / ms:.4f} of the bound; launches "
                       f"{_nz(counts)} (implies {_nz(exp)}) "
                       f"{'ok' if counts == exp else 'FAIL'}")
        check(counts == exp, f"[roofline] {variant} launches {counts} != {exp}")
        # every kernel call of this run against its plain version (not counted)
        _, flash_err = check_flash_calls(f"[roofline] {variant}", flash_calls)
        _, tome_err = check_tome_calls(f"[roofline] {variant}", tome_calls)
        shapes = sorted({tuple(q.shape) for (q, _, _), _, _ in flash_calls.values()},
                        key=lambda t: -t[2])
        biased = sum(kwargs.get("bias") is not None for _, kwargs, _ in flash_calls.values())
        tshapes = [(tuple(a.shape), tuple(bb.shape)) for (a, bb, *_), _, _ in tome_calls.values()]
        print(f"[roofline] {variant} kernels against their plain versions on the card: "
              f"flash_mma {len(flash_calls)} calls (q shapes {shapes[0]} .. {shapes[-1]}, "
              f"{biased} with the ToMe bias) max_abs_err {flash_err:.3e} (tol {FLASH_BF16} "
              f"and {FLASH_BF16_REL} x max|plain|); tome_scores {len(tome_calls)} calls "
              f"{tshapes[:1]} .. {tshapes[-1:]} max_abs_err {tome_err:.3e} (tol {TOME_MAX}) ok")
        del args, b, y
    flash_calls.clear()
    tome_calls.clear()
    same = torch.equal(logits["v0_baseline"], plain_logits)
    v0 = logits["v0_baseline"].float()
    rel3 = ((logits["v3_fused_qkv"].float() - v0).abs().max() / v0.abs().max()).item()
    print(f"[roofline] v0_baseline logits bit-equal to vit.forward on the same weights: {same}; "
          f"v3_fused_qkv against v0: max|d| / max|v0| {rel3:.4e} (tol {VISION_BF16_REL}) "
          f"{'ok' if same and rel3 <= VISION_BF16_REL else 'FAIL'}")
    check(same, "[roofline] v0_baseline logits differ from vit.forward")
    check(rel3 <= VISION_BF16_REL, "[roofline] v3_fused_qkv logits far from v0's")
    dt = time.perf_counter() - t_phase
    print(f"[roofline] phase {dt:.1f} s")
    return out


if __name__ == "__main__":
    sys.exit(main())
