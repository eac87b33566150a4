#!/usr/bin/env python3
"""Ablations of the bf16 flash forward (``csrc/flash_attention_mma.cu``) on
the card: what holds it, measured by taking one piece away at a time.

    python tools/flash_mma_ablations.py                 (on the machine with the card)
    python tools/flash_mma_ablations.py --variants base:,trace:-DTRACE --shapes flux_gen1024

Each variant is the kernel's source with switches spliced in at fixed
anchors (the script fails if an anchor no longer matches the source), built
by nvcc with the build's flags plus the variant's ``-D`` flags into
``build/flash_mma_ablations/``, loaded with ctypes and timed queued behind a
sleep kernel (``repro_torch.benchmarks.timing.time_ms``) at the paths' calls.
Each variant's ptxas registers, spills and C7511 notes (ptxas serialising
the wgmmas) are printed. Switches:

  NO_S        the S products reduced to their first k-step
  NO_PV       no O += P.V product
  NO_EXP      the softmax's weights without their exponentials
  HEAD_MAJOR  the grid with heads varying fastest (this kernel: query blocks)
  FORCE_W=n   n consumer warpgroups a block at every call
  STG=n       n ring stages at two warpgroups a block
  MB=n        n blocks an SM asked of the launch bound at one warpgroup
  QREG_ALL    Q in registers at D=128 too
  TRACE       clock64 marks around each pipelined step of one block's
              consumer threads 0: the mean clocks of a step and of its
              phases (full wait, -, issue, S wait, softmax, P.V wait and
              rescale, release and pack), printed per warpgroup

Outputs of variants that remove work are wrong by design; their error is
printed and not checked. No number here comes from the CPU.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention_mma.cu"
OUT = ROOT / "build" / "flash_mma_ablations"

# (label, B, H, S, D, causal, bias): kernel_bench's flash_attention_mma rows
# and the ViT B=1 path call
SHAPES = (("flux_gen1024", 4, 24, 4608, 128, False, False),
          ("flux_1536", 16, 24, 1536, 128, False, False),
          ("qwen3_prefill", 8, 32, 1024, 128, True, False),
          ("starcoder2_prefill", 8, 24, 1024, 128, True, False),
          ("vit_l16_train_fwd", 32, 16, 577, 64, False, False),
          ("vit_b8_bias", 8, 16, 577, 64, False, True),
          ("vit_b1_bias", 1, 16, 577, 64, False, True),
          ("dit_s2_bias", 4, 6, 4096, 64, False, True))

LOOP = """    for (int j = 1; j < n_full; ++j) {
      full_wait(j);
      s_product(sc, j % C::STAGES);
      pv_product(pf, (j - 1) % C::STAGES);
      wg_wait<1>();
      reg_fence(sc);
      softmax(sc, j * BN, j % C::STAGES);
      wg_wait<0>();
      reg_fence(o);
      reg_fence(pf);
      rescale();
      release(j - 1);
      pack(pf, sc);
    }"""
TRACED_LOOP = """    for (int j = 1; j < n_full; ++j) {
      TR(0);
      full_wait(j);
      TR(1);
      s_product(sc, j % C::STAGES);
      pv_product(pf, (j - 1) % C::STAGES);
      TR(2);
      wg_wait<1>();
      reg_fence(sc);
      TR(3);
      softmax(sc, j * BN, j % C::STAGES);
      reg_fence(sc);
      TR(4);
      wg_wait<0>();
      reg_fence(o);
      reg_fence(pf);
      rescale();
      TR(5);
      release(j - 1);
      pack(pf, sc);
      reg_fence(pf);
      TR(6);
    }"""
PHASES = ("full wait", "issue", "S wait", "softmax", "P.V wait + rescale", "release + pack")


def _ifdef(flag: str, on: str, off: str) -> str:
    return f"#ifdef {flag}\n{on}\n#else\n{off}\n#endif"


def variant_source() -> str:
    """The kernel's source with every switch of the module's docstring."""
    src = SRC.read_text().replace('#include "hopper.cuh"', f'#include "{SRC.parent}/hopper.cuh"')

    def splice(old: str, new: str) -> None:
        nonlocal src
        if src.count(old) != 1:
            raise SystemExit(f"flash_mma_ablations: anchor not found once in {SRC}:\n{old}")
        src = src.replace(old, new)

    line = "    for (int ks = 0; ks < NK; ++ks) wgmma_rs<D>(o, f[ks], dv + ((ks * 2048) >> 4));"
    splice(line, _ifdef("NO_PV", "", line))
    line = ("    for (int kk = 0; kk < D / 16; ++kk) {\n"
            "      const uint32_t rb = ((kk >> 2) * C::KV_PANEL + (kk & 3) * 32) >> 4;")
    splice(line, _ifdef("NO_S", line.replace("kk < D / 16", "kk < 1"), line))
    if src.count("] = ex2(") != 8:  # the softmax's weights, both of its paths
        raise SystemExit(f"flash_mma_ablations: the softmax's ex2 calls moved in {SRC}")
    src = src.replace("] = ex2(", "] = EX2(")
    line = "  const int bh = blockIdx.x / n_q_blocks, qb = blockIdx.x % n_q_blocks, b = bh / p.H;"
    splice(line, _ifdef("HEAD_MAJOR", "  const int n_bh = gridDim.x / n_q_blocks;\n"
                        "  const int bh = blockIdx.x % n_bh, qb = blockIdx.x / n_bh, b = bh / p.H;",
                        line))
    line = "  return (long long)B * H * ((Sq + 127) / 128) >= sms ? 2 : 1;"
    splice(line, "#ifdef FORCE_W\n  return FORCE_W;\n#endif\n" + line)
    line = "  static constexpr int STAGES = W == 2 || D == 64 ? 4 : 2;"
    splice(line, _ifdef("STG", "  static constexpr int STAGES = W == 2 ? STG : (D == 64 ? 4 : 2);",
                        line))
    line = "  static constexpr int MIN_BLOCKS = W == 2 ? 1 : (D == 64 ? 3 : 2);"
    splice(line, _ifdef("MB", "  static constexpr int MIN_BLOCKS = W == 2 ? 1 : MB;", line))
    line = "constexpr bool Q_REGS = D == 64;"
    splice(line, _ifdef("QREG_ALL", "constexpr bool Q_REGS = true;", line))
    splice(LOOP, TRACED_LOOP)
    splice("namespace {\n\nconstexpr int BN", """namespace {
#ifdef NO_EXP
#define EX2(x) (x)
#else
#define EX2(x) ex2(x)
#endif
#ifdef TRACE
__device__ long long g_trace[2][7][128];
#define TR(k) do { if (traced && tid == 0 && j < 128) g_trace[wg][k][j] = clock64(); } while (0)
#else
#define TR(k) do {} while (0)
#endif

constexpr int BN""")
    splice("  if (r0 >= p.Sq) return;\n",
           "  if (r0 >= p.Sq) return;\n  const bool traced = blockIdx.x == gridDim.x / 2;\n"
           "  (void)traced;\n")
    return src + """
#ifdef TRACE
// copies the marks out and clears them
extern "C" int read_trace(long long* host) {
  static long long zeros[2 * 7 * 128] = {};
  cudaError_t err = cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_trace, zeros, sizeof(g_trace));
  return (int)err;
}
#endif
"""


def ptxas_notes(log: str) -> str:
    """``D/W:registers r spill B`` a kernel instantiation, and ``C7511 D/W``
    where ptxas serialised the wgmmas."""
    out, cur, spill = [], "?", "?"
    for line in log.splitlines():
        m = re.search(r"kernelILi(\d+)ELi(\d)E", line)
        if "Compiling entry" in line and m:
            cur = f"{m.group(1)}/{m.group(2)}"
        elif "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+)", line).group(1)
            out.append(f"{cur}:{regs}r{spill}B")
        elif "C7511" in line and m:
            out.append(f"C7511 {m.group(1)}/{m.group(2)}")
    return " ".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="base:,no_s:-DNO_S,no_pv:-DNO_PV,no_exp:-DNO_EXP,"
                    "head_major:-DHEAD_MAJOR,trace:-DTRACE",
                    help="name:flags pairs, comma-separated; flags space-separated")
    ap.add_argument("--shapes", default=",".join(s[0] for s in SHAPES))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    from repro_torch.benchmarks.timing import PEAK_BF16, time_ms
    from repro_torch.kernels import _build, ref
    if not torch.cuda.is_available():
        raise SystemExit("flash_mma_ablations: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "flash_attention_mma.cu").write_text(variant_source())
    jobs = {}
    for item in args.variants.split(","):
        name, flags = item.split(":")
        so = OUT / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags.split(), "-o", str(so),
               str(OUT / "flash_attention_mma.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise SystemExit(f"flash_mma_ablations: nvcc failed for {name}:\n{log}")
        print(f"[ablation] {name} ptxas: {ptxas_notes(log)}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
        libs[name].flash_attention_mma_fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                                                       + [ctypes.c_void_p])

    dev = torch.device("cuda")

    def call(lib, q, k, v, bias, causal):
        out = torch.empty_like(q)
        b, h, s, d = q.shape
        err = lib.flash_attention_mma_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
            None, out.data_ptr(), None, b, h, s, s, d, int(causal),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_mma_ablations: launch failed, error {err}")
        return out

    wanted = args.shapes.split(",")
    for label, b, h, s, d, causal, with_bias in SHAPES:
        if label not in wanted:
            continue
        gen = torch.Generator(device=dev).manual_seed(1)
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in "qkv")
        bias = (torch.log(torch.rand((b, s), generator=gen, device=dev) + 0.5) if with_bias
                else None)
        flops = 4.0 * b * h * d * (s * (s + 1) / 2 if causal else s * s)
        exp = ref.flash_attention_ref(q, k, v, bias=bias, causal=causal) if s <= 2048 else None
        iters = 10 if s > 1024 or causal else 30
        cells = []
        for name, lib in libs.items():
            err = float("nan")
            if exp is not None:
                err = (call(lib, q, k, v, bias, causal).float() - exp.float()).abs().max().item()
            ms = time_ms(lambda lib=lib: call(lib, q, k, v, bias, causal), iters, queued=True)
            cells.append(f"{name} {ms:.4f} ms ({flops / PEAK_BF16 * 1e3 / ms:.3f} of the "
                         f"operations bound, err {err:.1e})")
            if hasattr(lib, "read_trace"):  # one traced launch after the marks are cleared
                buf = np.zeros((2, 7, 128), dtype=np.int64)
                for launch in (False, True):
                    if launch:
                        call(lib, q, k, v, bias, causal)
                    torch.cuda.synchronize()
                    if lib.read_trace(ctypes.c_void_p(buf.ctypes.data)) != 0:
                        raise RuntimeError("flash_mma_ablations: read_trace failed")
                for w in range(2):
                    marks = buf[w].astype(np.float64)
                    steps = np.nonzero((marks[0] > 0) & (marks[6] > 0))[0][2:-2]
                    if len(steps) < 4:
                        continue
                    phases = np.diff(marks[:, steps], axis=0).mean(axis=1)
                    step = np.diff(marks[0, steps]).mean()
                    print(f"[ablation] {name} {label} warpgroup {w}: {step:.0f} clocks a step over "
                          f"{len(steps)} steps; " + ", ".join(
                              f"{p} {x:.0f}" for p, x in zip(PHASES, phases)), flush=True)
        print(f"[ablation] {label} [{b},{h},{s},{d}]{' causal' if causal else ''}"
              f"{' bias' if with_bias else ''}: " + "; ".join(cells), flush=True)
        del q, k, v, exp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
