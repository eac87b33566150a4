#!/usr/bin/env python3
"""Ablations of the bf16 decode kernel (``csrc/decode_attention_mma.cu``) on
the card: what its one-launch combine costs, and which split counts and ring
depth serve the decode shapes.

    python tools/decode_mma_ablations.py          (on the machine with the card)
    python tools/decode_mma_ablations.py --parent old/decode_attention_mma.cu

Each variant is the kernel's source with a change spliced in at fixed
anchors (the script fails if an anchor no longer matches the source), built
by nvcc with the build's flags into ``build/decode_mma_ablations/``, loaded
with ctypes and timed queued behind a sleep kernel
(``repro_torch.benchmarks.timing.time_ms``) at the decode shapes, at each of
a few split counts. Variants:

  base         the kernel as it is
  no_combine   no cluster: each block returns with its partial merged in
               shared memory (the split pass alone; wrong output)
  launch_only  the same, launched as clusters (the cluster launch's cost)
  ring192      a 192 KB ring (6 K/V pairs at D=128, 12 at D=64) at one
               block an SM, which holds a block's whole share at the path
               shapes
  parent       with ``--parent``: an older source whose C entry takes (q, k,
               v, lengths, part_acc, part_m, part_l, out, B, Hq, Hkv, S, D,
               nsplit, stream) and combines in a second launch, at its own
               split rule

Outputs of variants that remove work are wrong by design; their error is not
checked. No number here comes from the CPU.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = {  # (B, Hq, Hkv, S, D, length), split counts
    "starcoder2": ((8, 24, 2, 2048, 128, 1088), (2, 4, 8)),
    "qwen3": ((8, 32, 4, 2048, 128, 1088), (2, 4, 8)),
    "granite": ((8, 24, 8, 2048, 64, 1040), (1, 2, 4)),
    "b8_s8192": ((8, 24, 2, 8192, 128, 8192), (4, 8, 16)),
    "b1_s32768": ((1, 24, 2, 32768, 128, 32768), (16, 32, 64, 128)),
}
WRONG = ("no_combine", "launch_only")
RETURN_AT = ("  cluster_wait();  // every rank's barrier is initialised\n", "  return;\n")
NO_ARRIVE = ("  if (p.nsplit > 1) cluster_arrive();", "")
NO_ATTR = ("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")
SPLICES = {
    "base": [],
    "no_combine": [RETURN_AT, NO_ARRIVE, NO_ATTR],
    "launch_only": [RETURN_AT, NO_ARRIVE],
    "ring192": [("STAGES = D == 64 ? 6 : 3;", "STAGES = D == 64 ? 12 : 6;"),
                ("__launch_bounds__(THREADS, 2)\ndecode_mma_kernel(",
                 "__launch_bounds__(THREADS, 1)\ndecode_mma_kernel(")],
}


def build(out_dir: pathlib.Path, sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """One nvcc a variant, all at once; each variant's ptxas lines printed."""
    from repro_torch.kernels import _build
    jobs = {}
    for tag, text in sources.items():
        cu, so = out_dir / f"{tag}.cu", out_dir / f"lib{tag}.so"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        jobs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), so)
    libs = {}
    for tag, (proc, so) in jobs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            sys.exit(f"nvcc failed for {tag}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "stack frame" in line:
                print(f"[{tag}] {line.strip()}")
        libs[tag] = ctypes.CDLL(str(so))
    return libs


def caller(torch, lib, tag, q, k, v, lens, nsplit, counters):
    """One call of a variant's C entry at ``nsplit`` splits."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    rows = b * hq * nsplit
    part = torch.empty(rows * (d + 2), dtype=torch.float32, device=q.device)
    acc = part.data_ptr()
    m = acc + rows * d * 4
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    fwd = lib.decode_attention_mma_fwd
    if tag == "parent":
        fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), acc, m,
                m + rows * 4, out.data_ptr())
    else:
        fwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        maps = ctypes.create_string_buffer(256)
        lib.decode_attention_mma_maps.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        assert lib.decode_attention_mma_maps(k.data_ptr(), v.data_ptr(), b, s, hkv, d, maps) == 0
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), maps, lens.data_ptr(), acc, m,
                m + rows * 4, counters.data_ptr(), out.data_ptr())

    def call():
        err = fwd(*args, b, hq, hkv, s, d, nsplit, stream)
        if err:
            raise RuntimeError(f"{tag}: error {err}")
        return out
    return call


def parent_splits(b, hq, hkv, s) -> int:
    """The two-launch kernel's split rule: at least 4 tiles of 64 positions
    of capacity a split, up to about two blocks an SM."""
    blocks = b * hkv * -(-(hq // hkv) // 16)
    return max(1, min(-(-(-(-s // 64)) // 4), 2 * 132 // blocks))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an older decode_attention_mma.cu (two launches)")
    ap.add_argument("--variants", default=",".join(SPLICES), help="comma-separated")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("decode_mma_ablations: needs a CUDA card")
    from repro_torch.benchmarks.timing import time_ms
    from repro_torch.kernels import _build, ref

    src = (_build.CSRC / "decode_attention_mma.cu").read_text()
    sources = {}
    for tag in args.variants.split(","):
        text = src
        for old, new in SPLICES[tag]:
            if old not in text:
                sys.exit(f"{tag}: anchor no longer in the source: {old!r}")
            text = text.replace(old, new)
        sources[tag] = text
    if args.parent:
        sources["parent"] = pathlib.Path(args.parent).read_text()
    out_dir = ROOT / "build" / "decode_mma_ablations"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build(out_dir, sources)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    counters = torch.zeros(1 << 16, dtype=torch.int32, device=dev)
    for label, ((b, hq, hkv, s, d, n), splits) in SHAPES.items():
        q = torch.randn((b, hq, d), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev).bfloat16() for _ in "kv")
        lens = torch.full((b,), n, dtype=torch.int32, device=dev)
        want = ref.decode_attention_ref(q, k, v, lens).float()
        res = []
        for tag, lib in libs.items():
            for ns in (parent_splits(b, hq, hkv, s),) if tag == "parent" else splits:
                fn = caller(torch, lib, tag, q, k, v, lens, ns, counters)
                err = (fn().float() - want).abs().max().item()
                torch.cuda.synchronize()
                if tag not in WRONG and not err <= 2e-2:
                    sys.exit(f"{tag}/{ns} at {label}: max_abs_err {err:.3e}")
                res.append(f"{tag}/{ns} {time_ms(fn, queued=True):.4f}")
        print(f"[decode ablation] {label} [{b},{hq},{hkv},{s},{d}] length {n}, queued ms: "
              + ", ".join(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
