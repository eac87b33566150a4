"""Kernel micro-benchmarks on the card, PyTorch port of
``benchmarks/kernel_bench.py``.

The reference times jnp oracles on the host against TPU v5e constants;
neither carries over. Here each row is one of the port's Hopper kernels at
one shape: its wrapper is checked against its plain PyTorch version
(``kernels/ref.py``) on the same inputs, then timed queued behind a sleep
kernel (``timing.time_ms(queued=True)``: the card's time per call, the
host's per-call overhead hidden) beside its plain version and one library
call computing the same function (SDPA; ``bmm`` + ``max(-1)``; a plain
flash version whose f32 scores pass PLAIN_QUEUED_MAX_BYTES back to back,
``plain_timing`` says which), and set against its H100 bound (``timing.bound``: the bytes each input read once
and each output written once over HBM's rate, or the operations over the
dtype's peak, whichever is larger).

Rows, part 1: the reference's three shapes in its dtype (f32), on the f32
kernels: tome_scores [8,289,64] x [8,288,64] (also the ViT path's B=8
call), flash [1,16,577,64], decode [8,24,128] over a full [8,4096,2,128]
cache. Part 2: the paths' bf16 calls: flash_attention_mma at ViT B=8 with
the ToMe bias and at starcoder2's causal prefill [8,24,1024,128], and
decode_attention_mma at starcoder2's last decode step. Part 3: the flash
backward (``flash_bwd``) at the train calls: flash_attention_mma_bwd (wgmma
and TMA since slice 15) at vit-l16 ``cls_384`` [32,16,577,64] and an LM
train shape [2,24,1024,128] causal, flash_attention_bwd at the f32 train parity's [4,16,577,64] and
at D=16 [8,4,577,16]; the plain version is ``ref.flash_attention_bwd_ref``,
the library call SDPA's backward alone (``autograd.grad`` of a retained
graph). Part 4: the f32 decode kernel (``decode_attention``) at the shapes
it is judged on: the f32 LM paths' last decode steps (starcoder2-3b group 12,
qwen3-moe group 8, granite-moe group 3 at D=64) and two long full caches
(B=8 over 8192 positions, B=1 over 32768). Every decode row also carries
``cold_l2_ms``, its time with the L2 flushed before each call
(``timing.time_cold_ms``): its path shapes' caches fit in the 50 MB L2.
Part 5: flash_attention_mma where it lost most to SDPA: flux-dev
``gen_1024`` [4,24,4608,128] and [16,24,1536,128], the qwen3-moe prefill
[8,32,1024,128] causal, vit-l16 ``cls_384``'s train forward [32,16,577,64],
dit-s2 ``gen_1024`` [4,6,4096,64] with the log-size bias, and the Janus
path's one-frame call [1,16,577,64] with the bias.

``rows()`` keeps the reference's ``(name, us_per_call, derived)`` shape:
the kernel's µs a call and its bound in µs. Without a card it refuses: no
CPU time is ever written under a kernel's name.

  python -m repro_torch.benchmarks.kernel_bench   (on the card)
  (writes experiments/torch/bench/BENCH_kernel.json)
"""
from __future__ import annotations

import argparse
import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.benchmarks import common
from repro_torch.benchmarks.timing import PEAK_BF16, PEAK_F32, bound, time_cold_ms, time_ms
from repro_torch.kernels import decode_attention as decode_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import tome_scores as tome_mod
from repro_torch.runtime.device import parity_numerics

# each kernel against its plain version, by dtype (tests/test_kernels.py's
# limits for f32; bf16 outputs are rounded once from f32 math on both sides)
FLASH_F32 = dict(atol=2e-5, rtol=1e-4)
FLASH_BF16 = dict(atol=2e-2, rtol=0.0)
# bf16 flash, beside FLASH_BF16: max|kernel - plain| <= FLASH_BF16_REL * max|plain|.
# At S in the thousands an output is ~sqrt(e/S) ~ 0.025, so 2e-2 alone is
# loose; chip_smoke.py shows that a plainly wrong kernel (one key tile
# dropped, one query tile wrong, the bias ignored) reads above it.
FLASH_BF16_REL = 3e-2
TOME_MAX = dict(atol=2e-5, rtol=1e-3)   # tests/test_kernels.py:29-30
DECODE_F32 = dict(atol=2e-5, rtol=1e-4)  # tests/test_kernels.py:113
DECODE_BF16 = dict(atol=2e-2, rtol=0.0)
# flash backward dq/dk/dv, max|d| <= this x max|g|: bf16 against the f32
# gradient, P, dS and the gradients rounded to bf16 once (sound readings
# 2.7e-3 to 3.9e-3 of max|g| on the card, 2.4e-3 to 4.9e-3 on the CPU; the
# wrong backwards of chip_smoke.py's wrong_flash_backwards read 0.17 and
# above on the CPU); f32 both f32 throughout, only sums differ in order
FLASH_BWD_BF16_OF_MAX = 1e-2
FLASH_BWD_F32_OF_MAX = 1e-4
# a flash call's plain version materialises its f32 scores [B, H, Sq, Sk]; past
# this many bytes its allocations stall the host, which then cannot queue the
# calls behind the sleep kernel (flux-dev gen_1024's 8.2 GB), so it is timed
# back to back
PLAIN_QUEUED_MAX_BYTES = 2 << 30


@dataclasses.dataclass(frozen=True)
class Case:
    """One row: a kernel family at one call shape.

    flash and flash_bwd (its backward): ``shape`` = (B, H, S, D),
    ``causal``, ``bias`` (a [B, S] log-size bias; flash only); decode:
    ``shape`` = (B, Hq, Hkv, S, D), ``length`` (valid cache entries); tome:
    ``shape`` = (B, Na, Nb, D), always f32. The backward's FLOPs and bytes
    are the counter's own, ``ops.flash_bwd_cost``."""
    label: str
    family: str
    shape: tuple[int, ...]
    dtype: torch.dtype
    causal: bool = False
    bias: bool = False
    length: int = 0

    @property
    def peak(self) -> float:
        return PEAK_BF16 if self.dtype == torch.bfloat16 else PEAK_F32

    def _bwd_cost(self) -> tuple[float, float]:
        q = torch.empty(self.shape, dtype=self.dtype, device="meta")
        return ops.flash_bwd_cost(q, q, q, causal=self.causal)[:2]

    def flops(self) -> float:
        if self.family == "flash":
            b, h, s, d = self.shape
            # causal: S * (S + 1) / 2 (query, key) pairs of 4 * D flops
            pairs = s * (s + 1) / 2 if self.causal else s * s
            return 4.0 * b * h * d * pairs
        if self.family == "flash_bwd":
            return self._bwd_cost()[0]
        if self.family == "decode":
            b, hq, _, _, d = self.shape
            return 4.0 * b * hq * self.length * d
        b, na, nb, d = self.shape
        return 2.0 * b * na * nb * d

    def nbytes(self) -> float:
        elt = torch.finfo(self.dtype).bits // 8
        if self.family == "flash":  # q, k, v read, out written; the f32 bias read
            b, _, s, _ = self.shape
            return 4.0 * math.prod(self.shape) * elt + (b * s * 4 if self.bias else 0)
        if self.family == "flash_bwd":
            return self._bwd_cost()[1]
        if self.family == "decode":  # the valid cache read once, q read, out written
            b, hq, hkv, _, d = self.shape
            return (2.0 * b * self.length * hkv * d + 2 * b * hq * d) * elt + b * 4
        b, na, nb, d = self.shape  # a and b read; max (f32) and index (int32) written
        return (b * na * d + b * nb * d) * 4.0 + b * na * 8

    def bound(self) -> tuple[float, str]:
        return bound(self.flops(), self.nbytes(), self.peak)

    def plain_queued(self) -> bool:
        """Whether the plain version is timed queued (see
        PLAIN_QUEUED_MAX_BYTES), else back to back."""
        if self.family != "flash":
            return True
        b, h, s, _ = self.shape
        return 4 * b * h * s * s <= PLAIN_QUEUED_MAX_BYTES

    def kernel(self) -> str:
        """The name of the kernel the wrapper routes this call to."""
        if self.family == "flash":
            return flash_mod.kernel_for(self.dtype, self.shape[-1])
        if self.family == "flash_bwd":
            return flash_mod.BWD[flash_mod.kernel_for(self.dtype, self.shape[-1])]
        if self.family == "decode":
            return decode_mod.kernel_for(self.dtype, self.shape[-1])
        return "tome_scores"


CASES = (
    # part 1: the reference's shapes, f32
    Case("vit_b8_f32", "tome", (8, 289, 288, 64), torch.float32),
    Case("vit_b1_f32", "flash", (1, 16, 577, 64), torch.float32),
    Case("starcoder2_s4096_f32", "decode", (8, 24, 2, 4096, 128), torch.float32, length=4096),
    # part 2: the paths' bf16 calls
    Case("vit_b8_bias_bf16", "flash", (8, 16, 577, 64), torch.bfloat16, bias=True),
    Case("starcoder2_prefill_causal_bf16", "flash", (8, 24, 1024, 128), torch.bfloat16,
         causal=True),
    Case("starcoder2_decode_bf16", "decode", (8, 24, 2, 2048, 128), torch.bfloat16,
         length=1088),
    # part 3: the flash backward at the train calls
    Case("vit_l16_train_bwd_bf16", "flash_bwd", (32, 16, 577, 64), torch.bfloat16),
    Case("lm_train_causal_bwd_bf16", "flash_bwd", (2, 24, 1024, 128), torch.bfloat16,
         causal=True),
    Case("vit_l16_f32_parity_bwd_f32", "flash_bwd", (4, 16, 577, 64), torch.float32),
    # the smoke ViTs' head dim, D=16, at 577 tokens
    Case("d16_bwd_f32", "flash_bwd", (8, 4, 577, 16), torch.float32),
    # part 4: the f32 decode kernel at the f32 paths' last steps and two long caches
    Case("starcoder2_decode_f32", "decode", (8, 24, 2, 2048, 128), torch.float32, length=1088),
    Case("qwen3_decode_f32", "decode", (8, 32, 4, 2048, 128), torch.float32, length=1088),
    Case("granite_decode_f32", "decode", (8, 24, 8, 2048, 64), torch.float32, length=1040),
    Case("long_cache_b8_f32", "decode", (8, 24, 2, 8192, 128), torch.float32, length=8192),
    Case("long_cache_b1_f32", "decode", (1, 24, 2, 32768, 128), torch.float32, length=32768),
    # part 5: the bf16 forward where it lost most to SDPA: flux-dev gen_1024's
    # two joint-attention calls, qwen3-moe's causal prefill, vit-l16 cls_384's
    # train forward (no bias) and dit-s2 gen_1024 with the log-size bias; and
    # the Janus path's one-frame call (ViT-L@384 at B=1, the bias), its
    # smallest grid
    Case("flux_gen1024_bf16", "flash", (4, 24, 4608, 128), torch.bfloat16),
    Case("flux_1536_bf16", "flash", (16, 24, 1536, 128), torch.bfloat16),
    Case("qwen3_prefill_causal_bf16", "flash", (8, 32, 1024, 128), torch.bfloat16, causal=True),
    Case("vit_l16_train_fwd_bf16", "flash", (32, 16, 577, 64), torch.bfloat16),
    Case("dit_s2_bias_bf16", "flash", (4, 6, 4096, 64), torch.bfloat16, bias=True),
    Case("vit_b1_bias_bf16", "flash", (1, 16, 577, 64), torch.bfloat16, bias=True),
)


def _require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_bench times kernels on a CUDA card and "
                           "torch.cuda.is_available() is False; no CPU time is "
                           "reported under a kernel's name")


def _calls(case: Case, gen: torch.Generator):
    """(kernel, plain version, library call, tolerance, library's name,
    check) at the case: ``check(got, want)`` is (max|kernel - plain|, ok)."""
    dev = torch.device("cuda")
    if case.family == "flash":
        b, h, s, d = case.shape
        q, k, v = (torch.randn(case.shape, generator=gen, device=dev).to(case.dtype)
                   for _ in "qkv")
        bias = None
        if case.bias:
            bias = torch.log(torch.randint(1, 5, (b, s), generator=gen, device=dev).float())
        mask = None if bias is None else bias[:, None, None, :].to(case.dtype)
        tol = (FLASH_F32 if case.dtype == torch.float32
               else dict(FLASH_BF16, of_max_plain=FLASH_BF16_REL))
        return (lambda: flash_mod.flash_attention(q, k, v, bias=bias, causal=case.causal),
                lambda: ref.flash_attention_ref(q, k, v, bias=bias, causal=case.causal),
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                       is_causal=case.causal),
                tol, "torch.nn.functional.scaled_dot_product_attention",
                lambda got, want: flash_close(got, want))
    if case.family == "flash_bwd":
        q, k, v, dout = (torch.randn(case.shape, generator=gen, device=dev).to(case.dtype)
                         for _ in range(4))
        out, lse = flash_mod._forward(q, k, v, None, None, case.causal, True)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=case.causal)
        of_max = FLASH_BWD_F32_OF_MAX if case.dtype == torch.float32 else FLASH_BWD_BF16_OF_MAX
        return (lambda: flash_mod.backward(q, k, v, out, dout, causal=case.causal, lse=lse),
                lambda: ref.flash_attention_bwd_ref(q, k, v, out, dout, causal=case.causal),
                lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True),
                {"of_max_plain": of_max},
                "torch.autograd.grad of torch.nn.functional.scaled_dot_product_attention "
                "(the backward alone, its graph retained)",
                lambda got, want: flash_bwd_close(got, want, of_max))
    if case.family == "decode":
        b, hq, hkv, s, d = case.shape
        q = torch.randn((b, hq, d), generator=gen, device=dev).to(case.dtype)
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev).to(case.dtype)
                for _ in "kv")
        lens = torch.full((b,), case.length, dtype=torch.int32, device=dev)
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))  # [B, Hkv, S, D]
        mask = (torch.arange(s, device=dev) < lens[:, None])[:, None, None, :]
        tol = DECODE_F32 if case.dtype == torch.float32 else DECODE_BF16
        return (lambda: decode_mod.decode_attention(q, k, v, lens),
                lambda: ref.decode_attention_ref(q, k, v, lens),
                lambda: F.scaled_dot_product_attention(q[:, :, None], kt, vt, attn_mask=mask,
                                                       enable_gqa=True)[:, :, 0],
                tol, "torch.nn.functional.scaled_dot_product_attention (enable_gqa, length mask)",
                lambda got, want: _close(got, want, tol))
    b, na, nb, d = case.shape
    a = F.normalize(torch.randn((b, na, d), generator=gen, device=dev), dim=-1)
    bb = F.normalize(torch.randn((b, nb, d), generator=gen, device=dev), dim=-1)
    return (lambda: tome_mod.tome_scores(a, bb),
            lambda: ref.tome_scores_ref(a, bb),
            lambda: torch.bmm(a, bb.transpose(1, 2)).max(-1),
            TOME_MAX, "torch.bmm(a, b.transpose(1, 2)).max(-1)",
            lambda got, want: tome_close(a, bb, None, got, want))


def flash_close(got, want) -> tuple[float, bool]:
    """max|kernel - plain| and whether a flash output is within its dtype's
    limits: FLASH_F32, or FLASH_BF16 and FLASH_BF16_REL x max|plain|."""
    if got.dtype == torch.float32:
        return _close(got, want, FLASH_F32)
    err, ok = _close(got, want, FLASH_BF16)
    return err, ok and err <= FLASH_BF16_REL * want.float().abs().max().item()


def flash_bwd_close(got, want, of_max: float) -> tuple[float, bool]:
    """max|kernel - plain| over dq, dk, dv, and whether it is within
    ``of_max`` of the largest |plain| gradient."""
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got[:3], want[:3]))
    scale = max(w.float().abs().max().item() for w in want[:3])
    return err, all(bool(torch.isfinite(g).all()) for g in got[:3]) and err <= of_max * scale


def tome_close(a, b, nb_len, got, want) -> tuple[float, bool]:
    """The maxima within TOME_MAX, and the score at the kernel's index equal
    to the maximum within TOME_MAX (a tie may pick another index); the error
    is the larger of the two."""
    (m, i), (mr, _) = got, want
    scores = torch.bmm(a, b.transpose(1, 2))
    if nb_len is not None:
        col = torch.arange(b.shape[1], device=b.device)
        scores = scores.masked_fill(col[None, None, :] >= nb_len[:, None, None], -torch.inf)
    at_idx = torch.gather(scores, 2, i.long()[..., None])[..., 0]
    err = max((m - mr).abs().max().item(), (at_idx - mr).abs().max().item())
    return err, bool(torch.allclose(m, mr, **TOME_MAX) and torch.allclose(at_idx, mr, **TOME_MAX))


def _close(got, want, tol: dict) -> tuple[float, bool]:
    err = (got.float() - want.float()).abs().max().item()
    return err, bool(torch.isfinite(got).all()) and torch.allclose(got.float(), want.float(),
                                                                    **tol)


def measure(cases=CASES) -> list[dict]:
    """Every case on the card: checked against its plain version (raises on
    a disagreement), then timed. One record per case."""
    _require_card()
    parity_numerics()  # the f32 plain versions and bmm must not use TF32
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for case in cases:
        kernel, plain, library, tol, library_name, close = _calls(case, gen)
        err, ok = close(kernel(), plain())
        torch.cuda.synchronize()
        if not ok:
            raise RuntimeError(f"kernel_bench {case.family}/{case.label}: {case.kernel()} "
                               f"disagrees with its plain version (max_abs_err {err:.3e}, "
                               f"tol {tol})")
        iters = 10 if case.causal or case.family == "flash_bwd" else 30
        ms = time_ms(kernel, iters, queued=True)
        plain_ms = time_ms(plain, iters, queued=case.plain_queued())
        library_ms = time_ms(library, iters, queued=True)
        bound_ms, bound_by = case.bound()
        extra = {"cold_l2_ms": time_cold_ms(kernel)} if case.family == "decode" else {}
        out.append({"name": f"kernel/{case.kernel()}/{case.label}", "label": case.label,
                    "kernel": case.kernel(),
                    "shape": list(case.shape), "dtype": str(case.dtype).removeprefix("torch."),
                    "causal": case.causal, "bias": case.bias, "length": case.length,
                    "max_abs_err": err, "tol": tol, "timing": "queued",
                    "plain_timing": "queued" if case.plain_queued() else "back to back",
                    "ms": ms, "plain_ms": plain_ms, "library": library_name,
                    "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "flops": case.flops(), "bytes": case.nbytes(), **extra})
    return out


def rows():
    """``run.py`` hook: (name, kernel µs a call, bound µs). Card only."""
    return [(r["name"], r["ms"] * 1e3, round(r["bound_ms"] * 1e3, 3)) for r in measure()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=common.out_path("BENCH_kernel.json"))
    args = ap.parse_args(argv)
    records = measure()
    for r in records:
        cold = f", L2 flushed {r['cold_l2_ms']:.4f} ms" if "cold_l2_ms" in r else ""
        print(f"{r['name']}: kernel {r['ms']:.4f} ms{cold}, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), max_abs_err {r['max_abs_err']:.3e}")
    common.write_json(args.out, {"benchmark": "kernel_bench",
                                 "device": torch.cuda.get_device_name(0),
                                 "rows": records}, indent=1)
    print(f"[kernel_bench] wrote {len(records)} rows -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
