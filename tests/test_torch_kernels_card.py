"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card (the
machine with the card need not have JAX: this file imports torch only).
Run them there with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_card.py

Tolerances: flash f32 atol 2e-5 / rtol 1e-4, bf16 atol 2e-2 (f32 scores
and accumulation on both sides, one rounding of the output; the tensor-core
kernel also rounds the softmax weights to bf16 before P.V, which
``tests/test_torch_kernels.py`` shows stays inside 2e-2 by emulating it on
the CPU); tome max atol 2e-5 / rtol 1e-3 and argmax
by score at the chosen index (``tests/test_kernels.py``'s own); decode as
flash.
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as decode_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ref
from repro_torch.kernels import tome_scores as tome_mod

ATOL, RTOL = 2e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _flash_case(cuda, b, h, sq, sk, d, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=cuda).to(dtype)
               for s in (sq, sk, sk))
    bias = torch.log(torch.rand((b, sk), generator=gen, device=cuda) + 0.5)
    bias[:, sk - min(3, sk - 1):] = -torch.inf  # bucket pads at the tail
    return gen, q, k, v, bias


def _check_flash(q, k, v, **kw):
    """One wrapper call against the plain version; the launch lands on the
    kernel ``kernel_for`` names."""
    mma = flash_mod.kernel_for(q.dtype, q.shape[-1]) == flash_mod.MMA
    before = flash_mod.launches, flash_mod.launches_mma
    out = flash_mod.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (flash_mod.launches, flash_mod.launches_mma) == (before[0] + 1, before[1] + mma)
    exp = ref.flash_attention_ref(q, k, v, **kw)
    tol = dict(atol=ATOL, rtol=RTOL) if q.dtype == torch.float32 else dict(atol=2e-2, rtol=0)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), exp.float(), **tol)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,sq,sk,d", [
    (2, 3, 64, 64, 32), (1, 2, 100, 100, 16), (1, 4, 257, 257, 64),
    (1, 1, 7, 200, 64), (2, 2, 130, 77, 128), (8, 16, 577, 577, 64),
    (1, 2, 577, 7, 64), (2, 2, 7, 200, 128), (2, 3, 300, 130, 64), (1, 2, 577, 7, 128),
])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_on_card(cuda, b, h, sq, sk, d, causal, dtype):
    """Ragged tiles on both axes (Sq=577 over Sk=7, Sq=7 over Sk=200), Sq > Sk
    with the causal mask (rows that see no key), -inf bias pads, kv_len."""
    gen, q, k, v, bias = _flash_case(cuda, b, h, sq, sk, d, dtype)
    kv_len = torch.randint(1, sk + 1, (b,), generator=gen, device=cuda, dtype=torch.int32)
    for kw in ({}, {"bias": bias}, {"kv_len": kv_len}, {"bias": bias, "kv_len": kv_len}):
        _check_flash(q, k, v, causal=causal, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_mma_kv_len_zero_beside_live_members_on_card(cuda, d, causal):
    """A member with kv_len 0 in a batch with live ones, and members whose
    first key tiles are masked for some rows of a block: those rows' running
    max stays at the sentinel over a leading tile (exp(s - m) = 1 fills l and
    O with junk) until a real key wipes it, or the row outputs 0."""
    gen, q, k, v, bias = _flash_case(cuda, 4, 2, 200, 200, d, torch.bfloat16, seed=5)
    kv_len = torch.tensor([0, 200, 1, 65], dtype=torch.int32, device=cuda)
    for kw in ({"kv_len": kv_len}, {"kv_len": kv_len, "bias": bias}):
        out = _check_flash(q, k, v, causal=causal, **kw)
        assert torch.all(out[0] == 0)
    # causal with Sq > Sk: the first Sq - Sk rows see no key, the block's
    # later rows do, so the leading tile is masked for a part of the block only
    q2 = torch.randn((2, 2, 300, d), generator=gen, device=cuda).to(torch.bfloat16)
    out = _check_flash(q2, k[:2], v[:2], causal=True, bias=bias[:2])
    assert torch.all(out[:, :, :100] == 0) and torch.any(out[:, :, 100:] != 0)


@pytest.mark.gpu
def test_flash_mma_lm_prefill_shape_on_card(cuda):
    """starcoder2-3b's prefill call: [8, 24, 1024, 128] bf16, causal."""
    _, q, k, v, _ = _flash_case(cuda, 8, 24, 1024, 1024, 128, torch.bfloat16, seed=7)
    _check_flash(q, k, v, causal=True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [
    (torch.float32, 64), (torch.float32, 128), (torch.float32, 16),
    (torch.bfloat16, 16), (torch.bfloat16, 32),
])
def test_flash_f32_and_small_head_dims_stay_on_the_cuda_core_kernel(cuda, dtype, d):
    _, q, k, v, bias = _flash_case(cuda, 2, 2, 70, 70, d, dtype, seed=9)
    before = flash_mod.launches_mma
    _check_flash(q, k, v, bias=bias)
    assert flash_mod.launches_mma == before


@pytest.mark.gpu
def test_flash_kernel_fully_masked_rows_are_zero_on_card(cuda):
    q = torch.randn((2, 2, 70, 32), device=cuda)
    out = flash_mod.flash_attention(q, q, q, kv_len=torch.tensor([0, 70], dtype=torch.int32,
                                                                  device=cuda))
    assert torch.all(out[0] == 0)
    torch.testing.assert_close(out, ref.flash_attention_ref(
        q, q, q, kv_len=torch.tensor([0, 70], dtype=torch.int32, device=cuda)))


@pytest.mark.gpu
def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.randn((1, 2, 16, 24), device=cuda)
    with pytest.raises(ValueError):
        flash_mod.flash_attention(q, q, q)  # head dim 24
    q = torch.randn((1, 2, 16, 32), device=cuda)
    with pytest.raises(ValueError):
        flash_mod.flash_attention(q.transpose(2, 3), q, q)
    with pytest.raises(TypeError):
        flash_mod.flash_attention(q.half(), q.half(), q.half())
    flat = torch.randn(2 * 16 * 64 + 4, device=cuda).to(torch.bfloat16)
    qb = flat[4:].view(1, 2, 16, 64)  # contiguous, 8 bytes off a 16-byte boundary
    with pytest.raises(ValueError):
        flash_mod.flash_attention(qb, qb, qb)


@pytest.mark.gpu
@pytest.mark.parametrize("b,na,nb,d", [
    (1, 64, 64, 32), (2, 289, 288, 64), (8, 289, 288, 64), (1, 130, 100, 16),
    (3, 48, 49, 128),
])
def test_tome_kernel_matches_plain_on_card(cuda, b, na, nb, d):
    gen = torch.Generator(device=cuda).manual_seed(1)
    a = torch.nn.functional.normalize(torch.randn((b, na, d), generator=gen, device=cuda), dim=-1)
    bb = torch.nn.functional.normalize(torch.randn((b, nb, d), generator=gen, device=cuda), dim=-1)
    nb_len = torch.randint(1, nb + 1, (b,), generator=gen, device=cuda, dtype=torch.int32)
    for extra in (None, nb_len):
        m, i = tome_mod.tome_scores(a, bb, extra)
        mr, _ = ref.tome_scores_ref(a, bb, extra)
        torch.testing.assert_close(m, mr, atol=2e-5, rtol=1e-3)
        scores = torch.einsum("bnd,bmd->bnm", a, bb)
        if extra is not None:
            col = torch.arange(nb, device=cuda)
            scores = scores.masked_fill(col[None, None, :] >= extra[:, None, None], -torch.inf)
        at_idx = torch.gather(scores, 2, i.long()[..., None])[..., 0]
        torch.testing.assert_close(at_idx, scores.amax(-1), atol=2e-5, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (3, 24, 2, 2048, 128), (3, 16, 8, 300, 128), (2, 8, 2, 256, 64), (1, 4, 4, 100, 64),
    (2, 16, 1, 128, 64), (1, 40, 2, 1000, 128), (8, 24, 2, 64, 128),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain_on_card(cuda, b, hq, hkv, s, d, dtype):
    """Lengths 1, ragged inside a tile, and full; group 40 takes three head
    tiles; S=64 leaves one tile of capacity."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((b, hq, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=cuda).to(dtype) for _ in "kv")
    lengths = torch.tensor(([1, s - 37, s] * b)[:b], dtype=torch.int32, device=cuda)
    before = decode_mod.launches
    out = decode_mod.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert decode_mod.launches == before + 1
    exp = ref.decode_attention_ref(q, k, v, lengths)
    tol = dict(atol=ATOL, rtol=RTOL) if dtype == torch.float32 else dict(atol=2e-2, rtol=0)
    torch.testing.assert_close(out.float(), exp.float(), **tol)


@pytest.mark.gpu
def test_decode_kernel_empty_rows_and_garbage_past_the_length(cuda):
    q = torch.randn((3, 8, 128), device=cuda)
    k, v = (torch.randn((3, 500, 2, 128), device=cuda) for _ in "kv")
    k[:, 300:], v[:, 300:] = torch.nan, torch.inf
    lengths = torch.tensor([0, 300, 123], dtype=torch.int32, device=cuda)
    out = decode_mod.decode_attention(q, k, v, lengths)
    assert torch.all(out[0] == 0) and torch.isfinite(out).all()
    torch.testing.assert_close(out, ref.decode_attention_ref(q, k, v, lengths),
                               atol=ATOL, rtol=RTOL)
    # a scalar length is broadcast to every member
    torch.testing.assert_close(decode_mod.decode_attention(q, k, v, 77),
                               ref.decode_attention_ref(q, k, v, 77), atol=ATOL, rtol=RTOL)


@pytest.mark.gpu
def test_decode_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.randn((2, 8, 128), device=cuda)
    k = torch.randn((2, 64, 2, 128), device=cuda)
    with pytest.raises(ValueError):
        decode_mod.decode_attention(q[..., :96].contiguous(), k[..., :96].contiguous(),
                                    k[..., :96].contiguous(), 3)  # head dim 96
    with pytest.raises(ValueError):
        decode_mod.decode_attention(q, k.transpose(1, 2), k.transpose(1, 2), 3)
    with pytest.raises(ValueError):
        decode_mod.decode_attention(q[:, :7].contiguous(), k, k, 3)  # 7 heads over 2
    with pytest.raises(TypeError):
        decode_mod.decode_attention(q.half(), k.half(), k.half(), 3)
    with pytest.raises(ValueError):
        decode_mod.decode_attention(q, k, k, torch.tensor([3, 3], device=cuda))  # int64
