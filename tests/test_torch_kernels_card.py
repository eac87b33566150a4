"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card (the
machine with the card need not have JAX: this file imports torch only).
Run them there with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_card.py

Tolerances: flash f32 atol 2e-5 / rtol 1e-4, bf16 atol 2e-2 (both sides
compute in f32 and round once); tome max atol 2e-5 / rtol 1e-3 and argmax
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


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,sq,sk,d", [
    (2, 3, 64, 64, 32), (1, 2, 100, 100, 16), (1, 4, 257, 257, 64),
    (1, 1, 7, 200, 64), (2, 2, 130, 77, 128), (8, 16, 577, 577, 64),
])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_on_card(cuda, b, h, sq, sk, d, causal, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=cuda).to(dtype)
               for s in (sq, sk, sk))
    bias = torch.log(torch.rand((b, sk), generator=gen, device=cuda) + 0.5)
    bias[:, sk - 3:] = -torch.inf
    kv_len = torch.randint(1, sk + 1, (b,), generator=gen, device=cuda, dtype=torch.int32)
    for kw in ({}, {"bias": bias}, {"kv_len": kv_len}):
        before = flash_mod.launches
        out = flash_mod.flash_attention(q, k, v, causal=causal, **kw)
        torch.cuda.synchronize()
        assert flash_mod.launches == before + 1
        exp = ref.flash_attention_ref(q, k, v, causal=causal, **kw)
        tol = dict(atol=ATOL, rtol=RTOL) if dtype == torch.float32 else dict(atol=2e-2, rtol=0)
        torch.testing.assert_close(out.float(), exp.float(), **tol)


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
