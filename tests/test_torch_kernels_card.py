"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card (the
machine with the card need not have JAX: this file imports torch only).
Run them there with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_card.py

Tolerances: flash f32 atol 2e-5 / rtol 1e-4, bf16 atol 2e-2 (both sides
compute in f32 and round once); tome max atol 2e-5 / rtol 1e-3 and argmax
by score at the chosen index (``tests/test_kernels.py``'s own).
"""
import pytest
import torch

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
