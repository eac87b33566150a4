"""The port's kernels and their plain versions against the reference kernels.

On the CPU the port's plain versions (``repro_torch.kernels.ref``, which the
wrappers use for CPU tensors) are held against the reference Pallas kernels
in interpret mode and the reference's jnp oracles, in f32, at the shapes of
``tests/test_kernels.py``. Tolerances: flash atol 2e-5 / rtol 1e-4; tome max
atol 2e-5 / rtol 1e-3 and argmax by score at the chosen index (ties may
legitimately pick another index) — the reference tests' own tolerances.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_kernels_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.tome_scores import tome_scores as jtome

from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import tome_scores as tome_mod

ATOL, RTOL = 2e-5, 1e-4


def _randn(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a, device="cpu", dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(device=device, dtype=dtype)


# ---------------------------------------------------------------- flash (CPU)

@pytest.mark.parametrize("b,h,sq,sk,d", [
    (2, 3, 64, 64, 32), (1, 2, 100, 100, 16), (2, 2, 64, 128, 32),
    (1, 4, 257, 257, 64), (1, 1, 7, 200, 64),
])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_ref_matches_reference_kernel(b, h, sq, sk, d, causal):
    rng = np.random.default_rng(42)
    q, k, v = (_randn(rng, (b, h, s, d)) for s in (sq, sk, sk))
    out = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal).numpy()
    pallas = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, bq=64, bk=64))
    oracle = np.asarray(jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                                 jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(out, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out, oracle, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,h,s,d", [(2, 2, 64, 32), (3, 1, 130, 16)])
def test_flash_ref_key_bias_with_inf_pads(b, h, s, d):
    rng = np.random.default_rng(3)
    q, k, v = (_randn(rng, (b, h, s, d)) for _ in range(3))
    real = s - 7
    sizes = np.where(np.arange(s)[None, :] < real, 1.0 + rng.uniform(size=(b, s)), 0.0)
    with np.errstate(divide="ignore"):
        bias = np.log(sizes).astype(np.float32)  # -inf on the padded tail
    out = ref.flash_attention_ref(_t(q), _t(k), _t(v), bias=_t(bias)).numpy()
    pallas = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               bias=jnp.asarray(bias), bq=64, bk=64))
    assert not np.any(np.isnan(out))
    np.testing.assert_allclose(out, pallas, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,h,s,d", [(3, 2, 64, 32), (2, 2, 100, 16)])
def test_flash_ref_kv_len_matches_reference(b, h, s, d):
    rng = np.random.default_rng(5)
    q, k, v = (_randn(rng, (b, h, s, d)) for _ in range(3))
    kv_len = np.asarray([s, s - 9, s // 2][:b], np.int32)
    out = ref.flash_attention_ref(_t(q), _t(k), _t(v),
                                  kv_len=torch.from_numpy(kv_len)).numpy()
    pallas = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               kv_len=jnp.asarray(kv_len), bq=64, bk=64))
    np.testing.assert_allclose(out, pallas, atol=ATOL, rtol=RTOL)


def test_flash_fully_masked_rows_are_zero():
    """The port's contract where every key of a row is masked (never on the
    main path): 0, where the Pallas kernel averages V and its oracle gives
    NaN. Rows with a key keep the reference's values."""
    rng = np.random.default_rng(9)
    q, k, v = (_randn(rng, (2, 2, 16, 16)) for _ in range(3))
    kv_len = torch.tensor([0, 16], dtype=torch.int32)
    out = ref.flash_attention_ref(_t(q), _t(k), _t(v), kv_len=kv_len)
    assert torch.all(out[0] == 0)
    pallas = np.asarray(jflash(jnp.asarray(q[1:]), jnp.asarray(k[1:]), jnp.asarray(v[1:]),
                               bq=64, bk=64))
    np.testing.assert_allclose(out[1:].numpy(), pallas, atol=ATOL, rtol=RTOL)
    # every key -inf by bias, and causal rows that see no key (Sq > Sk)
    bias = torch.full((2, 16), -torch.inf)
    assert torch.all(ref.flash_attention_ref(_t(q), _t(k), _t(v), bias=bias) == 0)
    out_c = ref.flash_attention_ref(_t(q), _t(k[:, :, :10]), _t(v[:, :, :10]), causal=True)
    assert torch.all(out_c[:, :, :6] == 0)
    assert torch.all(torch.isfinite(out_c)) and torch.any(out_c[:, :, 6:] != 0)


def test_flash_bf16_ref_rounds_once_at_the_output():
    """bf16 inputs: f32 math throughout and one rounding of the output, as
    the Pallas kernel (not the jnp sdpa, which rounds scores and weights)."""
    rng = np.random.default_rng(1)
    q, k, v = (_randn(rng, (1, 2, 128, 64)) for _ in range(3))
    qb, kb, vb = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    pallas = np.asarray(jflash(qb, kb, vb, bq=64, bk=64), np.float32)
    tb = [_t(np.asarray(t, np.float32), dtype=torch.bfloat16) for t in (qb, kb, vb)]
    out = ref.flash_attention_ref(*tb)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), pallas, atol=2e-2)


def test_wrappers_use_plain_versions_on_cpu():
    rng = np.random.default_rng(2)
    q, k, v = (_t(_randn(rng, (1, 2, 33, 16))) for _ in range(3))
    before = flash_mod.launches
    assert torch.equal(flash_mod.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v))
    a, b = _t(_randn(rng, (2, 9, 16))), _t(_randn(rng, (2, 8, 16)))
    m, i = tome_mod.tome_scores(a, b)
    mr, ir = ref.tome_scores_ref(a, b)
    assert torch.equal(m, mr) and torch.equal(i, ir)
    assert flash_mod.launches == before  # plain versions launch nothing
    with ops.plain_versions():
        assert torch.equal(ops.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v))


# ----------------------------------------------------------------- tome (CPU)

def _unit(rng, shape):
    x = _randn(rng, shape)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("b,na,nb,d", [
    (1, 64, 64, 32), (2, 289, 288, 64), (1, 130, 100, 16), (3, 48, 49, 128),
])
def test_tome_ref_matches_reference_kernel(b, na, nb, d):
    rng = np.random.default_rng(42)
    a, bb = _unit(rng, (b, na, d)), _unit(rng, (b, nb, d))
    m, i = ref.tome_scores_ref(_t(a), _t(bb))
    mj, ij = jtome(jnp.asarray(a), jnp.asarray(bb), bm=64, bn=64)
    np.testing.assert_allclose(m.numpy(), np.asarray(mj), atol=2e-5, rtol=1e-3)
    assert i.dtype == torch.int32
    scores = np.einsum("bnd,bmd->bnm", a, bb)
    at_idx = np.take_along_axis(scores, i.numpy().astype(np.int64)[..., None], -1)[..., 0]
    np.testing.assert_allclose(at_idx, scores.max(-1), atol=2e-5, rtol=1e-3)
    mo, io = jref.tome_scores_ref(jnp.asarray(a), jnp.asarray(bb))
    np.testing.assert_allclose(m.numpy(), np.asarray(mo), atol=2e-5, rtol=1e-3)


def test_tome_ref_ties_go_to_first_index():
    a = np.zeros((1, 3, 16), np.float32)
    a[..., 0] = 1.0
    b = np.zeros((1, 5, 16), np.float32)
    b[0, [1, 3, 4], 0] = 1.0  # three equal maxima
    m, i = ref.tome_scores_ref(_t(a), _t(b))
    _, ij = jtome(jnp.asarray(a), jnp.asarray(b), bm=64, bn=64)
    assert i.tolist() == [[1, 1, 1]] == np.asarray(ij).tolist()


@pytest.mark.parametrize("n,reals", [(21, (21, 14)), (30, (17, 30)), (16, (5, 9))])
def test_nb_len_equals_tome_merge_padded_mask(n, reals):
    """The valid count handed to the kernel reproduces the reference's pad
    column mask (``tome.py:129-135``): pads sit at the tail on entry."""
    rng = np.random.default_rng(n)
    metric = _randn(rng, (len(reals), n, 16))
    sizes = np.zeros((len(reals), n), np.float32)
    for bi, t in enumerate(reals):
        sizes[bi, :t] = 1.0 + rng.uniform(size=t)
    m = metric / (np.linalg.norm(metric, axis=-1, keepdims=True) + 1e-6)
    a, bset = m[:, ::2], m[:, 1::2]
    pad_b = sizes[:, 1::2] <= 0.0
    scores = jnp.einsum("bnd,bmd->bnm", jnp.asarray(a), jnp.asarray(bset))
    scores = jnp.where(jnp.asarray(pad_b)[:, None, :], -jnp.inf, scores)
    nb_len = torch.from_numpy((~pad_b).sum(-1).astype(np.int32))
    assert nb_len.tolist() == [t // 2 for t in reals]
    mx, ix = ref.tome_scores_ref(_t(a), _t(bset), nb_len)
    np.testing.assert_allclose(mx.numpy(), np.asarray(scores.max(-1)), atol=2e-5, rtol=1e-3)
    assert np.array_equal(ix.numpy(), np.asarray(scores.argmax(-1)))
