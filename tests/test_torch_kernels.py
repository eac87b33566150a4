"""The port's kernels and their plain versions against the reference kernels.

On the CPU the port's plain versions (``repro_torch.kernels.ref``, which the
wrappers use for CPU tensors) are held against the reference Pallas kernels
in interpret mode and the reference's jnp oracles, in f32, at the shapes of
``tests/test_kernels.py``. Tolerances: flash atol 2e-5 / rtol 1e-4; tome max
atol 2e-5 / rtol 1e-3 and argmax by score at the chosen index (ties may
legitimately pick another index); decode atol 2e-5 / rtol 1e-4 — the
reference tests' own tolerances.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_kernels_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jdecode
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.tome_scores import tome_scores as jtome

from repro_torch.kernels import decode_attention as decode_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import tome_scores as tome_mod

# -n 6 workers, each running 8 intra-op threads on 8 cores, oversubscribe the CPU
# (a 2 s case took 150 s among six copies): one thread a worker
torch.set_num_threads(1)

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


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 64, flash_mod.MMA), (torch.bfloat16, 128, flash_mod.MMA),
    (torch.bfloat16, 16, flash_mod.CUDA_CORE), (torch.bfloat16, 32, flash_mod.CUDA_CORE),
    (torch.float32, 16, flash_mod.CUDA_CORE), (torch.float32, 32, flash_mod.CUDA_CORE),
    (torch.float32, 64, flash_mod.CUDA_CORE), (torch.float32, 128, flash_mod.CUDA_CORE),
])
def test_flash_kernel_for_routes_by_dtype_and_head_dim(dtype, d, kernel):
    """bf16 at D 64 and 128 goes to the tensor-core kernel; f32 (which must
    stay off TF32) and the small head dims to the CUDA-core kernel. Each name
    is a source the build compiles."""
    from repro_torch.kernels import _build
    assert flash_mod.kernel_for(dtype, d) == kernel
    assert kernel in _build.SOURCES


@pytest.mark.parametrize("dtype,d,exc", [
    (torch.float16, 64, TypeError), (torch.int32, 64, TypeError),
    (torch.bfloat16, 24, ValueError), (torch.bfloat16, 256, ValueError),
    (torch.float32, 96, ValueError),
])
def test_flash_kernel_for_raises_on_what_no_kernel_takes(dtype, d, exc):
    with pytest.raises(exc):
        flash_mod.kernel_for(dtype, d)


LOG2E = 1.4426950408889634


def _mma_emulation(q, k, v, *, bias=None, kv_len=None, causal=False, bk=64):
    """The tensor-core kernel's arithmetic (``csrc/flash_attention_mma.cu``)
    on the CPU: bf16 q, k, v; f32 scores in log2 units; an online softmax
    over key tiles of ``bk``; the weights P rounded to bf16 before P.V, l
    summed from the f32 weights; f32 accumulation; one bf16 rounding of the
    output; rows with no unmasked key give 0."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    scale_log2 = torch.tensor(LOG2E / np.sqrt(d), dtype=torch.float32)
    kend = torch.full((b,), sk) if kv_len is None else kv_len.long().clamp(0, sk)
    bias2 = (torch.zeros((b, sk)) if bias is None
             else bias.float().clamp_min(ref.NEG) * LOG2E)
    qpos = torch.arange(sq)[:, None]
    m = torch.full((b, h, sq, 1), ref.NEG)
    l = torch.zeros((b, h, sq, 1))
    o = torch.zeros((b, h, sq, d))
    for t0 in range(0, sk, bk):
        kpos = torch.arange(t0, min(t0 + bk, sk))
        s = (torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, t0:t0 + bk]) * scale_log2
             + bias2[:, None, None, t0:t0 + bk])
        ok = (kpos[None, :] < kend[:, None])[:, None, None, :]
        if causal:
            ok = ok & (kpos[None, :] <= qpos + (sk - sq))
        s = torch.where(ok, s, torch.full_like(s, ref.NEG))
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp2(m - mn), torch.exp2(s - mn)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(),
                                     vf[:, :, t0:t0 + bk])
        m = mn
    out = torch.where(m > 0.5 * ref.NEG, o / l.clamp_min(1e-30), torch.zeros_like(o))
    return out.bfloat16()


@pytest.mark.parametrize("b,h,sq,sk,d,pads,kv_len,causal", [
    (2, 2, 257, 257, 64, 7, None, False),        # S=257 of tests/test_kernels.py
    (1, 2, 577, 577, 64, 15, None, False),       # ViT-L@384 tokens, bucket pads
    (3, 2, 100, 100, 64, 0, (0, 100, 37), False),  # a fully masked member beside live ones
    (2, 2, 130, 130, 128, 0, None, True),        # LM prefill's head dim, causal
    (2, 2, 130, 77, 128, 0, None, True),         # causal with Sq > Sk: rows that see no key
])
def test_flash_mma_rounding_points_stay_inside_the_bf16_tolerance(b, h, sq, sk, d, pads,
                                                                  kv_len, causal):
    """The tensor-core kernel rounds P to bf16 before P.V, where the plain
    version and the Pallas kernel keep f32 weights; the emulation of its
    arithmetic agrees with both within the card tests' bf16 tolerance (atol
    2e-2), and its fully masked rows are exactly 0."""
    rng = np.random.default_rng(17)
    q, k, v = (_t(_randn(rng, (b, h, s, d)), dtype=torch.bfloat16) for s in (sq, sk, sk))
    sizes = 1.0 + rng.uniform(size=(b, sk))
    if pads:
        sizes[:, sk - pads:] = 0.0
    with np.errstate(divide="ignore"):
        bias = np.log(sizes).astype(np.float32)  # -inf on the padded tail
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    kw = dict(bias=_t(bias), kv_len=kvl, causal=causal)
    emu = _mma_emulation(q, k, v, **kw)
    plain = ref.flash_attention_ref(q, k, v, **kw)
    assert emu.dtype == plain.dtype == torch.bfloat16
    torch.testing.assert_close(emu.float(), plain.float(), atol=2e-2, rtol=0)
    jkw = dict(bias=jnp.asarray(bias), causal=causal, bq=64, bk=64)
    if kvl is not None:
        jkw["kv_len"] = jnp.asarray(kvl.numpy())
    jb = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)]
    pallas = torch.from_numpy(np.asarray(jflash(*jb, **jkw), np.float32))
    live = plain.float().abs().amax(-1) > 0  # the Pallas kernel averages V on empty rows
    torch.testing.assert_close(emu.float()[live], pallas[live], atol=2e-2, rtol=0)
    if kvl is not None:
        assert torch.all(emu[0] == 0) and torch.all(plain[0] == 0)
    if causal and sq > sk:
        assert torch.all(emu[:, :, :sq - sk] == 0)


def test_wrappers_use_plain_versions_on_cpu():
    rng = np.random.default_rng(2)
    q, k, v = (_t(_randn(rng, (1, 2, 33, 16))) for _ in range(3))
    before = flash_mod.launches, flash_mod.launches_mma
    assert torch.equal(flash_mod.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v))
    qb, kb, vb = (_t(_randn(rng, (1, 2, 33, 64)), dtype=torch.bfloat16) for _ in range(3))
    assert torch.equal(flash_mod.flash_attention(qb, kb, vb, causal=True),
                       ref.flash_attention_ref(qb, kb, vb, causal=True))
    a, b = _t(_randn(rng, (2, 9, 16))), _t(_randn(rng, (2, 8, 16)))
    m, i = tome_mod.tome_scores(a, b)
    mr, ir = ref.tome_scores_ref(a, b)
    assert torch.equal(m, mr) and torch.equal(i, ir)
    assert (flash_mod.launches, flash_mod.launches_mma) == before  # plain versions launch nothing
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


# --------------------------------------------------------------- decode (CPU)

@pytest.mark.parametrize("b,hq,hkv,s,d,length", [
    (2, 8, 2, 256, 32, 200), (1, 4, 4, 100, 64, 100),
    (3, 6, 2, 515, 16, 300), (2, 16, 1, 128, 64, 1), (1, 8, 8, 64, 128, 33),
])
def test_decode_ref_matches_reference_kernel(b, hq, hkv, s, d, length):
    """The shapes of ``tests/test_kernels.py``; the plain version and the
    wrapper on a CPU tensor against the Pallas kernel (interpret mode, as
    the reference tests run it) and its jnp oracle."""
    rng = np.random.default_rng(7)
    q, k, v = _randn(rng, (b, hq, d)), _randn(rng, (b, s, hkv, d)), _randn(rng, (b, s, hkv, d))
    out = ref.decode_attention_ref(_t(q), _t(k), _t(v), length).numpy()
    wrapped = ops.decode_attention(_t(q), _t(k), _t(v),
                                   torch.full((b,), length, dtype=torch.int32)).numpy()
    pallas = np.asarray(jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.int32(length), bs=128))
    oracle = np.asarray(jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                                  jnp.asarray(v), jnp.int32(length)))
    np.testing.assert_allclose(out, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out, oracle, atol=ATOL, rtol=RTOL)
    assert np.array_equal(wrapped, out)


def test_decode_ref_per_member_lengths_and_empty_rows():
    """Lengths [B] mask each member on its own (the Pallas kernel takes one
    scalar: each member is held against its own call); a length of 0 gives
    0, as the Pallas kernel (its jnp oracle gives NaN)."""
    rng = np.random.default_rng(8)
    b, hq, hkv, s, d = 4, 6, 2, 150, 32
    q, k, v = _randn(rng, (b, hq, d)), _randn(rng, (b, s, hkv, d)), _randn(rng, (b, s, hkv, d))
    lengths = np.asarray([1, 77, 150, 0], np.int32)
    out = ref.decode_attention_ref(_t(q), _t(k), _t(v), torch.from_numpy(lengths)).numpy()
    for i, n in enumerate(lengths):
        pallas = np.asarray(jdecode(jnp.asarray(q[i:i + 1]), jnp.asarray(k[i:i + 1]),
                                    jnp.asarray(v[i:i + 1]), jnp.int32(n), bs=64))
        np.testing.assert_allclose(out[i:i + 1], pallas, atol=ATOL, rtol=RTOL)
    assert np.all(out[3] == 0)
    # garbage (non-finite) cache entries past the length are never read
    k[:, 100:], v[:, 100:] = np.nan, np.inf
    again = ref.decode_attention_ref(_t(q), _t(k), _t(v), torch.from_numpy(lengths)).numpy()
    np.testing.assert_array_equal(again[:2], out[:2])


def test_decode_bf16_ref_rounds_once_at_the_output():
    rng = np.random.default_rng(11)
    qb, kb, vb = (jnp.asarray(_randn(rng, sh), jnp.bfloat16)
                  for sh in ((2, 24, 128), (2, 96, 2, 128), (2, 96, 2, 128)))
    pallas = np.asarray(jdecode(qb, kb, vb, jnp.int32(90), bs=32), np.float32)
    tb = [_t(np.asarray(t, np.float32), dtype=torch.bfloat16) for t in (qb, kb, vb)]
    out = ref.decode_attention_ref(*tb, 90)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), pallas, atol=2e-2)


def test_decode_wrapper_uses_plain_version_on_cpu():
    rng = np.random.default_rng(12)
    q, k, v = _t(_randn(rng, (2, 4, 16))), _t(_randn(rng, (2, 40, 2, 16))), \
        _t(_randn(rng, (2, 40, 2, 16)))
    before = decode_mod.launches, decode_mod.launches_mma
    exp = ref.decode_attention_ref(q, k, v, torch.tensor([9, 9], dtype=torch.int32))
    for lengths in (9, torch.tensor(9), torch.tensor([9, 9], dtype=torch.int32)):
        assert torch.equal(decode_mod.decode_attention(q, k, v, lengths), exp)
    with ops.plain_versions():
        assert torch.equal(ops.decode_attention(q, k, v, 9), exp)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))  # the tensor-core kernel's dtype
    assert torch.equal(decode_mod.decode_attention(qb, kb, vb, 9),
                       ref.decode_attention_ref(qb, kb, vb, 9))
    assert (decode_mod.launches, decode_mod.launches_mma) == before  # plain versions launch nothing


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 64, decode_mod.MMA), (torch.bfloat16, 128, decode_mod.MMA),
    (torch.float32, 64, decode_mod.CUDA_CORE), (torch.float32, 128, decode_mod.CUDA_CORE),
])
def test_decode_kernel_for_routes_by_dtype(dtype, d, kernel):
    """bf16 goes to the tensor-core kernel, f32 (which must stay off TF32)
    to the CUDA-core one. Each name is a source the build compiles."""
    from repro_torch.kernels import _build
    assert decode_mod.kernel_for(dtype, d) == kernel
    assert kernel in _build.SOURCES


@pytest.mark.parametrize("dtype,d,exc", [
    (torch.float16, 128, TypeError), (torch.int32, 64, TypeError),
    (torch.bfloat16, 32, ValueError), (torch.bfloat16, 96, ValueError),
    (torch.float32, 16, ValueError),
])
def test_decode_kernel_for_raises_on_what_no_kernel_takes(dtype, d, exc):
    with pytest.raises(exc):
        decode_mod.kernel_for(dtype, d)


def _decode_mma_emulation(q, k, v, lengths, nsplit, ch=64, warps=4):
    """The tensor-core decode kernel's arithmetic (``csrc/decode_attention_mma.cu``)
    on the CPU: bf16 q, k, v; the valid tiles of ``ch`` positions spread over
    ``nsplit`` splits; in each split every warp carries its own online softmax
    over its ``ch / warps`` positions of each tile, in log2 units, with the
    weights P rounded to bf16 before P.V and l summed from the f32 weights;
    the warps, then the splits, merge their (m, l, O), a state whose max
    stayed at the sentinel weighing 0; one bf16 rounding of the output."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g, pw = hq // hkv, ch // warps
    scale_log2 = torch.tensor(LOG2E / np.sqrt(d), dtype=torch.float32)
    neg = torch.tensor(ref.NEG)

    def merge(states):
        """(m, l, o) states -> one, skipping those with no valid position."""
        ms = torch.stack([m for m, _, _ in states])
        valid = ms > 0.5 * ref.NEG
        mb = torch.where(valid, ms, neg).amax(0)
        w = torch.where(valid, torch.exp2(ms - mb), torch.zeros_like(ms))
        lb = (torch.stack([l for _, l, _ in states]) * w).sum(0)
        ob = (torch.stack([o for _, _, o in states]) * w).sum(0)
        return mb, lb, ob

    out = torch.zeros((b, hkv, g, d))
    for bi in range(b):
        n = max(0, min(int(lengths[bi]), s))
        nt = -(-n // ch)
        qf = q[bi].float().reshape(hkv, g, d)
        kf, vf = (t[bi].float().transpose(0, 1) for t in (k, v))  # [Hkv, S, D]
        parts = []
        for sp in range(nsplit):
            states = []
            for w in range(warps):
                m = torch.full((hkv, g, 1), ref.NEG)
                l, o = torch.zeros((hkv, g, 1)), torch.zeros((hkv, g, d))
                for t in range(sp * nt // nsplit, (sp + 1) * nt // nsplit):
                    pos = torch.arange(t * ch + w * pw, t * ch + (w + 1) * pw)
                    ok = pos < n
                    kk, vv = (torch.where(ok[None, :, None], x[:, pos.clamp(max=s - 1)], 0.0)
                              for x in (kf, vf))  # zero-filled past the length
                    x = torch.einsum("hgd,hpd->hgp", qf, kk) * scale_log2
                    x = torch.where(ok, x, neg)
                    mn = torch.maximum(m, x.amax(-1, keepdim=True))
                    alpha, p = torch.exp2(m - mn), torch.exp2(x - mn)
                    l = l * alpha + p.sum(-1, keepdim=True)
                    o = o * alpha + torch.einsum("hgp,hpd->hgd", p.bfloat16().float(), vv)
                    m = mn
                states.append((m, l, o))
            parts.append(merge(states))
        # the combine skips splits with l = 0 (empty ones)
        _, lb, ob = merge([(torch.where(l > 0, m, neg), l, o) for m, l, o in parts])
        out[bi] = ob / lb.clamp_min(1e-30)
    return out.reshape(b, hq, d).bfloat16()


@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (3, 24, 2, 300, 128),  # group 12 at D=128, as starcoder2-3b
    (3, 4, 2, 300, 64),    # group 2 at D=64, as internlm2
])
@pytest.mark.parametrize("nsplit", [None, 3])
def test_decode_mma_rounding_points_stay_inside_the_bf16_tolerance(b, hq, hkv, s, d, nsplit):
    """The tensor-core decode kernel rounds P to bf16 before P.V, where the
    plain version and the Pallas kernel keep f32 weights; the emulation of
    its arithmetic (warp slices, even spread of the valid tiles over the
    splits, the warp and split merges) agrees with both within the card
    tests' bf16 tolerance (atol 2e-2), at lengths 1, ragged and full, with
    the wrapper's split count and with 3 splits."""
    rng = np.random.default_rng(23)
    q = _t(_randn(rng, (b, hq, d)), dtype=torch.bfloat16)
    k, v = (_t(_randn(rng, (b, s, hkv, d)), dtype=torch.bfloat16) for _ in "kv")
    lengths = torch.tensor([1, 197, s], dtype=torch.int32)
    nsplit = decode_mod.n_splits(b, hq, hkv, s, d, decode_mod.MMA) if nsplit is None else nsplit
    emu = _decode_mma_emulation(q, k, v, lengths, nsplit)
    plain = ref.decode_attention_ref(q, k, v, lengths)
    assert emu.dtype == plain.dtype == torch.bfloat16
    torch.testing.assert_close(emu.float(), plain.float(), atol=2e-2, rtol=0)
    for i, n in enumerate(lengths.tolist()):
        jb = [jnp.asarray(t[i:i + 1].float().numpy(), jnp.bfloat16) for t in (q, k, v)]
        pallas = np.asarray(jdecode(*jb, jnp.int32(n), bs=128), np.float32)
        torch.testing.assert_close(emu[i:i + 1].float(), torch.from_numpy(pallas),
                                   atol=2e-2, rtol=0)
    assert torch.all(_decode_mma_emulation(q, k, v, torch.zeros(b, dtype=torch.int32),
                                           nsplit) == 0)


def _decode_f32_emulation(q, k, v, lengths, nsplit, ch=decode_mod.CH_F32, warps=4):
    """The CUDA-core decode kernel's summation order (``csrc/decode_attention.cu``)
    on the CPU, f32 throughout: the valid tiles of ``ch`` positions spread
    over ``nsplit`` splits; in each split every warp carries its own online
    softmax over its ``ch / warps`` positions of each tile (one max and one
    rescale a tile); the warps merge their (m, l, acc) in warp order, a state
    whose max stayed at the sentinel weighing 0; the combine sums the splits
    in split order, skipping those with l = 0."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g, nb = hq // hkv, ch // warps
    scale = torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32)
    neg = torch.tensor(ref.NEG)

    def merge(states, valid):
        """(m, l, acc) states summed in their order, weighted by exp(m - max)
        where ``valid``."""
        ms = torch.stack([m for m, _, _ in states])
        ok = torch.stack([valid(st) for st in states])
        mb = torch.where(ok, ms, neg).amax(0)
        lb, ob = torch.zeros_like(states[0][1]), torch.zeros_like(states[0][2])
        for (m, l, o), good in zip(states, ok):
            w = torch.where(good, torch.exp(m - mb), torch.zeros_like(m))
            lb, ob = lb + l * w, ob + o * w
        return mb, lb, ob

    out = torch.zeros((b, hkv, g, d))
    for bi in range(b):
        n = max(0, min(int(lengths[bi]), s))
        nt = -(-n // ch)
        qf = q[bi].reshape(hkv, g, d)
        kf, vf = (t[bi].transpose(0, 1) for t in (k, v))  # [Hkv, S, D]
        parts = []
        for sp in range(nsplit):
            states = []
            for w in range(warps):
                m = torch.full((hkv, g, 1), ref.NEG)
                l, o = torch.zeros((hkv, g, 1)), torch.zeros((hkv, g, d))
                for t in range(sp * nt // nsplit, (sp + 1) * nt // nsplit):
                    pos = torch.arange(t * ch + w * nb, t * ch + (w + 1) * nb)
                    ok = pos < n
                    kk, vv = (torch.where(ok[None, :, None], x[:, pos.clamp(max=s - 1)], 0.0)
                              for x in (kf, vf))  # zero-filled past the length
                    x = torch.where(ok, torch.einsum("hgd,hpd->hgp", qf, kk) * scale, neg)
                    mn = torch.maximum(m, x.amax(-1, keepdim=True))
                    alpha = torch.exp(m - mn)
                    p = torch.where(ok, torch.exp(x - mn), 0.0)
                    l = l * alpha + p.sum(-1, keepdim=True)
                    o = o * alpha + torch.einsum("hgp,hpd->hgd", p, vv)
                    m = mn
                states.append((m, l, o))
            parts.append(merge(states, lambda st: st[0] > 0.5 * ref.NEG))
        _, lb, ob = merge(parts, lambda st: st[1] > 0)
        out[bi] = ob / lb.clamp_min(1e-30)
    return out.reshape(b, hq, d)


@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (4, 24, 2, 300, 128),  # group 12 at D=128, as starcoder2-3b
    (4, 32, 4, 300, 128),  # group 8 at D=128, as qwen3-moe
    (4, 24, 8, 300, 64),   # group 3 at D=64, as granite-moe
    (4, 4, 2, 300, 64),    # group 2 at D=64, as internlm2
])
@pytest.mark.parametrize("nsplit", [None, 7])
def test_decode_f32_summation_order_stays_inside_the_f32_tolerance(b, hq, hkv, s, d, nsplit):
    """The CUDA-core decode kernel's order of summation (tiles of 32 spread
    over the splits, 8 positions a warp and tile, the warp merge, the
    combine in split order) agrees with the plain version and the Pallas
    kernel within the f32 tolerance (atol 2e-5, rtol 1e-4), at lengths 0,
    1, ragged and full, with the wrapper's split count and with 7 splits
    (empty ones at length 1)."""
    rng = np.random.default_rng(29)
    q = _t(_randn(rng, (b, hq, d)))
    k, v = (_t(_randn(rng, (b, s, hkv, d))) for _ in "kv")
    lengths = torch.tensor([0, 1, 197, s], dtype=torch.int32)
    if nsplit is None:
        nsplit = decode_mod.n_splits(b, hq, hkv, s, d, decode_mod.CUDA_CORE)
    emu = _decode_f32_emulation(q, k, v, lengths, nsplit)
    plain = ref.decode_attention_ref(q, k, v, lengths)
    torch.testing.assert_close(emu, plain, atol=ATOL, rtol=RTOL)
    assert torch.all(emu[0] == 0)
    for i, n in enumerate(lengths.tolist()):
        pallas = np.array(jdecode(*(jnp.asarray(t[i:i + 1].numpy()) for t in (q, k, v)),
                                  jnp.int32(n), bs=128))
        torch.testing.assert_close(emu[i:i + 1], torch.from_numpy(pallas), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,hq,hkv,s,kernel,expect", [
    # the tensor-core kernel (bf16, D=128 here): the LM path, 17 valid tiles
    # (lengths 1025..1088) over 4 splits, one cluster (at least 8 tiles of
    # capacity a split); longer caches at up to one block an SM, a power of
    # two (B=1 over 32768 positions: 8 clusters of 8); one split when the
    # shapes alone fill the card
    (8, 24, 2, 2048, decode_mod.MMA, 4), (8, 24, 2, 8192, decode_mod.MMA, 8),
    (1, 24, 2, 32768, decode_mod.MMA, 64), (1, 40, 2, 64, decode_mod.MMA, 1),
    (2, 4, 2, 100, decode_mod.MMA, 1), (2, 8, 2, 2000, decode_mod.MMA, 4),
    (64, 32, 8, 4096, decode_mod.MMA, 1),
    # the CUDA-core kernel (f32): the f32 LM path, 34 valid tiles of 32
    # (lengths 1057..1088) over 16 splits; longer caches at two blocks an SM;
    # one split when the capacity holds fewer than 8 tiles
    (8, 24, 2, 2048, decode_mod.CUDA_CORE, 16), (8, 24, 2, 8192, decode_mod.CUDA_CORE, 16),
    (1, 24, 2, 32768, decode_mod.CUDA_CORE, 132), (1, 40, 2, 64, decode_mod.CUDA_CORE, 1),
    (2, 4, 2, 100, decode_mod.CUDA_CORE, 1),
])
def test_decode_split_count_follows_the_shapes(b, hq, hkv, s, kernel, expect):
    """The CUDA-core kernel: at least 4 tiles of capacity per split and up
    to about two blocks an SM. The tensor-core kernel: at least 8 tiles of
    64 positions at D=128 per split (16 at D=64) and up to one block an SM,
    rounded down to a power of two (its splits run as clusters of up to 8).
    Groups above a block's heads (16 on either kernel) take several head
    tiles."""
    assert decode_mod.n_splits(b, hq, hkv, s, 128, kernel) == expect


@pytest.mark.parametrize("b,hq,hkv,s,d,expect", [
    (8, 24, 2, 2048, 128, 4),    # starcoder2-3b's decode step
    (8, 32, 4, 2048, 128, 4),    # qwen3-moe's
    (8, 24, 8, 2048, 64, 2),     # granite-moe's, D=64: half the bytes a tile
    (8, 24, 2, 8192, 128, 8),    # a full 8192-position cache
    (1, 24, 2, 32768, 128, 64),  # a full 32768-position cache at B=1
    (3, 24, 2, 300, 128, 1), (1, 40, 2, 1000, 128, 2), (5, 12, 4, 777, 64, 1),
    (64, 32, 8, 4096, 128, 1), (2, 8, 1, 4096, 64, 4),
])
def test_decode_mma_splits_form_whole_clusters(b, hq, hkv, s, d, expect):
    """The tensor-core kernel's split count is a power of two (clusters of
    min(nsplit, 8) tile the splits), at most the C entry's 128, its grid at
    most one block an SM unless one split already overfills it, and each
    split holds at least 8 * 64 * 128 / D positions of capacity, rounded
    up."""
    n = decode_mod.n_splits(b, hq, hkv, s, d, decode_mod.MMA)
    blocks = b * hkv * -(-(hq // hkv) // decode_mod.GT)
    assert n == expect
    assert n & (n - 1) == 0 and 1 <= n <= 128 and n % min(n, decode_mod.MAX_CLUSTER) == 0
    assert n == 1 or n * blocks <= decode_mod.SMS
    assert n <= -(-(s * d) // decode_mod.MIN_SPLIT_ELEMS)


@pytest.mark.parametrize("b,na,nb,d,route", [
    (1, 289, 288, 64, tome_mod.SMALL),    # the ViT's B=1 call
    (8, 289, 288, 64, tome_mod.SMALL),    # the ViT's cloud batch and kernel_bench's row
    (128, 99, 98, 64, tome_mod.SMALL),    # vit-l16 serve_b128's first ToMe merge
    (4, 2048, 2048, 64, tome_mod.LARGE),  # dit-s2's first merge at gen_1024
    (4, 1571, 1570, 64, tome_mod.LARGE),  # its second
    (4, 1022, 1022, 64, tome_mod.LARGE),  # its last
    (1, 2048, 1024, 64, tome_mod.LARGE),  # the threshold, 2^21 scores
    (1, 2047, 1024, 64, tome_mod.SMALL),  # one row short of it
    (4, 2048, 2048, 16, tome_mod.SMALL),  # the large route takes D 64 and 128 only
    (4, 2048, 2048, 128, tome_mod.LARGE),
])
def test_tome_route_follows_the_work(b, na, nb, d, route):
    """tome_scores' route is a pure function of the call's shapes: the large
    route from LARGE_MIN_WORK scores (B * Na * Nb) at D 64 and 128, the
    small one below it, where the ViT's calls sit."""
    assert tome_mod.route_for(b, na, nb, d) == route


def test_tome_wrapper_takes_the_plain_version_on_cpu_whatever_the_route():
    """On a CPU tensor the wrapper returns the plain version, with or
    without a forced route, and launches nothing."""
    rng = np.random.default_rng(31)
    a, b = (torch.nn.functional.normalize(_t(_randn(rng, (2, n, 64))), dim=-1)
            for n in (40, 33))
    before = tome_mod.launches, tome_mod.launches_large
    want = ref.tome_scores_ref(a, b)
    for route in (None, tome_mod.SMALL, tome_mod.LARGE):
        m, i = tome_mod.tome_scores(a, b, route=route)
        assert torch.equal(m, want[0]) and torch.equal(i, want[1])
    assert (tome_mod.launches, tome_mod.launches_large) == before


def test_decode_path_shape_gives_every_split_several_tiles():
    """At the LM path's shape each of the 4 splits walks 4 or 5 of the 17
    valid tiles (lengths 1025..1088): no split has a single tile, and none
    is empty; the whole share fits the ring (3 K/V pairs in flight at D=128,
    refilled as they free)."""
    nsplit = decode_mod.n_splits(8, 24, 2, 2048, 128, decode_mod.MMA)
    nt = -(-1088 // decode_mod.CH)
    shares = [(i + 1) * nt // nsplit - i * nt // nsplit for i in range(nsplit)]
    assert nsplit == 4 and sum(shares) == nt and min(shares) >= 4 and max(shares) <= 5


@pytest.mark.parametrize("length", [1057, 1088])
def test_decode_f32_path_shape_gives_every_split_several_tiles(length):
    """The CUDA-core kernel at the f32 LM path's shape (B=8, Hq=24, Hkv=2,
    S=2048): 34 valid tiles of 32 over 16 splits, 2 or 3 each, no split
    empty, and the grid (16 blocks a split) fills the card at about two
    blocks an SM."""
    nsplit = decode_mod.n_splits(8, 24, 2, 2048, 128, decode_mod.CUDA_CORE)
    nt = -(-length // decode_mod.CH_F32)
    shares = [(i + 1) * nt // nsplit - i * nt // nsplit for i in range(nsplit)]
    assert nt == 34 and sum(shares) == nt and min(shares) >= 2 and max(shares) <= 3
    assert decode_mod.SMS <= 8 * 2 * nsplit <= 2 * decode_mod.SMS
