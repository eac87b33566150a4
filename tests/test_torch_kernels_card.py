"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card (the
machine with the card need not have JAX: this file imports torch only).
Run them there with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_card.py

Tolerances: flash f32 atol 2e-5 / rtol 1e-4, bf16 atol 2e-2 (f32 scores
and accumulation on both sides, one rounding of the output; the tensor-core
kernels also round the softmax weights to bf16 before P.V, which
``tests/test_torch_kernels.py`` shows stays inside 2e-2 by emulating them on
the CPU) and, beside it, 3e-2 of max|plain| (at thousands of keys an output
is ~sqrt(e/S) ~ 0.025, so 2e-2 alone would pass a wrong kernel); tome max atol 2e-5 / rtol 1e-3 and argmax
by score at the chosen index (``tests/test_kernels.py``'s own); decode as
flash. The flash and decode tests assert which kernel launched
(``launches_mma``). The flash backward (the kernel's forward, the backward
kernels) against autograd of the plain version in f32: f32 within 1e-4 of
max|g|, bf16 within 1e-2 of max|g| (P, dS and the gradients rounded to bf16
once; sound readings 2.7e-3 to 3.9e-3 at the train shapes, a backward
without dS's rowsum term or with a key tile's dK and dV dropped 0.32 and
above, ``chip_smoke.py``'s ``[train]`` phase); the backward kernels against
the plain backward ``ref.flash_attention_bwd_ref`` on the same inputs, with
the same limits (both round at the same points; only sums differ in order).
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as decode_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ref
from repro_torch.kernels import tome_scores as tome_mod

ATOL, RTOL = 2e-5, 1e-4
BF16_OF_MAX = 3e-2  # bf16 flash: max|kernel - plain| <= this x max|plain|, too
BWD_BF16_OF_MAX = 1e-2  # bf16 flash backward: max|d| <= this x max|g|


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
    if q.dtype == torch.bfloat16:
        err = (out.float() - exp.float()).abs().max()
        assert err <= BF16_OF_MAX * exp.float().abs().max()
    return out


def _check_decode(q, k, v, lengths):
    """One wrapper call against the plain version; the launch lands on the
    kernel ``kernel_for`` names (bf16: the tensor-core one)."""
    mma = decode_mod.kernel_for(q.dtype, q.shape[-1]) == decode_mod.MMA
    assert mma == (q.dtype == torch.bfloat16)
    before = decode_mod.launches, decode_mod.launches_mma
    out = decode_mod.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert (decode_mod.launches, decode_mod.launches_mma) == (before[0] + 1, before[1] + mma)
    exp = ref.decode_attention_ref(q, k, v, lengths)
    dtype = q.dtype
    tol = dict(atol=ATOL, rtol=RTOL) if dtype == torch.float32 else dict(atol=2e-2, rtol=0)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), exp.float(), **tol)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,sq,sk,d", [
    (2, 3, 64, 64, 32), (1, 2, 100, 100, 16), (1, 4, 257, 257, 64),
    (1, 1, 7, 200, 64), (2, 2, 130, 77, 128), (8, 16, 577, 577, 64),
    (1, 2, 577, 7, 64), (2, 2, 7, 200, 128), (2, 3, 300, 130, 64), (1, 2, 577, 7, 128),
    (1, 1, 1, 577, 128), (1, 1, 65, 129, 64), (40, 4, 129, 577, 128),
])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_on_card(cuda, b, h, sq, sk, d, causal, dtype):
    """Ragged tiles on both axes (Sq=577 over Sk=7, Sq=7 over Sk=200), Sq > Sk
    with the causal mask (rows that see no key), -inf bias pads, kv_len; B*H
    = 1, and a grid of two-warpgroup blocks ([40,4,129,577] in bf16 at
    D=128)."""
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
@pytest.mark.parametrize("b,h,s,d,with_bias", [
    (4, 6, 4096, 64, True), (4, 6, 4096, 64, False), (2, 24, 1536, 128, False),
    (4, 6, 3141, 64, True), (4, 6, 2044, 64, True),
], ids=["dit-janus-gen1024", "dit-dense-gen1024", "flux-gen-fast",
        "dit-janus-gen1024-layer1", "dit-janus-gen1024-layer11"])
def test_flash_mma_diffusion_shapes_on_card(cuda, b, h, s, d, with_bias):
    """dit-s2 at gen_1024 (4096 tokens, D=64; the Janus forward adds the
    ToMe log-size bias, and its later layers attend the merged lengths, 3141
    at the second and 2044 at the last, neither a multiple of a 64-key tile)
    and flux-dev's joint attention at gen_fast (1024 + 512 tokens, D=128,
    non-causal, no bias)."""
    gen, q, k, v, _ = _flash_case(cuda, b, h, s, s, d, torch.bfloat16, seed=11)
    bias = None
    if with_bias:
        sizes = torch.randint(1, 9, (b, s), generator=gen, device=cuda).float()
        bias = torch.log(sizes)
    _check_flash(q, k, v, bias=bias)


# the tensor-core forward's two block shapes: one consumer warpgroup (64 query
# rows) on a small grid, two (128 rows; 128-key tiles at D=128) when 128-row
# blocks give every SM one (B*H*ceil(Sq/128) >= 132 on the H100)
MMA_FWD_GRIDS = {"one-warpgroup": (1, 1), "two-warpgroups": (4, 40)}
MMA_FWD_LENGTHS = ((1, 1), (65, 65), (129, 129), (577, 577), (1, 577), (129, 577), (577, 129),
                   (540, 520), (300, 560))


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk", MMA_FWD_LENGTHS, ids=[f"{a}x{b}" for a, b in MMA_FWD_LENGTHS])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("grid", list(MMA_FWD_GRIDS))
def test_flash_mma_ragged_lengths_on_card(cuda, grid, d, sq, sk):
    """Lengths that are multiples of neither block (64 or 128 query rows) nor
    key tile (64 or 128): trimmed tails of 8 to 64 keys and a full masked one,
    a last block whose second warpgroup has no row, Sq < Sk and Sq > Sk under
    the causal mask, B*H = 1; plain, with the bias (-inf pads), causal, with
    kv_len < Sk, and all together."""
    b, h = MMA_FWD_GRIDS[grid]
    gen, q, k, v, bias = _flash_case(cuda, b, h, sq, sk, d, torch.bfloat16, seed=sq + sk + d)
    kv_len = torch.randint(max(1, sk // 2), sk + 1, (b,), generator=gen, device=cuda,
                           dtype=torch.int32)
    for kw in ({}, {"bias": bias}, {"causal": True}, {"kv_len": kv_len},
               {"bias": bias, "kv_len": kv_len, "causal": True}):
        _check_flash(q, k, v, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("grid", list(MMA_FWD_GRIDS))
def test_flash_mma_masked_rows_and_lse_on_card(cuda, grid, d, causal):
    """A bias of -1e30 (the clamp) and of -inf, a member whose bias is -inf
    everywhere, one with kv_len 0 and one with kv_len < Sk beside live ones,
    and (causal, Sq > Sk) rows that see no key: such rows output 0 and their
    lse is +inf; every other row's lse is the plain log-sum-exp of its
    scaled, clamped, masked scores (f32, within 1e-5), and the output with
    the lse written is the output without it, bit for bit."""
    b, h = MMA_FWD_GRIDS[grid]
    b = max(b, 4)
    sq, sk = (300, 200) if causal else (200, 300)
    gen, q, k, v, bias = _flash_case(cuda, b, h, sq, sk, d, torch.bfloat16, seed=41 + d)
    bias[:, 10:40] = -1e30
    bias[1] = -torch.inf
    kv_len = torch.full((b,), sk, dtype=torch.int32, device=cuda)
    kv_len[0], kv_len[2] = 0, sk // 3
    out = _check_flash(q, k, v, bias=bias, kv_len=kv_len, causal=causal)
    out_lse, lse = flash_mod._forward(q, k, v, bias, kv_len, causal, True)
    torch.cuda.synchronize()
    assert torch.equal(out, out_lse) and lse.shape == q.shape[:3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / d ** 0.5
    s = s + bias.clamp_min(ref.NEG)[:, None, None, :]
    kpos, qpos = torch.arange(sk, device=cuda), torch.arange(sq, device=cuda)
    mask = (kpos[None, :] < kv_len[:, None])[:, None, None, :]
    if causal:
        mask = mask & (qpos[:, None] + (sk - sq) >= kpos[None, :])
    s = s.masked_fill(~mask, -torch.inf)
    seen = s.amax(-1) > 0.5 * ref.NEG
    assert not seen[:2].any() and seen[2:].any()
    assert torch.all(out[~seen] == 0)
    assert torch.all(torch.isinf(lse[~seen]) & (lse[~seen] > 0))
    torch.testing.assert_close(lse[seen], torch.logsumexp(s, dim=-1)[seen], rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,s,d,causal", [(4, 24, 4608, 128, False), (8, 32, 1024, 128, True),
                                            (32, 16, 577, 64, False), (1, 16, 577, 64, False)],
                         ids=["flux-gen1024", "qwen3-prefill", "vit-l16-train", "vit-b1"])
def test_flash_mma_forward_runs_are_bit_equal_on_card(cuda, b, h, s, d, causal):
    """No atomics: two runs of the forward give the same output and lse bits,
    at flux-dev gen_1024's call, the qwen3 causal prefill, the vit-l16 train
    call (two warpgroups a block) and a ViT frame (one)."""
    _, q, k, v, _ = _flash_case(cuda, b, h, s, s, d, torch.bfloat16, seed=43)
    first = flash_mod._forward(q, k, v, None, None, causal, True)
    second = flash_mod._forward(q, k, v, None, None, causal, True)
    torch.cuda.synchronize()
    assert torch.isfinite(first[0]).all() and torch.isfinite(first[1]).all()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("h", [12, 16], ids=["vit-b16", "vit-l16"])
def test_flash_vision_serve_shapes_on_card(cuda, h, dtype):
    """vit-b16 and vit-l16 at serve_b128: 128 images of 197 tokens, D=64, no
    bias; bf16 on the tensor-core kernel, f32 on the CUDA-core one."""
    _, q, k, v, _ = _flash_case(cuda, 128, h, 197, 197, 64, dtype, seed=12)
    _check_flash(q, k, v)


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


def _unit(cuda, gen, shape):
    return torch.nn.functional.normalize(torch.randn(shape, generator=gen, device=cuda), dim=-1)


def _check_tome(a, bb, nb_len):
    """One wrapper call against the plain version: the max within the
    tolerance, and the chosen index holds the row max (another index may tie)."""
    before = tome_mod.launches
    m, i = tome_mod.tome_scores(a, bb, nb_len)
    torch.cuda.synchronize()
    assert tome_mod.launches == before + 1
    mr, _ = ref.tome_scores_ref(a, bb, nb_len)
    torch.testing.assert_close(m, mr, atol=2e-5, rtol=1e-3)
    scores = torch.einsum("bnd,bmd->bnm", a, bb)
    if nb_len is not None:
        col = torch.arange(bb.shape[1], device=a.device)
        scores = scores.masked_fill(col[None, None, :] >= nb_len[:, None, None], -torch.inf)
    at_idx = torch.gather(scores, 2, i.long()[..., None])[..., 0]
    torch.testing.assert_close(at_idx, scores.amax(-1), atol=2e-5, rtol=1e-3)
    return m, i


@pytest.mark.gpu
@pytest.mark.parametrize("b,na,nb,d", [
    (1, 64, 64, 32), (2, 289, 288, 64), (8, 289, 288, 64), (1, 130, 100, 16),
    (3, 48, 49, 128), (2, 33, 300, 32), (1, 17, 129, 128), (2, 289, 257, 16),
    (1, 5, 3, 64), (2, 20, 700, 64), (16, 100, 300, 32), (40, 70, 600, 64),
])
def test_tome_kernel_matches_plain_on_card(cuda, b, na, nb, d):
    """Na not a multiple of a block's rows (8 per row group; 1 to 3 row
    groups, picked from the grid), Nb not a multiple of a warp's 64 columns,
    Nb above one pass of 8 warps (600, 700), D 16/32/64/128."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    a, bb = _unit(cuda, gen, (b, na, d)), _unit(cuda, gen, (b, nb, d))
    nb_len = torch.randint(1, nb + 1, (b,), generator=gen, device=cuda, dtype=torch.int32)
    for extra in (None, nb_len):
        _check_tome(a, bb, extra)


@pytest.mark.gpu
@pytest.mark.parametrize("na,nb", [(2048, 2048), (1571, 1570), (1022, 1022)],
                         ids=["layer0", "layer1", "layer11"])
def test_tome_kernel_dit_merge_shapes_on_card(cuda, na, nb):
    """dit-s2's first, second and last merge layers at gen_1024: 4096, 3141
    and 2044 tokens split into the alternating A and B sets (the first 7x
    the rows of any ViT call)."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    a, bb = _unit(cuda, gen, (4, na, 64)), _unit(cuda, gen, (4, nb, 64))
    _check_tome(a, bb, None)


@pytest.mark.gpu
@pytest.mark.parametrize("nb", [288, 700])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_tome_kernel_ties_go_to_the_first_index_on_card(cuda, nb, d):
    """Exact duplicate columns score bit-equal in the kernel; the first one
    wins wherever the duplicates sit: in one lane (5, 37; 8, 40), across
    warps (63, 64; 133, 261), across lanes (130, 131), across passes of the
    columns (20, 530), and with nb_len cutting the later ones off."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    a, bb = _unit(cuda, gen, (2, 40, d)), _unit(cuda, gen, (2, nb, d))
    sets = [(5, 37, 69, 133, 261), (63, 64, 100, 287), (130, 131), (40, 8)]
    if nb > 512:
        sets.append((20, 530, 699))
    for row, dups in enumerate(sets):
        for j in dups[1:]:
            bb[:, j] = bb[:, dups[0]]
        a[:, row] = bb[:, dups[0]]  # the row's max is the duplicated column
    for nb_len in (None, torch.tensor([nb, 132], dtype=torch.int32, device=cuda)):
        _, i = _check_tome(a, bb, nb_len)
        for row, dups in enumerate(sets):
            assert i[:, row].tolist() == [min(dups)] * 2


@pytest.mark.gpu
def test_tome_kernel_member_with_no_valid_column_on_card(cuda):
    """nb_len 0 for one member gives (-inf, 0) on each of its rows; the other
    members are untouched."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    a, bb = _unit(cuda, gen, (3, 50, 64)), _unit(cuda, gen, (3, 70, 64))
    nb_len = torch.tensor([70, 0, 33], dtype=torch.int32, device=cuda)
    m, i = tome_mod.tome_scores(a, bb, nb_len)
    assert torch.all(m[1] == -torch.inf) and torch.all(i[1] == 0)
    mr, ir = ref.tome_scores_ref(a, bb, nb_len)
    assert torch.all(mr[1] == -torch.inf) and torch.all(ir[1] == 0)
    torch.testing.assert_close(m[0::2], mr[0::2], atol=2e-5, rtol=1e-3)


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
    _check_decode(q, k, v, lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [130, 2048])
@pytest.mark.parametrize("hq,hkv,d", [(24, 2, 128), (4, 2, 64), (40, 2, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_tile_edges_on_card(cuda, s, hq, hkv, d, dtype):
    """Lengths 0, 1, 63, 64, 65 and full (S=130 is not a multiple of the
    64-position tile): the edges of a tile and of a warp's 16 positions,
    and a member with no key beside live ones (it outputs 0)."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn((6, hq, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((6, s, hkv, d), generator=gen, device=cuda).to(dtype) for _ in "kv")
    lengths = torch.tensor([0, 1, 63, 64, 65, s], dtype=torch.int32, device=cuda)
    out = _check_decode(q, k, v, lengths)
    assert torch.all(out[0] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_empty_rows_and_garbage_past_the_length(cuda, dtype):
    q = torch.randn((3, 8, 128), device=cuda).to(dtype)
    k, v = (torch.randn((3, 500, 2, 128), device=cuda).to(dtype) for _ in "kv")
    k[:, 300:], v[:, 300:] = torch.nan, torch.inf
    lengths = torch.tensor([0, 300, 123], dtype=torch.int32, device=cuda)
    out = _check_decode(q, k, v, lengths)
    assert torch.all(out[0] == 0)
    # a scalar length is broadcast to every member
    tol = dict(atol=ATOL, rtol=RTOL) if dtype == torch.float32 else dict(atol=2e-2, rtol=0)
    torch.testing.assert_close(decode_mod.decode_attention(q, k, v, 77).float(),
                               ref.decode_attention_ref(q, k, v, 77).float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,s,d,length", [
    (8, 24, 2, 2048, 128, 1088),  # the f32 LM path's shape (starcoder2-3b)
    (8, 32, 4, 2048, 128, 1088),  # qwen3-moe's group 8
    (8, 24, 8, 2048, 64, 1040),   # granite-moe's group 3 at D=64
])
def test_decode_f32_runs_are_bit_equal_on_card(cuda, b, hq, hkv, s, d, length):
    """The f32 kernel sums the warps and the splits in a fixed order (no
    atomics): two calls on the same inputs give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((b, hq, d), generator=gen, device=cuda)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=cuda) for _ in "kv")
    lengths = torch.full((b,), length, dtype=torch.int32, device=cuda)
    first = _check_decode(q, k, v, lengths)
    assert torch.equal(first, decode_mod.decode_attention(q, k, v, lengths))


@pytest.mark.gpu
@pytest.mark.parametrize("length", [32731, 20001])
def test_decode_f32_long_cache_many_splits_on_card(cuda, length):
    """B=1 over a 32768-position cache: 132 splits of 7 or 8 valid tiles,
    the last tile (and so the last split) partial, and every split's partial
    staged by the combine."""
    assert decode_mod.n_splits(1, 24, 2, 32768, decode_mod.CUDA_CORE) == 132
    gen = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((1, 24, 128), generator=gen, device=cuda)
    k, v = (torch.randn((1, 32768, 2, 128), generator=gen, device=cuda) for _ in "kv")
    k[:, length:], v[:, length:] = torch.nan, torch.inf  # never read
    _check_decode(q, k, v, torch.tensor([length], dtype=torch.int32, device=cuda))


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
    flat = torch.randn(2 * 8 * 128 + 4, device=cuda).to(torch.bfloat16)
    qb = flat[4:].view(2, 8, 128)  # contiguous, 8 bytes off a 16-byte boundary
    kb = k.to(torch.bfloat16)
    with pytest.raises(ValueError):
        decode_mod.decode_attention(qb, kb, kb, 3)


def _grads_through(fn, leaves, dout):
    return torch.autograd.grad(fn(*leaves), leaves, dout)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,sq,sk,d", [(2, 16, 577, 577, 64), (2, 4, 300, 130, 128),
                                         (1, 2, 70, 200, 64)])
@pytest.mark.parametrize("mode", ["plain", "causal", "kv_len", "bias"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_backward_matches_autograd_of_plain_on_card(cuda, b, h, sq, sk, d, mode, dtype,
                                                          monkeypatch):
    """dq/dk/dv (and dbias) through the kernel's autograd Function against
    autograd of the plain version in f32 on the same inputs: f32 within 1e-4
    of max|g| (full f32 products; the kernel's output enters only through
    rowsum(dO * O)), bf16 within 1e-2 of max|g| (P, dS and the gradients
    rounded to bf16 once, the forward's output from the bf16 kernel). The
    backward runs on the backward kernel of the forward's route, never on
    the plain backward."""
    def plain_backward(*args, **kw):
        raise AssertionError("the plain backward ran on a CUDA tensor")

    monkeypatch.setattr(ref, "flash_attention_bwd_ref", plain_backward)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen, q, k, v, bias = _flash_case(cuda, b, h, sq, sk, d, dtype, seed=21)
    kw = {}
    if mode == "causal":
        kw["causal"] = True
    if mode == "kv_len":
        kw["kv_len"] = torch.randint(1, sk + 1, (b,), generator=gen, device=cuda,
                                     dtype=torch.int32)
    leaves = [q.requires_grad_(), k.requires_grad_(), v.requires_grad_()]
    if mode == "bias":
        leaves.append(bias.requires_grad_())
    dout = torch.randn((b, h, sq, d), generator=gen, device=cuda).to(dtype)

    def kernel(q, k, v, bias=None):
        return flash_mod.flash_attention(q, k, v, bias=bias, **kw)

    def plain(q, k, v, bias=None):
        return ref.flash_attention_ref(q, k, v, bias=bias, **kw)

    before = flash_mod.launches, flash_mod.launches_bwd, flash_mod.launches_bwd_mma
    got = _grads_through(kernel, leaves, dout)
    mma = flash_mod.kernel_for(dtype, d) == flash_mod.MMA
    # the forward ran the kernel, the backward its backward kernel
    assert (flash_mod.launches, flash_mod.launches_bwd, flash_mod.launches_bwd_mma) == (
        before[0] + 1, before[1] + 1, before[2] + mma)
    pf = [t.detach().float().requires_grad_() for t in leaves]
    exp = _grads_through(plain, pf, dout.float())
    tol = 1e-4 if dtype == torch.float32 else BWD_BF16_OF_MAX
    for g, e in zip(got, exp):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.float(), e, rtol=0, atol=tol * float(e.abs().max()))


def _bwd_case(cuda, d, mode, dtype, seed=23):
    """Inputs of one backward call: B=2, H=3, ragged lengths (Sq > Sk under
    causal, so the first queries see no key); ``mode`` adds the bias (with
    -inf pads), kv_len [0, 97] (member 0 sees no key, member 1 only keys
    before 97) and the causal mask."""
    sq, sk = (150, 130) if "causal" in mode else (130, 150)
    gen, q, k, v, bias = _flash_case(cuda, 2, 3, sq, sk, d, dtype, seed=seed)
    kw = {"causal": "causal" in mode}
    if "bias" in mode:
        kw["bias"] = bias
    if "kv_len" in mode:
        kw["kv_len"] = torch.tensor([0, 97], dtype=torch.int32, device=cuda)
    dout = torch.randn((2, 3, sq, d), generator=gen, device=cuda).to(dtype)
    return q, k, v, dout, kw


def _kernel_backward(q, k, v, dout, kw):
    out, lse = flash_mod._forward(q, k, v, kw.get("bias"), kw.get("kv_len"), kw["causal"], True)
    grads = flash_mod.backward(q, k, v, out, dout, need_bias="bias" in kw, lse=lse, **kw)
    torch.cuda.synchronize()
    return out, grads


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("mode", ["bias", "kv_len", "causal", "bias+kv_len+causal"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_backward_kernel_matches_plain_backward_on_card(cuda, d, mode, dtype):
    """The backward kernel of each route against ``ref.flash_attention_bwd_ref``
    on the same inputs (the kernel's forward output and its log-sum-exp):
    f32 within 1e-4 of max|g|, bf16 within BWD_BF16_OF_MAX; dbias summed over
    heads and zero at the -inf pads; a kv_len-0 member's gradients all 0,
    and keys past kv_len exactly 0 in dK and dV."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, dout, kw = _bwd_case(cuda, d, mode, dtype)
    mma = flash_mod.kernel_for(dtype, d) == flash_mod.MMA
    before = flash_mod.launches_bwd, flash_mod.launches_bwd_mma
    out, got = _kernel_backward(q, k, v, dout, kw)
    assert (flash_mod.launches_bwd, flash_mod.launches_bwd_mma) == (before[0] + 1,
                                                                    before[1] + mma)
    exp = ref.flash_attention_bwd_ref(q, k, v, out, dout, need_bias="bias" in kw, **kw)
    tol = 1e-4 if dtype == torch.float32 else BWD_BF16_OF_MAX
    for name, g, e in zip(("dq", "dk", "dv", "dbias"), got, exp):
        if e is None:
            assert g is None, name
            continue
        assert g.shape == e.shape and g.dtype == e.dtype and torch.isfinite(g).all(), name
        torch.testing.assert_close(g.float(), e.float(), rtol=0,
                                   atol=tol * float(e.float().abs().max()), msg=name)
    if "bias" in kw:
        assert torch.all(got[3][:, -3:] == 0)  # the -inf pads
    if "kv_len" in kw:
        assert all(float(g[0].abs().max()) == 0 for g in got[:3])
        assert torch.all(got[1][1, :, 97:] == 0) and torch.all(got[2][1, :, 97:] == 0)
    if kw["causal"]:  # Sq > Sk: the first Sq - Sk queries see no key
        assert torch.all(got[0][:, :, :20] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("d,dtype", [(64, torch.bfloat16), (128, torch.bfloat16),
                                     (32, torch.bfloat16), (64, torch.float32),
                                     (128, torch.float32)],
                         ids=["mma-64", "mma-128", "cuda-core-bf16-32", "cuda-core-f32-64",
                              "cuda-core-f32-128"])
def test_flash_backward_kernels_are_deterministic_on_card(cuda, d, dtype):
    """No atomics: two runs of the backward give the same bits."""
    q, k, v, dout, kw = _bwd_case(cuda, d, "bias+kv_len+causal", dtype, seed=24)
    _, first = _kernel_backward(q, k, v, dout, kw)
    _, second = _kernel_backward(q, k, v, dout, kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("d,dtype", [(64, torch.bfloat16), (128, torch.bfloat16),
                                     (16, torch.bfloat16), (64, torch.float32),
                                     (128, torch.float32)])
@pytest.mark.parametrize("mode", ["bias", "bias+kv_len+causal"])
def test_flash_forward_lse_leaves_the_output_unchanged_on_card(cuda, d, dtype, mode):
    """The forward's output with the log-sum-exp written equals its output
    without, bit for bit; the log-sum-exp is the plain scores' (natural
    units, f32 within 1e-5 of its size) and +inf on a row with no unmasked
    key."""
    q, k, v, _, kw = _bwd_case(cuda, d, mode, dtype, seed=25)
    args = (q, k, v, kw.get("bias"), kw.get("kv_len"), kw["causal"])
    plain_out = flash_mod._forward(*args)
    out, lse = flash_mod._forward(*args, True)
    torch.cuda.synchronize()
    assert torch.equal(out, plain_out) and lse.shape == q.shape[:3]
    sq, sk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / d ** 0.5
    if "bias" in kw:
        s = s + kw["bias"].clamp_min(ref.NEG)[:, None, None, :]
    kpos, qpos = torch.arange(sk, device=cuda), torch.arange(sq, device=cuda)
    mask = torch.ones((2, 1, sq, sk), dtype=torch.bool, device=cuda)
    if "kv_len" in kw:
        mask = mask & (kpos[None, :] < kw["kv_len"][:, None])[:, None, None, :]
    if kw["causal"]:
        mask = mask & (qpos[:, None] + (sk - sq) >= kpos[None, :])
    s = s.masked_fill(~mask, -torch.inf)
    seen = (s.amax(-1) > 0.5 * ref.NEG)
    exp = torch.logsumexp(s, dim=-1)
    assert torch.all(torch.isinf(lse[~seen]) & (lse[~seen] > 0))
    torch.testing.assert_close(lse[seen], exp[seen], rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_backward_gqa_repeated_outside_on_card(cuda, dtype):
    """``layers.sdpa`` with 8 q heads over 2 kv heads (repeated outside the
    kernel), causal, D=128: the kv gradients sum over each group."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(22)
    q = torch.randn((2, 256, 8, 128), generator=gen, device=cuda).to(dtype).requires_grad_()
    k, v = (torch.randn((2, 256, 2, 128), generator=gen, device=cuda).to(dtype).requires_grad_()
            for _ in range(2))
    dout = torch.randn((2, 256, 8, 128), generator=gen, device=cuda).to(dtype)
    got = _grads_through(lambda *t: layers.sdpa(*t, causal=True), [q, k, v], dout)
    pf = [t.detach().float().requires_grad_() for t in (q, k, v)]
    with ops.plain_versions():
        exp = _grads_through(lambda *t: layers.sdpa(*t, causal=True), pf, dout.float())
    tol = 1e-4 if dtype == torch.float32 else BWD_BF16_OF_MAX
    for g, e in zip(got, exp):
        torch.testing.assert_close(g.float(), e, rtol=0, atol=tol * float(e.abs().max()))


# (Sq, Sk) at the 3xTF32 kernels' tile edges (16-row warps, 64-row blocks,
# key tiles of 64 or 32): each of 1, 15, 16, 17, 63, 64, 65 and 577 as Sq and
# as Sk, Sq < Sk and Sq > Sk
TF32_EDGES = ((1, 577), (577, 1), (15, 17), (17, 15), (16, 16), (63, 65), (65, 63), (64, 64))


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk", TF32_EDGES, ids=[f"{a}x{b}" for a, b in TF32_EDGES])
@pytest.mark.parametrize("dtype,d", [(torch.float32, 16), (torch.float32, 32),
                                     (torch.float32, 64), (torch.float32, 128),
                                     (torch.bfloat16, 16), (torch.bfloat16, 32)],
                         ids=["f32-16", "f32-32", "f32-64", "f32-128", "bf16-16", "bf16-32"])
def test_flash_tf32_kernels_at_tile_edges_on_card(cuda, dtype, d, sq, sk):
    """The 3xTF32 forward and backward (the ``CUDA_CORE`` route) at tile-edge
    lengths, plain, with the bias (-inf pads), causal, with a kv_len that
    splits a key tile, and all three: the forward against the plain version
    at the flash limits, the backward kernel against the plain backward on
    the same inputs at 1e-4 (f32) or BWD_BF16_OF_MAX (bf16) of max|g|. With
    one key (Sk = 1) the softmax is constant, so dQ, dK and dbias are 0 up to
    rounding: their limit is taken of max|dV| there."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen, q, k, v, bias = _flash_case(cuda, 2, 2, sq, sk, d, dtype, seed=sq + 3 * sk + d)
    kv_len = torch.tensor([max(1, sk - 5), (sk + 1) // 2], dtype=torch.int32, device=cuda)
    dout = torch.randn((2, 2, sq, d), generator=gen, device=cuda).to(dtype)
    tol = 1e-4 if dtype == torch.float32 else BWD_BF16_OF_MAX
    for kw in ({}, {"bias": bias}, {"causal": True}, {"kv_len": kv_len},
               {"bias": bias, "kv_len": kv_len, "causal": True}):
        assert flash_mod.kernel_for(dtype, d) == flash_mod.CUDA_CORE
        _check_flash(q, k, v, **kw)
        kw = {"causal": False, **kw}
        out, got = _kernel_backward(q, k, v, dout, kw)
        exp = ref.flash_attention_bwd_ref(q, k, v, out, dout, need_bias="bias" in kw, **kw)
        dv_scale = float(exp[2].float().abs().max())
        for name, g, e in zip(("dq", "dk", "dv", "dbias"), got, exp):
            if e is None:
                assert g is None, name
                continue
            assert g.shape == e.shape and torch.isfinite(g).all(), (name, kw)
            scale = dv_scale if sk == 1 and name != "dv" else float(e.float().abs().max())
            torch.testing.assert_close(g.float(), e.float(), rtol=0, atol=tol * scale,
                                       msg=lambda m, name=name: f"{name} {sorted(kw)}: {m}")


@pytest.mark.gpu
def test_flash_tf32_route_refuses_misaligned_operands_on_card(cuda):
    """Both flash routes copy rows in 16-byte pieces and refuse a q, k or v
    that does not start on a 16-byte boundary, forward and backward, as the
    bf16 tensor-core route always has; the gradient autograd hands over may
    be a strided or offset view, which the backward copies, with the results
    of an aligned one."""
    flat = torch.randn(3 * 2 * 3 * 70 * 32 + 2, device=cuda)
    q, k, v = (flat[1 + i * 13440:1 + (i + 1) * 13440].view(2, 3, 70, 32) for i in range(3))
    assert q.is_contiguous() and q.data_ptr() % 16 == 4
    assert flash_mod.kernel_for(q.dtype, 32) == flash_mod.CUDA_CORE
    with pytest.raises(ValueError, match="16-byte"):
        flash_mod.flash_attention(q, k, v, causal=True)
    qa, ka, va = (t.clone() for t in (q, k, v))
    out, lse = flash_mod._forward(qa, ka, va, None, None, True, True)
    dout = flat[2:13442].view(2, 3, 70, 32)
    assert dout.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte"):
        flash_mod.backward(q, ka, va, out, dout, causal=True, lse=lse)
    got = flash_mod.backward(qa, ka, va, out, dout, causal=True, lse=lse)
    aligned = flash_mod.backward(qa, ka, va, out, dout.clone(), causal=True, lse=lse)
    for g, a in zip(got[:3], aligned[:3]):
        assert torch.equal(g, a)


@pytest.mark.gpu
def test_flash_f32_limits_reject_a_tf32_plain_version_on_card(cuda):
    """The f32 limits that the 3xTF32 kernels meet reject plain TF32: at the
    reference's [1, 16, 577, 64] f32 call with the bias, the forward kernel
    is within atol 2e-5 / rtol 1e-4 of the plain version and the plain
    version with TF32 matmuls (``torch.backends.cuda.matmul.allow_tf32``) is
    not; the backward kernel at [2, 16, 577, 64] is within 1e-4 of max|g| of
    the plain backward and the plain backward with TF32 matmuls is not."""
    from repro_torch.runtime.device import parity_numerics

    parity_numerics()
    gen, q, k, v, bias = _flash_case(cuda, 1, 16, 577, 577, 64, torch.float32, seed=31)
    _check_flash(q, k, v, bias=bias)
    exp = ref.flash_attention_ref(q, k, v, bias=bias)
    q2, k2, v2, dout, kw = _bwd_case(cuda, 64, "bias", torch.float32, seed=32)
    out, got = _kernel_backward(q2, k2, v2, dout, kw)
    exp_g = ref.flash_attention_bwd_ref(q2, k2, v2, out, dout, need_bias=True, **kw)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = ref.flash_attention_ref(q, k, v, bias=bias)
        tf32_g = ref.flash_attention_bwd_ref(q2, k2, v2, out, dout, need_bias=True, **kw)
        torch.cuda.synchronize()
    finally:
        parity_numerics()
    assert not torch.allclose(tf32, exp, atol=ATOL, rtol=RTOL)
    of_max = [float((g - e).abs().max() / e.abs().max()) for g, e in zip(got[:3], exp_g[:3])]
    tf32_of_max = [float((g - e).abs().max() / e.abs().max())
                   for g, e in zip(tf32_g[:3], exp_g[:3])]
    assert max(of_max) <= 1e-4 < max(tf32_of_max), (of_max, tf32_of_max)


@pytest.mark.gpu
def test_decode_attention_raises_under_grad_on_card(cuda):
    q = torch.randn((2, 8, 64), device=cuda, dtype=torch.bfloat16, requires_grad=True)
    kv = torch.randn((2, 64, 2, 64), device=cuda, dtype=torch.bfloat16)
    lengths = torch.full((2,), 64, dtype=torch.int32, device=cuda)
    before = decode_mod.launches
    with pytest.raises(RuntimeError, match="no backward"):
        decode_mod.decode_attention(q, kv, kv, lengths)
    assert decode_mod.launches == before
    with torch.no_grad():
        _check_decode(q.detach(), kv, kv, lengths)


# (Sq, Sk) at the wgmma backward's edges (64-row warpgroups, 128-row blocks,
# streamed tiles of 64 or 32 trimmed to 8, 16 or 32): each of 1, 8, 15, 16,
# 17, 63, 64, 65, 127, 128, 129 and 577 as Sq and as Sk, Sq < Sk and Sq > Sk
MMA_EDGES = ((1, 577), (577, 1), (8, 15), (15, 8), (16, 17), (17, 16), (63, 65), (65, 63),
             (64, 64), (127, 129), (129, 127), (128, 128), (577, 577))


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk", MMA_EDGES, ids=[f"{a}x{b}" for a, b in MMA_EDGES])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_mma_backward_at_tile_edges_on_card(cuda, d, sq, sk):
    """The tensor-core backward (``flash_attention_mma_bwd``) at tile-edge
    lengths against the plain backward on the same inputs, within
    BWD_BF16_OF_MAX of max|g|: plain, the bias with -inf pads, causal, a
    kv_len that splits a key tile, a kv_len-0 member (all its gradients 0,
    keys past a kv_len exactly 0 in dK and dV), and all together. With one
    key (Sk = 1) the softmax is constant, so dQ, dK and dbias are 0 up to
    rounding: their limit is taken of max|dV| there."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen, q, k, v, bias = _flash_case(cuda, 2, 2, sq, sk, d, torch.bfloat16, seed=sq + 5 * sk + d)
    split = torch.tensor([max(1, sk - 5), (sk + 1) // 2], dtype=torch.int32, device=cuda)
    empty = torch.tensor([0, (sk + 1) // 2], dtype=torch.int32, device=cuda)
    dout = torch.randn((2, 2, sq, d), generator=gen, device=cuda).to(torch.bfloat16)
    assert flash_mod.kernel_for(torch.bfloat16, d) == flash_mod.MMA
    for kw in ({}, {"bias": bias}, {"causal": True}, {"kv_len": split}, {"kv_len": empty},
               {"bias": bias, "kv_len": split, "causal": True}):
        kw = {"causal": False, **kw}
        before = flash_mod.launches_bwd_mma
        out, got = _kernel_backward(q, k, v, dout, kw)
        assert flash_mod.launches_bwd_mma == before + 1
        exp = ref.flash_attention_bwd_ref(q, k, v, out, dout, need_bias="bias" in kw, **kw)
        dv_scale = float(exp[2].float().abs().max())
        for name, g, e in zip(("dq", "dk", "dv", "dbias"), got, exp):
            if e is None:
                assert g is None, name
                continue
            assert g.shape == e.shape and torch.isfinite(g).all(), (name, kw)
            scale = dv_scale if sk == 1 and name != "dv" else float(e.float().abs().max())
            torch.testing.assert_close(g.float(), e.float(), rtol=0,
                                       atol=BWD_BF16_OF_MAX * scale,
                                       msg=lambda m, name=name: f"{name} {sorted(kw)}: {m}")
        pads = min(3, sk - 1)  # _flash_case's -inf pads
        if "bias" in kw and pads:
            assert torch.all(got[3][:, sk - pads:] == 0)
        if "kv_len" in kw:
            for member, n in enumerate(kw["kv_len"].tolist()):
                assert torch.all(got[1][member, :, n:] == 0)
                assert torch.all(got[2][member, :, n:] == 0)
                if n == 0:
                    assert all(float(g[member].abs().max()) == 0 for g in got[:3])


@pytest.mark.gpu
def test_flash_mma_backward_is_deterministic_at_the_train_call_on_card(cuda):
    """At vit-l16 ``cls_384``'s [32, 16, 577, 64] (2560 blocks a pass, many
    waves on 132 SMs) two runs of the tensor-core backward give the same
    bits: no atomics, every row's sums in a fixed order."""
    gen = torch.Generator(device=cuda).manual_seed(26)
    q, k, v, dout = (torch.randn((32, 16, 577, 64), generator=gen, device=cuda)
                     .to(torch.bfloat16) for _ in range(4))
    kw = {"causal": False}
    _, first = _kernel_backward(q, k, v, dout, kw)
    _, second = _kernel_backward(q, k, v, dout, kw)
    for a, b in zip(first[:3], second[:3]):
        assert torch.equal(a, b)
    assert all(float(g.abs().max()) > 0 for g in first[:3])


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_flash_mma_backward_copies_an_offset_dout_on_card(cuda, d):
    """The gradient autograd hands over may be an offset view: the wrapper
    copies a dout off a 16-byte boundary (TMA's alignment) and the result is
    the contiguous one's, bit for bit."""
    gen, q, k, v, bias = _flash_case(cuda, 2, 3, 130, 150, d, torch.bfloat16, seed=27)
    n = 2 * 3 * 130 * d
    flat = torch.randn(n + 8, generator=gen, device=cuda).to(torch.bfloat16)
    dout = flat[3:3 + n].view(2, 3, 130, d)
    assert dout.is_contiguous() and dout.data_ptr() % 16 != 0
    out, lse = flash_mod._forward(q, k, v, bias, None, True, True)
    got = flash_mod.backward(q, k, v, out, dout, bias=bias, causal=True, need_bias=True, lse=lse)
    aligned = flash_mod.backward(q, k, v, out, dout.clone(), bias=bias, causal=True,
                                 need_bias=True, lse=lse)
    torch.cuda.synchronize()
    for g, a in zip(got, aligned):
        assert torch.equal(g, a)
