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
(``launches_mma``). The flash backward (the kernel's forward, the explicit
PyTorch backward) against autograd of the plain version in f32: f32 within
1e-4 of max|g|, bf16 within 1e-2 of max|g| (P, dS and the gradients rounded
to bf16 once; sound readings 2.7e-3 to 3.9e-3 at the train shapes, a
backward without dS's rowsum term or with a key tile's dK and dV dropped
0.32 and above, ``chip_smoke.py``'s ``[train]`` phase).
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
def test_flash_backward_matches_autograd_of_plain_on_card(cuda, b, h, sq, sk, d, mode, dtype):
    """dq/dk/dv (and dbias) through the kernel's autograd Function against
    autograd of the plain version in f32 on the same inputs: f32 within 1e-4
    of max|g| (full f32 products; the kernel's output enters only through
    rowsum(dO * O)), bf16 within 1e-2 of max|g| (P, dS and the gradients
    rounded to bf16 once, the forward's output from the bf16 kernel)."""
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

    before = flash_mod.launches
    got = _grads_through(kernel, leaves, dout)
    assert flash_mod.launches == before + 1  # the forward ran the kernel
    pf = [t.detach().float().requires_grad_() for t in leaves]
    exp = _grads_through(plain, pf, dout.float())
    tol = 1e-4 if dtype == torch.float32 else BWD_BF16_OF_MAX
    for g, e in zip(got, exp):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.float(), e, rtol=0, atol=tol * float(e.abs().max()))


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
