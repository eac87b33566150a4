"""The tensor-core flash backward's arithmetic, emulated on the CPU.

``csrc/flash_attention_mma_bwd.cu`` runs on the card only. This file emulates
its two passes over the kernel's own tiles: the dQ pass in blocks of 128
query rows (two warpgroups of 64), the dK/dV pass in groups of 64 keys (two
a block at D=64, one block shared by both warpgroups at D=128), streamed
tiles of 64 trimmed at the ragged end to the least of 8, 16, 32, 64 that
covers their live rows, a warpgroup skipping the tiles it cannot see. Each
product is a sum of exact bf16 products in f32, k-steps of 16 added in
order (wgmma m64nNk16); S and dP stay f32, P and dS are rounded to bf16
before the dV, dQ and dK products, D_i = rowsum(dO * O) in f32, dbias sums
the unrounded dS, and each gradient is rounded to bf16 once.

The emulation is held within the card tests' bf16 limit (1e-2 of max|g|,
``tests/test_torch_kernels_card.py``'s BWD_BF16_OF_MAX) of the port's plain
backward ``ref.flash_attention_bwd_ref`` (the same rounding points, sums in
another order) and of ``jax.vjp`` of the reference's oracle
``repro.kernels.ref.flash_attention_ref`` in f32 on the same bf16 values
(on the rows and members that see a key: the oracle gives NaN on a row with
none). Blocks touch disjoint outputs and sum in a fixed order: visiting
them in another order gives the same bits.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

from repro_torch.kernels import ref

OF_MAX = 1e-2
LOG2E = 1.4426950408889634
WIDTHS = (8, 16, 32, 64)  # streamed tile widths the kernel instantiates
TILE = 64                 # streamed rows a tile; rows a consumer warpgroup


def _width(live: int) -> int:
    """The trimmed width of a streamed tile with ``live`` rows left."""
    return next(w for w in WIDTHS if w >= min(live, TILE))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [H, M, K] @ b [H, K, N] in f32 over bf16 values: each k-step of 16
    summed, the steps added in order (K a multiple of 16)."""
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 16):
        out = out + a[..., k0:k0 + 16] @ b[..., k0:k0 + 16, :]
    return out


def _rows(x: torch.Tensor, r0: int, n: int) -> torch.Tensor:
    """Rows [r0, r0 + n) of x [H, S, ...], zero past S (TMA's fill)."""
    out = x.new_zeros((x.shape[0], n) + x.shape[2:])
    m = max(0, min(n, x.shape[1] - r0))
    out[:, :m] = x[:, r0:r0 + m]
    return out


def _pad16(x: torch.Tensor) -> torch.Tensor:
    """The last dim padded with zeros to a multiple of 16 (an n8 tile's k-step)."""
    n = x.shape[-1]
    return torch.nn.functional.pad(x, (0, -n % 16))


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def emulate(q, k, v, out, dout, lse, *, bias=None, kv_len=None, causal=False, order=None):
    """(dq, dk, dv, dbias or None) of the kernel's two passes; q, k, v, out,
    dout bf16 [B, H, S, D], lse [B, H, Sq] f32 (natural units, +inf on a row
    with no key). ``order`` permutes the visit of the blocks (dQ pass) and of
    the key groups (dK/dV pass)."""
    b_, h_, sq, d = q.shape
    sk = k.shape[2]
    shift = sk - sq
    scale = np.float32(1.0 / math.sqrt(d))
    scale_log2 = float(np.float32(LOG2E) * scale)
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, out, dout))
    dq = torch.zeros_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    part = torch.zeros((b_, h_, sk), dtype=torch.float32)
    rowsum = (dof * of).sum(-1)  # D_i, f32
    q_blocks = list(range(0, sq, 2 * TILE))
    k_groups = list(range(0, sk, TILE))
    if order is not None:
        q_blocks, k_groups = order(q_blocks), order(k_groups)
    for b in range(b_):
        kend = sk if kv_len is None else min(sk, max(int(kv_len[b]), 0))
        b2 = (torch.zeros(sk) if bias is None
              else bias[b].float().clamp_min(ref.NEG) * np.float32(LOG2E))
        ls2 = lse[b] * np.float32(LOG2E)  # [H, Sq]

        # pass 1: dQ, one block of two 64-row warpgroups
        for q0 in q_blocks:
            for r0 in (q0, q0 + TILE):
                if r0 >= sq:
                    continue
                end = kend
                if causal:
                    end = min(end, max(min(r0 + TILE, sq) + shift, 0))
                qpos = torch.arange(r0, r0 + TILE)[:, None]
                qw, dow = _rows(qf[b], r0, TILE), _rows(dof[b], r0, TILE)
                lw = _rows(ls2[..., None], r0, TILE)
                lw[:, max(0, sq - r0):] = math.inf
                dw = _rows(rowsum[b][..., None], r0, TILE)
                acc = torch.zeros((h_, TILE, d))
                for t0 in range(0, end, TILE):
                    n = _width(end - t0)
                    kt, vt = _rows(kf[b], t0, n), _rows(vf[b], t0, n)
                    s = _dot(qw, kt.transpose(1, 2))
                    dp = _dot(dow, vt.transpose(1, 2))
                    kpos = torch.arange(t0, t0 + n)[None, :]
                    bt = torch.zeros(n)
                    bt[:max(0, min(n, sk - t0))] = b2[t0:t0 + n]
                    p = torch.exp2(s * scale_log2 + bt - lw)
                    seen = kpos < kend
                    if causal:
                        seen = seen & (kpos <= qpos + shift)
                    p = torch.where(seen, p, torch.zeros_like(p))
                    ds = p * (dp - dw)
                    kpad = _pad16(kt.transpose(1, 2)).transpose(1, 2)  # keys past n: 0
                    acc = acc + _dot(_pad16(_bf(ds)), kpad)
                rows = slice(r0, min(r0 + TILE, sq))
                dq[b, :, rows] = (acc * scale)[:, :rows.stop - r0].bfloat16()

        # pass 2: dK and dV, 64 keys at a time
        for kw0 in k_groups:
            keys = slice(kw0, min(kw0 + TILE, sk))
            if kw0 >= kend:  # no query sees these keys: zeros
                continue
            kpos = torch.arange(kw0, kw0 + TILE)[:, None]
            kw, vw = _rows(kf[b], kw0, TILE), _rows(vf[b], kw0, TILE)
            kb = torch.zeros(TILE)
            kb[:keys.stop - kw0] = b2[keys]
            gk, gv = torch.zeros((h_, TILE, d)), torch.zeros((h_, TILE, d))
            db = torch.zeros((h_, TILE))
            for t0 in range(0, sq, TILE):
                if causal and kw0 > min(t0 + TILE, sq) - 1 + shift:
                    continue  # the warpgroup's first key is seen by no query of the tile
                n = _width(sq - t0)
                qt, dot = _rows(qf[b], t0, n), _rows(dof[b], t0, n)
                lt = _rows(ls2[..., None], t0, n)[..., 0]
                rt = _rows(rowsum[b][..., None], t0, n)[..., 0]
                st = _dot(kw, qt.transpose(1, 2))
                dpt = _dot(vw, dot.transpose(1, 2))
                qpos = torch.arange(t0, t0 + n)[None, :]
                pt = torch.exp2(st * scale_log2 + kb[None, :, None] - lt[:, None, :])
                seen = (qpos < sq) & (kpos < kend)
                if causal:
                    seen = seen & (kpos <= qpos + shift)
                pt = torch.where(seen, pt, torch.zeros_like(pt))
                dopad = _pad16(dot.transpose(1, 2)).transpose(1, 2)
                qpad = _pad16(qt.transpose(1, 2)).transpose(1, 2)
                gv = gv + _dot(_pad16(_bf(pt)), dopad)
                dst = pt * (dpt - rt[:, None, :])
                db = db + dst.sum(-1)
                gk = gk + _dot(_pad16(_bf(dst)), qpad)
            m = keys.stop - kw0
            dk[b, :, keys] = (gk * scale)[:, :m].bfloat16()
            dv[b, :, keys] = gv[:, :m].bfloat16()
            part[b, :, keys] = db[:, :m]
    dbias = None if bias is None else part.sum(dim=1) * (bias >= ref.NEG)
    return dq, dk, dv, dbias


def _lse(q, k, bias, kv_len, causal):
    """The forward's log-sum-exp of the plain f32 scores, +inf on a row with
    no unmasked key (the forward kernel's convention)."""
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if bias is not None:
        s = s + bias.float().clamp_min(ref.NEG)[:, None, None, :]
    kpos = torch.arange(sk)
    mask = torch.ones((q.shape[0], 1, sq, sk), dtype=torch.bool)
    if kv_len is not None:
        mask = mask & (kpos[None, :] < kv_len[:, None])[:, None, None, :]
    if causal:
        mask = mask & (torch.arange(sq)[:, None] + (sk - sq) >= kpos[None, :])
    lse = torch.logsumexp(s.masked_fill(~mask, -math.inf), dim=-1)
    return torch.where(torch.isinf(lse), torch.full_like(lse, math.inf), lse)


def _case(b, h, sq, sk, d, *, seed, bias=False, kv_len=None, causal=False):
    """Inputs drawn with numpy: bf16 q, k, v, dout; a log-size bias with -inf
    on the last (up to 3) keys; the forward's output (plain version) and
    log-sum-exp."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(b, h, sq, d)).astype(np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.normal(size=(b, h, sk, d)).astype(np.float32)).bfloat16()
            for _ in range(2))
    dout = torch.from_numpy(rng.normal(size=(b, h, sq, d)).astype(np.float32)).bfloat16()
    kw = {"causal": causal}
    if bias:
        sizes = rng.uniform(0.5, 4.0, size=(b, sk))
        sizes[:, sk - min(3, sk - 1):] = 0.0
        with np.errstate(divide="ignore"):
            kw["bias"] = torch.from_numpy(np.log(sizes).astype(np.float32))
    if kv_len is not None:
        kw["kv_len"] = torch.tensor(kv_len, dtype=torch.int32)
    out = ref.flash_attention_ref(q, k, v, **kw)
    lse = _lse(q, k, kw.get("bias"), kw.get("kv_len"), causal)
    return q, k, v, out, dout, lse, kw


def _close(got, exp, scale, name):
    assert torch.isfinite(got).all(), name
    err = float((got.float() - exp.float()).abs().max())
    assert err <= OF_MAX * scale, f"{name}: {err:.3e} > {OF_MAX} x {scale:.3e}"


def _against_plain(got, q, k, v, out, dout, kw):
    """Each gradient within OF_MAX of max|g| of the port's plain backward;
    with one key dQ, dK and dbias are 0 up to rounding (limit of max|dV|)."""
    exp = ref.flash_attention_bwd_ref(q, k, v, out, dout, need_bias="bias" in kw, **kw)
    dv_scale = float(exp[2].float().abs().max())
    for name, g, e in zip(("dq", "dk", "dv", "dbias"), got, exp):
        if e is None:
            assert g is None, name
            continue
        assert g.shape == e.shape and g.dtype == e.dtype, name
        scale = dv_scale if k.shape[2] == 1 and name != "dv" else float(e.float().abs().max())
        _close(g, e, scale, name)


def _jax_grads(q, k, v, dout, kw):
    """(dq, dk, dv, dbias or None) by jax.vjp of the reference's oracle on
    the bf16 values in f32."""
    args = [jnp.asarray(t.float().numpy()) for t in (q, k, v)]
    bias = kw.get("bias")
    if bias is not None:
        args.append(jnp.asarray(bias.numpy()))
    kl = kw.get("kv_len")
    kl = None if kl is None else jnp.asarray(kl.numpy())

    def f(q, k, v, *b):
        return jref.flash_attention_ref(q, k, v, bias=b[0] if b else None, kv_len=kl,
                                        causal=kw["causal"])

    @jax.jit  # one compilation a shape, not one an operation
    def grads(ct, *args):
        return jax.vjp(f, *args)[1](ct)
    out = grads(jnp.asarray(dout.float().numpy()), *args)
    return [torch.from_numpy(np.array(g)) for g in out] + ([None] if bias is None else [])


def _against_jax(got, q, k, v, dout, kw):
    """Within OF_MAX of max|g| of jax.vjp of the oracle, on the members with
    a key (kv_len > 0) and, causal with Sq > Sk, on the last Sk queries (the
    first Sq - Sk see no key; with bottom-right alignment the rest is the
    oracle's causal call on them); the rows cut have dq = 0."""
    sq, sk = q.shape[2], k.shape[2]
    keep = [b for b in range(q.shape[0])
            if "kv_len" not in kw or int(kw["kv_len"][b]) > 0]
    cut = max(0, sq - sk) if kw["causal"] else 0
    if cut:
        assert torch.all(got[0][:, :, :cut] == 0)
    sub = {name: kw[name][keep] for name in ("bias", "kv_len") if name in kw}
    sub["causal"] = kw["causal"]
    exp = _jax_grads(q[keep][:, :, cut:], k[keep], v[keep], dout[keep][:, :, cut:], sub)
    mine = [got[0][keep][:, :, cut:], got[1][keep], got[2][keep],
            None if got[3] is None else got[3][keep]]
    dv_scale = float(exp[2].abs().max())
    for name, g, e in zip(("dq", "dk", "dv", "dbias"), mine, exp):
        if e is None:
            continue
        scale = dv_scale if sk == 1 and name != "dv" else float(e.abs().max())
        _close(g, e, scale, name)


LENGTHS = (1, 17, 64, 65, 129, 577)


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("d", [64, 128])
def test_emulation_matches_the_plain_backward_and_jax(d, s):
    """Sq = Sk at each length: the bias with -inf pads (also against
    jax.vjp); causal with a kv_len splitting a tile (member 1) beside the
    full length; and a kv_len-0 member beside one that splits a tile (the
    plain backward, which tests/test_torch_flash_bwd.py holds against
    jax.vjp, in these two)."""
    split = max(1, (s + 1) // 2)
    for i, mode in enumerate(({"bias": True}, {"causal": True, "kv_len": [s, split]},
                              {"kv_len": [0, split], "bias": True})):
        q, k, v, out, dout, lse, kw = _case(2, 2, s, s, d, seed=100 * d + 7 * s + i, **mode)
        got = emulate(q, k, v, out, dout, lse, **kw)
        _against_plain(got, q, k, v, out, dout, kw)
        if i == 0:
            _against_jax(got, q, k, v, dout, kw)


@pytest.mark.parametrize("sq,sk", [(65, 129), (129, 65), (17, 577), (577, 17)],
                         ids=lambda x: str(x))
@pytest.mark.parametrize("d", [64, 128])
def test_emulation_causal_with_unequal_lengths(d, sq, sk):
    """Causal with Sq < Sk (every query sees keys) and Sq > Sk (the first
    Sq - Sk queries see none and get dq = 0), with the bias."""
    q, k, v, out, dout, lse, kw = _case(2, 2, sq, sk, d, seed=sq + 3 * sk + d, bias=True,
                                        causal=True)
    got = emulate(q, k, v, out, dout, lse, **kw)
    _against_plain(got, q, k, v, out, dout, kw)
    _against_jax(got, q, k, v, dout, kw)


@pytest.mark.parametrize("d", [64, 128])
def test_emulation_zeros_unseen_keys_empty_rows_and_clamped_bias(d):
    """A kv_len-0 member gets every gradient 0, keys past a kv_len dK = dV = 0
    (a whole key group past it too), rows that see no key dq = 0, and dbias
    0 at the -inf pads."""
    q, k, v, out, dout, lse, kw = _case(2, 2, 150, 130, d, seed=9, bias=True, causal=True,
                                        kv_len=[0, 40])
    dq, dk, dv, dbias = emulate(q, k, v, out, dout, lse, **kw)
    assert all(float(g[0].abs().max()) == 0 for g in (dq, dk, dv))
    assert torch.all(dk[1, :, 40:] == 0) and torch.all(dv[1, :, 40:] == 0)
    assert torch.all(dq[1, :, :20] == 0)  # Sq - Sk = 20 queries see no key
    assert torch.all(dbias[:, -3:] == 0) and torch.all(dbias[0] == 0)
    assert float(dk[1, :, :40].abs().max()) > 0


@pytest.mark.parametrize("d", [64, 128])
def test_emulation_is_the_same_in_any_block_order(d):
    """Blocks write disjoint rows and each sums its tiles in a fixed order:
    the dQ blocks and the key groups visited in reverse, or interleaved,
    give the same bits (no atomics; the kernel's gradient does not depend
    on which SM runs which block when)."""
    q, k, v, out, dout, lse, kw = _case(2, 2, 577, 577, d, seed=11, bias=True, causal=True,
                                        kv_len=[577, 300])
    first = emulate(q, k, v, out, dout, lse, **kw)
    for order in (lambda xs: xs[::-1], lambda xs: xs[1::2] + xs[::2]):
        again = emulate(q, k, v, out, dout, lse, order=order, **kw)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_widths_trim_the_ragged_tail():
    """The streamed tile at the ragged end takes the least width the kernel
    instantiates: at 577 rows, nine tiles of 64 and one of 8, so a (b, h)
    computes 640 x 584 (query, key) pairs in each pass, 1.12 x 577^2."""
    widths = [_width(577 - t0) for t0 in range(0, 577, TILE)]
    assert widths == [64] * 9 + [8]
    rows = -(-577 // TILE) * TILE
    assert rows * sum(widths) == 640 * 584
    assert round(640 * 584 / 577 ** 2, 2) == 1.12
    assert [_width(n) for n in (1, 8, 9, 16, 17, 32, 33, 64, 65)] == [8, 8, 16, 16, 32, 32, 64,
                                                                     64, 64]
