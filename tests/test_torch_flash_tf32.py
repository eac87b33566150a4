"""The 3xTF32 arithmetic of the flash kernels that serve f32, on the CPU.

``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu`` compute f32
attention on the tensor cores: every f32 operand x is split into
hi = tf32(x) and lo = tf32(x - hi) (``cvt.rna.tf32.f32``: round to a 10-bit
mantissa, ties away from zero), and a.b is taken as
lo_a.hi_b + hi_a.lo_b + hi_a.hi_b. Here that arithmetic is emulated in the
kernels' order (``mma_mm``): the contraction in k-steps of 8 (one
``mma.sync.m16n8k8`` a term, the small terms first), each mma's sum rounded
toward zero to f32; the products over the head dim (S, dP) keep their sum in
the mma's accumulator, the products over keys or queries (P.V, dV, dQ, dK)
sum each step's terms from zero and add them to the f32 accumulator with one
add, to nearest. Rounding each mma's sum toward zero is
a model of the tensor cores' accumulation (its products exact); the hardware's
alignment of the products before the sum is not modelled. The emulation runs
through the forward's online softmax over key tiles and through every
product of the plain backward (``ref.flash_attention_bwd_ref``), and is held
against the JAX oracle ``repro.kernels.ref.flash_attention_ref`` and
``jax.vjp`` of it at the card's f32 limits: atol 2e-5 / rtol 1e-4 for the
output, 1e-4 of max|g| for each gradient. A 1xTF32 emulation (hi.hi alone)
must break the same limits on the same inputs, so the limits are shown to
reject plain TF32. Keeping P.V's whole sum over the keys in the mma's
accumulator instead lets it drift toward zero: at the reference's 577 keys
its error is several times the kernels' order's, which is why each step is
added in f32. Inputs are drawn with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

from repro_torch.kernels import ref

# -n 6 workers, each running 8 intra-op threads on 8 cores, oversubscribe the CPU
# (a 2 s case took 150 s among six copies): one thread a worker
torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4  # the f32 flash limits
BWD_OF_MAX = 1e-4        # the f32 flash backward's limit, of max|g|
LOG2E = 1.4426950408889634
MODES = ["plain", "causal", "bias", "kv_len"]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 rounded to 10 mantissa bits, to nearest,
    ties away from zero, by integer operations on the bits (the sign bit is
    apart, so adding half an ulp to the pattern rounds the magnitude up)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(x)
    return hi, tf32(x - hi)


def toward_zero(x: torch.Tensor) -> torch.Tensor:
    """f64 ``x`` rounded to f32 toward zero."""
    r = x.float()
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def mma_mm(a: torch.Tensor, b: torch.Tensor, terms: int, acc: torch.Tensor | None = None,
           per_step: bool = True) -> torch.Tensor:
    """``acc`` (0 if None) + a @ b, batched f32, as the kernels take it:
    3xTF32 (``terms`` 3; the small terms first) or plain TF32 (``terms`` 1)
    over k-steps of 8, each mma's sum (its products exact) rounded toward
    zero to f32. With ``per_step`` each step's terms are summed from zero and
    added to ``acc`` in f32, to nearest (the kernels' ``mma3``); without it
    every mma adds into ``acc`` itself."""
    ah, al = split(a.float())
    bh, bl = split(b.float())
    pairs = [(al, bh), (ah, bl), (ah, bh)] if terms == 3 else [(ah, bh)]
    shape = (*a.shape[:-1], b.shape[-1])
    out = torch.zeros(shape) if acc is None else acc.float()
    for k0 in range(0, a.shape[-1], 8):
        f = torch.zeros(shape) if per_step else out
        for x, y in pairs:
            f = toward_zero(f.double() + x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double())
        out = out + f if per_step else f
    return out


def _draw(b, h, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, h, sk, d)).astype(np.float32) for _ in range(2))
    bias = np.log(rng.uniform(0.5, 4.0, size=(b, sk))).astype(np.float32)
    bias[:, sk - 3:] = -np.inf  # bucket pads
    dout = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    return q, k, v, bias, dout


def _case(d, mode, seed):
    """Inputs of one call: B=2, H=2; Sq < Sk (Sq > Sk under causal in the
    forward); the bias with -inf pads; kv_len 61 and 100 (a key tile split)."""
    sq, sk = (70, 100) if mode != "causal" else (100, 70)
    q, k, v, bias, dout = _draw(2, 2, sq, sk, d, seed)
    kw = {"causal": mode == "causal", "bias": bias if mode == "bias" else None,
          "kv_len": np.asarray([61, sk], np.int32) if mode == "kv_len" else None}
    return q, k, v, dout, kw


def forward_emulation(q, k, v, *, bias=None, kv_len=None, causal=False, terms=3,
                      per_step=True):
    """The forward kernel's arithmetic: scores in log2 units, an online
    softmax over key tiles of 64 (32 at D=128), S = Q.K^T in the mma's
    accumulator and O += P.V added per k-step (``per_step``) by ``mma_mm``,
    f32 P, output acc / max(l, 1e-30), 0 on a row with no unmasked key."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bk = 32 if d > 64 else 64
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
        s = (mma_mm(q, k[:, :, t0:t0 + bk].transpose(2, 3), terms, per_step=False)
             * scale_log2
             + bias2[:, None, None, t0:t0 + bk])
        ok = (kpos[None, :] < kend[:, None])[:, None, None, :]
        if causal:
            ok = ok & (kpos[None, :] <= qpos + (sk - sq))
        s = torch.where(ok, s, torch.full_like(s, ref.NEG))
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp2(m - mn), torch.exp2(s - mn)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = mma_mm(p, v[:, :, t0:t0 + bk], terms, o * alpha, per_step)
        m = mn
    return torch.where(m > 0.5 * ref.NEG, o / l.clamp_min(1e-30), torch.zeros_like(o))


def backward_emulation(q, k, v, out, dout, *, bias=None, kv_len=None, causal=False, terms=3):
    """``ref.flash_attention_bwd_ref``'s arithmetic (f32 inputs) with each of
    its five products, S, dP, dV, dQ and dK, by ``mma_mm`` (S and dP in the
    mma's accumulator)."""
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    scale = 1.0 / np.sqrt(d)
    s = mma_mm(q, k.transpose(2, 3), terms, per_step=False) * scale
    if bias is not None:
        s = s + bias.clamp_min(ref.NEG)[:, None, None, :]
    kpos, qpos = torch.arange(sk), torch.arange(sq)
    mask = torch.ones((q.shape[0], 1, sq, sk), dtype=torch.bool)
    if kv_len is not None:
        mask = mask & (kpos[None, :] < kv_len[:, None])[:, None, None, :]
    if causal:
        mask = mask & (qpos[:, None] + (sk - sq) >= kpos[None, :])
    s = s.masked_fill(~mask, ref.NEG)
    p = torch.softmax(s, dim=-1) * (s.amax(-1, keepdim=True) > 0.5 * ref.NEG)
    dv = mma_mm(p.transpose(2, 3), dout, terms)
    rowsum = (dout * out).sum(-1, keepdim=True)
    ds = p * (mma_mm(dout, v.transpose(2, 3), terms, per_step=False) - rowsum)
    dq = mma_mm(ds, k, terms) * scale
    dk = mma_mm(ds.transpose(2, 3), q, terms) * scale
    dbias = None if bias is None else ds.sum(dim=(1, 2)) * (bias >= ref.NEG)
    return dq, dk, dv, dbias


def _jax_forward(q, k, v, kw):
    return np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=None if kw["bias"] is None else jnp.asarray(kw["bias"]),
        kv_len=None if kw["kv_len"] is None else jnp.asarray(kw["kv_len"]),
        causal=kw["causal"]))


def _jax_grads(q, k, v, dout, kw):
    args = [jnp.asarray(a) for a in (q, k, v)]
    if kw["bias"] is not None:
        args.append(jnp.asarray(kw["bias"]))
    kl = None if kw["kv_len"] is None else jnp.asarray(kw["kv_len"])

    def f(q, k, v, *b):
        return jref.flash_attention_ref(q, k, v, bias=b[0] if b else None, kv_len=kl,
                                        causal=kw["causal"])
    _, vjp = jax.vjp(f, *args)
    return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _torch_kw(kw):
    return {"causal": kw["causal"],
            "bias": None if kw["bias"] is None else torch.from_numpy(kw["bias"]),
            "kv_len": None if kw["kv_len"] is None else torch.from_numpy(kw["kv_len"])}


def _forward(q, k, v, kw, terms):
    t = [torch.from_numpy(a) for a in (q, k, v)]
    return forward_emulation(*t, terms=terms, **_torch_kw(kw)).numpy()


def _live(q, k, kw):
    """The rows that see a key (the oracle gives NaN on the others)."""
    sq, sk = q.shape[2], k.shape[2]
    rows = np.ones(q.shape[:3], bool)
    if kw["causal"]:
        rows[:, :, :max(sq - sk, 0)] = False
    return rows


def _forward_close(got, exp, rows) -> bool:
    return bool(np.allclose(got[rows], exp[rows], atol=ATOL, rtol=RTOL))


def _grads(q, k, v, dout, kw, terms):
    t = [torch.from_numpy(a) for a in (q, k, v, dout)]
    tkw = _torch_kw(kw)
    out = forward_emulation(*t[:3], terms=terms, **tkw)
    grads = backward_emulation(*t[:3], out, t[3], terms=terms, **tkw)
    return [g.numpy() for g in grads if g is not None]


def _grad_readings(got, exp) -> list[float]:
    """max|got - exp| / max|exp| of each gradient."""
    return [float(np.abs(g - e).max() / np.abs(e).max()) for g, e in zip(got, exp)]


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    one = 1.0
    x = torch.tensor([one + 2 ** -11, -(one + 2 ** -11), one + 2 ** -11 - 2 ** -23,
                      one + 3 * 2 ** -11, 2 ** -11 * 3, one + 2 ** -10], dtype=torch.float32)
    want = torch.tensor([one + 2 ** -10, -(one + 2 ** -10), one, one + 2 ** -9, 2 ** -11 * 3,
                         one + 2 ** -10], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    assert torch.all(tf32(x).view(torch.int32) & 0x1FFF == 0)


def test_split_keeps_f32_accuracy_and_bf16_is_exact():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=4096).astype(np.float32) * 10.0)
    hi, lo = split(x)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((lo.view(torch.int32) & 0x1FFF) == 0)
    # hi + lo keeps 21 or more of the 24 mantissa bits
    assert float(((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()) \
        <= 2.0 ** -21
    assert float((hi - x).abs().max()) > 0  # one TF32 term alone does not
    xb = x.bfloat16().float()
    hb, lb = split(xb)
    assert torch.equal(hb, xb) and torch.all(lb == 0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_3xtf32_forward_meets_the_f32_limits(d, mode):
    q, k, v, _, kw = _case(d, mode, seed=d + len(mode))
    got = _forward(q, k, v, kw, terms=3)
    exp = _jax_forward(q, k, v, kw)
    rows = _live(q, k, kw)
    np.testing.assert_allclose(got[rows], exp[rows], atol=ATOL, rtol=RTOL)
    assert np.all(got[~rows] == 0)
    plain = ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                    **_torch_kw(kw)).numpy()
    np.testing.assert_allclose(got, plain, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_1xtf32_forward_breaks_the_f32_limits(d, mode):
    q, k, v, _, kw = _case(d, mode, seed=d + len(mode))
    exp = _jax_forward(q, k, v, kw)
    assert not _forward_close(_forward(q, k, v, kw, terms=1), exp, _live(q, k, kw))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_3xtf32_backward_meets_the_f32_limit(d, mode):
    # causal with Sq < Sk here: the oracle's gradient is NaN on a row with no key
    q, k, v, dout, kw = _case(d, "plain" if mode == "causal" else mode, seed=3 * d)
    kw["causal"] = mode == "causal"
    got = _grads(q, k, v, dout, kw, terms=3)
    exp = _jax_grads(q, k, v, dout, kw)
    assert len(got) == len(exp) == (4 if mode == "bias" else 3)
    assert max(_grad_readings(got, exp)) <= BWD_OF_MAX


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_1xtf32_backward_breaks_the_f32_limit(d, mode):
    q, k, v, dout, kw = _case(d, "plain" if mode == "causal" else mode, seed=3 * d)
    kw["causal"] = mode == "causal"
    exp = _jax_grads(q, k, v, dout, kw)
    assert max(_grad_readings(_grads(q, k, v, dout, kw, terms=1), exp)) > BWD_OF_MAX


def test_a_running_mma_accumulator_drifts_toward_zero():
    """At the reference's [·, ·, 577, 64]: with P.V's whole sum over the keys
    kept in the mma's accumulator, every mma rounding toward zero, the
    forward's mean error against an f64 softmax is several times that of the
    kernels' order (each k-step added in f32), and it leans toward zero."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 577, 64)).astype(np.float32))
               for _ in range(3))
    s = q.double() @ k.double().transpose(2, 3) / 8.0
    exp = torch.softmax(s, dim=-1) @ v.double()
    per_step = forward_emulation(q, k, v).double() - exp
    running = forward_emulation(q, k, v, per_step=False).double() - exp
    assert float(running.abs().mean()) > 5 * float(per_step.abs().mean())
    lean = [float((d * exp.sign()).mean()) for d in (per_step, running)]
    assert lean[1] < 5 * lean[0] < 0, lean
    assert float(per_step.abs().max()) <= 1e-6
