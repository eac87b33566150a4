"""The flash backward's plain version and its dispatcher, on the CPU.

``ref.flash_attention_bwd_ref`` (the plain version the backward kernels are
held against on the card) against ``jax.vjp`` of the reference's jnp oracle
``repro.kernels.ref.flash_attention_ref`` in f32, on the same inputs drawn
with numpy: plain, bias, kv_len, causal with Sq < Sk and all together, and
causal with Sq > Sk on the rows that see a key (the oracle gives NaN on a
fully masked row; the port gives those rows zero gradient). Tolerance: atol
1e-5 of max|g| (f32 on both sides, sums in another order). Then the
dispatcher: ``flash_attention.backward`` on a CPU tensor is the plain
version bit for bit, the autograd Function reaches it, and the count of a
backward call is the kernel's formula.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops, ref
from repro_torch.runtime import hlo_bytes

OF_MAX = 1e-5


def _draw(b, h, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, h, sk, d)).astype(np.float32) for _ in range(2))
    bias = np.log(rng.uniform(0.5, 4.0, size=(b, sk))).astype(np.float32)
    dout = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    return q, k, v, bias, dout


def _jax_grads(q, k, v, bias, dout, kv_len, causal):
    """(dq, dk, dv, dbias or None) by jax.vjp of the reference's oracle."""
    args = [jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)]
    if bias is not None:
        args.append(jnp.asarray(bias))
    kl = None if kv_len is None else jnp.asarray(kv_len, dtype=jnp.int32)

    def f(q, k, v, *b):
        return jref.flash_attention_ref(q, k, v, bias=b[0] if b else None, kv_len=kl,
                                        causal=causal)
    out, vjp = jax.vjp(f, *args)
    grads = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    return np.asarray(out), grads + ([None] if bias is None else [])


def _port_grads(q, k, v, bias, dout, kv_len, causal):
    t = [torch.from_numpy(a) for a in (q, k, v)]
    kw = dict(causal=causal,
              kv_len=None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32),
              bias=None if bias is None else torch.from_numpy(bias))
    out = ref.flash_attention_ref(*t, **kw)
    grads = ref.flash_attention_bwd_ref(*t, out, torch.from_numpy(dout),
                                        need_bias=bias is not None, **kw)
    return out.numpy(), [None if g is None else g.numpy() for g in grads]


def _close(got, exp, name):
    scale = float(np.abs(exp).max())
    np.testing.assert_allclose(got, exp, rtol=0, atol=OF_MAX * scale, err_msg=name)


@pytest.mark.parametrize("b,h,sq,sk,d,mode", [
    (2, 3, 40, 40, 16, "plain"),
    (2, 2, 33, 70, 32, "bias"),
    (2, 2, 64, 64, 64, "kv_len"),
    (1, 3, 37, 90, 16, "causal"),
    (2, 2, 50, 77, 32, "bias+kv_len+causal"),
])
def test_plain_backward_matches_jax_vjp_of_the_reference_oracle(b, h, sq, sk, d, mode):
    q, k, v, bias, dout = _draw(b, h, sq, sk, d, seed=sq * 7 + sk)
    bias = bias if "bias" in mode else None
    # every member sees at least one key: the oracle gives NaN on an empty row
    kv_len = [sk // 2 + 1 + i for i in range(b)] if "kv_len" in mode else None
    causal = "causal" in mode
    out_j, g_j = _jax_grads(q, k, v, bias, dout, kv_len, causal)
    out_p, g_p = _port_grads(q, k, v, bias, dout, kv_len, causal)
    np.testing.assert_allclose(out_p, out_j, rtol=0, atol=1e-6)
    for name, got, exp in zip(("dq", "dk", "dv", "dbias"), g_p, g_j):
        if exp is None:
            assert got is None
            continue
        assert got.shape == exp.shape, name
        _close(got, exp, name)


def test_plain_backward_zeroes_the_rows_that_see_no_key():
    """Causal with Sq > Sk: the first Sq - Sk queries see no key. Their dq is
    0; the other rows, and dk, dv, equal the oracle's on the rows that see a
    key (the bottom-right alignment makes them the oracle's causal call on
    the last Sk queries)."""
    b, h, sq, sk, d = 2, 2, 45, 30, 16
    q, k, v, bias, dout = _draw(b, h, sq, sk, d, seed=3)
    out_p, g_p = _port_grads(q, k, v, bias, dout, None, True)
    cut = sq - sk
    _, g_j = _jax_grads(q[:, :, cut:], k, v, bias, dout[:, :, cut:], None, True)
    assert np.all(out_p[:, :, :cut] == 0) and np.all(g_p[0][:, :, :cut] == 0)
    _close(g_p[0][:, :, cut:], g_j[0], "dq")
    for name, got, exp in zip(("dk", "dv", "dbias"), g_p[1:], g_j[1:]):
        _close(got, exp, name)


def test_plain_backward_zero_where_the_bias_is_clamped_or_no_query_looks():
    """-inf bias pads get dbias 0 (the clamp at -1e30), a kv_len-0 member gets
    every gradient 0, and keys past kv_len get dk = dv = 0."""
    q, k, v, bias, dout = (torch.from_numpy(a) for a in _draw(2, 2, 9, 12, 16, seed=4))
    bias[:, -3:] = -torch.inf
    kv_len = torch.tensor([0, 7], dtype=torch.int32)
    out = ref.flash_attention_ref(q, k, v, bias=bias, kv_len=kv_len)
    dq, dk, dv, dbias = ref.flash_attention_bwd_ref(q, k, v, out, dout, bias=bias,
                                                    kv_len=kv_len, need_bias=True)
    assert torch.all(dbias[:, -3:] == 0) and torch.all(dbias[0] == 0)
    assert all(torch.all(g[0] == 0) for g in (dq, dk, dv))
    assert torch.all(dk[1, :, 7:] == 0) and torch.all(dv[1, :, 7:] == 0)
    assert float(dk[1, :, :7].abs().max()) > 0


@pytest.mark.parametrize("kw", [{}, {"causal": True}, {"kv_len": [5, 0]}, {"bias": True},
                                {"bias": True, "causal": True, "kv_len": [9, 3]}],
                         ids=["plain", "causal", "kv_len", "bias", "all"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_on_a_cpu_tensor_is_the_plain_version(kw, dtype):
    """``flash_attention.backward`` (the dispatcher) on CPU tensors returns
    the plain version's gradients bit for bit (no log-sum-exp needed)."""
    q, k, v, bias, dout = (torch.from_numpy(a).to(dtype) if i != 3 else torch.from_numpy(a)
                           for i, a in enumerate(_draw(2, 3, 7, 9, 16, seed=5)))
    kw = dict(kw)
    if "kv_len" in kw:
        kw["kv_len"] = torch.tensor(kw["kv_len"], dtype=torch.int32)
    if kw.get("bias"):
        kw["bias"] = bias
    need_bias = "bias" in kw
    out = ref.flash_attention_ref(q, k, v, **kw)
    got = flash_mod.backward(q, k, v, out, dout, need_bias=need_bias, **kw)
    exp = ref.flash_attention_bwd_ref(q, k, v, out, dout, need_bias=need_bias, **kw)
    for g, e in zip(got, exp):
        assert (g is None and e is None) or torch.equal(g, e)


def test_autograd_function_reaches_the_dispatcher_on_cpu(monkeypatch):
    """Under grad the wrapper's autograd Function calls ``backward`` (the
    dispatcher that sends a CUDA tensor to the kernels) once a call, with
    the forward's log-sum-exp (None on the CPU) and need_bias as asked."""
    calls = []
    sound = flash_mod.backward

    def recording(*args, **kw):
        calls.append(kw)
        return sound(*args, **kw)

    monkeypatch.setattr(flash_mod, "backward", recording)
    q, k, v, bias, dout = (torch.from_numpy(a) for a in _draw(1, 2, 6, 6, 16, seed=6))
    leaves = [q.requires_grad_(), k.requires_grad_(), bias.requires_grad_()]
    out = flash_mod.flash_attention(q, k, v, bias=bias, causal=True)
    grads = torch.autograd.grad(out, leaves, dout)
    assert len(calls) == 1 and calls[0]["need_bias"] and calls[0]["causal"]
    assert calls[0]["lse"] is None
    exp = ref.flash_attention_bwd_ref(q.detach(), k, v, out.detach(), dout, bias=bias.detach(),
                                      causal=True, need_bias=True)
    for g, e in zip(grads, (exp[0], exp[1], exp[3])):
        assert torch.equal(g, e)


@pytest.mark.parametrize("sq,sk,causal", [(6, 6, False), (6, 9, True), (9, 6, True)])
def test_backward_is_counted_at_the_kernel_formula(sq, sk, causal):
    """A counted step sees one ``flash_attention_bwd`` call a flash call under
    grad: five products of 2*D FLOPs a visible (query, key) pair, and the
    kernel's bytes; nothing inside it is counted."""
    b, h, d = 2, 3, 16
    q, k, v, _, dout = (torch.from_numpy(a) for a in _draw(b, h, sq, sk, d, seed=7))
    q.requires_grad_()
    pairs = sum(min(sk, max(0, i + sk - sq + 1)) for i in range(sq)) if causal else sq * sk
    with hlo_bytes.Counter() as c:
        out = ops.flash_attention(q, k, v, causal=causal)
        torch.autograd.grad(out, [q], dout)
    assert c.kernels["flash_attention"] == 1 and c.kernels["flash_attention_bwd"] == 1
    # q, k, v, out, dout and the f32 lse read; dq, dk, dv written
    assert c.by_kind["kernel.flash_attention_bwd"] == 4 * (
        4 * b * h * sq * d + 4 * b * h * sk * d + b * h * sq)
    assert c.flops == 4 * b * h * d * pairs + 10 * b * h * d * pairs
    assert ops.flash_bwd_cost(q, k, v, causal=causal)[0] == 10.0 * b * h * d * pairs
