"""The port's optimizer and gradient compression against the reference, on
the CPU.

Both packages get the same params, grads and state, made with numpy: where
``v`` is near 0, Adam turns any tiny difference of a grad into an update of
+-lr, so the update is held at identical grads.

Tolerances: ``lr_at`` rtol 1e-6 (f32 arithmetic on both sides); the grad
norm rtol 1e-6 (another summation order within each leaf); ``m``, ``v`` and
f32 params within 1e-6 of the leaf's max|x| (the clip factor carries the
norm's last-ulp difference into every element, and ``m`` cancels between
its two terms: measured up to 3 f32 ulps of an element of ``m``); bf16
params at most one bf16 ulp on any element (an f32 update equal to that
tolerance, rounded once to bf16); top-k, error feedback and int8 bit for
bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import grad_compression as jgc

from repro_torch.optim import adamw, grad_compression as gc

# -n 6 workers, each running 8 intra-op threads on 8 cores, oversubscribe the CPU
# (a 2 s case took 150 s among six copies): one thread a worker
torch.set_num_threads(1)

RTOL = 1e-6


def _tree(seed: int, scale: float = 1.0):
    rng = np.random.default_rng(seed)
    return {"blocks": {"w": (scale * rng.standard_normal((3, 8, 16))).astype(np.float32),
                       "b": (scale * rng.standard_normal((3, 16))).astype(np.float32)},
            "head": {"w": (scale * rng.standard_normal((16, 10))).astype(np.float32)},
            "a_norm": {"scale": (scale * rng.standard_normal((16,))).astype(np.float32)}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _np(x):
    x = x.detach() if isinstance(x, torch.Tensor) else x
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(jnp.asarray(x, jnp.float32) if x.dtype == jnp.bfloat16 else x)


def test_adamw_config_equals_the_reference():
    assert adamw.AdamWConfig() == adamw.AdamWConfig(**vars(jadamw.AdamWConfig()))


@pytest.mark.parametrize("cfg", [adamw.AdamWConfig(),
                                 adamw.AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=40,
                                                   min_lr_ratio=0.0)])
def test_lr_at_matches_reference(cfg):
    jcfg = jadamw.AdamWConfig(**vars(cfg))
    steps = np.arange(0, cfg.total_steps + 20, dtype=np.int32)
    exp = np.array([float(jadamw.lr_at(jcfg, jnp.int32(s))) for s in steps], np.float32)
    got = adamw.lr_at(cfg, torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=0)


def _run_both(cfg, dtype, n_steps=3, grad_scale=1.0):
    """n AdamW steps of both packages from the same params, each step fed the
    same grads; returns [(reference, port)] per step of (params, m, v,
    metrics)."""
    jcfg = jadamw.AdamWConfig(**vars(cfg))
    p0 = _tree(0)
    jparams = _map(lambda a: jnp.asarray(a).astype(dtype[0]), p0)
    tparams = _map(lambda a: torch.from_numpy(a).to(dtype[1]), p0)
    jstate = jadamw.init_state(jparams)
    tstate = adamw.init_state(tparams)
    out = []
    for s in range(n_steps):
        g = _tree(10 + s, grad_scale)
        jg = _map(lambda a: jnp.asarray(a).astype(dtype[0]), g)
        tg = _map(lambda a: torch.from_numpy(a).to(dtype[1]), g)
        jparams, jstate, jm = jadamw.apply_updates(jcfg, jparams, jg, jstate)
        tparams, tstate, tm = adamw.apply_updates(cfg, tparams, tg, tstate)
        snapshot = _map(torch.clone, {"p": tparams, "s": tstate})  # the port updates in place
        out.append(((jparams, jstate, jm), (snapshot["p"], snapshot["s"], tm)))
    return out


def _close(got, exp, msg):
    np.testing.assert_allclose(got, exp, rtol=0, atol=RTOL * np.abs(exp).max(), err_msg=msg)


def _check_step(ref, port, bf16: bool):
    (jp, js, jm), (tp, ts, tm) = ref, port
    assert int(ts["step"]) == int(js["step"]) and ts["step"].dtype == torch.int32
    for name in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=RTOL)
    for key in ("m", "v"):
        for k, a in _flat(ts[key]).items():
            assert a.dtype == torch.float32
            _close(a.numpy(), _np(_flat(js[key])[k]), f"{key}/{k}")
    for k, a in _flat(tp).items():
        exp = _np(_flat(jp)[k])
        assert a.dtype == (torch.bfloat16 if bf16 else torch.float32)
        if bf16:  # one rounding of an f32 update equal to rtol 1e-6: at most one bf16 ulp
            ulp = np.abs(exp) * 2.0 ** -7
            assert np.all(np.abs(_np(a) - exp) <= ulp), k
        else:
            _close(a.numpy(), exp, k)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_apply_updates_matches_reference_on_the_same_grads(bf16):
    dtype = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    for ref, port in _run_both(cfg, dtype):
        _check_step(ref, port, bf16)


@pytest.mark.parametrize("grad_clip", [0.5, 0.0], ids=["clipped", "no-clip"])
def test_grad_clip_matches_reference(grad_clip):
    """Grads of norm ~100: clipped to 0.5 (a factor ~5e-3) or, with
    ``grad_clip=0``, not clipped at all."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0, grad_clip=grad_clip)
    runs = _run_both(cfg, (jnp.float32, torch.float32), n_steps=2, grad_scale=10.0)
    for ref, port in runs:
        _check_step(ref, port, False)
    assert float(runs[0][1][2]["grad_norm"]) > 50


def test_global_norm_sums_leaves_in_the_reference_order():
    tree = _map(torch.from_numpy, _tree(3))
    assert [tuple(t.shape) for t in adamw.leaves(tree)] == [
        (16,), (3, 16), (3, 8, 16), (16, 10)]  # a_norm, blocks/b, blocks/w, head
    exp = float(jadamw.global_norm(_map(jnp.asarray, _tree(3))))
    np.testing.assert_allclose(float(adamw.global_norm(tree)), exp, rtol=RTOL)


@pytest.mark.parametrize("keep_ratio", [0.1, 0.5, 1e-4])
def test_topk_sparsify_bit_for_bit(keep_ratio):
    rng = np.random.default_rng(0)
    g = rng.standard_normal((32, 24)).astype(np.float32)
    g[0, :8] = 2.5  # ties at the threshold keep the same mask
    g[1, :4] = -2.5
    jsparse, jmask = jgc.topk_sparsify(jnp.asarray(g), keep_ratio)
    sparse, mask = gc.topk_sparsify(torch.from_numpy(g), keep_ratio)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(sparse.numpy().view(np.uint32),  # +0 where dropped
                                  np.asarray(jsparse).view(np.uint32))


def test_ef_step_bit_for_bit_over_steps():
    jerr = jgc.init_error_state(_map(jnp.asarray, _tree(0)))
    err = gc.init_error_state(_map(torch.from_numpy, _tree(0)))
    for s in range(3):
        g = _tree(20 + s)
        jsparse, jerr = jgc.ef_step(_map(jnp.asarray, g), jerr, 0.2)
        sparse, err = gc.ef_step(_map(torch.from_numpy, g), err, 0.2)
        for got, exp in ((sparse, jsparse), (err, jerr)):
            for k, a in _flat(got).items():
                np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                              np.asarray(_flat(exp)[k]).view(np.uint32),
                                              err_msg=k)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_int8_compress_bit_for_bit(scale):
    rng = np.random.default_rng(1)
    x = (scale * rng.standard_normal((64, 33))).astype(np.float32)
    x[0, 0] = 127.5 * scale / 127.0 * 0  # keeps a zero in every case
    jq, jscale = jgc.int8_compress(jnp.asarray(x))
    q, s = gc.int8_compress(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert np.float32(s) == np.float32(jscale)
    np.testing.assert_array_equal(gc.int8_decompress(q, s).numpy(),
                                  np.asarray(jgc.int8_decompress(jq, jscale)))


def test_int8_rounds_half_to_even_as_the_reference():
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5], np.float32)  # scale exactly 1
    jq, _ = jgc.int8_compress(jnp.asarray(x))
    q, _ = gc.int8_compress(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(q.numpy(), [127, 0, 2, 2, 0, -2, 4])


def test_compressed_psum_mean_on_one_rank_is_the_int8_round_trip():
    """On a one-rank mesh the mean is the int8 round trip, bit for bit, for
    plain leaves and for a replicated DTensor leaf, which keeps its
    placements (the multi-rank cases are in test_torch_train_mesh_io.py)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(device="cpu")
    try:
        rng = np.random.default_rng(0)
        w = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))
        h = torch.from_numpy(rng.standard_normal((5,)).astype(np.float32)).bfloat16()
        r = DTensor.from_local(w.clone(), mesh, [Replicate(), Replicate()])
        out = gc.compressed_psum_mean({"w": w, "blk": {"h": h, "r": r}}, mesh)
        for got, x in ((out["w"], w), (out["blk"]["h"], h), (out["blk"]["r"].to_local(), w)):
            assert got.dtype == x.dtype
            assert torch.equal(got, gc.int8_decompress(*gc.int8_compress(x), x.dtype))
        assert out["blk"]["r"].placements == r.placements
        assert torch.equal(gc.compressed_psum_mean(w, mesh), out["w"])
    finally:
        dist.destroy_process_group()
