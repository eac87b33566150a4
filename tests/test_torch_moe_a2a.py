"""The port's all-to-all MoE dispatch (``models/moe_a2a.py``) against the
reference's (``repro.models.moe_a2a``), on the CPU.

- The fallback (tokens not divisible by dp*tp) is ``moe.apply``, bit for bit.
- One rank, a (1,1) gloo mesh: ``y`` within 1e-5 and ``aux`` within 1e-6 of
  the reference's ``moe_a2a.apply`` on a one-device mesh with Auto axes; with
  ``capacity_factor`` 8.0 (no drop) also of ``moe.apply``.
- Four gloo ranks, meshes (1,4) and (2,2), the config of
  ``tests/test_moe_a2a.py`` (d 32, ff 16, 8 experts, top 2): ``y`` within
  1e-5 and ``aux`` within 1e-6 of the reference's a2a on four host devices,
  at ``capacity_factor`` 8.0 and at 1.25, where tokens are dropped (``y``
  departs from the no-capacity ``dense_reference``) and must be the same.
- qwen3-moe-30b-a3b's SMOKE config with ``moe_impl="a2a"``: ``lm.prefill``
  and 4 teacher-forced decode steps under ``ep_tp`` rules on (1,1), against
  the reference's under a one-device Auto mesh, logits within 1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

import repro.models  # noqa: F401  (import models before sharding: circular import)
from repro.configs import qwen3_moe_30b_a3b as jqw
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import moe_a2a as jmoe_a2a
from repro.models import param as jparam
from repro.sharding import rules as jrules

from repro_torch.configs import qwen3_moe_30b_a3b
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm, moe, moe_a2a, param
from repro_torch.sharding import rules

from _ranks import run_ranks, run_reference

# -n 6 workers, each running 8 intra-op threads on 8 cores, oversubscribe the CPU
# (a 2 s case took 150 s among six copies): one thread a worker
torch.set_num_threads(1)

MOE_KW = dict(d_model=32, d_ff=16, n_experts=8, top_k=2, group_size=32)


def _moe(cf: float):
    jcfg = jmoe.MoEConfig(capacity_factor=cf, **MOE_KW)
    cfg = moe.MoEConfig(capacity_factor=cf, **MOE_KW)
    jp = jparam.init_params(jmoe.specs(jcfg), jax.random.key(0))
    x = np.array(jax.random.normal(jax.random.key(1), (4, 16, 32)))
    return jcfg, cfg, jp, param.from_jax_params(jax.tree.map(np.asarray, jp), "cpu"), x


@pytest.fixture
def host_mesh():
    mesh = make_host_mesh(device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_fallback_is_moe_apply():
    _, cfg, _, tp, x = _moe(1.25)
    xt = torch.from_numpy(x[:1, :3].copy())  # 3 tokens: not divisible by dp*tp = 4
    y, aux = moe_a2a.apply(tp, cfg, xt, {"data": 1, "model": 4})
    y2, aux2 = moe.apply(tp, cfg, xt)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_one_rank_mesh_matches_reference(host_mesh, cf):
    jcfg, cfg, jp, tp, x = _moe(cf)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jy, jaux = jax.jit(lambda p, x: jmoe_a2a.apply(p, jcfg, x, jmesh))(jp, jnp.asarray(x))
    n0 = moe_a2a.collectives
    y, aux = moe_a2a.apply(tp, cfg, torch.from_numpy(x), host_mesh)
    assert moe_a2a.collectives - n0 == 6  # 3 all-to-alls, 1 all-gather, 2 all-reduces
    assert type(y) is torch.Tensor and y.shape == (4, 16, 32)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=1e-6, rtol=0)
    if cf == 8.0:  # no token dropped: the gspmd path's numbers
        y2, _ = moe.apply(tp, cfg, torch.from_numpy(x))
        np.testing.assert_allclose(y.numpy(), y2.numpy(), atol=1e-5, rtol=0)


def test_dtensor_tokens_come_back_as_dtensors(host_mesh):
    _, cfg, _, tp, x = _moe(8.0)
    r = rules.make_rules("ep_tp", host_mesh)
    placed = rules.place_params(tp, moe.specs(cfg), r)
    xd = r.place(torch.from_numpy(x), ("batch", None, None))
    y, aux = moe_a2a.apply(placed, cfg, xd, host_mesh)
    y0, aux0 = moe_a2a.apply(tp, cfg, torch.from_numpy(x), host_mesh)
    assert isinstance(y, DTensor) and isinstance(aux, DTensor)
    assert torch.equal(rules.to_global(y), y0) and torch.equal(rules.to_global(aux), aux0)


# ------------------------------------------------------------ four ranks

CASES = [((1, 4), 8.0), ((1, 4), 1.25), ((2, 2), 8.0), ((2, 2), 1.25)]

_REFERENCE = """
import os
import jax, jax.numpy as jnp, numpy as np
import repro.models
from repro.models import moe, moe_a2a, param
from repro.checkpoint.checkpointer import _flatten
out = {}
for (dp, tp), cf in %r:
    cfg = moe.MoEConfig(d_model=32, d_ff=16, n_experts=8, top_k=2, capacity_factor=cf,
                        group_size=32)
    params = param.init_params(moe.specs(cfg), jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (4, 16, 32))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(dp, tp), ("data", "model"))
    y, aux = jax.jit(lambda p, x: moe_a2a.apply(p, cfg, x, mesh))(params, x)
    tag = f"{dp}x{tp}_{cf}"
    out["y_" + tag], out["aux_" + tag] = np.asarray(y), np.asarray(aux)
    out["dense_" + tag] = np.asarray(moe.dense_reference(params, cfg, x))
out["x"] = np.asarray(x)
for k, v in _flatten(jax.tree.map(np.asarray, params)).items():
    out["p/" + k] = v
np.savez(os.path.join(os.environ["OUT"], "reference.npz"), **out)
""" % (CASES,)

_RANK = """
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe, moe_a2a, param
ref = np.load(os.path.join(OUT, "reference.npz"))
params = param.from_jax_params({k[2:]: ref[k] for k in ref.files if k.startswith("p/")}, "cpu")
x = torch.from_numpy(ref["x"])
out = {}
for (dp, tp), cf in %r:
    cfg = moe.MoEConfig(d_model=32, d_ff=16, n_experts=8, top_k=2, capacity_factor=cf,
                        group_size=32)
    mesh = make_host_mesh(model=tp, device="cpu")
    assert tuple(mesh.shape) == (dp, tp), mesh
    y, aux = moe_a2a.apply(params, cfg, x, mesh)
    tag = f"{dp}x{tp}_{cf}"
    out["y_" + tag], out["aux_" + tag] = y.numpy(), aux.numpy()
np.savez(os.path.join(OUT, f"rank{RANK}.npz"), **out)
dist.destroy_process_group()
""" % (CASES,)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_a2a")
    run_reference(_REFERENCE, 4, tmp)
    run_ranks(_RANK, 4, tmp)
    return np.load(tmp / "reference.npz"), [np.load(tmp / f"rank{r}.npz") for r in range(4)]


@pytest.mark.parametrize("mesh,cf", CASES)
def test_four_ranks_match_reference(four_ranks, mesh, cf):
    ref, ranks = four_ranks
    tag = f"{mesh[0]}x{mesh[1]}_{cf}"
    dropped = np.abs(ref["y_" + tag] - ref["dense_" + tag]).max()
    assert (dropped > 1e-3) == (cf == 1.25), dropped  # 1.25 drops tokens, 8.0 none
    for got in ranks:
        np.testing.assert_allclose(got["y_" + tag], ref["y_" + tag], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["aux_" + tag], ref["aux_" + tag], atol=1e-6, rtol=0)


# ------------------------------------------------------------ the LM, a2a

def test_qwen3_a2a_prefill_and_decode_on_one_rank_mesh(host_mesh):
    jcfg = dataclasses.replace(jqw.SMOKE, moe_impl="a2a")
    cfg = dataclasses.replace(qwen3_moe_30b_a3b.SMOKE, moe_impl="a2a")
    jp = jparam.init_params(jlm.specs(jcfg), jax.random.key(0))
    tp = param.from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 28)).astype(np.int32)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jr = jrules.make_rules("ep_tp", jmesh)
    with jrules.use_rules(jr):
        jlogits, jcache = jax.jit(functools.partial(jlm.prefill, cfg=jcfg, max_len=32))(
            jp, tokens=jnp.asarray(toks[:, :24]))
        jouts = [jlogits]
        jstep = jax.jit(jlm.decode_step, static_argnums=1)
        for i in range(4):
            jlogits, jcache = jstep(jp, jcfg, jnp.asarray(toks[:, 24 + i:25 + i]), jcache,
                                    jnp.int32(24 + i))
            jouts.append(jlogits)

    r = rules.make_rules("ep_tp", host_mesh)
    placed = rules.place_params(tp, lm.specs(cfg), r)
    n0 = moe_a2a.collectives
    with rules.use_rules(r):
        logits, cache = lm.prefill(placed, cfg, torch.from_numpy(toks[:, :24]), max_len=32)
        outs = [logits]
        for i in range(4):
            logits, cache = lm.decode_step(placed, cfg, torch.from_numpy(toks[:, 24 + i:25 + i]),
                                           cache, 24 + i)
            outs.append(logits)
    assert isinstance(cache["k"], DTensor)
    assert moe_a2a.collectives - n0 == 5 * cfg.n_layers * 6  # every layer of every call
    for i, (a, b) in enumerate(zip(outs, jouts)):
        np.testing.assert_allclose(rules.to_global(a).numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0, err_msg=f"call {i}")
