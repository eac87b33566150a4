"""The port's MoE layer (``repro_torch.models.moe``) against the reference's.

Same weights (the reference's ``init_params``, through ``from_jax_params``)
and the same numpy inputs go through both packages on the CPU, in f32.
Tolerances: layer outputs atol 1e-5 (the two frameworks sum in other
orders); the aux loss rtol 1e-6 (its means may round one ulp apart);
routes, positions and capacities exactly. Each routing trap of the port has
a test: top-k ties, the reference's capacity and grouping, the sentinel
scatter of dropped slots, padded experts.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import models before sharding: circular import)
from repro.configs import granite_moe_3b_a800m as jgr
from repro.configs import qwen3_moe_30b_a3b as jqw
from repro.models import moe as jmoe
from repro.models import param as jparam

from repro_torch.configs import granite_moe_3b_a800m, qwen3_moe_30b_a3b
from repro_torch.models import moe, param

# -n 6 workers, each running 8 intra-op threads on 8 cores, oversubscribe the CPU
# (a 2 s case took 150 s among six copies): one thread a worker
torch.set_num_threads(1)

ATOL = 1e-5
AUX_RTOL = 1e-6
MOES = {"qwen3-moe-30b-a3b": (jqw, qwen3_moe_30b_a3b),
        "granite-moe-3b-a800m": (jgr, granite_moe_3b_a800m)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_cfg(jc: jmoe.MoEConfig, **kw) -> moe.MoEConfig:
    """The port's MoEConfig with the reference config's numbers."""
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    fields["router_dtype"] = getattr(torch, str(jnp.dtype(jc.router_dtype)))
    return moe.MoEConfig(**{**fields, **kw})


@functools.lru_cache(maxsize=None)
def _params(name, seed=0):
    jc = MOES[name][0].SMOKE.moe
    jp = jparam.init_params(jmoe.specs(jc), jax.random.key(seed))
    return jp, param.from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


@functools.lru_cache(maxsize=None)
def _japply(jc):
    return jax.jit(functools.partial(jmoe.apply, cfg=jc))


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ----------------------------------------------------------------- configs

@pytest.mark.parametrize("name", sorted(MOES))
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_moe_configs_copy_the_reference_numbers(name, which):
    jc, tc = getattr(MOES[name][0], which).moe, getattr(MOES[name][1], which).moe
    for f in dataclasses.fields(jc):
        jv, tv = getattr(jc, f.name), getattr(tc, f.name)
        if f.name == "router_dtype":
            assert str(jnp.dtype(jv)) == str(tv).removeprefix("torch.")
        else:
            assert jv == tv, f.name
    assert tc == _port_cfg(jc)
    assert (jc.e_pad, jc.capacity()) == (tc.e_pad, tc.capacity())


@pytest.mark.parametrize("name,sg,expected", [
    ("qwen3-moe-30b-a3b", 8, 1),      # decode at B=8: ceil(8*8*1.25/128), drops
    ("qwen3-moe-30b-a3b", 512, 40),   # a prefill group
    ("granite-moe-3b-a800m", 8, 2),   # divides by the 40 real experts, not 48
    ("granite-moe-3b-a800m", 512, 128),
])
def test_capacity_is_the_references(name, sg, expected):
    jc, tc = MOES[name][0].CONFIG.moe, MOES[name][1].CONFIG.moe
    assert tc.capacity(sg) == jc.capacity(sg) == expected


def test_specs_match_reference_with_padded_experts():
    for name, (jmod, tmod) in MOES.items():
        for which in ("SMOKE", "CONFIG"):
            jc, tc = getattr(jmod, which).moe, getattr(tmod, which).moe
            jspec, tspec = jmoe.specs(jc), moe.specs(tc)
            assert jspec.keys() == tspec.keys()
            for k in jspec:
                assert (jspec[k].shape, jspec[k].axes, jspec[k].init, jspec[k].scale) == (
                    tspec[k].shape, tspec[k].axes, tspec[k].init, tspec[k].scale), (name, k)
            assert tspec["router"].shape[-1] == tc.n_experts
            assert tspec["w_gate"].shape[0] == tc.e_pad


# ------------------------------------------------------------------ routing

def test_stable_top_k_keeps_the_lower_index_on_ties():
    """The trap itself: torch.topk orders exact ties otherwise than
    jax.lax.top_k; ``route`` takes the first k of a stable descending sort."""
    probs = np.asarray([.1, .5, .5, .2, .5, .5, .3, .5], np.float32)
    _, jidx = jax.lax.top_k(jnp.asarray(probs), 3)
    assert np.asarray(jidx).tolist() == [1, 2, 4]
    cfg = moe.MoEConfig(d_model=4, d_ff=4, n_experts=8, top_k=3)
    # log-probs as logits: the softmax gives back ties exactly where probs tie
    gates, experts = moe.route(cfg, torch.log(_t(probs)))
    assert experts.tolist() == [1, 2, 4]
    assert torch.allclose(gates.sum(-1), torch.tensor(1.0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k", [2, 3, 8])
def test_route_matches_reference_on_exact_ties(dtype, top_k):
    """Router logits on a coarse grid (many exact ties, also at the top-k
    boundary), in f32 and bf16: experts equal to ``jax.lax.top_k``'s, gates
    within f32 rounding."""
    rng = np.random.default_rng(top_k)
    logits = rng.integers(-3, 4, size=(3, 17, 12)).astype(np.float32) * 0.25
    jc = jmoe.MoEConfig(d_model=4, d_ff=4, n_experts=12, top_k=top_k)
    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    jgates, jexperts = jmoe.route(jc, jl)
    gates, experts = moe.route(_port_cfg(jc), _t(logits).to(getattr(torch, dtype)))
    probs = np.asarray(jax.nn.softmax(jl.astype(jnp.float32), axis=-1))
    ties = sum(int(np.sum(row == row[np.argsort(-row, kind="stable")[top_k - 1]])) > 1
               for row in probs.reshape(-1, 12))
    assert ties > 10  # the grid really ties at the boundary
    assert np.array_equal(experts.numpy(), np.asarray(jexperts))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), rtol=1e-6)


@pytest.mark.parametrize("m,n_experts,seed", [(16, 8, 0), (40, 5, 1), (257, 48, 2)])
def test_positions_in_expert_match_reference(m, n_experts, seed):
    ids = np.random.default_rng(seed).integers(0, n_experts, size=m).astype(np.int32)
    exp = np.asarray(jmoe._positions_in_expert(jnp.asarray(ids), n_experts))
    got = moe._positions_in_expert(_t(ids).long(), n_experts)
    assert np.array_equal(got.numpy(), exp)
    # batched over groups: each row as its own call
    rows = np.stack([ids, ids[::-1].copy()])
    got2 = moe._positions_in_expert(_t(rows).long(), n_experts)
    assert np.array_equal(got2[1].numpy(),
                          np.asarray(jmoe._positions_in_expert(jnp.asarray(rows[1]), n_experts)))
    assert np.array_equal(got2[0].numpy(), exp)


# -------------------------------------------------------------------- apply

def _dropped_slots(jc, jp, x):
    """Slots the reference drops at capacity for input x (its own routing)."""
    b, s, d = x.shape
    t = b * s
    sg = jc.group_size if t % jc.group_size == 0 else t
    logits = jnp.einsum("gsd,de->gse", jnp.asarray(x).reshape(t // sg, sg, d), jp["router"])
    _, experts = jmoe.route(jc, logits)
    pos = jax.vmap(lambda e: jmoe._positions_in_expert(e, jc.e_pad))(
        experts.reshape(t // sg, sg * jc.top_k).astype(jnp.int32))
    return int(jnp.sum(pos >= jc.capacity(sg)))


# (shape, must the reference drop slots at capacity?)
SHAPES = [((2, 32, 64), None),   # 64 tokens: two groups of 32
          ((3, 7, 64), None),    # 21 tokens, not a multiple of 32: one group of all
          ((1, 2, 64), None),    # a decode step of 2: one group of 2
          ((4, 64, 64), True)]   # eight groups, and slots dropped at capacity


@pytest.mark.parametrize("name", sorted(MOES))
@pytest.mark.parametrize("shape,drops", SHAPES)
def test_apply_matches_reference(name, shape, drops):
    jc = MOES[name][0].SMOKE.moe
    tc = MOES[name][1].SMOKE.moe
    jp, tp = _params(name)
    x = _x(shape, seed=sum(shape))
    jy, jaux = _japply(jc)(jp, x=jnp.asarray(x))
    y, aux = moe.apply(tp, tc, _t(x))
    assert y.shape == shape and aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=AUX_RTOL)
    if drops:
        assert _dropped_slots(jc, jp, x) > 0


@pytest.mark.parametrize("name", sorted(MOES))
def test_apply_all_tokens_to_one_expert_drops_past_capacity(name):
    """A router that sends every token's first choice to expert 1: all but
    ``capacity`` of those slots are dropped, and every dropped slot writes
    the sentinel cell of ``slot_of_cell`` (the one duplicate-write target,
    discarded). Output and aux loss still equal the reference's."""
    jc, tc = MOES[name][0].SMOKE.moe, MOES[name][1].SMOKE.moe
    jp, _ = _params(name, seed=1)
    router = np.asarray(jp["router"]).copy()
    router[:, 1] += 10.0
    jp = {**jp, "router": jnp.asarray(router)}
    tp = param.from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    x = np.abs(_x((2, 32, 64), seed=5)) + 0.5  # positive: x @ router[:, 1] is large
    assert _dropped_slots(jc, jp, x) >= 2 * (32 - jc.capacity(32))
    jy, jaux = _japply(jc)(jp, x=jnp.asarray(x))
    y, aux = moe.apply(tp, tc, _t(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=AUX_RTOL)


def test_padded_experts_get_no_cells_and_no_weight():
    """granite: the router spans the 5 real experts of 8; a padded expert's
    weights never reach the output."""
    jc, tc = jgr.SMOKE.moe, granite_moe_3b_a800m.SMOKE.moe
    _, tp = _params("granite-moe-3b-a800m")
    x = _t(_x((2, 32, 64), seed=9))
    y, aux = moe.apply(tp, tc, x)
    poisoned = {**tp}
    for k in ("w_gate", "w_up", "w_down"):
        w = tp[k].clone()
        w[tc.n_experts:] = 1e6
        poisoned[k] = w
    y2, aux2 = moe.apply(poisoned, tc, x)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    _, experts = moe.route(tc, x @ tp["router"])
    assert int(experts.max()) < tc.n_experts < tc.e_pad == jc.e_pad


@pytest.mark.parametrize("name", sorted(MOES))
def test_dense_reference_matches_reference(name):
    jc, tc = MOES[name][0].SMOKE.moe, MOES[name][1].SMOKE.moe
    jp, tp = _params(name)
    x = _x((2, 9, 64), seed=7)
    exp = jmoe.dense_reference(jp, jc, jnp.asarray(x))
    np.testing.assert_allclose(moe.dense_reference(tp, tc, _t(x)).numpy(), np.asarray(exp),
                               atol=ATOL)


@pytest.mark.parametrize("name", sorted(MOES))
def test_apply_without_drops_is_the_dense_reference(name):
    """With room for every slot (capacity factor = n_experts / top_k), the
    capacity path computes the dense reference."""
    tc = MOES[name][1].SMOKE.moe
    tc = dataclasses.replace(tc, capacity_factor=tc.n_experts / tc.top_k)
    _, tp = _params(name)
    x = _t(_x((2, 32, 64), seed=11))
    y, _ = moe.apply(tp, tc, x)
    torch.testing.assert_close(y, moe.dense_reference(tp, tc, x), atol=ATOL, rtol=0)
