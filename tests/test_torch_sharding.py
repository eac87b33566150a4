"""The port's sharding (``repro_torch.sharding``, ``launch.mesh``, the
engine's, fleet's, CLI's and step bundles' mesh paths) against the
reference's, on the CPU.

- ``spec_for`` and ``fallbacks`` equal the reference's ``Rules`` for every
  profile, every param leaf of every registry architecture (full configs,
  shapes only), and the step bundles' cache and logits specs, at the mesh
  shapes (1,1), (2,4), (16,16) and (2,16,16); the reference reads only
  ``mesh.shape``, so both get a mesh given as its shape.
- One process, a (1,1) gloo mesh (``make_host_mesh(device="cpu")``): the
  meshed ``run_cloud_batch`` is bit-equal to the unmeshed one, and within
  1e-6 of the reference's sharded path on a (1,1) mesh with Auto axes
  (``jax.make_mesh`` gives Explicit axes under JAX 0.9, on which the
  reference's ``with_sharding_constraint`` raises); the meshed fleet has
  equal latencies and logits within 1e-5; the CLI prints the mesh; every
  family's serve bundles are bit-equal with and without the mesh.
- Four gloo ranks, mesh (2,2), tp: every rank's logits of a stacked cloud
  batch (batch over "data", heads over "model") within 1e-5 of the
  reference's on four host devices.
"""
import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

import repro.models  # noqa: F401  (import models before sharding: circular import)
from repro import configs as jconfigs
from repro.core import engine as jengine
from repro.core import pruning as jpruning
from repro.core.bucketing import BucketingConfig as JBucketingConfig
from repro.core.bucketing import BucketTable as JBucketTable
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.models import param as jparam
from repro.models import vit as jvit
from repro.sharding import rules as jrules

from repro_torch import configs
from repro_torch.core import bandwidth, engine
from repro_torch.core.bucketing import BucketingConfig, BucketTable
from repro_torch.launch import serve, steps
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import param, vit
from repro_torch.optim import adamw
from repro_torch.serving import fleet
from repro_torch.sharding import rules

import jax
from _ranks import run_ranks, run_reference
from test_torch_serving import _port_profile

# -n 6 workers, each running 8 intra-op threads on 8 cores, oversubscribe the CPU
# (a 2 s case took 150 s among six copies): one thread a worker
torch.set_num_threads(1)

MESHES = ({"data": 1, "model": 1}, {"data": 2, "model": 4}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16})
ALPHAS = (0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)  # tests/test_execute_bucketed.py
SPLIT = 4
VIT50 = dict(img_res=56, patch=8, n_layers=6, d_model=32, n_heads=2, d_ff=64, n_classes=8)


class _MeshShape:
    """What the reference's ``Rules.spec_for`` reads of a mesh."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = (tuple(v.shape), tuple(v.axes))
    return out


def _spec(p) -> tuple:
    return tuple(p)


def test_profiles_are_the_reference_profiles():
    assert rules.PROFILES == jrules.PROFILES
    assert rules.BATCH_AXES == jrules.BATCH_AXES


@pytest.mark.parametrize("arch", list(jconfigs._ARCHS))
def test_spec_for_and_fallbacks_match_reference(arch):
    jarch, tarch = jconfigs.get_arch(arch), configs.get_arch(arch)
    jl = _leaves(jsteps._specs_for(jarch.family, jarch.config))
    tl = _leaves(steps._specs_for(tarch.family, tarch.config))
    assert jl == tl
    for profile in rules.PROFILES:
        for mesh in MESHES:
            jr = jrules.Rules(dict(jrules.PROFILES[profile]), _MeshShape(mesh))
            tr = rules.make_rules(profile, mesh)
            for key, (shape, axes) in tl.items():
                assert tr.spec_for(shape, axes) == _spec(jr.spec_for(shape, axes)), \
                    (arch, profile, mesh, key)
            assert tr.fallbacks == jr.fallbacks, (arch, profile, mesh)


def _reference_out_specs(jr, arch, shape_name):
    """The reference's cache and logits specs of ``build_bundle`` (its
    shapes and logical axes, ``src/repro/launch/steps.py``)."""
    jarch = jconfigs.get_arch(arch)
    shape = jarch.shape(shape_name)
    cfg = jconfigs.config_for_shape(jarch, shape)
    if jarch.family == "lm":
        gb, seq = shape.global_batch, shape.seq_len
        acache = jlm.abstract_cache(cfg, gb, seq, dtype=cfg.cache_dtype)
        axes = jlm.CACHE_AXES if shape.kind == "prefill" else jlm.cache_axes(cfg)
        cache = {k: _spec(jr.spec_for(v.shape, axes)) for k, v in acache.items()}
        return (_spec(jr.spec_for((gb, 1, cfg.vocab), ("batch", None, "act_vocab"))), cache)
    if jarch.family in ("dit", "flux"):
        lres = cfg.latent_res
        return _spec(jr.spec_for((shape.batch, lres, lres, cfg.latent_channels),
                                 ("batch", None, None, None)))
    return _spec(jr.spec_for((shape.batch, 1000), ("batch", "act_vocab")))


@pytest.mark.parametrize("arch", list(jconfigs._ARCHS))
def test_bundle_cache_and_logits_specs_match_reference(arch):
    """The serve bundles' ``out_shardings`` (built on a mesh given as its
    shape) against the reference's specs of the same shapes and axes; every
    full config's classifier has 1000 classes, the reference's constant."""
    tarch = configs.get_arch(arch)
    for mesh in MESHES:
        jr = jrules.Rules(dict(jrules.PROFILES[tarch.serve_profile]), _MeshShape(mesh))
        for shape in tarch.shapes:
            if shape.kind == "train" or shape.skip_reason:
                continue
            b = steps.build_bundle(arch, shape.name, mesh)
            assert b.out_shardings == _reference_out_specs(jr, arch, shape.name), \
                (arch, shape.name, mesh)


def test_granite_vocab_is_a_known_fallback():
    r = rules.make_rules("ep_tp", {"data": 16, "model": 16})
    spec = r.spec_for((49155, 1536), ("vocab", "embed"))
    assert spec == (None, None)
    assert r.fallbacks == [("vocab", ("model",), "49155 % 16 != 0")]


def test_make_rules_raises_and_constrain_is_identity_without_rules():
    with pytest.raises(KeyError, match="unknown sharding profile"):
        rules.make_rules("nope", {"data": 1, "model": 1})
    x = torch.ones(2, 3)
    assert rules.current_rules() is None
    assert rules.constrain(x, ("batch", None)) is x


def test_production_mesh_needs_its_world():
    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh(device="cpu")


# ----------------------------------------------------------- one rank, (1,1)

@pytest.fixture
def host_mesh():
    mesh = make_host_mesh(device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _vit50():
    jcfg, cfg = jvit.ViTConfig(**VIT50), vit.ViTConfig(**VIT50)
    jp = jparam.init_params(jvit.specs(jcfg), jax.random.key(0))
    return jcfg, cfg, jp, param.from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


@functools.lru_cache(maxsize=None)
def _jplans(alphas):
    """The reference's device partitions of seeded images (jitted; its
    eager ToMe merges dispatch op by op)."""
    jcfg, _, jp, _ = _vit50()
    plans = []
    device_forward = jax.jit(jengine.device_forward, static_argnums=(1, 3, 4))
    for i, a in enumerate(alphas):
        img = np.random.default_rng(100 + i).normal(size=(1, 56, 56, 3)).astype(np.float32)
        sched = tuple(jpruning.make_schedule("exponential", a, jcfg.n_layers, jcfg.num_tokens))
        x, sizes = device_forward(jp, jcfg, img, sched, SPLIT)
        plans.append(jengine.ExecPlan(sched, SPLIT, x=x, sizes=sizes))
    return plans


def _port_plans(jplans):
    return [engine.ExecPlan(p.schedule, p.split, x=torch.from_numpy(np.array(p.x)),
                            sizes=torch.from_numpy(np.array(p.sizes))) for p in jplans]


@pytest.mark.parametrize("profile", ["dp", "tp"])
@pytest.mark.parametrize("bucketed", [False, True])
def test_run_cloud_batch_on_one_rank_mesh(host_mesh, profile, bucketed):
    jcfg, cfg, jp, tp = _vit50()
    jplans = _jplans((0.3, 0.7))
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jr = jrules.make_rules(profile, jmesh)
    jtable = JBucketTable.build(jcfg, ALPHAS, config=JBucketingConfig(n_edges=2)) \
        if bucketed else None
    jengine.run_cloud_batch(jengine.CompiledPlanCache(rules=jr), jcfg,
                            jengine.shard_params(jp, jcfg, jr), jplans, buckets=jtable)

    table = BucketTable.build(cfg, ALPHAS, config=BucketingConfig(n_edges=2)) \
        if bucketed else None
    r = rules.make_rules(profile, host_mesh)
    placed = engine.shard_params(tp, cfg, r)
    assert isinstance(placed["blocks"]["attn"]["wq"], DTensor)
    assert placed["blocks"]["attn"]["wq"].to_local().data_ptr() == \
        tp["blocks"]["attn"]["wq"].data_ptr()  # placed as a view
    meshed, plain = _port_plans(jplans), _port_plans(jplans)
    cache = engine.CompiledPlanCache(rules=r)
    engine.run_cloud_batch(cache, cfg, placed, meshed, buckets=table)
    engine.run_cloud_batch(engine.CompiledPlanCache(), cfg, tp, plain, buckets=table)
    assert cache.traces == (1 if bucketed else 2)
    for m, p, j in zip(meshed, plain, jplans):
        assert type(m.logits) is torch.Tensor
        assert torch.equal(m.logits, p.logits)
        np.testing.assert_allclose(m.logits.numpy(), np.asarray(j.logits), atol=1e-6, rtol=0)


def test_nested_rules_keep_implicit_replication(host_mesh):
    """A plain tensor meets a DTensor inside ``use_rules`` after a nested
    ``use_rules`` scope has closed (a bundle step inside a caller's rules)."""
    r = rules.make_rules("tp", host_mesh)
    w = r.place(torch.ones(4, 6), ("embed", "mlp"))
    with rules.use_rules(r):
        with rules.use_rules(r):
            inner = torch.ones(2, 4) @ w
        outer = torch.ones(2, 4) @ w
    assert torch.equal(rules.to_global(outer), rules.to_global(inner))
    assert torch.equal(rules.to_global(outer), torch.full((2, 6), 4.0))


def test_device_partition_on_one_rank_mesh(host_mesh):
    _, cfg, _, tp = _vit50()
    r = rules.make_rules("tp", host_mesh)
    img = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 56, 56, 3)).astype(np.float32))
    sched = (0, 3, 3, 3, 3, 3)
    x1, s1 = engine.CompiledPlanCache(rules=r).device_fn(cfg, sched, SPLIT, img)(
        engine.shard_params(tp, cfg, r), img)
    x0, s0 = engine.device_forward(tp, cfg, img, sched, SPLIT)
    assert type(x1) is torch.Tensor and torch.equal(x1, x0) and torch.equal(s1, s0)


@pytest.mark.parametrize("profile", ["dp", "tp"])
def test_fleet_mesh_rules_on_one_rank_mesh(host_mesh, profile):
    """As ``tests/test_execute_bucketed.py``'s fleet parity: a fleet with
    ``mesh_rules`` against one without."""
    _, cfg, _, tp = _vit50()
    images = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 56, 56, 3))
                              .astype(np.float32))
    eng_cfg = engine.EngineConfig(sla_s=0.5, execute=True, include_scheduler_overhead=False)
    trace = bandwidth.NetworkTrace(np.full(3, 80e6), 0.002, "s0")

    def run(mesh_rules):
        rt = fleet.FleetRuntime(_port_profile(), eng_cfg, [fleet.StreamSpec(trace, 3)],
                                cloud=fleet.CloudTierConfig(max_batch=1), model_cfg=cfg,
                                params=tp, mesh_rules=mesh_rules, device="cpu")
        return rt.run(images=images), rt

    fs_plain, _ = run(None)
    fs_mesh, rt = run(rules.make_rules(profile, host_mesh))
    assert rt.plan_cache.rules is rt.mesh_rules
    assert isinstance(rt.params["head"]["w"], DTensor)
    assert len(fs_plain.all_frames) == len(fs_mesh.all_frames) == 3
    for f0, f1 in zip(fs_plain.all_frames, fs_mesh.all_frames):
        assert f0.latency_s == f1.latency_s
        np.testing.assert_allclose(f0.logits.numpy(), f1.logits.numpy(), atol=1e-5, rtol=1e-5)


def test_cli_mesh_prints_the_mesh(capsys):
    try:
        serve.main(["--streams", "2", "--frames", "3", "--execute", "--mesh", "dp",
                    "--device", "cpu"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("[fleet execute]"))
    assert line.endswith(" mesh=(('data', 1), ('model', 1))"), line


# the serve bundles' inputs: floats N(0, 0.25) folded positive (BatchNorm
# variances), ids in [0, 8) (every smoke vocab and class count is larger)
def _materialize(x, gen):
    if isinstance(x, dict):
        return {k: _materialize(v, gen) for k, v in x.items()}
    if isinstance(x, list):
        return [_materialize(v, gen) for v in x]
    if not isinstance(x, torch.Tensor):
        return x
    if x.dtype.is_floating_point:
        return (0.5 * torch.randn(x.shape, generator=gen)).abs().to(x.dtype)
    return torch.randint(0, 8, x.shape, generator=gen).to(x.dtype)


def _global(x):
    if isinstance(x, dict):
        return {k: _global(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_global(v) for v in x)
    assert isinstance(x, DTensor), type(x)
    return rules.to_global(x)


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def _train_args(b, seed):
    """Fresh (params, opt, batch) of a train bundle (the step updates params
    and moments in place)."""
    params = _materialize(b.abstract_inputs[0], torch.Generator().manual_seed(seed))
    return [params, adamw.init_state(params),
            _materialize(b.abstract_inputs[2], torch.Generator().manual_seed(seed + 1))]


@pytest.mark.parametrize("arch", list(configs._ARCHS))
def test_serve_bundles_on_one_rank_mesh_equal_unmeshed(host_mesh, arch):
    """Every bundle on a (1,1) mesh, bit for bit: the serving steps and the
    train steps (the train profile's placements, the updated params and
    moments and the metrics)."""
    for shape in configs.get_arch(arch).shapes:
        b0 = steps.build_bundle(arch, shape.name, smoke=True)
        b1 = steps.build_bundle(arch, shape.name, host_mesh, smoke=True)
        if shape.kind == "train":
            out0 = b0.step_fn(*_train_args(b0, 0))
            out1 = b1.step_fn(*steps.place_inputs(b1, *_train_args(b0, 0)))
            assert _equal(out0, _global(out1)), (arch, shape.name)
            continue
        params = _materialize(b0.abstract_inputs[0], torch.Generator().manual_seed(0))

        def rest():
            return [_materialize(a, torch.Generator().manual_seed(1))
                    for a in b0.abstract_inputs[1:]]

        out0 = b0.step_fn(params, *rest())
        out1 = b1.step_fn(*steps.place_inputs(b1, params, *rest()))
        assert _equal(out0, _global(out1)), (arch, shape.name)


# ------------------------------------------------------------ four ranks, tp

_REFERENCE_TP = """
import os
import jax, numpy as np
import repro.models
from repro.core import engine, pruning
from repro.core.bucketing import BucketingConfig, BucketTable
from repro.models import param, vit
from repro.sharding.rules import make_rules
from repro.checkpoint.checkpointer import _flatten
cfg = vit.ViTConfig(img_res=56, patch=8, n_layers=6, d_model=32, n_heads=2, d_ff=64, n_classes=8)
params = param.init_params(vit.specs(cfg), jax.random.key(0))
plans = []
device_forward = jax.jit(engine.device_forward, static_argnums=(1, 3, 4))
for i, a in enumerate((0.3, 0.7)):
    img = np.random.default_rng(100 + i).normal(size=(1, 56, 56, 3)).astype(np.float32)
    sched = tuple(pruning.make_schedule("exponential", a, cfg.n_layers, cfg.num_tokens))
    x, sizes = device_forward(params, cfg, img, sched, 4)
    plans.append(engine.ExecPlan(sched, 4, x=x, sizes=sizes))
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
r = make_rules("tp", mesh)
table = BucketTable.build(cfg, (0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9),
                          config=BucketingConfig(n_edges=2))
engine.run_cloud_batch(engine.CompiledPlanCache(rules=r), cfg,
                       engine.shard_params(params, cfg, r), plans, buckets=table)
out = {"p/" + k: np.asarray(v) for k, v in _flatten(jax.tree.map(np.asarray, params)).items()}
for i, p in enumerate(plans):
    out[f"x{i}"], out[f"s{i}"] = np.asarray(p.x), np.asarray(p.sizes)
    out[f"logits{i}"] = np.asarray(p.logits)
    out[f"sched{i}"] = np.asarray(p.schedule)
np.savez(os.path.join(os.environ["OUT"], "reference.npz"), **out)
"""

_RANK_TP = """
from repro_torch.core import engine
from repro_torch.core.bucketing import BucketingConfig, BucketTable
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import param, vit
from repro_torch.optim import adamw
from repro_torch.sharding.rules import make_rules
ref = np.load(os.path.join(OUT, "reference.npz"))
cfg = vit.ViTConfig(img_res=56, patch=8, n_layers=6, d_model=32, n_heads=2, d_ff=64, n_classes=8)
params = param.from_jax_params({k[2:]: ref[k] for k in ref.files if k.startswith("p/")}, "cpu")
plans = [engine.ExecPlan(tuple(int(r) for r in ref[f"sched{i}"]), 4,
                         x=torch.from_numpy(ref[f"x{i}"]), sizes=torch.from_numpy(ref[f"s{i}"]))
         for i in range(2)]
mesh = make_host_mesh(model=2, device="cpu")
assert tuple(mesh.shape) == (2, 2), mesh
r = make_rules("tp", mesh)
table = BucketTable.build(cfg, (0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9),
                          config=BucketingConfig(n_edges=2))
placed = engine.shard_params(params, cfg, r)
wq = placed["blocks"]["attn"]["wq"]
assert tuple(wq.to_local().shape) == (6, 32, 16), wq.to_local().shape  # heads split over "model"
engine.run_cloud_batch(engine.CompiledPlanCache(rules=r), cfg, placed, plans, buckets=table)
np.savez(os.path.join(OUT, f"rank{RANK}.npz"), *[p.logits.numpy() for p in plans])

# the local boundary refuses what the kernels do not treat independently
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.kernels import ops
def refused(fn, match):
    try:
        fn()
    except ValueError as e:
        assert match in str(e), e
        return
    raise AssertionError("not refused: " + match)
q = DTensor.from_local(torch.randn(2, 2, 4, 16), mesh, [Replicate(), Shard(2)], run_check=False)
refused(lambda: ops.flash_attention(q, q, q), "does not treat independently")
qd = DTensor.from_local(torch.randn(2, 2, 16), mesh, [Replicate(), Shard(1)], run_check=False)
kv = DTensor.from_local(torch.randn(2, 8, 1, 16), mesh, [Replicate(), Replicate()], run_check=False)
refused(lambda: ops.decode_attention(qd, kv, kv, 8), "does not divide")  # GQA: 1 kv head, 2 ranks
dist.destroy_process_group()
"""


def test_four_ranks_tp_cloud_batch_matches_reference(tmp_path):
    run_reference(_REFERENCE_TP, 4, tmp_path)
    run_ranks(_RANK_TP, 4, tmp_path)
    ref = np.load(tmp_path / "reference.npz")
    for rank in range(4):
        got = np.load(tmp_path / f"rank{rank}.npz")
        for i in range(2):
            np.testing.assert_allclose(got[f"arr_{i}"], ref[f"logits{i}"], atol=1e-5, rtol=0)
