"""The port's execution engine against the reference engine.

Same profile, weights, images and network trace through both packages on
the CPU, in f32, at the 50-token geometry of ``tests/test_execute_bucketed.py``.
Tolerances: identical (α, split) per frame; logits atol 1e-5; payload bytes
within 1% (an ulp in the device activation can flip one int8 code and so
change the LZW length); padded vs exact cloud batch atol 2e-6 (``PAD_ATOL``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import models before sharding: circular import)
from repro.core import bandwidth as jbandwidth
from repro.core import compression as jcompression
from repro.core import engine as jengine
from repro.models import param as jparam
from repro.models import vit as jvit

from repro_torch.core import bandwidth, engine, profiler, pruning, scheduler
from repro_torch.core.bucketing import BucketingConfig, BucketTable
from repro_torch.models import param, vit

# -n 6 workers, each running 8 intra-op threads on 8 cores, oversubscribe the CPU
# (a 2 s case took 150 s among six copies): one thread a worker
torch.set_num_threads(1)

ALPHAS = (0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
SPLIT = 4
PAD_ATOL = 2e-6
KW = dict(img_res=56, patch=8, n_layers=6, d_model=32, n_heads=2, d_ff=64, n_classes=8)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, cfg = jvit.ViTConfig(**KW), vit.ViTConfig(**KW)
    jp = jparam.init_params(jvit.specs(jcfg), jax.random.key(0))
    return jcfg, cfg, jp, param.from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


def _port_profile(p):
    return scheduler.ModelProfile(
        n_layers=p.n_layers, x0=p.x0, token_bytes=p.token_bytes,
        raw_input_bytes=p.raw_input_bytes,
        device=profiler.latency_model_from_json(p.device.to_json()),
        cloud=profiler.latency_model_from_json(p.cloud.to_json()),
        device_embed_s=p.device_embed_s, cloud_embed_s=p.cloud_embed_s,
        head_s=p.head_s, schedule_kind=p.schedule_kind)


def _images(cfg, seed=0):
    rng = np.random.default_rng(100 + seed)
    return rng.normal(size=(1, cfg.img_res, cfg.img_res, 3)).astype(np.float32)


def _jax_split_inference(jp, jcfg, images, sched, split, quantize):
    """``repro.core.engine.split_inference`` with its partitions jitted (the
    reference runs them op by op, which takes tens of seconds on the CPU)."""
    n = jcfg.n_layers
    s = n if split == n + 1 else split
    x, sizes = jax.jit(lambda p, i: jengine.device_forward(p, jcfg, i, sched, s))(jp, images)
    payload = None
    if split not in (0, n + 1):
        payload = jcompression.activation_payload(x, quantize=quantize)
        x = jnp.asarray(jcompression.decode_activation(payload), dtype=jcfg.dtype)
    cloud = jax.jit(lambda p, x, z: jengine.cloud_forward(p, jcfg, x, z, sched, s))
    return cloud(jp, x, sizes), payload


@pytest.mark.parametrize("split,quantize", [(2, False), (4, True), (0, True), (7, True)])
def test_split_inference_matches_reference(split, quantize):
    jcfg, cfg, jp, tp = _setup()
    img = _images(cfg, 3)
    sched = tuple(pruning.make_schedule("exponential", 0.6, cfg.n_layers, cfg.num_tokens))
    jlogits, jpay = _jax_split_inference(jp, jcfg, jnp.asarray(img), sched, split, quantize)
    logits, pay = engine.split_inference(tp, cfg, torch.from_numpy(img), sched, split,
                                         quantize=quantize)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5)
    assert (pay is None) == (jpay is None)
    if pay is not None:
        assert abs(pay.nbytes - jpay.nbytes) <= 0.01 * jpay.nbytes


def _mixed_profile():
    """A 6-layer profile (the executed geometry) with a slow device and a fast
    cloud, under which Algorithm 1 picks inner splits with merges, device-only
    frames and unpruned frames along the trace below."""
    from repro.core.profiler import LinearProfiler
    from repro.core.scheduler import ModelProfile
    return ModelProfile(n_layers=6, x0=50, token_bytes=32.0, raw_input_bytes=20000.0,
                        device=LinearProfiler(1e-4, 1e-3), cloud=LinearProfiler(2e-6, 1e-4),
                        device_embed_s=1e-3, cloud_embed_s=1e-4, head_s=1e-4)


def test_run_trace_execute_matches_reference():
    jcfg, cfg, jp, tp = _setup()
    img = _images(cfg)
    ref_prof = _mixed_profile()
    bps = np.array([3e5, 1e6, 3e6, 1e7, 2e5, 5e5])
    frames = len(bps)
    jtrace = jbandwidth.NetworkTrace(bps, 0.005)
    trace = bandwidth.NetworkTrace(bps, 0.005)
    jeng = jengine.JanusEngine(ref_prof, jengine.EngineConfig(
        sla_s=0.03, execute=True, include_scheduler_overhead=False),
        model_cfg=jcfg, params=jp)
    eng = engine.JanusEngine(_port_profile(ref_prof), engine.EngineConfig(
        sla_s=0.03, execute=True, include_scheduler_overhead=False),
        model_cfg=cfg, params=tp, device="cpu")
    jst = jeng.run_trace(jtrace, frames, images=jnp.asarray(img))
    st = eng.run_trace(trace, frames, images=torch.from_numpy(img))
    decisions = {(f.alpha, f.split) for f in st.frames}
    assert {s for _, s in decisions} == {1, 7} and max(a for a, _ in decisions) > 0, \
        f"trace should mix inner splits, device-only frames and merges: {decisions}"
    for f, jf in zip(st.frames, jst.frames):
        assert (f.alpha, f.split) == (jf.alpha, jf.split)
        assert f.accuracy == jf.accuracy and f.bandwidth_bps == jf.bandwidth_bps
        assert abs(f.payload_bytes - jf.payload_bytes) <= 0.01 * jf.payload_bytes
        assert f.latency_s == pytest.approx(jf.latency_s, rel=1e-2)
        np.testing.assert_allclose(f.logits.numpy(), np.asarray(jf.logits), atol=1e-5)
    # a repeated geometry reuses its partition callable
    traces = eng.plan_cache.traces
    eng.run_trace(trace, frames, images=torch.from_numpy(img))
    assert eng.plan_cache.traces == traces and eng.plan_cache.hits > 0


def _plan(cfg, tp, alpha, seed):
    sched = tuple(pruning.make_schedule("exponential", alpha, cfg.n_layers, cfg.num_tokens))
    x, sizes = engine.device_forward(tp, cfg, torch.from_numpy(_images(cfg, seed)),
                                     sched, SPLIT)
    return engine.ExecPlan(sched, SPLIT, x=x, sizes=sizes)


def test_run_cloud_batch_bucketed_parity_mixed_alpha():
    """Mixed α at a shared split: bucketed stacking reproduces each plan's
    own cloud forward, with retraces bounded by the split's edge count, and
    the exact path needs one program per distinct token count."""
    _, cfg, _, tp = _setup()
    plans = [_plan(cfg, tp, a, i) for i, a in enumerate(ALPHAS)]
    refs = [engine.cloud_forward(tp, cfg, p.x, p.sizes, p.schedule, SPLIT) for p in plans]
    assert {p.schedule[SPLIT:] for p in plans} == {(1, 1)}, "geometry precondition drifted"
    counts = {p.x.shape[1] for p in plans}
    assert len(counts) == len(ALPHAS), "geometry precondition drifted"

    table = BucketTable.build(cfg, ALPHAS, config=BucketingConfig(n_edges=2))
    cache = engine.CompiledPlanCache()
    engine.run_cloud_batch(cache, cfg, tp, plans, buckets=table)
    for plan, ref in zip(plans, refs):
        np.testing.assert_allclose(plan.logits.numpy(), ref.numpy(),
                                   atol=PAD_ATOL, rtol=PAD_ATOL)
    n_padded = cache.traces_by_kind.get("cloud_padded", 0)
    assert n_padded <= len(table.edges_by_split[SPLIT])
    assert n_padded < len(counts)

    plans2 = [_plan(cfg, tp, a, i) for i, a in enumerate(ALPHAS)]
    cache2 = engine.CompiledPlanCache()
    engine.run_cloud_batch(cache2, cfg, tp, plans2)
    assert cache2.traces_by_kind.get("cloud", 0) == len(counts)
    for plan, ref in zip(plans2, refs):
        np.testing.assert_allclose(plan.logits.numpy(), ref.numpy(),
                                   atol=PAD_ATOL, rtol=PAD_ATOL)


def test_run_cloud_batch_stacks_same_geometry_and_matches_reference():
    """Join-vs-stack: plans of one geometry run as one stacked forward whose
    rows equal the reference's per-plan cloud forward."""
    jcfg, cfg, jp, tp = _setup()
    plans = [_plan(cfg, tp, 0.5, i) for i in range(3)]
    cache = engine.CompiledPlanCache()
    engine.run_cloud_batch(cache, cfg, tp, plans)
    assert cache.traces_by_kind == {"cloud": 1}
    sched = plans[0].schedule
    jfn = jax.jit(lambda p, x, s: jengine.cloud_forward(p, jcfg, x, s, sched, SPLIT))
    for plan in plans:
        ref = jfn(jp, jnp.asarray(plan.x.numpy()), jnp.asarray(plan.sizes.numpy()))
        np.testing.assert_allclose(plan.logits.numpy(), np.asarray(ref), atol=1e-5)
