"""The port's host control plane against the reference, bit for bit.

``repro_torch.core.{pruning, splitter, profiler, scheduler, planner,
bucketing, bandwidth, compression}`` are numpy copies of ``repro.core``;
they must return identical Decisions over the reference planner tests'
grids, identical BucketTable JSON, and identical LZW codes and payload
bytes. Tolerance: none (exact equality), except ``predicted_latency_s``,
which is compared exactly too since both run the same float64 pipeline.
"""
import numpy as np
import pytest
import torch
from conftest import small_model_profile

import repro.models  # noqa: F401  (import models before sharding: circular import)
import jax.numpy as jnp
from repro.core import bucketing as ref_bucketing
from repro.core import compression as ref_compression
from repro.core import planner as ref_planner
from repro.core import scheduler as ref_scheduler
from repro.core.profiler import LinearProfiler as RefLinear

from repro_torch.core import bandwidth, bucketing, compression, planner, \
    profiler, scheduler


def _port_profile(p) -> scheduler.ModelProfile:
    """The same ModelProfile value, built from the port's classes."""
    return scheduler.ModelProfile(
        n_layers=p.n_layers, x0=p.x0, token_bytes=p.token_bytes,
        raw_input_bytes=p.raw_input_bytes,
        device=profiler.latency_model_from_json(p.device.to_json()),
        cloud=profiler.latency_model_from_json(p.cloud.to_json()),
        device_embed_s=p.device_embed_s, cloud_embed_s=p.cloud_embed_s,
        head_s=p.head_s, schedule_kind=p.schedule_kind)


def _random_profile(pseed: int):
    """tests/test_planner.py::_random_profile (reference classes)."""
    rng = np.random.default_rng(pseed)
    n = int(rng.integers(2, 33))
    x0 = int(rng.integers(40, 700))
    dev_a = 10 ** rng.uniform(-7, -4)
    dev_b = 10 ** rng.uniform(-5, -3)
    scale = rng.uniform(0.02, 0.9)
    return ref_scheduler.ModelProfile(
        n_layers=n, x0=x0,
        token_bytes=float(rng.integers(64, 2048)),
        raw_input_bytes=float(rng.integers(10_000, 500_000)),
        device=RefLinear(dev_a, dev_b),
        cloud=RefLinear(dev_a * scale, dev_b * scale),
        device_embed_s=10 ** rng.uniform(-5, -3),
        cloud_embed_s=10 ** rng.uniform(-6, -4),
        head_s=10 ** rng.uniform(-6, -4),
        schedule_kind=["exponential", "linear"][int(rng.integers(2))])


def _same(dec, ref):
    assert (dec.alpha, dec.split, dec.meets_sla, tuple(dec.schedule)) == \
        (ref.alpha, ref.split, ref.meets_sla, tuple(ref.schedule))
    assert dec.predicted_latency_s == ref.predicted_latency_s


@pytest.mark.parametrize("pseed", range(8))
def test_tables_decisions_match_reference_on_random_profiles(pseed):
    ref_p = _random_profile(pseed)
    port_p = _port_profile(ref_p)
    rng = np.random.default_rng(1000 + pseed)
    for _ in range(6):
        bw, rtt, sla = 10 ** rng.uniform(4, 9), rng.uniform(0, 0.1), rng.uniform(1e-4, 3.0)
        _same(planner.tables_for(port_p).decide(bw, rtt, sla),
              ref_planner.tables_for(ref_p).decide(bw, rtt, sla))
        _same(scheduler._reference_schedule(port_p, bw, rtt, sla),
              ref_scheduler._reference_schedule(ref_p, bw, rtt, sla))


@pytest.mark.parametrize("bw", (1e3, 1e5, 1e6, 5e6, 20e6, 80e6, 1e9))
def test_tables_decisions_match_reference_on_fitted_profile(bw):
    ref_p = small_model_profile()
    port_p = _port_profile(ref_p)
    for sla in (1e-9, 0.05, 0.3, 10.0):
        _same(scheduler.schedule(port_p, bw, 0.01, sla),
              ref_scheduler.schedule(ref_p, bw, 0.01, sla))
    sweep, ref_sweep = (scheduler.sweep_alpha(port_p, bw, 0.01, 0.3),
                        ref_scheduler.sweep_alpha(ref_p, bw, 0.01, 0.3))
    assert len(sweep) == len(ref_sweep)
    for dec, ref in zip(sweep, ref_sweep):
        _same(dec, ref)


@pytest.mark.parametrize("n_edges", (1, 2, 4))
def test_step_aware_decisions_match_reference(n_edges):
    """tests/test_step_planner.py's step-aware planner on the fitted profile."""
    ref_p = ref_planner.step_aware_profile(
        small_model_profile(), ref_bucketing.BucketingConfig(n_edges=n_edges))
    port_p = planner.step_aware_profile(
        _port_profile(small_model_profile()), bucketing.BucketingConfig(n_edges=n_edges))
    assert port_p.cloud.to_json() == ref_p.cloud.to_json()
    for bw in (2e5, 1e6, 5e6, 20e6, 1e8):
        for sla in (0.02, 0.1, 0.3):
            _same(planner.tables_for(port_p).decide(bw, 0.02, sla),
                  ref_planner.tables_for(ref_p).decide(bw, 0.02, sla))


@pytest.mark.parametrize("n_edges", (1, 2, 3, 4))
def test_bucket_table_json_matches_reference(n_edges):
    alphas = ref_planner.default_alpha_grid(24, 577, 0.01)
    ref_t = ref_bucketing.BucketTable.build_for(
        24, 577, alphas, config=ref_bucketing.BucketingConfig(n_edges=n_edges))
    port_t = bucketing.BucketTable.build_for(
        24, 577, alphas, config=bucketing.BucketingConfig(n_edges=n_edges))
    assert port_t.as_json() == ref_t.as_json()
    assert bucketing.BucketTable.from_json(ref_t.as_json()).edges_by_split == \
        port_t.edges_by_split


def test_synthetic_traces_match_reference():
    from repro.core import bandwidth as ref_bandwidth
    for net in ("4g", "5g", "wifi"):
        for mob in ("static", "walking", "driving"):
            a = bandwidth.synthetic_trace(net, mob, steps=50, seed=3)
            b = ref_bandwidth.synthetic_trace(net, mob, steps=50, seed=3)
            assert np.array_equal(a.bps, b.bps) and a.rtt_s == b.rtt_s


@pytest.mark.parametrize("kind", ["gauss", "sparse", "bytes"])
def test_lzw_codes_match_reference(kind):
    rng = np.random.default_rng(7)
    if kind == "gauss":
        data = np.clip(np.round(rng.normal(size=6000) * 20), -127, 127).astype(np.int8).tobytes()
    elif kind == "sparse":
        data = (rng.random(20000) < 0.05).astype(np.uint8).tobytes()
    else:
        data = rng.integers(0, 256, size=3000, dtype=np.uint8).tobytes()
    codes = compression.lzw_compress(data)
    assert np.array_equal(codes, ref_compression.lzw_compress(data))
    assert compression.lzw_decompress(codes) == data


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activation_payload_matches_reference(quantize, dtype):
    """Same activation values -> the same payload bytes; a bf16 tensor is
    promoted to f32 on the host as ``np.asarray`` of a bf16 JAX array is."""
    rng = np.random.default_rng(11)
    x32 = rng.normal(size=(1, 37, 48)).astype(np.float32)
    jx = jnp.asarray(x32, getattr(jnp, dtype))
    tx = torch.from_numpy(x32).to(getattr(torch, dtype))
    pay = compression.activation_payload(tx, quantize=quantize)
    ref = ref_compression.activation_payload(jx, quantize=quantize)
    assert pay.nbytes == ref.nbytes and pay.scale == ref.scale and pay.shape == ref.shape
    if ref.codes is not None:
        assert np.array_equal(pay.codes, ref.codes)
    else:
        assert pay.raw == ref.raw
    assert np.array_equal(compression.decode_activation(pay),
                          ref_compression.decode_activation(ref))


def test_profile_measured_cpu_fits_linear():
    prof = profiler.profile_measured(lambda t: sum(range(t * 200)), [50, 100, 200, 400],
                                     repeats=2)
    assert prof.a > 0
