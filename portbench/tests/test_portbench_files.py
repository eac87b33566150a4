"""The benchmark's files: found by name, within the contract's limits, and
the frozen numbers they carry."""
import json
import re

import numpy as np
import pytest

from harness import flops, modules, spec
from harness.traffic import Source, validate

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
L384_027 = (74, 61, 50, 42, 35, 29, 24, 19, 16, 13, 11, 9, 7, 6, 5, 4, 3, 3, 2, 2, 1, 1, 1, 1)
B16_049 = (41, 29, 21, 15, 10, 7, 5, 3, 2, 1, 1, 1)


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for n in names + CELLS + [c["name"] for c in BENCH["configs"]]:
        assert NAME.match(n), n
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w = spec.workload(BENCH, cell)
    cfg = spec.config(BENCH, w["config"])
    traffic = spec.traffic(w["traffic"])
    validate(traffic, cfg)
    assert cfg["name"] == w["config"] and cfg["reduced"] == []
    assert cfg["hidden_size"] == cfg["num_attention_heads"] * cfg["head_dim"]
    assert cfg["num_tokens"] == (cfg["img_res"] // cfg["patch"]) ** 2 + 1
    for e2e in (False, True):
        assert spec.metrics_for(BENCH, cell, e2e), (cell, e2e)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(spec.reader(metric))


def test_frozen_schedules():
    def kinds(traffic):
        return {k["alpha"]: (k["frames"], tuple(k["schedule"]))
                for k in spec.traffic(traffic)["mix"]}
    l384 = kinds("offload-4g-l384")
    assert l384[0.0] == (62, (0,) * 24) and l384[0.27] == (115, L384_027)
    assert sorted(l384) == [0.0, 0.07, 0.13, 0.16, 0.18, 0.22, 0.23, 0.26, 0.27]
    assert sum(n for n, _ in l384.values()) == 187
    assert l384[0.07][1] == (3, 2, 2, 2, 2, 2, 2, 2, 2) + (1,) * 15
    assert kinds("offload-wifi-l384") == {0.0: (100, (0,) * 24)}
    assert kinds("offload-4g-b16") == {0.0: (18, (0,) * 12), 0.49: (75, B16_049)}
    assert 577 - sum(L384_027) == 158 and 197 - sum(B16_049) == 61


def test_frame_flops():
    l384 = spec.config(BENCH, "janus-vit-l384")
    b16 = spec.config(BENCH, "vit-b16")
    # the MLP is counted at the tokens left after a layer's merge: the
    # count at the tokens entering it would be 161.1 and 17.0
    assert round(flops.frame_flops(l384, (0,) * 24) / 1e9, 1) == 382.1
    assert round(flops.frame_flops(l384, L384_027) / 1e9, 1) == 154.1
    assert round(flops.frame_flops(b16, (0,) * 12) / 1e9, 1) == 35.1
    assert round(flops.frame_flops(b16, B16_049) / 1e9, 1) == 15.7


def test_bounds_count_each_call():
    b16 = spec.config(BENCH, "vit-b16")
    flash, tome = flops.group_bounds(b16, (0,) * 12, 8)
    assert tome == 0.0
    assert flash == pytest.approx(12 * flops.flash_bound_s(8, 12, 197, 64))
    _, tome = flops.group_bounds(b16, B16_049, 8)
    assert tome == pytest.approx(sum(flops.tome_bound_s(8, n, 64) for n in
                                     flops.token_counts(197, B16_049)[:-1]))


def test_module_check():
    assert modules.forbidden_loaded(["jax", "jax.numpy", "os"]) == ["jax"]
    assert modules.forbidden_loaded(["repro.core.engine", "repro_torch"]) == ["repro"]
    assert modules.forbidden_loaded(["repro_torch", "repro_torch.core", "jaxtyping",
                                     "flax_like", "reprox"]) == []
    assert modules.forbidden_loaded(["jaxlib.xla", "flax.linen"]) == ["flax", "jaxlib"]


@pytest.mark.parametrize("traffic", ["offload-4g-l384", "offload-4g-b16", "offload-wifi-l384"])
def test_traffic_follows_the_seed(traffic):
    tr = spec.traffic(traffic)
    block = sum(k["frames"] for k in tr["mix"])

    def draw(seed):
        src = Source(tr, seed)
        return [(f.kind, f.image) for f in (src.next(0.0) for _ in range(3 * block))]

    a, b, c = draw(2**31 + 11), draw(2**31 + 11), draw(2**31 + 12)
    assert a == b and a != c
    # every seed gets the same work: each kind's frames exact in every block
    for kinds in (a, c):
        for lo in range(0, 3 * block, block):
            got = [k for k, _ in kinds[lo:lo + block]]
            assert [got.count(i) for i in range(len(tr["mix"]))] == \
                [k["frames"] for k in tr["mix"]]
