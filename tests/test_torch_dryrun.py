"""The port's dry-run and hill-climb tooling (``launch/dryrun.py``,
``launch/hillclimb.py``, ``build_bundle``'s hill-climb options and
``hlo_scale``), on the CPU.

Fake worlds run in subprocesses, one world size a process (a pytest worker
is reused across files and may hold another group):

- (16,16), 256 ranks: a DTensor product split (Shard(0),R) x (R,Shard(1))
  counts this rank's 2*64*512*32 FLOPs, where ``FlopCounterMode`` counts the
  global product; a redistribution to replicated is counted once, as its two
  all-gathers with their groups; ``moe_a2a``'s c10d calls are counted (three
  all-to-alls, one all-gather, two all-reduces); one smoke cell per family
  through ``dryrun.run_cell``, status ok; the skipped shapes with the
  reference's reasons.
- (2,16,16), 512 ranks: one smoke cell.
- (1,1): a ViT serve cell's counted FLOPs equal a hand formula of its
  matmuls and attention exactly; a sampler's count scaled from one step
  (``unit_fn`` x ``hlo_scale``) against the whole step: FLOPs equal, bytes
  within 2% (the initial noise and time grid are counted once a unit).

In process, against the reference's ``build_bundle`` at smoke size on a
one-device Auto mesh: ``janus_alpha`` (logits and notes), ``config_patch``
(fused qkv), ``profile_override`` (the rules' mapping and logits) and
``optimizer`` (one train step's params); and the CLIs write one record a
cell or variant under their directories.
"""
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.models  # noqa: F401  (import models before sharding: circular import)
from repro.launch import steps as jsteps
from repro.models import param as jparam
from repro.optim import adamw as jadamw

from repro_torch.launch import dryrun, hillclimb, steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import param
from repro_torch.optim import adamw

from _ranks import ROOT, _env

# -n 6 workers, each running 8 intra-op threads on 8 cores, oversubscribe the CPU
# (a 2 s case took 150 s among six copies): one thread a worker
torch.set_num_threads(1)

FAMILY_CELLS = [("vit-b16", "serve_b128"), ("starcoder2-3b", "decode_32k"),
                ("qwen3-moe-30b-a3b", "train_4k"), ("dit-s2", "gen_fast"),
                ("flux-dev", "gen_fast"), ("swin-b", "serve_b128"), ("resnet-152", "serve_b128")]
SKIPPED = [("starcoder2-3b", "long_500k"), ("qwen3-moe-30b-a3b", "long_500k")]


def _run(code: str, timeout: float = 240.0) -> dict:
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=timeout, env=_env())
    assert res.returncode == 0, f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}"
    return json.loads(res.stdout.strip().splitlines()[-1])


_WORLD_256 = """
import json
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.launch import dryrun
from repro_torch.models import moe, moe_a2a
from repro_torch.runtime import hlo_bytes
out = {}
mesh = dryrun.make_mesh(False)
with FakeTensorMode():
    a = DTensor.from_local(torch.empty(64, 512), mesh, [Shard(0), Replicate()], run_check=False)
    b = DTensor.from_local(torch.empty(512, 32), mesh, [Replicate(), Shard(1)], run_check=False)
    with hlo_bytes.Counter() as c, FlopCounterMode(display=False) as fc:
        y = a @ b
    out["flops"], out["global_flops"] = c.flops, fc.get_total_flops()
    with hlo_bytes.Counter() as c:
        y.redistribute(mesh, [Replicate(), Replicate()])
    out["redistribute"] = [(r.op, r.n, r.bytes, list(r.ranks)) for r in c.collectives]
    out["comm_counts"] = sum(c.get_comm_counts().values())
    cfg = moe.MoEConfig(d_model=32, d_ff=16, n_experts=32, top_k=2, group_size=32)
    p = {k: torch.empty(s.shape) for k, s in moe.specs(cfg).items()}
    with hlo_bytes.Counter() as c:
        moe_a2a.apply(p, cfg, torch.empty(16, 32, 32), mesh)
    out["a2a"] = sorted((r.op, r.n) for r in c.collectives if r.kind.startswith("c10d."))
out["cells"] = {f"{a}/{s}": dryrun.run_cell(a, s, smoke=True, verbose=False)["status"]
                for a, s in %r}
out["skipped"] = {f"{a}/{s}": dryrun.run_cell(a, s, verbose=False) for a, s in %r}
print(json.dumps(out))
""" % (FAMILY_CELLS, SKIPPED)


@pytest.fixture(scope="module")
def world_256():
    return _run(_WORLD_256)


def test_dtensor_flops_are_the_ranks_share(world_256):
    assert world_256["flops"] == 2 * 64 * 512 * 32 == 2_097_152
    assert world_256["global_flops"] == 2 * 1024 * 512 * 512  # the trap: the global count


def test_redistribution_counted_once(world_256):
    model, data = list(range(16)), list(range(0, 256, 16))
    assert world_256["redistribute"] == [["all-gather", 16, 64 * 32 * 4, model],
                                         ["all-gather", 16, 64 * 512 * 4, data]]
    assert world_256["comm_counts"] == 2


def test_moe_a2a_collectives_counted(world_256):
    assert world_256["a2a"] == [["all-gather", 16]] + [["all-reduce", 16]] * 2 + \
        [["all-to-all", 16]] * 3


@pytest.mark.parametrize("arch,shape", FAMILY_CELLS)
def test_family_smoke_cell_on_16x16(world_256, arch, shape):
    assert world_256["cells"][f"{arch}/{shape}"] == "ok"


@pytest.mark.parametrize("arch,shape", SKIPPED)
def test_skip_reasons_are_the_references(world_256, arch, shape):
    rec = world_256["skipped"][f"{arch}/{shape}"]
    with pytest.raises(jsteps.SkipShape) as e:
        jsteps.build_bundle(arch, shape, None)
    assert rec == {"cell": f"{arch}/{shape}@16x16", "status": "skipped",
                   "reason": e.value.reason}


def test_multi_pod_smoke_cell():
    rec = _run("""
import json
from repro_torch.launch import dryrun
rec = dryrun.run_cell("swin-b", "serve_b128", True, smoke=True, verbose=False)
print(json.dumps(rec))
""")
    assert rec["status"] == "ok" and rec["chips"] == 512 and rec["mesh"] == "2x16x16"
    assert rec["hlo_flops_per_device"] > 0 and rec["t_compute_s"] > 0


_WORLD_1 = """
import dataclasses, json
from repro_torch.launch import dryrun, steps
out = {}
rec = dryrun.run_cell("vit-b16", "serve_b1", mesh_shape=(1, 1), smoke=True, verbose=False)
out["vit"] = rec
mesh = dryrun.make_mesh(mesh_shape=(1, 1))
for arch in ("dit-s2", "flux-dev"):
    b = steps.build_bundle(arch, "gen_fast", mesh, smoke=True)
    unit, _ = dryrun.count_bundle(b)
    whole, _ = dryrun.count_bundle(dataclasses.replace(b, unit_fn=None, hlo_scale=1.0))
    out[arch] = dict(scale=b.hlo_scale, unit_flops=unit.flops, unit_bytes=unit.bytes,
                     whole_flops=whole.flops, whole_bytes=whole.bytes,
                     unit_kernels=dict(unit.kernels), whole_kernels=dict(whole.kernels))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def world_1():
    return _run(_WORLD_1)


def test_vit_serve_flops_equal_the_hand_formula(world_1):
    from repro_torch.configs import config_for_shape, get_arch
    arch = get_arch("vit-b16")
    cfg = config_for_shape(arch, arch.shape("serve_b1"), smoke=True)
    b, s, d, f, h = 2, cfg.num_tokens, cfg.d_model, cfg.d_ff, cfg.n_heads
    hd = d // h
    patch = 2 * b * cfg.num_patches * (cfg.patch ** 2 * 3) * d
    layer = 2 * b * s * d * (3 * d + d + 2 * f) + 4 * b * h * s * s * hd
    head = 2 * b * d * cfg.n_classes
    rec = world_1["vit"]
    assert rec["status"] == "ok" and rec["chips"] == 1
    assert rec["hlo_flops_per_device"] == patch + cfg.n_layers * layer + head
    assert rec["kernel_calls"] == {"flash_attention": cfg.n_layers}


@pytest.mark.parametrize("arch", ["dit-s2", "flux-dev"])
def test_hlo_scale_scaled_against_whole(world_1, arch):
    r = world_1[arch]
    assert r["scale"] == 2
    assert r["unit_flops"] * r["scale"] == r["whole_flops"] > 0
    assert {k: v * 2 for k, v in r["unit_kernels"].items()} == r["whole_kernels"]
    assert abs(r["unit_bytes"] * r["scale"] / r["whole_bytes"] - 1) < 2e-2


# ------------------------------------------------ build_bundle options, in process

def _jmesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@pytest.fixture
def host_mesh():
    mesh = make_host_mesh(device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def _vit_inputs(jb):
    images = np.array(jax.random.normal(jax.random.key(1), jb.abstract_inputs[-1]["images"].shape))
    return images, np.zeros(images.shape[0], np.int32)


def _ref_params(jb, key=0):
    """The reference's params for its bundle (drawn from its abstract tree)."""
    leaves, tree = jax.tree.flatten(jb.abstract_inputs[0])
    keys = jax.random.split(jax.random.key(key), len(leaves))
    drawn = [0.05 * jax.random.normal(k, l.shape, l.dtype) for k, l in zip(keys, leaves)]
    return jax.tree.unflatten(tree, drawn)


def _port(tree):
    return param.from_jax_params(jax.tree.map(np.asarray, tree), "cpu")


@pytest.mark.parametrize("jkw", [{"janus_alpha": 0.2},
                                 {"config_patch": {"fused_qkv": True}},
                                 {"config_patch": {"fused_qkv": True}, "janus_alpha": 0.2}],
                         ids=["janus_alpha", "fused_qkv", "both"])
def test_vit_serve_options_match_reference(jkw):
    jb = jsteps.build_bundle("vit-b16", "serve_b1", _jmesh(), smoke=True, **jkw)
    b = steps.build_bundle("vit-b16", "serve_b1", None, smoke=True, **jkw)
    jp = _ref_params(jb)
    images, labels = _vit_inputs(jb)
    want = jax.jit(jb.step_fn)(jp, {"images": jnp.asarray(images), "labels": jnp.asarray(labels)})
    got = b.step_fn(_port(jp), {"images": torch.from_numpy(images),
                                "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert b.notes == jb.notes
    assert b.hlo_scale == jb.hlo_scale == 1


@pytest.mark.parametrize("profile", ["dp", "spatial"])
def test_profile_override_matches_reference(host_mesh, profile):
    jb = jsteps.build_bundle("resnet-152", "serve_b1", _jmesh(), smoke=True,
                             profile_override=profile)
    b = steps.build_bundle("resnet-152", "serve_b1", host_mesh, smoke=True,
                           profile_override=profile)
    from repro.sharding import rules as jrules
    from repro_torch.sharding import rules
    assert b.rules.mapping == rules.PROFILES[profile]
    assert {k: v for k, v in jrules.make_rules(profile, _jmesh()).mapping.items()} == \
        {k: (tuple(v) if isinstance(v, list) else v) for k, v in b.rules.mapping.items()}
    jp = _ref_params(jb)
    images, labels = _vit_inputs(jb)
    want = jax.jit(jb.step_fn)(jp, {"images": jnp.asarray(images), "labels": jnp.asarray(labels)})
    args = steps.place_inputs(b, _port(jp), {"images": torch.from_numpy(images),
                                             "labels": torch.from_numpy(labels)})
    got = rules.to_global(b.step_fn(*args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_optimizer_option_matches_reference():
    """One train step under a non-default ``AdamWConfig``: loss, the
    schedule's lr and the gradient norm equal the reference's; params too,
    but where a first Adam step is +-lr whatever the gradient's size (an
    element whose gradient is rounding, such as the key biases', can step
    the other way), within 2 lr; and they differ from the default config's."""
    ocfg = dict(lr=3e-2, weight_decay=0.3, warmup_steps=1, grad_clip=0.5)
    jb = jsteps.build_bundle("vit-b16", "cls_224", _jmesh(), smoke=True,
                             optimizer=jadamw.AdamWConfig(**ocfg))
    b = steps.build_bundle("vit-b16", "cls_224", None, smoke=True,
                           optimizer=adamw.AdamWConfig(**ocfg))
    jp = _ref_params(jb)
    images, _ = _vit_inputs(jb)
    labels = np.arange(images.shape[0], dtype=np.int32) % 10
    jnew, _, jm = jax.jit(jb.step_fn)(jp, jadamw.init_state(jp),
                                      {"images": jnp.asarray(images),
                                       "labels": jnp.asarray(labels)})
    batch = {"images": torch.from_numpy(images), "labels": torch.from_numpy(labels)}
    p = _port(jp)
    new, _, m = b.step_fn(p, adamw.init_state(p), batch)
    for k in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    lr = float(m["lr"])
    flat, jflat = param.flatten(new), param.flatten(_port(jnew))
    flips = 0
    for k in flat:
        d = (flat[k] - jflat[k]).abs()
        assert d.max().item() <= 2 * lr + 2e-5, k
        flips += int((d > 2e-5).sum())
    assert flips <= 4, flips  # only elements whose gradient is rounding
    p0 = _port(jp)
    default = steps.build_bundle("vit-b16", "cls_224", None, smoke=True)
    other, _, _ = default.step_fn(p0, adamw.init_state(p0), batch)
    assert max((a - flat[k]).abs().max().item()
               for k, a in param.flatten(other).items()) > lr / 2


def test_variants_table_is_the_references():
    """The reference's table, read from its source: importing
    ``repro.launch.hillclimb`` sets ``XLA_FLAGS`` for 512 host devices in
    the importing process."""
    import ast
    tree = ast.parse((ROOT / "src" / "repro" / "launch" / "hillclimb.py").read_text())
    want = next(ast.literal_eval(node.value) for node in ast.walk(tree)
                if isinstance(node, ast.AnnAssign) and node.target.id == "VARIANTS")
    assert list(hillclimb.VARIANTS) == list(want)
    for cell, rows in want.items():
        assert hillclimb.VARIANTS[cell] == [tuple(r) for r in rows], cell


def test_clis_write_one_record_a_cell_and_variant(tmp_path):
    code = f"""
import json, pathlib
from repro_torch.launch import dryrun, hillclimb
dryrun.OUT_DIR = pathlib.Path({str(tmp_path / 'dry')!r})
hillclimb.OUT = pathlib.Path({str(tmp_path / 'hc')!r})
dryrun.main(["--arch", "vit-b16", "--shape", "serve_b1"])
hillclimb.main(["--cell", "vit-l16/serve_b128", "--variant", "v3_fused_qkv"])
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=240, env=_env())
    assert res.returncode == 0, res.stderr[-3000:]
    recs = [json.loads(p.read_text()) for p in (tmp_path / "dry").glob("*.json")]
    assert [r["cell"] for r in recs] == ["vit-b16/serve_b1@16x16"]
    assert recs[0]["status"] == "ok" and "[dryrun] all cells OK" in res.stdout
    hc = [json.loads(p.read_text()) for p in (tmp_path / "hc").glob("*.json")]
    assert [(r["cell"], r["variant"]) for r in hc] == [("vit-l16/serve_b128", "v3_fused_qkv")]
    assert hc[0]["kernel_calls"] == {"flash_attention": 24} and hc[0]["chips"] == 256
    assert dryrun.OUT_DIR.parts[-3:] == ("experiments", "torch", "dryrun")
    assert hillclimb.OUT.parts[-3:] == ("experiments", "torch", "hillclimb")
