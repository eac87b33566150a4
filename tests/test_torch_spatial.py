"""Two mesh configurations against the reference, on the CPU: the
``spatial`` profile (conv activations split along H on "model", each
convolution and the max pool behind the local boundary with a halo of H
rows, ``sharding.rules.halo_exchange``), and a batch that does not divide
pod x data (replicated by the rules' fallback; the products' placements are
then decided by ``models.layers._product``, not by DTensor's cost model).

In process:
- ``resnet.halo_rows`` for every (H, k, s, P) of resnet-152's convolutions
  and max pool, full and smoke size, P = 2 and 4 where the output's H
  divides by P: the rows each block's windows read outside the block under
  XLA's SAME padding of the global H (``_same_pads``), block by block.
- ``conv_local`` and ``max_pool_local`` on ``row_blocks`` (the halos cut
  from the global tensor, as the ranks receive them), concatenated, against
  the unsplit op: f32 within 1e-5 of max|y| (another summation order).
- The spatial serve bundle on a one-rank mesh, bit-equal to the unmeshed
  forward.

Real ranks (``tests/_ranks.py``), concurrently with the reference's jitted
``build_bundle(..., profile_override="spatial")`` on as many host devices:
- resnet-152 smoke ``serve_b128`` logits on gloo meshes (1,2), (1,4), (2,2),
  every rank within 1e-6 of the largest logit of the reference's jitted
  bundle (at (2,2) of its unsharded forward: the reference's own (2,2)
  program is not, and that is pinned); (1,2) counts 16 exchanges a forward
  (``collective-permute``; the reference's compiled HLO has 15).
- A spatial convolution and the max pool on 2 ranks: input and weight
  gradients against autograd of the unsplit ops, 1e-5 of max|g|.
- vit-b16's smoke train step on (3,4), 12 ranks, the smallest mesh on which
  the unfixed port fails (a token split DTensor chose over "data" that the
  matmul cannot view back): loss, grad_norm and the updated params against
  the reference's step on 12 host devices, at ``test_torch_train_mesh.py``'s
  tolerances.

Fake worlds (``launch/dryrun.py``), one a process, run concurrently:
``dit-s2/gen_1024`` smoke at (2,4,2) (the multi-pod dry-run's error cell, at
16 ranks) with the kernel calls of the same cell on a (1,1) world; the
smoke train cells of vit-b16, dit-s2 and flux-dev at (3,4), where all three
fail unfixed; the hill-climb's ``resnet-152/serve_b128#v1_spatial`` on the
16x16 world, with its halo exchanges as ``collective-permute``.
"""
import functools
import json
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.models  # noqa: F401  (import models before sharding: circular import)
from repro.models import resnet as jresnet

from repro_torch.configs import resnet_152
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import param, resnet
from repro_torch.sharding import rules

from _ranks import ROOT, _env, run_ranks, run_reference
import test_torch_train_mesh as train_mesh
from test_torch_vision import _draw

# -n 6 workers, each running 8 intra-op threads on 8 cores, oversubscribe the CPU
# (a 2 s case took 150 s among six copies): one thread a worker
torch.set_num_threads(1)

# logits: f32, another summation order; the smoke weights (``_draw``) give
# logits up to ~440, where 1e-4 absolute is 2.3e-7 of them (measured 4.4e-7
# at (1,2)), so the limit is relative to their largest magnitude
LOGITS_REL = 1e-6
REL = 1e-5
MESHES = ((1, 2), (1, 4), (2, 2))


# ------------------------------------------------------------------ in process

def _windows(cfg) -> set[tuple[int, int, int]]:
    """Every (H, k, stride) window of resnet ``cfg``'s forward."""
    h = cfg.img_res
    out = {(h, 7, 2)}
    h //= 2
    out.add((h, 3, 2))  # the max pool
    h //= 2
    for i, depth in enumerate(cfg.depths):
        s = 1 if i == 0 else 2
        out |= {(h, 1, 1), (h, 3, s), (h, 1, s)}  # conv1, conv2, proj
        h //= s
        out |= {(h, 1, 1), (h, 3, 1)}  # conv3, the rest's conv2
    return out


@pytest.mark.parametrize("cfg", [resnet_152.CONFIG, resnet_152.SMOKE], ids=["full", "smoke"])
def test_halo_rows_are_what_each_block_reads(cfg):
    checked = 0
    for h, k, s in sorted(_windows(cfg)):
        for parts in (2, 4):
            if (h // s) % parts:
                continue  # the output does not divide: H is gathered
            before, _ = resnet._same_pads(h, k, s)
            blk = h // parts
            want_before, want_after = 0, 0
            for i in range(parts):
                first = (i * blk // s) * s - before           # the block's first window
                last = ((i + 1) * blk // s - 1) * s - before + k - 1
                want_before = max(want_before, i * blk - first)
                want_after = max(want_after, last - ((i + 1) * blk - 1))
            assert resnet.halo_rows(h, k, s, parts) == (want_before, want_after), (h, k, s, parts)
            checked += 1
    assert checked >= 10


# (H, W, k, stride, parts): resnet's windows at odd widths and block heights
BLOCK_CASES = [(16, 16, 7, 2, 2), (12, 11, 7, 2, 2), (9, 7, 3, 1, 3), (14, 9, 3, 1, 2),
               (12, 5, 3, 2, 2), (16, 13, 3, 2, 4), (8, 7, 1, 2, 4), (10, 10, 1, 1, 2)]


@pytest.mark.parametrize("h,w,k,s,parts", BLOCK_CASES)
def test_local_ops_on_row_blocks_match_the_whole(h, w, k, s, parts):
    gen = torch.Generator().manual_seed(h * 100 + w)
    x = torch.randn(2, h, w, 4, generator=gen)
    wt = torch.randn(k, k, 4, 5, generator=gen)
    want = resnet.conv_local(x, wt, s)
    got = torch.cat([resnet.conv_local(b, wt, s, halo=True)
                     for b in resnet.row_blocks(x, k, s, parts)], dim=1)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=REL * want.abs().max().item(), rtol=0)
    if (k, s) == (3, 2) or (h, k, s) == (16, 7, 2):  # the pool's window
        want = resnet.max_pool_local(x)
        got = torch.cat([resnet.max_pool_local(b, halo=True)
                         for b in resnet.row_blocks(x, 3, 2, parts, fill=-torch.inf)], dim=1)
        assert torch.equal(got, want)


@pytest.fixture
def host_mesh():
    mesh = make_host_mesh(device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _weights():
    """Flat numpy weights of the smoke resnet-152 (BatchNorm statistics
    drawn) and seeded images of its serve_b128 bundle."""
    _, tree = _draw(jresnet.specs(resnet_152.SMOKE))
    flat = {k: v.numpy() for k, v in param.flatten(tree).items()}
    images = np.random.default_rng(7).standard_normal((2, 64, 64, 3)).astype(np.float32)
    return flat, images


def test_spatial_bundle_on_one_rank_mesh_is_the_unmeshed_forward(host_mesh):
    flat, images = _weights()
    batch = {"images": torch.from_numpy(images), "labels": torch.zeros(2, dtype=torch.int32)}
    p = param.from_jax_params(flat, "cpu")
    b0 = steps.build_bundle("resnet-152", "serve_b128", smoke=True)
    b1 = steps.build_bundle("resnet-152", "serve_b128", host_mesh, smoke=True,
                            profile_override="spatial")
    got = rules.to_global(b1.step_fn(*steps.place_inputs(b1, p, batch)))
    assert torch.equal(got, b0.step_fn(p, batch))


# ------------------------------------------------------------------ real ranks

_REFERENCE = """
import json, os
import jax, jax.numpy as jnp, numpy as np
import repro.models
from repro.configs import get_arch
from repro.launch import steps
from repro.models import resnet
OUT = os.environ["OUT"]
w = np.load(os.path.join(OUT, "weights.npz"))
params = {}
for k in w.files:
    d = params
    *path, last = k.split("/")
    for p in path:
        d = d.setdefault(p, {})
    d[last] = jnp.asarray(w[k])
images = np.load(os.path.join(OUT, "images.npy"))
batch = {"images": jnp.asarray(images), "labels": jnp.zeros(images.shape[0], jnp.int32)}
cfg = get_arch("resnet-152").smoke_config
plain = jax.jit(lambda p, x: resnet.forward(p, cfg, x))
out = {"plain": np.asarray(plain(params, batch["images"]))}
for shape in json.loads(os.environ["MESHES"]):
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
    b = steps.build_bundle("resnet-152", "serve_b128", mesh, smoke=True,
                           profile_override="spatial")
    out["x".join(map(str, shape))] = np.asarray(b.jitted()(params, batch))
    hlo = b.jitted().lower(params, batch).compile().as_text()
    out["x".join(map(str, shape)) + "/permutes"] = np.array(hlo.count("collective-permute("))
np.savez(os.path.join(OUT, f"reference{jax.device_count()}.npz"), **out)
"""

_RANKS = """
import json
from torch.distributed.tensor import DTensor, Replicate
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import param, resnet
from repro_torch.runtime import hlo_bytes
from repro_torch.sharding import rules
w = np.load(os.path.join(OUT, "weights.npz"))
params = param.from_jax_params({k: w[k] for k in w.files}, "cpu")
images = torch.from_numpy(np.load(os.path.join(OUT, "images.npy")))
batch = {"images": images, "labels": torch.zeros(images.shape[0], dtype=torch.int32)}
out = {}
for shape in json.loads(os.environ["MESHES"]):
    mesh = make_host_mesh(model=shape[1], device="cpu")
    assert list(mesh.shape) == shape, mesh
    b = steps.build_bundle("resnet-152", "serve_b128", mesh, smoke=True,
                           profile_override="spatial")
    with hlo_bytes.Counter() as c:
        logits = b.step_fn(*steps.place_inputs(b, params, batch))
    name = "x".join(map(str, shape))
    out[name] = rules.to_global(logits).numpy()
    out[name + "/permutes"] = np.array(
        sum(r.op == "collective-permute" for r in c.collectives))

if WORLD == 2:  # gradients through a spatial convolution and the max pool
    mesh = make_host_mesh(model=2, device="cpu")
    r = rules.make_rules("spatial", mesh)
    gen = torch.Generator().manual_seed(11)
    for name, k, s in (("conv3x3s1", 3, 1), ("conv7x7s2", 7, 2), ("pool", 3, 2)):
        x = torch.randn(2, 16, 9, 4, generator=gen, requires_grad=True)
        wt = torch.randn(k, k, 4, 5, generator=gen, requires_grad=True)
        g = torch.randn(2, 16 // s, -(-9 // s), 4 if name == "pool" else 5, generator=gen)
        with rules.use_rules(r):
            xd = DTensor.from_local(x, mesh, [Replicate(), Replicate()], run_check=False)
            wd = DTensor.from_local(wt, mesh, [Replicate(), Replicate()], run_check=False)
            y = resnet._max_pool(xd) if name == "pool" else resnet.conv({"w": wd}, xd, s)
            assert y.placements[1].is_shard(1), y.placements  # rows stay split
            (y * g).sum().backward()
        out[name + "/x"] = x.grad.numpy()
        if name != "pool":
            out[name + "/w"] = wt.grad.numpy()
        x0, w0 = x.detach().requires_grad_(), wt.detach().requires_grad_()
        y0 = resnet._max_pool(x0) if name == "pool" else resnet.conv({"w": w0}, x0, s)
        (y0 * g).sum().backward()
        out[name + "/x0"] = x0.grad.numpy()
        if name != "pool":
            out[name + "/w0"] = w0.grad.numpy()
np.savez(os.path.join(OUT, f"rank{WORLD}_{RANK}.npz"), **out)
dist.destroy_process_group()
"""

# vit-b16's smoke train step at (3,4): test_torch_train_mesh's scripts, on
# 12 host devices and 12 ranks, the sharded step alone
_FAULT_MESH = [3, 4]
_FAULT_REFERENCE = train_mesh._REFERENCE.replace("jax.devices()[:4]", "jax.devices()[:12]")
_FAULT_RANKS = train_mesh._RANKS.replace(
    "    p0, o0 = fresh(name)\n    p0, o0, m0 = step0(p0, o0, pipeline.place(hb, \"cpu\"))\n",
    "").replace("    one = results(p0, o0, m0)\n", "").replace(
    "        np.savez(os.path.join(OUT, f\"one_{save_as}_{name}.npz\"), **one,\n"
    "                 split=np.array(split))\n", "")


# ------------------------------------------------------------------ fake worlds

_CELLS = """
import json, sys
from repro_torch.launch import dryrun, hillclimb
shape = json.loads(sys.argv[1])
out = {}
if shape == [16, 16]:
    out["v1_spatial"] = hillclimb.run_variant("resnet-152/serve_b128", "v1_spatial",
                                              {"profile_override": "spatial"})
for arch, cell in json.loads(sys.argv[2]):
    out[arch + "/" + cell] = dryrun.run_cell(arch, cell, mesh_shape=tuple(shape), smoke=True,
                                             verbose=False)
print(json.dumps(out))
"""
TRAIN_CELLS = [("vit-b16", "cls_224"), ("dit-s2", "train_256"), ("flux-dev", "train_256")]
WORLDS = {"1x1": ([1, 1], [("dit-s2", "gen_1024")]),
          "2x4x2": ([2, 4, 2], [("dit-s2", "gen_1024")]),
          "3x4": ([3, 4], TRAIN_CELLS),
          "16x16": ([16, 16], [])}


def _threads(*jobs):
    """Run the ``jobs`` (callables) concurrently; re-raise the first error."""
    errors = []

    def run(job):
        try:
            job()
        except Exception as e:  # noqa: BLE001  (re-raised below)
            errors.append(e)
    threads = [threading.Thread(target=run, args=(j,)) for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of the module, concurrently: the real ranks and
    their references (results under the returned dir) and the fake worlds
    (their records)."""
    procs = {k: subprocess.Popen([sys.executable, "-c", _CELLS, json.dumps(shape),
                                  json.dumps(cells)], cwd=ROOT, text=True, env=_env(),
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for k, (shape, cells) in WORLDS.items()}
    try:
        tmp = _real_ranks(tmp_path_factory.mktemp("spatial"))
    finally:
        outs = {k: p.communicate(timeout=300) for k, p in procs.items()}
    records = {}
    for k, p in procs.items():
        stdout, stderr = outs[k]
        assert p.returncode == 0, f"{k}:\n{stdout[-2000:]}\n{stderr[-4000:]}"
        records[k] = json.loads(stdout.strip().splitlines()[-1])
    return tmp, records


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


def _real_ranks(tmp):
    flat, images = _weights()
    np.savez(tmp / "weights.npz", **flat)
    np.save(tmp / "images.npy", images)
    assert "step0(" not in _FAULT_RANKS and "one_" not in _FAULT_RANKS
    fault = tmp / "fault"
    fault.mkdir()
    train_mesh._inputs(fault, ["vit-b16"])
    fault_env = {"MESH": json.dumps(_FAULT_MESH), "ARCHS": json.dumps(["vit-b16"])}
    two, four = {"MESHES": json.dumps([[1, 2]])}, {"MESHES": json.dumps([[1, 4], [2, 2]])}
    _threads(lambda: run_reference(_REFERENCE, 2, tmp, env=two),
             lambda: run_reference(_REFERENCE, 4, tmp, env=four),
             lambda: run_ranks(_RANKS, 2, tmp, env=two),
             lambda: run_ranks(_RANKS, 4, tmp, env=four),
             lambda: run_reference(_FAULT_REFERENCE, 12, fault, env=fault_env),
             lambda: run_ranks(_FAULT_RANKS, 12, fault, env=fault_env))
    return tmp


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_spatial_resnet_logits_match_reference(ranks, shape):
    n = shape[0] * shape[1]
    name = f"{shape[0]}x{shape[1]}"
    ref = np.load(ranks / f"reference{n}.npz")
    want, plain = ref[name], ref["plain"]
    assert want.shape == (2, 10) and np.isfinite(want).all()
    tol = LOGITS_REL * np.abs(plain).max()
    if shape == (2, 2):
        # the reference's GSPMD program with the batch on "data" and H on
        # "model" is not its own forward (JAX 0.9.0 on host devices: off by
        # ~170 of ~600); the port is held to the reference's unsharded
        # forward there
        assert np.abs(want - plain).max() > 1.0
        want = plain
    np.testing.assert_allclose(want, plain, atol=tol, rtol=0)
    for rank in range(n):
        got = np.load(ranks / f"rank{n}_{rank}.npz")
        np.testing.assert_allclose(got[name], want, atol=tol, rtol=0, err_msg=f"rank {rank}")
    if shape == (1, 2):
        # one exchange per direction that has rows; XLA's program sends the
        # same rows op for op but for stage 3's 3x3/1 at one row a device
        # (one permute and an all-reduce there)
        assert int(np.load(ranks / "rank2_0.npz")[name + "/permutes"]) == 16
        assert int(ref[name + "/permutes"]) == 15


@pytest.mark.parametrize("name", ["conv3x3s1", "conv7x7s2", "pool"])
def test_spatial_gradients_match_the_unsplit_ops(ranks, name):
    for rank in range(2):
        got = np.load(ranks / f"rank2_{rank}.npz")
        for leaf in ("x", "w") if name != "pool" else ("x",):
            want = got[f"{name}/{leaf}0"]
            np.testing.assert_allclose(got[f"{name}/{leaf}"], want, rtol=0,
                                       atol=REL * np.abs(want).max(), err_msg=f"{leaf} {rank}")


def test_fallback_batch_train_step_matches_reference_on_3x4(ranks):
    fault = ranks / "fault"
    train_mesh._check(np.load(fault / "port_vit-b16.npz"), np.load(fault / "ref_vit-b16.npz"),
                      "vit-b16")


@pytest.fixture(scope="module")
def worlds(runs):
    return runs[1]


def test_multi_pod_batch_fallback_cell_counts_as_one_rank(worlds):
    rec, one = worlds["2x4x2"]["dit-s2/gen_1024"], worlds["1x1"]["dit-s2/gen_1024"]
    assert rec["status"] == one["status"] == "ok" and rec["chips"] == 16
    assert rec["kernel_calls"] == one["kernel_calls"] == {"flash_attention": 2}


@pytest.mark.parametrize("arch,shape", TRAIN_CELLS)
def test_smoke_train_cells_with_a_fallback_batch(worlds, arch, shape):
    rec = worlds["3x4"][f"{arch}/{shape}"]
    assert rec["status"] == "ok" and rec["chips"] == 12
    assert rec["kernel_calls"]["flash_attention_bwd"] > 0


def test_hillclimb_spatial_variant_counts_its_halo(worlds):
    rec = worlds["16x16"]["v1_spatial"]
    assert rec["status"] == "ok" and rec["chips"] == 256
    # 14 rows a rank at 224 px: the 7x7/2 stem alone splits (the pool's
    # output, 56, does not divide by 16, so its input is gathered); two
    # exchanges, of 2 and 3 rows of a [8, 224, 3] bf16 block
    assert rec["collective_counts"]["collective-permute"] == 2
    assert rec["collectives"]["collective-permute"] == (2 + 3) * 8 * 224 * 3 * 2
    assert rec["t_collective_s"] > 0
