"""The training mesh's other cases against the reference and the port's
own one-device runs: the sharded step at (4,1) and (1,4) and with
accumulation (the tolerances of ``test_torch_train_mesh.py``), then the
mesh's I/O on gloo ranks (``tests/_ranks.py``):

- ``compressed_psum_mean`` on a (4,1) mesh: identical leaves on every rank
  against the reference's on an Auto (4,1) mesh of host devices, bit for
  bit; distinct leaves per rank against the numpy formula
  ``sum_i q_i * max_i scale_i / n``, which is not the exact mean where the
  ranks' scales differ (the reference's behaviour, kept);
- ``place`` with a bundle's batch shardings at (2,2): each rank's local
  shard is the slice of the host batch that the reference's ``place`` puts
  on the device of the same mesh coordinate;
- the elastic restore: a checkpoint saved sharded on a (2,2) world (the
  port's after one step, and the reference's from a sharded tree) restored
  with ``shardings=`` in a new 2-rank world at ``plan_elastic_mesh(2,
  model_parallel=2)``, bit for bit and placed as the bundle's
  ``in_shardings``;
- ``launch.train.main([... "--mesh"])`` on 2 ranks: its losses, and a
  ``--resume``, against the unmeshed run; only rank 0 prints.
"""
import json
import threading

import numpy as np
import pytest

from repro_torch.launch import train
from repro_torch.optim import grad_compression as gc

from _ranks import run_ranks, run_reference
from test_torch_train import LOSS_RTOL
from test_torch_train_mesh import _check_all, _draw, _run_both
import torch

# -n 6 workers, each running 8 intra-op threads on 8 cores, oversubscribe the CPU
# (a 2 s case took 150 s among six copies): one thread a worker
torch.set_num_threads(1)


@pytest.mark.parametrize("mesh", [(4, 1), (1, 4)], ids=["4x1", "1x4"])
def test_sharded_step_matches_reference_on_other_meshes(tmp_path, mesh):
    names = ("vit-b16", "starcoder2-3b")
    _run_both(tmp_path, names, mesh)
    _check_all(tmp_path, names, mesh[1] > 1)


def test_sharded_accumulation_matches_reference(tmp_path):
    """vit-b16 at accum=2 over a batch of 4 on (2,2): each microbatch is
    rows 2i..2i+1 of the global batch, split over "data"."""
    _run_both(tmp_path, ("vit-b16",), (2, 2), accum=2)
    _check_all(tmp_path, ("vit-b16",), True)


def _leaves(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 8)).astype(np.float32),
            "b": (3.0 * rng.standard_normal((5,))).astype(np.float32)}


_REFERENCE_IO = """
import json, os
import jax, jax.numpy as jnp, numpy as np
import repro.models
from repro.configs import get_arch
from repro.data.pipeline import DataConfig, SyntheticData, place
from repro.launch import steps, train
from repro.optim.grad_compression import compressed_psum_mean
OUT = os.environ["OUT"]
devs = np.array(jax.devices()[:4])
same = np.load(os.path.join(OUT, "same.npz"))
mesh41 = jax.sharding.Mesh(devs.reshape(4, 1), ("data", "model"))
out = compressed_psum_mean({k: jnp.asarray(same[k]) for k in same.files}, mesh41)
res = {f"psum/{k}": np.asarray(v) for k, v in out.items()}
mesh22 = jax.sharding.Mesh(devs.reshape(2, 2), ("data", "model"))
for name in ("vit-b16", "starcoder2-3b"):
    arch = get_arch(name)
    shape = next(s for s in arch.shapes if s.kind == "train")
    b = steps.build_bundle(name, shape.name, mesh22, smoke=True)
    hb = train.host_batch(arch, arch.smoke_config, SyntheticData(DataConfig()), 3,
                          b.abstract_inputs[2])
    placed = place(hb, b.in_shardings[2])
    for k, v in placed.items():
        res[f"global/{name}/{k}"] = np.asarray(v)
        for s in v.addressable_shards:
            res[f"shard/{name}/{k}/{s.device.id}"] = np.asarray(s.data)
np.savez(os.path.join(OUT, "reference.npz"), **res)
"""

_RANKS_IO = """
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.configs import get_arch
from repro_torch.data import pipeline
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import grad_compression as gc
from repro_torch.sharding import rules
res = {}
# compressed_psum_mean over "data" of a (4, 1) mesh
mesh41 = make_host_mesh(model=1, device="cpu")
same = np.load(os.path.join(OUT, "same.npz"))
mine = np.load(os.path.join(OUT, f"leaves{RANK}.npz"))
out = gc.compressed_psum_mean({k: torch.from_numpy(same[k]) for k in same.files}, mesh41)
res.update({f"psum/{k}": v.numpy() for k, v in out.items()})
out = gc.compressed_psum_mean({k: torch.from_numpy(mine[k]) for k in mine.files}, mesh41)
res.update({f"distinct/{k}": v.numpy() for k, v in out.items()})
rep = DTensor.from_local(torch.from_numpy(same["w"]), mesh41, [Replicate(), Replicate()])
got = gc.compressed_psum_mean(rep, mesh41)
assert got.placements == rep.placements
assert torch.equal(got.to_local(), torch.from_numpy(res["psum/w"]))
split = DTensor.from_local(torch.from_numpy(same["w"][:2]), mesh41, [Shard(0), Replicate()])
try:
    gc.compressed_psum_mean(split, mesh41)
    raise AssertionError("a sharded leaf was taken")
except ValueError as e:
    assert "not replicated" in str(e), e
# place with a bundle's batch shardings on (2, 2)
mesh22 = make_host_mesh(model=2, device="cpu")
for name in ("vit-b16", "starcoder2-3b"):
    arch = get_arch(name)
    shape = next(s for s in arch.shapes if s.kind == "train")
    b = steps.build_bundle(name, shape.name, mesh22, smoke=True)
    hb = train.host_batch(arch, arch.smoke_config, pipeline.SyntheticData(), 3,
                          b.abstract_inputs[2])
    placed = pipeline.place(hb, "cpu", b.in_shardings[2])
    for k, v in placed.items():
        want = b.in_shardings[2][k].placements(v.shape)
        assert tuple(v.placements) == want, (k, v.placements)
        idx = rules.shard_slices(hb[k].shape, mesh22, want)
        assert np.array_equal(v.to_local().numpy(), hb[k][idx]), k
        res[f"shard/{name}/{k}"] = v.to_local().numpy()
        res[f"global/{name}/{k}"] = rules.to_global(v).numpy()
np.savez(os.path.join(OUT, f"rank{RANK}.npz"), **res)
dist.destroy_process_group()
"""


def _formula(leaves: list) -> np.ndarray:
    """The reference's int8 mean in numpy, f32 as the port computes it."""
    qs, scales = [], []
    for x in leaves:
        scale = np.float32(max(np.abs(x).max(), np.float32(1e-12)) / np.float32(127.0))
        qs.append(np.clip(np.round(x / scale), -127, 127).astype(np.int8))
        scales.append(scale)
    acc = np.sum([q.astype(np.int32) for q in qs], axis=0)
    return (acc.astype(np.float32) * max(scales) / np.float32(len(leaves))).astype(np.float32)


def test_compression_and_sharded_place_match_reference(tmp_path):
    np.savez(tmp_path / "same.npz", **_leaves(0))
    for r in range(4):
        np.savez(tmp_path / f"leaves{r}.npz", **_leaves(10 + r))
    err = []
    t = threading.Thread(target=lambda: _catch(err, run_reference, _REFERENCE_IO, 4, tmp_path))
    t.start()
    run_ranks(_RANKS_IO, 4, tmp_path)
    t.join()
    if err:
        raise err[0]
    ref = np.load(tmp_path / "reference.npz")
    distinct = [_leaves(10 + r) for r in range(4)]
    for rank in range(4):
        got = np.load(tmp_path / f"rank{rank}.npz")
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[f"psum/{k}"], ref[f"psum/{k}"])
            np.testing.assert_array_equal(got[f"distinct/{k}"],
                                          _formula([d[k] for d in distinct]))
        for name, keys in (("vit-b16", ("images", "labels")), ("starcoder2-3b", ("tokens",))):
            for k in keys:
                np.testing.assert_array_equal(got[f"global/{name}/{k}"],
                                              ref[f"global/{name}/{k}"])
                # rank r sits at mesh coordinate (r // 2, r % 2), as device r there
                np.testing.assert_array_equal(got[f"shard/{name}/{k}"],
                                              ref[f"shard/{name}/{k}/{rank}"])
    # the formula is not the exact mean when the scales differ
    exact = np.mean([d["b"] for d in distinct], axis=0)
    assert np.abs(_formula([d["b"] for d in distinct]) - exact).max() > 1e-3


def test_compression_formula_is_the_port_on_one_process():
    """The numpy formula above is the port's function (one rank, n = 1)."""
    import torch
    x = _leaves(3)["w"]
    np.testing.assert_array_equal(
        _formula([x]), gc.int8_decompress(*gc.int8_compress(torch.from_numpy(x))).numpy())


def _catch(err, fn, *args, **kw):
    try:
        fn(*args, **kw)
    except Exception as e:  # noqa: BLE001  (re-raised by the caller)
        err.append(e)


_SAVE_22 = """
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_arch
from repro_torch.data import pipeline
from repro_torch.models import param
from repro_torch.optim import adamw
from repro_torch.sharding import rules
mesh = make_host_mesh(model=2, device="cpu")
arch = get_arch("vit-b16")
b = steps.build_bundle("vit-b16", "cls_224", mesh, smoke=True)
w = np.load(os.path.join(OUT, "w_vit-b16.npz"))
p = param.from_jax_params({k: w[k] for k in w.files}, "cpu")
p, o = steps.place_inputs(b, p, adamw.init_state(p))
hb = train.host_batch(arch, arch.smoke_config, pipeline.SyntheticData(), 0, b.abstract_inputs[2])
p, o, _ = b.step_fn(p, o, pipeline.place(hb, "cpu", b.in_shardings[2]))
Checkpointer(os.path.join(OUT, "port_ck")).save(1, (p, o), blocking=True)
# no rank returns from a blocking save before the checkpoint is committed
assert os.path.exists(os.path.join(OUT, "port_ck", "step_00000001", "COMMIT"))
flat = {f"0/{k}": rules.to_global(v).numpy() for k, v in param.flatten(p).items()}
flat.update({f"1/{t}/{k}": rules.to_global(v).numpy()
             for t in ("m", "v") for k, v in param.flatten(o[t]).items()})
flat["1/step"] = rules.to_global(o["step"]).numpy()
if RANK == 0:
    np.savez(os.path.join(OUT, "saved.npz"), **flat)
dist.destroy_process_group()
"""

_REFERENCE_SAVE = """
import os
import jax, jax.numpy as jnp, numpy as np
import repro.models
from repro.checkpoint import Checkpointer
from repro.launch import steps
from repro.optim import adamw
OUT = os.environ["OUT"]
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
b = steps.build_bundle("vit-b16", "cls_224", mesh, smoke=True)
w = np.load(os.path.join(OUT, "w_vit-b16.npz"))
params = {}
for k in w.files:
    d = params
    *path, last = k.split("/")
    for q in path:
        d = d.setdefault(q, {})
    d[last] = jnp.asarray(w[k])
opt = adamw.init_state(params)
psh, osh, _ = b.in_shardings
tree = (jax.device_put(params, psh), jax.device_put(opt, osh))
assert not tree[0]["blocks"]["attn"]["wq"].sharding.is_fully_replicated
Checkpointer(os.path.join(OUT, "ref_ck")).save(1, tree, blocking=True)
"""

_RESTORE_12 = """
from torch.distributed.tensor import DTensor, Shard
from repro_torch.checkpoint import Checkpointer
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import param
from repro_torch.runtime.fault_tolerance import plan_elastic_mesh
from repro_torch.sharding import rules
plan = plan_elastic_mesh(WORLD, model_parallel=2)
mesh = make_host_mesh(model=plan.model, device="cpu")
assert tuple(mesh.shape) == (plan.data, plan.model) == (1, 2), mesh
b = steps.build_bundle("vit-b16", "cls_224", mesh, smoke=True)
aparams, aopt, _ = b.abstract_inputs
saved = np.load(os.path.join(OUT, "saved.npz"))
w = np.load(os.path.join(OUT, "w_vit-b16.npz"))
for ck, expect in (("port_ck", lambda k: saved[k]),
                   ("ref_ck", lambda k: w[k[2:]] if k.startswith("0/") else
                    np.zeros_like(saved[k]))):
    (p, o), step = Checkpointer(os.path.join(OUT, ck)).restore(
        (aparams, aopt), device="cpu", shardings=b.in_shardings[:2])
    assert step == 1
    psh = param.flatten(b.in_shardings[0])
    leaves = {f"0/{k}": (v, psh[k]) for k, v in param.flatten(p).items()}
    leaves.update({f"1/{t}/{k}": (v, psh[k]) for t in ("m", "v")
                   for k, v in param.flatten(o[t]).items()})
    leaves["1/step"] = (o["step"], b.in_shardings[1]["step"])
    split = 0
    for k, (v, sh) in leaves.items():
        assert isinstance(v, DTensor) and tuple(v.placements) == sh.placements(v.shape), k
        split += any(isinstance(pl, Shard) for pl in v.placements)
        assert np.array_equal(rules.to_global(v).numpy(), expect(k)), (ck, k)
    assert split > 0
dist.destroy_process_group()
"""


def test_elastic_restore_onto_the_survivors_mesh(tmp_path):
    np.savez(tmp_path / "w_vit-b16.npz", **_draw("vit-b16"))
    err = []
    t = threading.Thread(target=lambda: _catch(err, run_reference, _REFERENCE_SAVE, 4,
                                               tmp_path))
    t.start()
    run_ranks(_SAVE_22, 4, tmp_path)
    t.join()
    if err:
        raise err[0]
    run_ranks(_RESTORE_12, 2, tmp_path)


_CLI = """
import contextlib, io
from repro_torch.launch import train
args = ["--arch", "vit-b16", "--ckpt-dir", os.path.join(OUT, "ck"), "--ckpt-every", "2",
        "--log-every", "1", "--device", "cpu", "--mesh", "--mesh-model", "2"]
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    first = train.main(args + ["--steps", "3"])
    second = train.main(args + ["--steps", "2", "--resume"])
open(os.path.join(OUT, f"stdout{RANK}.txt"), "w").write(buf.getvalue())
np.savez(os.path.join(OUT, f"losses{RANK}.npz"), first=first.losses, second=second.losses)
dist.destroy_process_group()
"""


def test_cli_on_a_mesh_trains_and_resumes_as_the_unmeshed_run(tmp_path, capsys):
    run_ranks(_CLI, 2, tmp_path)
    ref = train.main(["--arch", "vit-b16", "--steps", "5", "--device", "cpu", "--log-every", "1",
                      "--ckpt-dir", str(tmp_path / "ref_ck")])
    ref_lines = [ln for ln in capsys.readouterr().out.splitlines() if " loss " in ln]
    assert (tmp_path / "stdout1.txt").read_text() == ""  # only rank 0 prints
    out = (tmp_path / "stdout0.txt").read_text()
    assert "[train] mesh (('data', 1), ('model', 2)) profile tp" in out
    assert "[train] resumed from step 3" in out
    assert [ln for ln in out.splitlines() if " loss " in ln] == ref_lines
    for rank in range(2):
        got = np.load(tmp_path / f"losses{rank}.npz")
        np.testing.assert_allclose(np.concatenate([got["first"], got["second"]]), ref.losses,
                                   rtol=LOSS_RTOL)
