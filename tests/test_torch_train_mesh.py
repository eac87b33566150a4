"""The port's sharded train step against the reference's, on real splits.

Each case runs the reference's ``build_bundle(arch, first train shape, mesh,
smoke=True).jitted()`` on an Auto ("data", "model") mesh of 4 host devices,
and the port's sharded bundle on 4 gloo ranks at the same mesh shape
(``tests/_ranks.py``), one step from the same numpy-drawn weights (as
``tests/test_torch_train.py`` draws them: every ``zeros`` leaf from
N(0, 0.02^2)) on ``SyntheticData``'s batch of step 0. The diffusion losses
get the reference's own ``jax.random`` draws of step 0 (``fold_in(PRNGKey(0),
0)``) through ``dit_loss_given`` / ``flux_loss_given``; the port's own noise
draw on a mesh is held against its one-device step instead.

Held to ``tests/test_torch_train.py``'s tolerances: the loss rel 1e-5,
grad_norm rel 1e-4, lr rel 1e-6, every updated param within 2e-4 of the
leaf's max|p| plus 2 lr (one step), ``m`` (a clipped gradient times 0.1) and
``sqrt(v)`` (|g| times sqrt(0.05)) by the gradient bounds: within 1e-4 of
the largest of any leaf, and 2e-4 of the leaf's own max unless that is below
1e-6 of the largest. The reference agrees with itself across mesh shapes to
2.7e-6 in the loss and 3.4e-5 in grad_norm. Each rank also checks that every
leaf comes back placed as the bundle's ``in_shardings`` (a leaf sharded on
"model" stays sharded), and runs the port's one-device step beside the
sharded one (the same tolerances).
"""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.configs import config_for_shape, get_arch
from repro_torch.launch import steps
from repro_torch.models import param

from _ranks import run_ranks, run_reference
from test_torch_train import GRAD_OF_LEAF, GRAD_OF_MAX, LOSS_RTOL, ROUNDING_ONLY
import torch

# -n 6 workers, each running 8 intra-op threads on 8 cores, oversubscribe the CPU
# (a 2 s case took 150 s among six copies): one thread a worker
torch.set_num_threads(1)

FAMILIES = ("vit-b16", "swin-b", "resnet-152", "starcoder2-3b", "qwen3-moe-30b-a3b",
            "dit-s2", "flux-dev")
GNORM_RTOL = 1e-4
LR_RTOL = 1e-6


def _draw(name: str, seed: int = 0) -> dict:
    """Flat numpy weights of ``name``'s smoke config (keys "a/b/c")."""
    arch = get_arch(name)
    shape = next(s for s in arch.shapes if s.kind == "train")
    cfg = config_for_shape(arch, shape, smoke=True)
    rng = np.random.default_rng(seed)
    flat = {}
    for k, spec in param.flatten(steps._specs_for(arch.family, cfg)).items():
        if spec.init == "ones":
            flat[k] = np.ones(spec.shape, np.float32)
        else:
            std = 0.02 if spec.init == "zeros" else param._std(spec)
            flat[k] = (std * rng.standard_normal(spec.shape)).astype(np.float32)
    return flat


def _diffusion_draws(name: str) -> dict:
    """The reference's draws of step 0 inside its dit/flux loss."""
    arch = get_arch(name)
    cfg = arch.smoke_config
    b, lres = 2, cfg.latent_res
    k1, k2 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 0))
    shape = (b, lres, lres, cfg.latent_channels)
    if arch.family == "dit":
        t = jax.random.uniform(k1, (b,)) * 999.0
    else:
        t = jax.nn.sigmoid(jax.random.normal(k1, (b,)))
    return {"t": np.asarray(t), "noise": np.asarray(jax.random.normal(k2, shape, jnp.float32))}


def _inputs(tmp, names):
    for name in names:
        np.savez(tmp / f"w_{name}.npz", **_draw(name))
        if get_arch(name).family in ("dit", "flux"):
            np.savez(tmp / f"draws_{name}.npz", **_diffusion_draws(name))


_REFERENCE = """
import json, os
import jax, jax.numpy as jnp, numpy as np
import repro.models
from repro.configs import get_arch
from repro.data.pipeline import DataConfig, SyntheticData, place
from repro.launch import steps, train
from repro.models import vit
from repro.optim import adamw
from repro.sharding.rules import make_rules
OUT = os.environ["OUT"]
SHAPE = tuple(json.loads(os.environ["MESH"]))
ACCUM = int(os.environ.get("ACCUM", "1"))
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(SHAPE), ("data", "model"))

def nest(flat):
    out = {}
    for k, v in flat.items():
        d = out
        *path, last = k.split("/")
        for p in path:
            d = d.setdefault(p, {})
        d[last] = jnp.asarray(v)
    return out

def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out

for name in json.loads(os.environ["ARCHS"]):
    arch = get_arch(name)
    shape = next(s for s in arch.shapes if s.kind == "train")
    b = steps.build_bundle(name, shape.name, mesh, smoke=True)
    cfg = arch.smoke_config
    w = np.load(os.path.join(OUT, f"w_{name}.npz"))
    params = nest({k: w[k] for k in w.files})
    opt = adamw.init_state(params)
    abatch = b.abstract_inputs[2]
    step_fn = b.jitted()
    if ACCUM > 1:  # vit: the bundle's loss at accum=2 over a doubled batch
        abatch = {k: jax.ShapeDtypeStruct((2 * v.shape[0],) + v.shape[1:], v.dtype)
                  for k, v in abatch.items()}
        def loss_fn(p, bt, step):
            return steps._ce_loss(vit.forward(p, cfg, bt["images"]), bt["labels"])
        step_fn = jax.jit(steps._train_wrap(loss_fn, adamw.AdamWConfig(),
                                            make_rules(arch.train_profile, mesh), ACCUM),
                          in_shardings=b.in_shardings, out_shardings=b.out_shardings)
    hb = train.host_batch(arch, cfg, SyntheticData(DataConfig()), 0, abatch)
    psh, osh, bsh = b.in_shardings
    p, o, m = step_fn(jax.device_put(params, psh), jax.device_put(opt, osh), place(hb, bsh))
    res = {f"metric/{k}": np.asarray(v) for k, v in m.items()}
    res.update({f"p/{k}": v for k, v in flat(p).items()})
    res.update({f"m/{k}": v for k, v in flat(o["m"]).items()})
    res.update({f"v/{k}": v for k, v in flat(o["v"]).items()})
    np.savez(os.path.join(OUT, f"ref_{name}.npz"), **res)
"""

_RANKS = """
import json
from torch.distributed.tensor import DTensor, Shard
from repro_torch.configs import config_for_shape, get_arch
from repro_torch.data import pipeline
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import param
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from repro_torch.training import diffusion
SHAPE = tuple(json.loads(os.environ["MESH"]))
ACCUM = int(os.environ.get("ACCUM", "1"))
mesh = make_host_mesh(model=SHAPE[1], device="cpu")
assert tuple(mesh.shape) == SHAPE, mesh
dit_loss, flux_loss = diffusion.dit_loss, diffusion.flux_loss

def fresh(name):
    w = np.load(os.path.join(OUT, f"w_{name}.npz"))
    p = param.from_jax_params({k: w[k] for k in w.files}, "cpu")
    return p, adamw.init_state(p)

def given_draws(name):
    d = np.load(os.path.join(OUT, f"draws_{name}.npz"))
    t, noise = torch.from_numpy(d["t"]), torch.from_numpy(d["noise"])
    diffusion.dit_loss = lambda p, cfg, lat, y, gen: diffusion.dit_loss_given(
        p, cfg, lat, y, t, noise)
    diffusion.flux_loss = lambda p, cfg, lat, txt, vec, gen: diffusion.flux_loss_given(
        p, cfg, lat, txt, vec, t, noise)

def results(params, opt, metrics):
    out = {f"metric/{k}": rules.to_global(v).numpy() for k, v in metrics.items()}
    for tag, tree in (("p", params), ("m", opt["m"]), ("v", opt["v"])):
        out.update({f"{tag}/{k}": rules.to_global(v).numpy()
                    for k, v in param.flatten(tree).items()})
    return out

def run(name, save_as):
    arch = get_arch(name)
    shape = next(s for s in arch.shapes if s.kind == "train")
    cfg = config_for_shape(arch, shape, smoke=True)
    b0 = steps.build_bundle(name, shape.name, smoke=True)
    b1 = steps.build_bundle(name, shape.name, mesh, smoke=True)
    abatch = b0.abstract_inputs[2]
    step0, step1 = b0.step_fn, b1.step_fn
    if ACCUM > 1:
        abatch = {k: torch.empty((2 * v.shape[0],) + v.shape[1:], dtype=v.dtype, device="meta")
                  for k, v in abatch.items()}
        step0 = steps._train_wrap(b0.loss_fn, adamw.AdamWConfig(), ACCUM)
        step1 = steps._train_wrap(b1.loss_fn, adamw.AdamWConfig(), ACCUM, b1.rules)
    hb = train.host_batch(arch, cfg, pipeline.SyntheticData(), 0, abatch)
    p0, o0 = fresh(name)
    p0, o0, m0 = step0(p0, o0, pipeline.place(hb, "cpu"))
    p1, o1 = steps.place_inputs(b1, *fresh(name))
    p1, o1, m1 = step1(p1, o1, pipeline.place(hb, "cpu", b1.in_shardings[2]))
    # every leaf keeps its placement: no sharded param or moment is gathered
    psh = param.flatten(b1.in_shardings[0])
    split = 0
    for tree in (p1, o1["m"], o1["v"]):
        for k, v in param.flatten(tree).items():
            want = psh[k].placements(v.shape)
            assert isinstance(v, DTensor) and tuple(v.placements) == want, (name, k, v.placements)
            split += any(isinstance(pl, Shard) and mesh.size(i) > 1
                         for i, pl in enumerate(want))
    out = results(p1, o1, m1)
    one = results(p0, o0, m0)
    if RANK == 0:
        np.savez(os.path.join(OUT, f"{save_as}_{name}.npz"), **out)
        np.savez(os.path.join(OUT, f"one_{save_as}_{name}.npz"), **one,
                 split=np.array(split))

for name in json.loads(os.environ["ARCHS"]):
    if get_arch(name).family in ("dit", "flux"):
        run(name, "own")  # the port's own noise: one device against the mesh
        given_draws(name)
    run(name, "port")
    diffusion.dit_loss, diffusion.flux_loss = dit_loss, flux_loss
dist.destroy_process_group()
"""


def _run_both(tmp, names, mesh, accum=1):
    """The reference (4 host devices) and the port (4 gloo ranks),
    concurrently, at mesh shape ``mesh``."""
    _inputs(tmp, names)
    env = {"MESH": json.dumps(list(mesh)), "ARCHS": json.dumps(list(names)),
           "ACCUM": str(accum)}
    err = []

    def reference():
        try:
            run_reference(_REFERENCE, 4, tmp, timeout=600, env=env)
        except Exception as e:  # noqa: BLE001  (re-raised below)
            err.append(e)
    t = threading.Thread(target=reference)
    t.start()
    run_ranks(_RANKS, 4, tmp, timeout=600, env=env)
    t.join()
    if err:
        raise err[0]


def _leaf_bounds(got: dict, exp: dict, prefix: str, grad_like: bool, lr: float) -> None:
    keys = [k for k in exp if k.startswith(prefix)]
    assert keys and {k for k in got if k.startswith(prefix)} == set(keys)
    if not grad_like:
        for k in keys:
            err = float(np.abs(got[k] - exp[k]).max())
            bound = 2e-4 * float(np.abs(exp[k]).max()) + 2 * lr
            assert err <= bound, (k, err, bound)
        return
    top = max(float(np.abs(exp[k]).max()) for k in keys)
    for k in keys:
        err, own = float(np.abs(got[k] - exp[k]).max()), float(np.abs(exp[k]).max())
        assert err <= GRAD_OF_MAX * top, (k, err, top)
        if own >= ROUNDING_ONLY * top:
            assert err <= GRAD_OF_LEAF * own, (k, err, own)


def _check(got, exp, name) -> None:
    got, exp = dict(got), dict(exp)
    np.testing.assert_allclose(got["metric/loss"], exp["metric/loss"], rtol=LOSS_RTOL,
                               err_msg=name)
    np.testing.assert_allclose(got["metric/grad_norm"], exp["metric/grad_norm"],
                               rtol=GNORM_RTOL, err_msg=name)
    np.testing.assert_allclose(got["metric/lr"], exp["metric/lr"], rtol=LR_RTOL, err_msg=name)
    lr = float(exp["metric/lr"])
    _leaf_bounds(got, exp, "p/", False, lr)
    _leaf_bounds(got, exp, "m/", True, lr)
    for k in [k for k in exp if k.startswith("v/")]:
        got[k], exp[k] = np.sqrt(got[k]), np.sqrt(exp[k])
    _leaf_bounds(got, exp, "v/", True, lr)


def _check_all(tmp, names, model_split: bool) -> None:
    for name in names:
        port = np.load(tmp / f"port_{name}.npz")
        _check(port, np.load(tmp / f"ref_{name}.npz"), name)
        one = np.load(tmp / f"one_port_{name}.npz")
        _check(port, one, name)  # sharded against the port's one-device step
        if model_split:
            assert int(one["split"]) > 0, name  # some leaves are split, and stay so
        if get_arch(name).family in ("dit", "flux"):
            _check(np.load(tmp / f"own_{name}.npz"), np.load(tmp / f"one_own_{name}.npz"), name)


@pytest.mark.parametrize("names", [FAMILIES[:4], FAMILIES[4:]],
                         ids=["vision+starcoder2", "moe+diffusion"])
def test_sharded_step_matches_reference_at_2x2(tmp_path, names):
    _run_both(tmp_path, names, (2, 2))
    _check_all(tmp_path, names, True)
