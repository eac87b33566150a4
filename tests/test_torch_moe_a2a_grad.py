"""Gradients through the port's all-to-all MoE dispatch
(``models/moe_a2a.py``), on the CPU.

The loss is ``sum(y * gy) + 0.3 * aux`` on the config of
``tests/test_torch_moe_a2a.py`` (d 32, ff 16, 8 experts, top 2). Ranks of a
gloo group at meshes (1,2), (1,4) and (2,2) take the gradient of every
param leaf (router, ``w_gate``, ``w_up``, ``w_down``) and of the input x,
with the inputs plain global tensors and again placed as DTensors under
``ep_tp`` rules; each is held against ``jax.grad`` of the same loss through
the reference's ``moe_a2a.apply`` on host devices (an Auto-axes ``Mesh``),
within 1e-5 of the largest gradient entry. At ``capacity_factor`` 8.0 no
token is dropped, so the gradient of ``sum(y * gy)`` alone must also be
``moe.apply``'s (the gspmd path, one process), within 1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.models import moe

from _ranks import run_ranks, run_reference

# -n 6 workers, each running 8 intra-op threads on 8 cores, oversubscribe the CPU
# (a 2 s case took 150 s among six copies): one thread a worker
torch.set_num_threads(1)

CASES = [((1, 2), 8.0), ((1, 4), 8.0), ((2, 2), 8.0), ((2, 2), 1.25)]
LEAVES = ("router", "w_gate", "w_up", "w_down")
AUX = 0.3

_REFERENCE = """
import os
import jax, jax.numpy as jnp, numpy as np
import repro.models
from repro.models import moe, moe_a2a, param
out = {}
for (dp, tp), cf in %r:
    cfg = moe.MoEConfig(d_model=32, d_ff=16, n_experts=8, top_k=2, capacity_factor=cf,
                        group_size=32)
    params = param.init_params(moe.specs(cfg), jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (4, 16, 32))
    gy = jax.random.normal(jax.random.key(2), (4, 16, 32))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp),
                             ("data", "model"))

    def loss(p, x):
        y, aux = moe_a2a.apply(p, cfg, x, mesh)
        return jnp.sum(y * gy) + %r * aux

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    tag = f"{dp}x{tp}_{cf}"
    for k in %r:
        out[f"{tag}/{k}"] = np.asarray(gp[k])
    out[f"{tag}/x"] = np.asarray(gx)
out["x"], out["gy"] = np.asarray(x), np.asarray(gy)
for k, v in params.items():
    out["p/" + k] = np.asarray(v)
np.savez(os.path.join(os.environ["OUT"], "reference.npz"), **out)
""" % (CASES, AUX, LEAVES)

_RANK = """
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe, moe_a2a, param
from repro_torch.sharding import rules
ref = np.load(os.path.join(OUT, "reference.npz"))
x0, gy = torch.from_numpy(ref["x"]), torch.from_numpy(ref["gy"])
p0 = {k[2:]: torch.from_numpy(ref[k]) for k in ref.files if k.startswith("p/")}
tp = int(os.environ["TP"])
mesh = make_host_mesh(model=tp, device="cpu")
out = {}
for (dp, mtp), cf in %r:
    if (dp, mtp) != tuple(mesh.shape):
        continue
    cfg = moe.MoEConfig(d_model=32, d_ff=16, n_experts=8, top_k=2, capacity_factor=cf,
                        group_size=32)
    tag = f"{dp}x{mtp}_{cf}"
    # plain global inputs
    p = {k: v.clone().requires_grad_() for k, v in p0.items()}
    x = x0.clone().requires_grad_()
    y, aux = moe_a2a.apply(p, cfg, x, mesh)
    (torch.sum(y * gy) + %r * aux).backward()
    for k in p:
        out[f"plain/{tag}/{k}"] = p[k].grad.numpy()
    out[f"plain/{tag}/x"] = x.grad.numpy()
    if cf == 8.0:  # no drop: the gradient of sum(y * gy) alone, for moe.apply's
        p = {k: v.clone().requires_grad_() for k, v in p0.items()}
        x = x0.clone().requires_grad_()
        torch.sum(moe_a2a.apply(p, cfg, x, mesh)[0] * gy).backward()
        for k in p:
            out[f"y/{tag}/{k}"] = p[k].grad.numpy()
        out[f"y/{tag}/x"] = x.grad.numpy()
    # DTensors placed by the ep_tp rules, as the LM's layers see them
    r = rules.make_rules("ep_tp", mesh)
    placed = rules.place_params({k: v.clone() for k, v in p0.items()}, moe.specs(cfg), r)
    for v in placed.values():
        v.requires_grad_()
    xd = r.place(x0.clone(), ("batch", None, None)).requires_grad_()
    with rules.use_rules(r):
        y, aux = moe_a2a.apply(placed, cfg, xd, mesh)
        loss = torch.sum(rules.to_global(y) * gy) + %r * rules.to_global(aux)
    loss.backward()
    for k, v in placed.items():
        out[f"dtensor/{tag}/{k}"] = rules.to_global(v.grad).numpy()
    out[f"dtensor/{tag}/x"] = rules.to_global(xd.grad).numpy()
np.savez(os.path.join(OUT, f"rank{WORLD // tp}x{tp}_{RANK}.npz"), **out)
dist.destroy_process_group()
""" % (CASES, AUX, AUX)


@pytest.fixture(scope="module")
def grads(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_a2a_grad")
    run_reference(_REFERENCE, 4, tmp)
    for (dp, tp) in sorted({m for m, _ in CASES}):
        run_ranks(_RANK, dp * tp, tmp, env={"TP": str(tp)})
    return tmp


@pytest.mark.parametrize("mesh,cf", CASES)
@pytest.mark.parametrize("inputs", ["plain", "dtensor"])
def test_grads_match_reference(grads, mesh, cf, inputs):
    ref = np.load(grads / "reference.npz")
    tag = f"{mesh[0]}x{mesh[1]}_{cf}"
    for r in range(mesh[0] * mesh[1]):
        got = np.load(grads / f"rank{mesh[0]}x{mesh[1]}_{r}.npz")
        for k in (*LEAVES, "x"):
            want = ref[f"{tag}/{k}"]
            assert np.abs(want).max() > 0, (tag, k)
            np.testing.assert_allclose(got[f"{inputs}/{tag}/{k}"], want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=f"rank {r} {tag} {k}")


@pytest.mark.parametrize("mesh", [m for m, cf in CASES if cf == 8.0])
def test_grads_match_moe_apply(grads, mesh):
    ref = np.load(grads / "reference.npz")
    cfg = moe.MoEConfig(d_model=32, d_ff=16, n_experts=8, top_k=2, capacity_factor=8.0,
                        group_size=32)
    p = {k: torch.from_numpy(ref["p/" + k]).requires_grad_() for k in LEAVES}
    x = torch.from_numpy(ref["x"]).requires_grad_()
    torch.sum(moe.apply(p, cfg, x)[0] * torch.from_numpy(ref["gy"])).backward()
    tag = f"{mesh[0]}x{mesh[1]}_8.0"
    for r in range(mesh[0] * mesh[1]):
        got = np.load(grads / f"rank{mesh[0]}x{mesh[1]}_{r}.npz")
        for k, v in [*((k, p[k]) for k in LEAVES), ("x", x)]:
            want = v.grad.numpy()
            np.testing.assert_allclose(got[f"y/{tag}/{k}"], want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=f"rank {r} {tag} {k}")
