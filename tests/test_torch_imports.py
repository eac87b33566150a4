"""Import hygiene of the port, and its no-silent-CPU rule.

``repro_torch`` imports torch, numpy and the standard library only: never
``jax`` and never the reference package ``repro``. Its entry points run on
``cuda`` unless the caller passes ``device="cpu"``, and raise without a card.
"""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(len(names), "modules;", "foreign:", bad)
print("imported:", " ".join(names))
sys.exit(1 if bad else 0)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"  # one intra-op thread a process beside the -n 6 workers
    return env


def test_port_imports_neither_jax_nor_the_reference():
    res = subprocess.run([sys.executable, "-c", _PROBE], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "foreign: []" in res.stdout
    imported = res.stdout.split("imported:")[1].split()
    for name in ("repro_torch.sharding", "repro_torch.sharding.rules", "repro_torch.launch.mesh",
                 "repro_torch.models.moe_a2a", "repro_torch.examples.train_e2e",
                 "repro_torch.examples.elastic_failover"):
        assert name in imported, name


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.configs import janus_vit_l384
    from repro_torch.core import engine
    from repro_torch.launch import serve
    from repro_torch.models import param, vit

    profile = serve.make_profile(janus_vit_l384.CONFIG)
    with pytest.raises(RuntimeError, match="cuda"):
        engine.JanusEngine(profile, engine.EngineConfig(sla_s=0.3))
    with pytest.raises(RuntimeError, match="cuda"):
        param.init_params(vit.specs(janus_vit_l384.SMOKE), torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--frames", "1"])
    engine.JanusEngine(profile, engine.EngineConfig(sla_s=0.3), device="cpu")


def test_serving_entry_points_raise_without_a_card():
    """The fleet, the workload builder and the CLI's fleet mode run on
    ``cuda`` unless told ``device="cpu"``; so does the host mesh, whose
    group is NCCL on ``cuda`` and never falls back to gloo."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.configs import janus_vit_l384
    from repro_torch.core import bandwidth, engine
    from repro_torch.launch import serve
    from repro_torch.serving import fleet, workload

    profile = serve.make_profile(janus_vit_l384.CONFIG)
    cfg = engine.EngineConfig(sla_s=0.3)
    streams = [fleet.StreamSpec(bandwidth.synthetic_trace("4g", "driving", steps=2, seed=0), 2)]
    spec = workload.WorkloadSpec(n_streams=2, n_frames=2)
    with pytest.raises(RuntimeError, match="cuda"):
        fleet.FleetRuntime(profile, cfg, streams)
    with pytest.raises(RuntimeError, match="cuda"):
        workload.build_runtime(spec, profile, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--streams", "2", "--execute"])
    from repro_torch.launch.mesh import make_host_mesh
    with pytest.raises(RuntimeError, match="cuda"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--streams", "2", "--execute", "--mesh", "dp"])
    rt = workload.build_runtime(spec, profile, cfg, device="cpu")
    assert {e.device for e in rt.engines} == {torch.device("cpu")}
    assert len(rt.run().all_frames) == 4
    fleet.FleetRuntime(profile, cfg, streams, device="cpu")


def test_generation_and_registry_models_raise_without_a_card():
    """The samplers draw their noise, and every registry architecture's
    params are built, on ``cuda`` unless told ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch import configs
    from repro_torch.configs import dit_s2, flux_dev
    from repro_torch.models import dit, flux, lm, param, resnet, swin, vit
    from repro_torch.training import diffusion

    family = {"vit": vit, "swin": swin, "resnet": resnet, "lm": lm, "dit": dit, "flux": flux}
    for name in configs.list_archs():
        arch = configs.get_arch(name)
        specs = family[arch.family].specs(arch.smoke_config)
        with pytest.raises(RuntimeError, match="cuda"):
            param.init_params(specs, torch.Generator())
        param.init_params(specs, torch.Generator(), device="cpu")

    gen = torch.Generator().manual_seed(0)
    dcfg, fcfg = dit_s2.SMOKE, flux_dev.SMOKE
    dp = param.init_params(dit.specs(dcfg), gen, "cpu")
    fp = param.init_params(flux.specs(fcfg), gen, "cpu")
    y = torch.tensor([1, 2])
    txt, vec = torch.zeros((2, fcfg.txt_len, fcfg.t5_dim)), torch.zeros((2, fcfg.clip_dim))
    with pytest.raises(RuntimeError, match="cuda"):
        diffusion.dit_sample(dp, dcfg, gen, y, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        diffusion.dit_sample(dp, dcfg, gen, y, 1, schedule=(3, 2))
    with pytest.raises(RuntimeError, match="cuda"):
        diffusion.flux_sample(fp, fcfg, gen, txt, vec, 1)
    assert diffusion.dit_sample(dp, dcfg, gen, y, 1, schedule=(3, 2), device="cpu").shape == (
        2, dcfg.latent_res, dcfg.latent_res, dcfg.latent_channels)
    assert diffusion.flux_sample(fp, fcfg, gen, txt, vec, 1, device="cpu").shape == (
        2, fcfg.latent_res, fcfg.latent_res, fcfg.latent_channels)


def test_engine_rejects_tensors_on_another_device():
    """The engine moves nothing between devices: params or images that do
    not lie on its device raise instead of running there."""
    from repro_torch.configs import janus_vit_l384
    from repro_torch.core import bandwidth, engine
    from repro_torch.launch import serve
    from repro_torch.models import param, vit

    cfg = janus_vit_l384.SMOKE
    profile = serve.make_profile(janus_vit_l384.CONFIG)
    eng_cfg = engine.EngineConfig(sla_s=0.3, execute=True)
    params = param.init_params(vit.specs(cfg), torch.Generator().manual_seed(0), "cpu")
    on_meta = param.tree_map(lambda a: a.to("meta"), params)
    with pytest.raises(ValueError, match="meta"):
        engine.JanusEngine(profile, eng_cfg, model_cfg=cfg, params=on_meta, device="cpu")
    eng = engine.JanusEngine(profile, eng_cfg, model_cfg=cfg, params=params, device="cpu")
    images = torch.zeros((1, cfg.img_res, cfg.img_res, 3), device="meta")
    trace = bandwidth.synthetic_trace("4g", "driving", steps=1, seed=0)
    with pytest.raises(ValueError, match="images is on meta"):
        eng.run_trace(trace, 1, images=images)


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], env=_env(),
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_training_entry_points_raise_without_a_card(tmp_path):
    """The trainer, the data placement and the checkpoint restore run on
    ``cuda`` unless told ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import pipeline
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "vit-b16", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    batch = pipeline.SyntheticData().images(0, 2, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.place(batch)
    assert pipeline.place(batch, "cpu")["images"].device.type == "cpu"
    ck = Checkpointer(tmp_path / "ck")
    tree = {"w": torch.zeros(2)}
    ck.save(1, tree, blocking=True)
    with pytest.raises(RuntimeError, match="cuda"):
        ck.restore(tree)
    assert ck.restore(tree, device="cpu")[1] == 1


def test_mesh_trainer_and_examples_raise_without_a_card(tmp_path):
    """The trainer's ``--mesh`` path and both examples run on ``cuda``
    unless told ``--device cpu``: no fallback, no process group started."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    import torch.distributed as dist

    from repro_torch.examples import elastic_failover, train_e2e
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "vit-b16", "--steps", "1", "--mesh", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        train_e2e.main(["--steps", "2", "--ckpt-dir", str(tmp_path / "e2e")])
    with pytest.raises(RuntimeError, match="cuda"):
        elastic_failover.main(["--ckpt-dir", str(tmp_path / "el")])
    assert not dist.is_initialized()
