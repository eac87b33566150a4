"""End-to-end training driver, PyTorch port of ``repro.launch.train``.

Runs any ``--arch`` at a train shape on one device (``cuda`` unless
``--device cpu``; no silent fallback), smoke config by default and the
published config with ``--full``: synthetic data (``data.pipeline``),
AdamW, microbatching, async checkpointing with restart-resume.

  PYTHONPATH=src python -m repro_torch.launch.train --arch vit-b16 --steps 50 --device cpu
  python -m repro_torch.launch.train --arch vit-l16 --shape cls_384 --full --steps 4
  python -m repro_torch.launch.train --arch vit-l16 --shape cls_384 --full --steps 2 \\
      --resume   # restores the latest checkpoint and continues

It prints the reference's ``[train] step ... loss ... gnorm ... lr`` lines,
checks that every step's loss is finite, and ends with the step time (the
median after the first step), images or tokens per second and model TFLOP/s
(the bundle's analytic ``model_flops`` over the median step).

On the host mesh (``launch.mesh.make_host_mesh``: ``--mesh-model`` ranks on
"model", the rest on "data"), with ``--mesh`` or whenever it runs under
``torchrun`` with ``WORLD_SIZE`` > 1: the bundle is sharded by the
architecture's ``train_profile``, params and moments are placed by its
``in_shardings`` (each rank its slices), every batch goes through
``place(..., shardings)``, ``--resume`` restores with ``shardings=`` (the
saving mesh may differ), saves gather the shards and rank 0 writes, and only
rank 0 prints.

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch vit-b16 --steps 4 --device cpu --mesh-model 2   # gloo, (2, 2)
  python -m repro_torch.launch.train --arch vit-l16 --shape cls_384 --full --steps 4 \
      --mesh   # one card: a (1, 1) NCCL mesh

Not copied from the reference:
- the params are drawn for the shape's config (``config_for_shape``), as the
  bundle's step uses it; the reference draws ``arch.config``'s, whose
  position table does not fit ``--full --shape cls_384`` (577 tokens, not
  197);
- a periodic checkpoint is labelled with the number of steps done (the
  step to resume at); the reference labels it with the step just run, so a
  resume from it would run that step's batch again;
- the default ``--ckpt-dir`` is under the temporary directory;
- the reference always trains on the host mesh; here one process without
  ``--mesh`` trains unsharded on plain tensors: on one card a (1, 1) mesh
  computes the same and only adds DTensor dispatch to every op.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import statistics
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import config_for_shape, get_arch
from repro_torch.data.pipeline import DataConfig, SyntheticData, place
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import _specs_for, build_bundle, place_inputs
from repro_torch.models import param as param_lib
from repro_torch.optim import adamw
from repro_torch.runtime.device import resolve_device


def host_batch(arch, cfg, data: SyntheticData, step: int, abstract_batch) -> dict:
    """Step ``step``'s numpy batch for ``arch``'s family, shaped as the
    bundle's abstract batch."""
    fam = arch.family
    if fam == "lm":
        b, s = abstract_batch["tokens"].shape
        return data.tokens(step, b, s, cfg.vocab)
    if fam in ("vit", "swin", "resnet"):
        b, r, _, c = abstract_batch["images"].shape
        out = data.images(step, b, r, c)
        out["labels"] = out["labels"] % cfg.n_classes
        return out
    if fam == "dit":
        b, r, _, c = abstract_batch["latents"].shape
        out = data.latents(step, b, r, c)
        out["labels"] = out["labels"] % cfg.n_classes
        return out
    if fam == "flux":
        b, r, _, c = abstract_batch["latents"].shape
        return data.flux_batch(step, b, r, cfg.txt_len, cfg.t5_dim, cfg.clip_dim, c)
    raise ValueError(fam)


@dataclasses.dataclass
class TrainResult:
    params: dict
    opt: dict
    start_step: int
    losses: list[float]      # every step's loss
    step_s: list[float]      # every step's wall seconds, closed by a synchronize
    model_flops: float       # of one step
    samples_per_step: int    # images (or sequences) a step
    accum: int

    def median_step_s(self) -> float:
        """Median step time after the first step (which warms up)."""
        return statistics.median(self.step_s[1:] or self.step_s)


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None, help="default: first train shape")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--full", action="store_true",
                    help="full config (default: smoke config)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--mesh", action="store_true",
                    help="train sharded on the host mesh (always under torchrun "
                         "with WORLD_SIZE > 1)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="model-axis size of the host mesh")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = None
    if args.mesh or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        mesh = make_host_mesh(model=args.mesh_model, device=device)
    lead = mesh is None or dist.get_rank() == 0

    def say(line: str) -> None:
        if lead:
            print(line)

    arch = get_arch(args.arch)
    shape_name = args.shape or next(s.name for s in arch.shapes if s.kind == "train")
    shape = arch.shape(shape_name)
    if shape.kind != "train":
        raise ValueError(f"{args.arch}/{shape_name} is a {shape.kind} shape, not train")
    bundle = build_bundle(args.arch, shape_name, mesh, smoke=not args.full)
    aparams, aopt, abatch = bundle.abstract_inputs
    cfg = config_for_shape(arch, shape, smoke=not args.full)
    if mesh is not None:
        say(f"[train] mesh {tuple(bundle.rules.shape.items())} profile {arch.train_profile}")

    ckpt = Checkpointer(args.ckpt_dir)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        shardings = None if mesh is None else bundle.in_shardings[:2]
        (params, opt), start_step = ckpt.restore((aparams, aopt), device=device,
                                                 shardings=shardings)
        say(f"[train] resumed from step {start_step}")
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        params = param_lib.init_params(_specs_for(arch.family, cfg), gen, device=device,
                                       dtype=getattr(cfg, "dtype", None))
        opt = adamw.init_state(params)
        params, opt = place_inputs(bundle, params, opt)

    data = SyntheticData(DataConfig())
    end = start_step + args.steps
    losses, step_s = [], []
    t_start = time.perf_counter()
    for step in range(start_step, end):
        batch = place(host_batch(arch, cfg, data, step, abatch), device,
                      None if mesh is None else bundle.in_shardings[2])
        t0 = time.perf_counter()
        params, opt, metrics = bundle.step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        if not math.isfinite(loss):
            raise FloatingPointError(f"loss diverged at step {step}: {loss}")
        if step % args.log_every == 0 or step == end - 1:
            say(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}")
        if (step + 1) % args.ckpt_every == 0 and step + 1 < end:
            ckpt.save(step + 1, (params, opt))
    ckpt.save(end, (params, opt), blocking=True)  # its host copy waits for the card
    dt = time.perf_counter() - t_start

    samples = next(iter(abatch.values())).shape[0]
    tokens = samples * abatch["tokens"].shape[1] if "tokens" in abatch else samples
    res = TrainResult(params, opt, start_step, losses, step_s, bundle.model_flops,
                      samples, bundle.accum)
    med = res.median_step_s()
    unit = "tokens/s" if "tokens" in abatch else "images/s"
    say(f"[train] {args.steps} steps in {dt:.1f}s ({args.steps / dt:.2f} steps/s); "
          f"checkpoints in {args.ckpt_dir}")
    say(f"[train] {bundle.name} on {device} (accum {bundle.accum}): step "
          f"{med * 1e3:.2f} ms (median after the first), {tokens / med:.1f} {unit}, "
          f"model {bundle.model_flops / med / 1e12:.2f} TFLOP/s")
    return res


if __name__ == "__main__":
    main()
