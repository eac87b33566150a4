"""Step builders, PyTorch port of ``repro.launch.steps`` on one device.

One ``StepBundle`` per (architecture x shape): the step function, its
abstract inputs (meta-device tensors: shapes and dtypes, no memory), the
analytic model FLOPs of one step, and the microbatch count. The train
driver runs the train bundles; the serving bundles are thin wrappers over
the port's ``prefill``/``decode_step``, ``forward`` and samplers.

A train step is ``_train_wrap``: the loss and its gradient by autograd
(through the flash kernel's backward on the card), microbatches summed in
f32 in order and divided by ``accum``, then AdamW (``optim.adamw``, in
place). Params enter as plain tensors; the step differentiates detached
aliases of them, so the caller's tensors never require grad.

With a ``mesh`` (a ``DeviceMesh``), a serving bundle (serve, prefill,
decode, gen) builds its rules from the architecture's ``serve_profile``:
``in_shardings`` / ``out_shardings`` are trees of ``spec_for`` specs
matching the step's arguments and results, ``place_inputs`` places
concrete arguments by them (each rank's slice as a view), and the step runs
under ``use_rules``. A train shape with a mesh raises: the sharded train
step comes with the training mesh, the next slice of the port (ROADMAP.md
queue 1).
Not ported: ``donate_argnums`` and ``lower``/``jitted`` (ahead-of-time
compilation, item 7), nor ``build_bundle``'s ``config_patch``,
``janus_alpha`` and ``optimizer``, whose only caller is the hill-climb tool
(item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch

from repro_torch.configs import config_for_shape, get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.models import dit as dit_lib
from repro_torch.models import flux as flux_lib
from repro_torch.models import lm as lm_lib
from repro_torch.models import param as param_lib
from repro_torch.models import resnet as resnet_lib
from repro_torch.models import swin as swin_lib
from repro_torch.models import vit as vit_lib
from repro_torch.optim import adamw
from repro_torch.sharding import rules as rules_lib
from repro_torch.training import diffusion


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass
class StepBundle:
    name: str
    step_fn: Callable
    abstract_inputs: tuple   # meta-device tensors, in step_fn's argument order
    model_flops: float       # analytic MODEL_FLOPS of the whole step
    accum: int = 1           # microbatches of a train step
    notes: str = ""
    loss_fn: Callable | None = None  # a train step's loss(params, batch, step)
    in_shardings: Any = None     # spec trees of the arguments (with a mesh)
    out_shardings: Any = None    # spec trees of the results (with a mesh)
    rules: Any = None            # the serve profile's Rules (with a mesh)


def place_inputs(bundle: StepBundle, *args) -> tuple:
    """``args`` placed by ``bundle.in_shardings`` on its mesh: every tensor
    leaf as a DTensor holding this rank's slice (a view, no copy); leaves
    whose spec is None (the decode index) pass as they are. Without a mesh
    the arguments come back unchanged."""
    if bundle.rules is None:
        return args
    rules = bundle.rules

    def walk(x, spec):
        if spec is None:
            return x
        if isinstance(x, Mapping):
            return {k: walk(x[k], spec[k]) for k in x}
        if isinstance(x, list):
            return [walk(a, s) for a, s in zip(x, spec)]
        return rules_lib.place(x, rules.mesh, rules.placements(spec, x.shape))

    return tuple(walk(a, s) for a, s in zip(args, bundle.in_shardings))


def _specs_for(family: str, cfg):
    return {
        "vit": vit_lib.specs, "swin": swin_lib.specs, "resnet": resnet_lib.specs,
        "lm": lm_lib.specs, "dit": dit_lib.specs, "flux": flux_lib.specs,
    }[family](cfg)


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS (copied from the reference)
# ---------------------------------------------------------------------------


def transformer_model_flops(n_params: int, tokens: int, train: bool) -> float:
    return (6.0 if train else 2.0) * n_params * tokens


def moe_active_params(cfg: lm_lib.LMConfig, specs_tree) -> int:
    """Parameters touched per token: everything minus inactive experts."""
    total = param_lib.param_count(specs_tree)
    m = cfg.moe
    per_expert = 3 * m.d_model * m.d_ff
    inactive = (m.e_pad - m.top_k) * per_expert * cfg.n_layers
    return total - inactive


def swin_fwd_flops(cfg: swin_lib.SwinConfig, batch: int) -> float:
    """Per-stage 2·params·tokens plus the window-attention quadratic term."""
    f = 0.0
    hw = cfg.img_res // cfg.patch
    f += 2 * (cfg.patch ** 2 * cfg.in_channels) * cfg.dims[0] * hw * hw
    for i, depth in enumerate(cfg.depths):
        d = cfg.dims[i]
        tokens = hw * hw
        per_block = 4 * d * d + 2 * d * d * cfg.mlp_ratio  # qkvo + mlp
        f += 2 * depth * per_block * tokens
        f += depth * 2 * 2 * tokens * (cfg.window ** 2) * d  # window attn
        if i < len(cfg.depths) - 1:
            f += 2 * (4 * d) * cfg.dims[i + 1] * (hw // 2) ** 2
            hw //= 2
    f += 2 * cfg.dims[-1] * cfg.n_classes
    return f * batch


def flux_fwd_flops(cfg, batch: int) -> float:
    """Stream-aware: img-side double params see n_img tokens, txt-side see
    txt_len; single blocks see both."""
    d, ff = cfg.d_model, cfg.d_ff
    ni, nt = cfg.n_img_tokens, cfg.txt_len
    per_stream = 4 * d * d + 2 * d * ff + 6 * d * d  # qkvo + mlp + mod
    p_single = d * (3 * d + ff) + (d + ff) * d + 3 * d * d
    f = 2 * cfg.n_double * (per_stream * ni + per_stream * nt)
    f += 2 * cfg.n_single * p_single * (ni + nt)
    f += 2 * 2 * (cfg.n_double + cfg.n_single) * (ni + nt) ** 2 * d  # joint attn
    return f * batch


def resnet_fwd_flops(cfg: resnet_lib.ResNetConfig, batch: int) -> float:
    """Analytic conv MACs*2."""
    r = cfg.img_res
    f = 0.0
    f += 2 * 7 * 7 * cfg.in_channels * cfg.width * (r // 2) ** 2
    cin = cfg.width
    res = r // 4
    for i, depth in enumerate(cfg.depths):
        cmid = cfg.width * 2 ** i
        cout = cmid * cfg.expansion
        if i > 0:
            res //= 2
        for d in range(depth):
            ci = cin if d == 0 else cout
            f += 2 * res * res * (ci * cmid + 9 * cmid * cmid + cmid * cout)
            if d == 0:
                f += 2 * res * res * ci * cout
        cin = cout
    return f * batch


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def value_and_grad(loss_fn: Callable, params: dict, *args):
    """(loss, grads): ``loss_fn(params, *args)`` and its gradient in each
    param's dtype, zeros for a leaf the loss does not read (as JAX gives)."""
    flat = param_lib.flatten(params)
    live = {k: v.detach().requires_grad_() for k, v in flat.items()}
    with torch.enable_grad():
        loss = loss_fn(param_lib.unflatten(live), *args)
        grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), param_lib.unflatten(dict(zip(live, grads)))


def accumulated_grads(loss_fn: Callable, params: dict, batch: dict, step: torch.Tensor,
                      accum: int = 1):
    """(loss, grads) of one train step before the update. With ``accum`` > 1
    the batch splits into ``accum`` sequential microbatches along axis 0,
    their gradients summed in f32 in order and divided by ``accum``, the loss
    the mean of theirs; with 1, the grads keep the params' dtype."""
    if accum == 1:
        return value_and_grad(loss_fn, params, batch, step)
    gsum = param_lib.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    flat_sum = param_lib.flatten(gsum)
    losses = []
    for i in range(accum):
        mb = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
              for k, v in batch.items()}
        loss, grads = value_and_grad(loss_fn, params, mb, step)
        for key, g in param_lib.flatten(grads).items():
            flat_sum[key].add_(g)
        del grads
        losses.append(loss)
    for s in flat_sum.values():
        s.div_(accum)
    return torch.mean(torch.stack(losses)), gsum


def _train_wrap(loss_fn: Callable, ocfg: adamw.AdamWConfig, accum: int = 1):
    """Train step with optional microbatch gradient accumulation
    (``accumulated_grads``), then AdamW. ``step(params, opt, batch) ->
    (params, opt, metrics)``, params and opt updated in place."""
    def step(params, opt, batch):
        loss, grads = accumulated_grads(loss_fn, params, batch, opt["step"], accum)
        params, opt, metrics = adamw.apply_updates(ocfg, params, grads, opt)
        return params, opt, {"loss": loss, **metrics}
    return step


def pick_accum(global_batch: int, act_bytes_per_sample: float, dp: int,
               target_bytes_per_device: float = 64e6) -> int:
    """Smallest power-of-2 accumulation keeping the per-device live activation
    carry at or under target, while each microbatch still covers the DP extent."""
    accum = 1
    while (global_batch // (2 * accum) >= dp
           and global_batch % (2 * accum) == 0
           and (global_batch / dp) * act_bytes_per_sample / accum
               > target_bytes_per_device):
        accum *= 2
    return accum


def _vision_batch(shape: ShapeSpec) -> dict:
    return {"images": _meta((shape.batch, shape.img_res, shape.img_res, 3)),
            "labels": _meta((shape.batch,), torch.int32)}


def _ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy in f32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    true = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - true)


def _step_generator(device: torch.device, step: torch.Tensor) -> torch.Generator:
    """The diffusion losses' draws, seeded by the optimizer step (the
    reference folds the step into PRNGKey(0)); one host read of the step."""
    return torch.Generator(device=device).manual_seed(int(step))


def _sampler_generator(device: torch.device) -> torch.Generator:
    """The samplers' initial noise (the reference's PRNGKey(0))."""
    return torch.Generator(device=device).manual_seed(0)


class _Sharded:
    """A serving bundle's sharding on the rules' mesh: spec trees, the step
    run under the rules, and the bundle; without rules, no specs and the
    step as it is."""

    def __init__(self, rules, specs_tree):
        self.rules = rules
        self.params = None if rules is None else param_lib.tree_map(
            lambda s: rules.spec_for(s.shape, s.axes), specs_tree)

    def spec(self, shape, axes):
        return None if self.rules is None else self.rules.spec_for(tuple(shape), tuple(axes))

    def tree(self, tree, axes):
        """Specs of a dict (or list of dicts) of tensors; ``axes`` one tuple
        for every leaf or a dict of them by key."""
        if isinstance(tree, list):
            return [self.tree(t, axes) for t in tree]
        return {k: self.spec(v.shape, axes[k] if isinstance(axes, dict) else axes)
                for k, v in tree.items()}

    def bundle(self, name, step, inputs, in_sh, out_sh, flops, **kw) -> StepBundle:
        if self.rules is None:
            return StepBundle(name, step, inputs, flops, **kw)
        rules = self.rules

        def run(*args):
            with rules_lib.use_rules(rules):
                return step(*args)
        return StepBundle(name, run, inputs, flops, in_shardings=in_sh, out_shardings=out_sh,
                          rules=rules, **kw)


def build_bundle(arch_name: str, shape_name: str, mesh=None, *,
                 smoke: bool = False) -> StepBundle:
    """The bundle of ``arch_name`` at ``shape_name``; with ``mesh`` (serving
    shapes only) a sharded bundle (see the module docstring)."""
    arch = get_arch(arch_name)
    shape = arch.shape(shape_name)
    if shape.skip_reason and not smoke:
        raise SkipShape(arch_name, shape_name, shape.skip_reason)
    cfg = config_for_shape(arch, shape, smoke=smoke)
    train = shape.kind == "train"
    if train and mesh is not None:
        raise NotImplementedError(
            f"build_bundle({arch_name!r}, {shape_name!r}, mesh=...): the sharded train "
            "step is not ported yet; it comes with the training mesh, the next slice "
            "of the port (ROADMAP.md queue 1). Pass mesh=None for one device")
    specs_tree = _specs_for(arch.family, cfg)
    rules = None if mesh is None else rules_lib.make_rules(arch.serve_profile, mesh)
    sharded = _Sharded(rules, specs_tree)
    aparams = param_lib.abstract_params(specs_tree, dtype=getattr(cfg, "dtype", None))
    ocfg = adamw.AdamWConfig()
    n_params = param_lib.param_count(specs_tree)
    aopt = adamw.init_state(aparams) if train else None
    dp = 1
    name = f"{arch_name}/{shape_name}" + ("/smoke" if smoke else "")

    # ----------------------------------------------------- LM family
    if arch.family == "lm":
        active = moe_active_params(cfg, specs_tree) if cfg.moe else n_params
        gb, seq = shape.global_batch, shape.seq_len
        if train:
            if smoke:
                gb, seq = 4, 64
            batch = {"tokens": _meta((gb, seq), torch.int32)}

            def loss_fn(p, b, step):
                logits, aux = lm_lib.forward(p, cfg, b["tokens"])
                loss = lm_lib.lm_loss(logits[:, :-1], b["tokens"][:, 1:])
                return loss + cfg.aux_loss_coef * aux

            accum = 1 if smoke else pick_accum(gb, seq * cfg.d_model * 2, dp)
            return StepBundle(name, _train_wrap(loss_fn, ocfg, accum), (aparams, aopt, batch),
                              transformer_model_flops(active, gb * seq, True),
                              accum=accum, notes=f"accum={accum}", loss_fn=loss_fn)

        if shape.kind == "prefill":
            if smoke:
                gb, seq = 2, 64
            batch = {"tokens": _meta((gb, seq), torch.int32)}

            def step(params, batch):
                return lm_lib.prefill(params, cfg, batch["tokens"])

            acache = lm_lib.abstract_cache(cfg, gb, seq, dtype=cfg.cache_dtype)
            return sharded.bundle(
                name, step, (aparams, batch),
                (sharded.params, sharded.tree(batch, ("batch", "seq"))),
                (sharded.spec((gb, 1, cfg.vocab), ("batch", None, "act_vocab")),
                 sharded.tree(acache, lm_lib.cache_axes(cfg))),
                transformer_model_flops(active, gb * seq, False))

        # decode
        if smoke:
            gb, seq = 2, 64
        batch = {"token": _meta((gb, 1), torch.int32)}
        acache = lm_lib.abstract_cache(cfg, gb, seq, dtype=cfg.cache_dtype)

        def step(params, batch, cache, index):
            return lm_lib.decode_step(params, cfg, batch["token"], cache, index)

        cache_sh = sharded.tree(acache, lm_lib.cache_axes(cfg))
        return sharded.bundle(
            name, step, (aparams, batch, acache, 0),
            (sharded.params, sharded.tree(batch, ("batch", None)), cache_sh, None),
            (sharded.spec((gb, 1, cfg.vocab), ("batch", None, "act_vocab")), cache_sh),
            transformer_model_flops(active, gb, False))

    # ----------------------------------------------------- vision families
    if arch.family in ("vit", "swin", "resnet"):
        fwd = {"vit": lambda p, im: vit_lib.forward(p, cfg, im),
               "swin": lambda p, im: swin_lib.forward(p, cfg, im),
               "resnet": lambda p, im: resnet_lib.forward(p, cfg, im, train=train),
               }[arch.family]
        sh = shape if not smoke else ShapeSpec(shape.name, shape.kind,
                                               img_res=cfg.img_res, batch=2)
        batch = _vision_batch(sh)
        if arch.family == "resnet":
            mflops = resnet_fwd_flops(cfg, sh.batch) * (3 if train else 1)
        elif arch.family == "swin":
            mflops = swin_fwd_flops(cfg, sh.batch) * (3 if train else 1)
        else:
            tokens = sh.batch * (cfg.img_res // cfg.patch) ** 2
            mflops = transformer_model_flops(n_params, tokens, train)

        if train:
            def loss_fn(p, b, step):
                return _ce_loss(fwd(p, b["images"]), b["labels"])
            if arch.family == "resnet":
                act_b = (cfg.img_res // 4) ** 2 * cfg.width * 4 * 2
            else:
                d = cfg.d_model if arch.family == "vit" else cfg.dims[0]
                act_b = (cfg.img_res // cfg.patch) ** 2 * d * 2
            accum = 1 if smoke else pick_accum(sh.batch, act_b, dp)
            return StepBundle(name, _train_wrap(loss_fn, ocfg, accum), (aparams, aopt, batch),
                              mflops, accum=accum, notes=f"accum={accum}", loss_fn=loss_fn)

        def step(params, batch):
            return fwd(params, batch["images"])

        return sharded.bundle(
            name, step, (aparams, batch),
            (sharded.params, sharded.tree(batch, {"images": ("batch", None, None, None),
                                                  "labels": ("batch",)})),
            sharded.spec((sh.batch, cfg.n_classes), ("batch", "act_vocab")), mflops)

    # ----------------------------------------------------- diffusion families
    if arch.family == "dit":
        bsz = 2 if smoke else shape.batch
        steps = 2 if smoke else (shape.steps if shape.kind == "gen" else 1)
        lres = cfg.latent_res
        if train:
            batch = {"latents": _meta((bsz, lres, lres, cfg.latent_channels)),
                     "labels": _meta((bsz,), torch.int32)}

            def loss_fn(p, b, step):
                gen = _step_generator(b["latents"].device, step)
                return diffusion.dit_loss(p, cfg, b["latents"], b["labels"], gen)

            tokens = bsz * cfg.num_tokens
            return StepBundle(name, _train_wrap(loss_fn, ocfg), (aparams, aopt, batch),
                              transformer_model_flops(n_params, tokens, True), loss_fn=loss_fn)

        batch = {"labels": _meta((bsz,), torch.int32)}

        def step(params, batch):
            y = batch["labels"]
            return diffusion.dit_sample(params, cfg, _sampler_generator(y.device), y, steps,
                                        device=y.device)

        tokens = bsz * cfg.num_tokens * steps
        return sharded.bundle(
            name, step, (aparams, batch),
            (sharded.params, sharded.tree(batch, ("batch",))),
            sharded.spec((bsz, lres, lres, cfg.latent_channels), ("batch", None, None, None)),
            transformer_model_flops(n_params, tokens, False),
            notes=f"sampler: {steps} denoise steps")

    if arch.family == "flux":
        bsz = 2 if smoke else shape.batch
        steps = 2 if smoke else (shape.steps if shape.kind == "gen" else 1)
        lres = cfg.latent_res
        txt = _meta((bsz, cfg.txt_len, cfg.t5_dim))
        vec = _meta((bsz, cfg.clip_dim))
        if train:
            batch = {"latents": _meta((bsz, lres, lres, cfg.latent_channels)),
                     "txt": txt, "vec": vec}

            def loss_fn(p, b, step):
                gen = _step_generator(b["latents"].device, step)
                return diffusion.flux_loss(p, cfg, b["latents"], b["txt"], b["vec"], gen)

            act_b = (cfg.n_img_tokens + cfg.txt_len) * cfg.d_model * 2
            accum = 1 if smoke else pick_accum(bsz, act_b, dp)
            return StepBundle(name, _train_wrap(loss_fn, ocfg, accum), (aparams, aopt, batch),
                              flux_fwd_flops(cfg, bsz) * 3, accum=accum,
                              notes=f"accum={accum}", loss_fn=loss_fn)

        batch = {"txt": txt, "vec": vec}

        def step(params, batch):
            dev = batch["txt"].device
            return diffusion.flux_sample(params, cfg, _sampler_generator(dev), batch["txt"],
                                         batch["vec"], steps, device=dev)

        return sharded.bundle(
            name, step, (aparams, batch),
            (sharded.params, sharded.tree(batch, {"txt": ("batch", None, None),
                                                  "vec": ("batch", None)})),
            sharded.spec((bsz, lres, lres, cfg.latent_channels), ("batch", None, None, None)),
            flux_fwd_flops(cfg, bsz) * steps, notes=f"sampler: {steps} denoise steps")

    raise ValueError(f"unknown family {arch.family}")


class SkipShape(Exception):
    def __init__(self, arch, shape, reason):
        super().__init__(f"{arch}/{shape} skipped: {reason}")
        self.arch, self.shape, self.reason = arch, shape, reason

