"""Step builders, PyTorch port of ``repro.launch.steps``.

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

With a ``mesh`` (a ``DeviceMesh``), a bundle builds its rules from the
architecture's profile (``train_profile`` for a train shape, else
``serve_profile``): ``in_shardings`` / ``out_shardings`` are trees of
``NamedSharding`` (a ``spec_for`` spec on the mesh) matching the step's
arguments and results, ``place_inputs`` places concrete arguments by them
(each rank's slice as a view), and the step runs under ``use_rules``. A
sharded train step takes ``(params, opt, batch)`` placed as ``(params'
specs, {m, v: params' specs, step: replicated}, the family's batch axes)``;
its gradients come back in their params' placements, the f32 accumulator of
microbatches takes them too, a microbatch is the reference's (rows
``i*B/accum`` to ``(i+1)*B/accum`` of the global batch, each rank holding
its share, moved there by one all-to-all a step), and the metrics are
replicated. ``pick_accum`` sees the mesh's data-parallel extent
(``_dp_size``).
``build_bundle``'s hill-climb options are the reference's: ``optimizer``
(the train step's ``AdamWConfig``), ``profile_override`` (another sharding
profile), ``config_patch`` (``dataclasses.replace`` on the shape's config)
and ``janus_alpha`` (ViT serving through ``vit.forward_janus`` on the
exponential ToMe schedule).

``hlo_scale`` is the count of identical units a step repeats (a train
step's ``accum`` microbatches, a sampler's denoise steps) and ``unit_fn``
runs one of them on the step's arguments: one microbatch's gradient and
the update, or one denoise step from the initial noise. A count of
``unit_fn`` times ``hlo_scale`` stands for the step's (``launch.dryrun``),
as the reference scales the rolled loops of its cost analysis. Not ported:
``donate_argnums`` and ``lower``/``jitted`` (ahead-of-time compilation):
the dry-run runs the step on a fake world instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs import config_for_shape, get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import pruning as pruning_lib
from repro_torch.models import dit as dit_lib
from repro_torch.models import flux as flux_lib
from repro_torch.models import layers
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
    in_shardings: Any = None     # NamedSharding trees of the arguments (with a mesh)
    out_shardings: Any = None    # NamedSharding trees of the results (with a mesh)
    rules: Any = None            # the profile's Rules (with a mesh)
    hlo_scale: float = 1.0       # identical units of the step (microbatches, sampler steps)
    unit_fn: Callable | None = None  # one unit on the step's arguments (None: the step)


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


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Gradient ``g`` in its param ``p``'s placements (a pending sum over
    the batch is reduced, onto the param's shards where it is sharded)."""
    if isinstance(p, DTensor):
        return rules_lib.redistribute(g, p.placements)
    return g


def value_and_grad(loss_fn: Callable, params: dict, *args):
    """(loss, grads): ``loss_fn(params, *args)`` and its gradient in each
    param's dtype and placements, zeros for a leaf the loss does not read
    (as JAX gives)."""
    flat = param_lib.flatten(params)
    live = {k: v.detach().requires_grad_() for k, v in flat.items()}
    with torch.enable_grad():
        loss = loss_fn(param_lib.unflatten(live), *args)
        grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True,
                                    materialize_grads=True)
    grads = [_like(g, p) for g, p in zip(grads, flat.values())]
    return rules_lib.replicated(loss.detach()), param_lib.unflatten(dict(zip(live, grads)))


def _rows_by_microbatch(local: torch.Tensor, accum: int, n: int, s: int, group) -> torch.Tensor:
    """Rank ``s`` of the ``n`` splitting the batch holds global rows
    ``s*B/n`` on (``local``); one ``all_to_all_single`` in ``group`` returns
    its shares of the ``accum`` microbatches in order, ``B/(n*accum)`` rows
    each (the share of microbatch ``i`` is global block ``i*n + s``)."""
    k = local.shape[0] // accum
    dest = [(s * accum + j) % n for j in range(accum)]  # block s*accum+j's rank
    order = sorted(range(accum), key=lambda j: (dest[j], j))
    send = local.reshape(accum, k, *local.shape[1:])[order].reshape(local.shape).contiguous()
    recv = [k * sum((t * accum + j) % n == s for j in range(accum)) for t in range(n)]
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, recv, [k * dest.count(r) for r in range(n)], group=group)
    return out


def _first_microbatch(x: torch.Tensor, accum: int) -> torch.Tensor:
    """A microbatch's worth of the batch leaf ``x``: its first ``B/accum``
    rows, or a DTensor's first ``1/accum`` of each rank's rows (the same
    work as any microbatch, without the exchange that orders them)."""
    if not isinstance(x, DTensor):
        return x[:x.shape[0] // accum]
    local = x.to_local()
    return DTensor.from_local(local[:local.shape[0] // accum], x.device_mesh, x.placements,
                              run_check=False)


def _microbatches(x: torch.Tensor, accum: int) -> list[torch.Tensor]:
    """The ``accum`` microbatches of the global batch leaf ``x``, microbatch
    ``i`` rows ``i*B/accum`` to ``(i+1)*B/accum``. A DTensor's come back in
    its placements, each rank holding its share: where one mesh dim splits
    the batch evenly, rows move between its ranks in one all-to-all
    (``_rows_by_microbatch``) and no rank holds the whole batch; where
    several do (a "pod" and "data" mesh), the batch is gathered."""
    if not isinstance(x, DTensor):
        return list(x.reshape(accum, x.shape[0] // accum, *x.shape[1:]))
    mesh = x.device_mesh
    dims = [d for d, pl in enumerate(x.placements) if isinstance(pl, Shard) and pl.dim == 0]
    if len(dims) > 1 or x.shape[0] % (accum * math.prod(mesh.size(d) for d in dims)):
        g = rules_lib.to_global(x)
        m = g.shape[0] // accum
        return [rules_lib.place(g[i * m:(i + 1) * m], mesh, x.placements) for i in range(accum)]
    local = x.to_local()
    if dims and mesh.size(dims[0]) > 1:
        d = dims[0]
        local = _rows_by_microbatch(local, accum, mesh.size(d), mesh.get_local_rank(d),
                                    mesh.get_group(d))
    k = local.shape[0] // accum
    return [DTensor.from_local(local[i * k:(i + 1) * k], mesh, x.placements, run_check=False)
            for i in range(accum)]


def accumulated_grads(loss_fn: Callable, params: dict, batch: dict, step: torch.Tensor,
                      accum: int = 1):
    """(loss, grads) of one train step before the update. With ``accum`` > 1
    the batch splits into ``accum`` sequential microbatches along axis 0,
    their gradients summed in f32 in order and divided by ``accum``, the loss
    the mean of theirs; with 1, the grads keep the params' dtype."""
    if accum == 1:
        return value_and_grad(loss_fn, params, batch, step)
    gsum = param_lib.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    flat_sum = param_lib.flatten(gsum)
    losses = []
    mbs = {k: _microbatches(v, accum) for k, v in batch.items()}
    for i in range(accum):
        mb = {k: v[i] for k, v in mbs.items()}
        loss, grads = value_and_grad(loss_fn, params, mb, step)
        for key, g in param_lib.flatten(grads).items():
            flat_sum[key].add_(g)
        del grads
        losses.append(loss)
    for s in flat_sum.values():
        s.div_(accum)
    return torch.mean(torch.stack(losses)), gsum


def _train_wrap(loss_fn: Callable, ocfg: adamw.AdamWConfig, accum: int = 1, rules=None):
    """Train step with optional microbatch gradient accumulation
    (``accumulated_grads``), then AdamW, all under ``use_rules(rules)``.
    ``step(params, opt, batch) -> (params, opt, metrics)``, params and opt
    updated in place."""
    def step(params, opt, batch):
        with rules_lib.use_rules(rules):
            loss, grads = accumulated_grads(loss_fn, params, batch, opt["step"], accum)
            params, opt, metrics = adamw.apply_updates(ocfg, params, grads, opt)
        return params, opt, {"loss": loss, **metrics}
    return step


def _dp_size(mesh) -> int:
    """The data-parallel extent: the product of the "pod" and "data" axes."""
    shape = rules_lib.mesh_shape(mesh)
    return math.prod(shape.get(a, 1) for a in ("pod", "data"))


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


_VISION_AXES = {"images": ("batch", None, None, None), "labels": ("batch",)}


def _vision_batch(shape: ShapeSpec) -> dict:
    return {"images": _meta((shape.batch, shape.img_res, shape.img_res, 3)),
            "labels": _meta((shape.batch,), torch.int32)}


def _ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy in f32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    true = layers.take_labels(lf, labels)
    return torch.mean(lse - true)


def _step_generator(device: torch.device, step: torch.Tensor) -> torch.Generator:
    """The diffusion losses' draws, seeded by the optimizer step (the
    reference folds the step into PRNGKey(0)); one host read of the step.
    On a mesh every rank draws the global noise from it (plain tensors of
    the batch's global shape, which the rules take as replicated), so each
    sample gets the noise it gets on one device."""
    if isinstance(step, DTensor):
        step = step.to_local()
    return torch.Generator(device=device).manual_seed(int(step))


def _sampler_generator(device: torch.device) -> torch.Generator:
    """The samplers' initial noise (the reference's PRNGKey(0))."""
    return torch.Generator(device=device).manual_seed(0)


class _Sharded:
    """A bundle's sharding on the rules' mesh: spec trees, the step run
    under the rules, and the bundle; without rules, no specs and the step
    as it is."""

    def __init__(self, rules, specs_tree, ocfg: adamw.AdamWConfig):
        self.rules = rules
        self.ocfg = ocfg
        self.params = None if rules is None else param_lib.tree_map(
            lambda s: rules.named(rules.spec_for(s.shape, s.axes)), specs_tree)

    def spec(self, shape, axes):
        if self.rules is None:
            return None
        return self.rules.named(self.rules.spec_for(tuple(shape), tuple(axes)))

    def tree(self, tree, axes):
        """Specs of a dict (or list of dicts) of tensors; ``axes`` one tuple
        for every leaf or a dict of them by key."""
        if isinstance(tree, list):
            return [self.tree(t, axes) for t in tree]
        return {k: self.spec(v.shape, axes[k] if isinstance(axes, dict) else axes)
                for k, v in tree.items()}

    def under_rules(self, step):
        if self.rules is None or step is None:
            return step
        rules = self.rules

        def run(*args):
            with rules_lib.use_rules(rules):
                return step(*args)
        return run

    def bundle(self, name, step, inputs, in_sh, out_sh, flops, unit_fn=None,
               **kw) -> StepBundle:
        kw["unit_fn"] = self.under_rules(unit_fn)
        if self.rules is None:
            return StepBundle(name, step, inputs, flops, **kw)
        return StepBundle(name, self.under_rules(step), inputs, flops, in_shardings=in_sh,
                          out_shardings=out_sh, rules=self.rules, **kw)

    def train(self, name, loss_fn, accum, inputs, baxes, flops, **kw) -> StepBundle:
        """A train bundle: ``_train_wrap`` under the rules; on a mesh the
        params, moments and batch placed as the reference's
        ``(psh, osh, bsh)``, the metrics replicated."""
        step = _train_wrap(loss_fn, self.ocfg, accum, self.rules)
        one = _train_wrap(loss_fn, self.ocfg, 1, self.rules)

        def unit_fn(params, opt, batch):
            return one(params, opt, {k: _first_microbatch(v, accum) for k, v in batch.items()})
        kw.update(accum=accum, loss_fn=loss_fn, hlo_scale=accum,
                  unit_fn=unit_fn if accum > 1 else None)
        if self.rules is None:
            return StepBundle(name, step, inputs, flops, **kw)
        rep = self.rules.named(())
        osh = {"m": self.params, "v": self.params, "step": rep}
        metrics = {k: rep for k in ("loss", "grad_norm", "lr")}
        return StepBundle(name, step, inputs, flops,
                          in_shardings=(self.params, osh, self.tree(inputs[2], baxes)),
                          out_shardings=(self.params, osh, metrics), rules=self.rules, **kw)


def build_bundle(arch_name: str, shape_name: str, mesh=None, *,
                 smoke: bool = False,
                 optimizer: adamw.AdamWConfig | None = None,
                 profile_override: str | None = None,
                 config_patch: dict | None = None,
                 janus_alpha: float | None = None) -> StepBundle:
    """The bundle of ``arch_name`` at ``shape_name``; with ``mesh`` a sharded
    bundle (see the module docstring). ``profile_override``/``config_patch``/
    ``janus_alpha`` are the hill-climb knobs: another sharding profile,
    model-config field overrides (e.g. fused_qkv, cache_quant_scale), and
    the Janus ToMe schedule for ViT-family serving."""
    arch = get_arch(arch_name)
    shape = arch.shape(shape_name)
    if shape.skip_reason and not smoke:
        raise SkipShape(arch_name, shape_name, shape.skip_reason)
    cfg = config_for_shape(arch, shape, smoke=smoke)
    if config_patch:
        cfg = dataclasses.replace(cfg, **config_patch)
    train = shape.kind == "train"
    specs_tree = _specs_for(arch.family, cfg)
    profile = profile_override or (arch.train_profile if train else arch.serve_profile)
    rules = None if mesh is None else rules_lib.make_rules(profile, mesh)
    sharded = _Sharded(rules, specs_tree, optimizer or adamw.AdamWConfig())
    aparams = param_lib.abstract_params(specs_tree, dtype=getattr(cfg, "dtype", None))
    n_params = param_lib.param_count(specs_tree)
    aopt = adamw.init_state(aparams) if train else None
    dp = 1 if mesh is None else _dp_size(mesh)
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
            return sharded.train(name, loss_fn, accum, (aparams, aopt, batch),
                                 ("batch", "seq"),
                                 transformer_model_flops(active, gb * seq, True),
                                 notes=f"accum={accum}")

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
        janus_note = ""
        if janus_alpha is not None:
            if arch.family != "vit" or train:
                raise ValueError("ToMe schedule applies to ViT-family serving")
            sched_j = pruning_lib.make_schedule(
                "exponential", janus_alpha, cfg.n_layers, cfg.num_tokens)

            def fwd(p, im):
                return vit_lib.forward_janus(p, cfg, im, sched_j)
            janus_note = (f" janus_alpha={janus_alpha} "
                          f"(merges {sum(sched_j)}/{cfg.num_tokens} tokens)")
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
            return sharded.train(name, loss_fn, accum, (aparams, aopt, batch), _VISION_AXES,
                                 mflops, notes=f"accum={accum}")

        def step(params, batch):
            return fwd(params, batch["images"])

        return sharded.bundle(
            name, step, (aparams, batch), (sharded.params, sharded.tree(batch, _VISION_AXES)),
            sharded.spec((sh.batch, cfg.n_classes), ("batch", "act_vocab")), mflops,
            notes=janus_note)

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

            tokens = bsz * cfg.num_tokens  # DiT-S is tiny: accum=1
            return sharded.train(name, loss_fn, 1, (aparams, aopt, batch),
                                 {"latents": ("batch", None, None, None), "labels": ("batch",)},
                                 transformer_model_flops(n_params, tokens, True))

        batch = {"labels": _meta((bsz,), torch.int32)}

        def sample(n):
            def step(params, batch):
                y = batch["labels"]
                return diffusion.dit_sample(params, cfg, _sampler_generator(y.device), y, n,
                                            device=y.device)
            return step

        tokens = bsz * cfg.num_tokens * steps
        return sharded.bundle(
            name, sample(steps), (aparams, batch),
            (sharded.params, sharded.tree(batch, ("batch",))),
            sharded.spec((bsz, lres, lres, cfg.latent_channels), ("batch", None, None, None)),
            transformer_model_flops(n_params, tokens, False), unit_fn=sample(1),
            hlo_scale=steps, notes=f"sampler: {steps} denoise steps")

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
            return sharded.train(name, loss_fn, accum, (aparams, aopt, batch),
                                 {"latents": ("batch", None, None, None),
                                  "txt": ("batch", None, None), "vec": ("batch", None)},
                                 flux_fwd_flops(cfg, bsz) * 3, notes=f"accum={accum}")

        batch = {"txt": txt, "vec": vec}

        def sample(n):
            def step(params, batch):
                dev = batch["txt"].device
                return diffusion.flux_sample(params, cfg, _sampler_generator(dev),
                                             batch["txt"], batch["vec"], n, device=dev)
            return step

        return sharded.bundle(
            name, sample(steps), (aparams, batch),
            (sharded.params, sharded.tree(batch, {"txt": ("batch", None, None),
                                                  "vec": ("batch", None)})),
            sharded.spec((bsz, lres, lres, cfg.latent_channels), ("batch", None, None, None)),
            flux_fwd_flops(cfg, bsz) * steps, unit_fn=sample(1), hlo_scale=steps,
            notes=f"sampler: {steps} denoise steps")

    raise ValueError(f"unknown family {arch.family}")


class SkipShape(Exception):
    def __init__(self, arch, shape, reason):
        super().__init__(f"{arch}/{shape} skipped: {reason}")
        self.arch, self.shape, self.reason = arch, shape, reason

