"""ResNet (bottleneck), PyTorch port of ``repro.models.resnet`` (the
resnet-152 architecture: depths 3-8-36-3, width 64).

The interface is the reference's: NHWC activations, HWIO kernels, XLA's
SAME padding. Inside, each convolution runs ``torch.nn.functional.conv2d``
on the NHWC tensor viewed as NCHW (a ``channels_last`` tensor, the layout
cuDNN prefers) with the kernel permuted to OIHW. The reference's
convolution is XLA's, not a Pallas kernel, so cuDNN serves it here.

SAME padding is asymmetric where the total is odd: XLA pads ``total // 2``
before and the rest after (the 7x7/2 stem at 224 px pads (2, 3), the 3x3/2
convolutions and the 3x3/2 max pool (0, 1)), which ``conv2d(padding=k//2)``
would not reproduce. ``_same_pads`` computes XLA's pads; odd ones are
applied with ``F.pad`` (``-inf`` for the max pool).

BatchNorm keeps (scale, bias, mean, var): eval normalises with the stored
statistics, train with the batch's (population variance), as the reference;
the running statistics' update belongs to the training loop.

Per stage, the first (strided, projecting) block has its own params and the
remaining identical blocks are stacked over a leading axis (the reference
scans them; they run one after another here). Token pruning does not apply
(no tokens); Janus splits a CNN at stage boundaries (``stage_features``).

Under sharding rules each stage's first block's output is constrained to
("batch", "act_spatial", None, "act_conv_out"), as the reference.

Spatial partitioning (the ``spatial`` profile: "act_spatial", H, on
"model"): each convolution and the max pool take their input split along H
where their output's H divides by the split too (else it is gathered, the
rules' divisibility fallback), and run behind the local boundary with a
``Halo`` of H rows: ``halo_rows``, from XLA's SAME padding of the global H.
A rank's block then needs no H padding but the halo's fill at the image's
edges (0 for a convolution, -inf for the pool); W is padded as unsplit.
GSPMD inserts the same exchanges for the reference.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec, layer_params, stack_specs
from repro_torch.sharding.rules import Halo, constrain, current_rules, run_local


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depths: tuple[int, ...] = (3, 8, 36, 3)
    width: int = 64
    n_classes: int = 1000
    in_channels: int = 3
    img_res: int = 224
    dtype: torch.dtype = torch.float32
    expansion: int = 4


def conv_specs(kh, kw, cin, cout) -> dict:
    return {"w": ParamSpec((kh, kw, cin, cout), ("kh", "kw", "conv_in", "conv_out"),
                           init="fan_in", scale=1.4142)}


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_nchw(x: torch.Tensor, k: int, stride: int, value: float = 0.0, rows: bool = True):
    """x [B, C, H, W] padded as XLA's SAME (H only where ``rows``: a block
    with its halo needs none); returns (x, symmetric pads) where symmetric
    pads are left to the op (no copy)."""
    ph = _same_pads(x.shape[2], k, stride) if rows else (0, 0)
    pw = _same_pads(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


def halo_rows(size: int, k: int, stride: int, parts: int) -> tuple[int, int]:
    """The (before, after) rows a block of ``size // parts`` rows needs
    from its neighbours for a k x k / ``stride`` window under XLA's SAME
    padding of the whole ``size``: the padding's ``before``, and what the
    block's last output row reads past the block (none where it reads less
    than the block, as a 1x1/2 convolution). Needs the block's rows to
    divide by ``stride``."""
    h = size // parts
    before = _same_pads(size, k, stride)[0]
    return before, max((h // stride - 1) * stride + k - before - h, 0)


def _split_rows(x: torch.Tensor, k: int, stride: int, fill: float = 0.0,
                channels: str | None = None):
    """(x, the local role of its H) for a k x k / ``stride`` window under
    the active rules: where "act_spatial" splits H over more than one rank
    and the output's H divides by that split too, x split along H and a
    ``Halo`` of ``halo_rows``; else x with H whole (the rules'
    divisibility fallback, recorded in their ``fallbacks``) and None.
    ``channels``: the logical axis of x's channels (None: gathered)."""
    r = current_rules()
    if r is None:
        return x, None
    b, h, w, c = x.shape
    out = (b, -(-h // stride), -(-w // stride), c)
    axes = r.spec_for(out, (None, "act_spatial", None, None))[1]
    parts = 1 if axes is None else math.prod(
        r.shape[a] for a in ((axes,) if isinstance(axes, str) else axes))
    if parts == 1:
        return constrain(x, ("batch", None, None, channels)), None
    x = constrain(x, ("batch", "act_spatial", None, channels))
    return x, Halo("rows", *halo_rows(h, k, stride, parts), fill)


def row_blocks(x: torch.Tensor, k: int, stride: int, parts: int,
               fill: float = 0.0) -> list[torch.Tensor]:
    """x [B, H, W, C] cut into ``parts`` row blocks, each with its
    ``halo_rows`` cut from x (``fill`` past x's edges): what the local op
    gets on each rank of a split over ``parts`` after ``halo_exchange``."""
    h = x.shape[1] // parts
    before, after = halo_rows(x.shape[1], k, stride, parts)
    xp = F.pad(x, (0, 0, 0, 0, before, after), value=fill)
    return [xp[:, i * h:(i + 1) * h + before + after] for i in range(parts)]


def conv_local(x: torch.Tensor, w: torch.Tensor, stride: int, halo: bool = False):
    """The convolution on one rank's tensors: x [B, H, W, Cin] (NHWC), w
    HWIO; SAME padding, but none along H where x's rows carry their halo."""
    w = w.to(x.dtype)
    xc, pad = _pad_nchw(x.permute(0, 3, 1, 2), w.shape[0], stride, rows=not halo)
    return F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, padding=pad).permute(0, 2, 3, 1)


def max_pool_local(x: torch.Tensor, halo: bool = False) -> torch.Tensor:
    """The 3x3/2 max pool on one rank's x [B, H, W, C]: SAME padding with
    -inf, none along H where x's rows carry their halo."""
    xc, pad = _pad_nchw(x.permute(0, 3, 1, 2), 3, 2, value=-torch.inf, rows=not halo)
    return F.max_pool2d(xc, 3, 2, padding=pad).permute(0, 2, 3, 1)


def conv(p: dict, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x [B, H, W, Cin] (NHWC) * HWIO kernel, SAME padding -> [B, H', W', Cout].
    On DTensors it runs behind the local boundary (DTensor's convolution
    takes only some shardings): batch, output channels and (with a halo,
    ``_split_rows``) rows may be sharded, input channels not, so a
    channel-sharded input (the previous conv's output) is gathered first, as
    XLA does for the reference."""
    x, rows = _split_rows(x, p["w"].shape[0], stride)  # input channels gathered
    return run_local("conv", lambda x, w: conv_local(x, w, stride, rows is not None),
                     (x, p["w"]), (("batch", rows, None, None), (None, None, None, "channels")),
                     ("batch", "rows" if rows else None, None, "channels"))


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 max pool, SAME padding with -inf, NHWC (channels independent;
    behind the local boundary on DTensors, rows with a halo of -inf)."""
    x, rows = _split_rows(x, 3, 2, fill=-torch.inf, channels="act_conv_out")
    return run_local("max_pool", lambda x: max_pool_local(x, rows is not None), (x,),
                     (("batch", rows, None, "channels"),),
                     ("batch", "rows" if rows else None, None, "channels"))


def bn_specs(c: int) -> dict:
    return {"scale": ParamSpec((c,), ("conv_out",), init="ones"),
            "bias": ParamSpec((c,), ("conv_out",), init="zeros"),
            "mean": ParamSpec((c,), ("conv_out",), init="zeros"),
            "var": ParamSpec((c,), ("conv_out",), init="ones")}


def bn(p: dict, x: torch.Tensor, train: bool, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm over NHWC in f32, cast back to x's dtype."""
    xf = x.float()
    if train:
        mu = xf.mean(dim=(0, 1, 2))
        var = (xf - mu).square().mean(dim=(0, 1, 2))  # jnp.var's two passes
    else:
        mu, var = p["mean"].float(), p["var"].float()
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def _bottleneck_specs(cin: int, cmid: int, cout: int, project: bool) -> dict:
    p = {
        "conv1": conv_specs(1, 1, cin, cmid), "bn1": bn_specs(cmid),
        "conv2": conv_specs(3, 3, cmid, cmid), "bn2": bn_specs(cmid),
        "conv3": conv_specs(1, 1, cmid, cout), "bn3": bn_specs(cout),
    }
    if project:
        p["proj"] = conv_specs(1, 1, cin, cout)
        p["bn_proj"] = bn_specs(cout)
    return p


def _bottleneck(bp: dict, x: torch.Tensor, stride: int, train: bool) -> torch.Tensor:
    h = torch.relu(bn(bp["bn1"], conv(bp["conv1"], x), train))
    h = torch.relu(bn(bp["bn2"], conv(bp["conv2"], h, stride=stride), train))
    h = bn(bp["bn3"], conv(bp["conv3"], h), train)
    if "proj" in bp:
        x = bn(bp["bn_proj"], conv(bp["proj"], x, stride=stride), train)
    return torch.relu(x + h)


def specs(cfg: ResNetConfig) -> dict:
    p: dict = {
        "stem": conv_specs(7, 7, cfg.in_channels, cfg.width),
        "bn_stem": bn_specs(cfg.width),
    }
    cin = cfg.width
    for i, depth in enumerate(cfg.depths):
        cmid = cfg.width * (2 ** i)
        cout = cmid * cfg.expansion
        p[f"stage{i}_first"] = _bottleneck_specs(cin, cmid, cout, project=True)
        if depth > 1:
            p[f"stage{i}_rest"] = stack_specs(
                depth - 1, lambda cm=cmid, co=cout: _bottleneck_specs(co, cm, co, project=False))
        cin = cout
    p["head"] = L.linear_specs(cin, cfg.n_classes, axes=("embed", "vocab"))
    return p


def _stages(params: dict, cfg: ResNetConfig, images: torch.Tensor, train: bool):
    """Yield the stem's output (after the max pool), then each stage's."""
    x = images.to(cfg.dtype)
    x = torch.relu(bn(params["bn_stem"], conv(params["stem"], x, stride=2), train))
    x = _max_pool(x)
    yield x
    for i, depth in enumerate(cfg.depths):
        x = _bottleneck(params[f"stage{i}_first"], x, 1 if i == 0 else 2, train)
        x = constrain(x, ("batch", "act_spatial", None, "act_conv_out"))
        for l in range(depth - 1):
            x = _bottleneck(layer_params(params, l, f"stage{i}_rest"), x, 1, train)
        yield x


def forward(params: dict, cfg: ResNetConfig, images: torch.Tensor,
            train: bool = False) -> torch.Tensor:
    """images [B, H, W, C] (NHWC) -> logits [B, n_classes]."""
    *_, x = _stages(params, cfg, images, train)
    return L.linear(params["head"], x.mean(dim=(1, 2)))


def stage_features(params: dict, cfg: ResNetConfig, images: torch.Tensor,
                   train: bool = False) -> list[torch.Tensor]:
    """Per-stage outputs (the stem's first): the Janus CNN splitter sizes
    its transfers from them."""
    return list(_stages(params, cfg, images, train))
