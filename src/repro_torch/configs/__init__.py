"""Architecture registry, PyTorch port of ``repro.configs``:
``get_arch("<id>")``.

The ten assigned architectures plus the paper's own ViT-L@384 deployment
model, each an ``ArchSpec`` whose configs carry ``torch`` dtypes.
``config_for_shape`` resolves per-shape config overrides (img_res, the swin
window at 384 px, smoke reductions), as the reference.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (dit_s2, flux_dev, granite_moe_3b_a800m, internlm2_1_8b,
                                 janus_vit_l384, qwen3_moe_30b_a3b, resnet_152,
                                 starcoder2_3b, swin_b, vit_b16, vit_l16)
from repro_torch.configs.base import ArchSpec, ShapeSpec

_ARCHS: dict[str, ArchSpec] = {
    a.ARCH.name: a.ARCH
    for a in (starcoder2_3b, internlm2_1_8b, qwen3_moe_30b_a3b,
              granite_moe_3b_a800m, dit_s2, flux_dev, vit_l16, resnet_152,
              vit_b16, swin_b, janus_vit_l384)
}

ASSIGNED = [n for n in _ARCHS if n != "janus-vit-l384"]


def list_archs() -> list[str]:
    return list(_ARCHS)


def get_arch(name: str) -> ArchSpec:
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {list(_ARCHS)}")
    return _ARCHS[name]


def config_for_shape(arch: ArchSpec, shape: ShapeSpec, smoke: bool = False):
    """The family config for ``shape`` (img_res overrides etc.)."""
    cfg = arch.smoke_config if smoke else arch.config
    if smoke:
        return cfg
    if arch.family == "swin" and shape.img_res == 384:
        return swin_b.CONFIG_384
    if arch.family in ("vit", "resnet", "swin", "dit", "flux") and shape.img_res:
        if cfg.img_res != shape.img_res:
            cfg = dataclasses.replace(cfg, img_res=shape.img_res)
    return cfg
