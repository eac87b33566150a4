"""Config schema, PyTorch port of ``repro.configs.base`` (a copy: the
reference module imports no JAX, but the port imports nothing of it).

Every architecture is an ``ArchSpec`` with its published full config, a
reduced smoke config of the same family, its shape set, and the names of
its sharding profiles for training and serving (the profiles themselves
are ``sharding.rules.PROFILES``)."""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                  # train | prefill | decode | gen | serve
    seq_len: int | None = None
    global_batch: int | None = None
    img_res: int | None = None
    batch: int | None = None
    steps: int | None = None
    skip_reason: str | None = None  # e.g. long_500k on full-attention archs


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                # vit | swin | resnet | lm | dit | flux
    config: Any
    smoke_config: Any
    shapes: tuple[ShapeSpec, ...]
    train_profile: str = "tp"
    serve_profile: str = "tp"
    source: str = ""
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name} has no shape {name!r}")


# ---------------------------------------------------------------------------
# shared shape sets (the three families)
# ---------------------------------------------------------------------------

FULL_ATTN_SKIP = ("sub-quadratic attention required; this arch is pure "
                  "full-attention (GQA) -> skipped per brief, see DESIGN.md "
                  "§Arch-applicability")

LM_SHAPES = (
    ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
    ShapeSpec("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    ShapeSpec("decode_32k", "decode", seq_len=32768, global_batch=128),
    ShapeSpec("long_500k", "decode", seq_len=524288, global_batch=1,
              skip_reason=FULL_ATTN_SKIP),
)

DIFFUSION_SHAPES = (
    ShapeSpec("train_256", "train", img_res=256, batch=256, steps=1000),
    ShapeSpec("gen_1024", "gen", img_res=1024, batch=4, steps=50),
    ShapeSpec("gen_fast", "gen", img_res=512, batch=16, steps=4),
    ShapeSpec("train_1024", "train", img_res=1024, batch=32, steps=1000),
)

VISION_SHAPES = (
    ShapeSpec("cls_224", "train", img_res=224, batch=256),
    ShapeSpec("cls_384", "train", img_res=384, batch=64),
    ShapeSpec("serve_b1", "serve", img_res=224, batch=1),
    ShapeSpec("serve_b128", "serve", img_res=224, batch=128),
)
