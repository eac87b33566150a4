"""The paper's deployment model: ViT-L@384 (§V-B), PyTorch port of
``repro.configs.janus_vit_l384``.

img 384, patch 16 -> 576 patches + cls = 577 tokens; 24L, d=1024, 16H,
d_ff 4096, bf16 activations. ``SMOKE`` is the reduced model the serve CLI
executes under ``--execute``, as in the reference.
"""
import torch

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.models.vit import ViTConfig

CONFIG = ViTConfig(img_res=384, patch=16, n_layers=24, d_model=1024, n_heads=16,
                   d_ff=4096, n_classes=1000, dtype=torch.bfloat16)

SMOKE = ViTConfig(img_res=64, patch=16, n_layers=4, d_model=64, n_heads=4,
                  d_ff=128, n_classes=10, dtype=torch.float32)

SHAPES = (
    ShapeSpec("serve_b1", "serve", img_res=384, batch=1),
    ShapeSpec("serve_b32", "serve", img_res=384, batch=32),
)

ARCH = ArchSpec(
    name="janus-vit-l384", family="vit", config=CONFIG, smoke_config=SMOKE,
    shapes=SHAPES, train_profile="tp", serve_profile="tp",
    source="paper §V-B / arXiv:2010.11929",
    notes="The paper's primary serving target; Janus fully applies.")
