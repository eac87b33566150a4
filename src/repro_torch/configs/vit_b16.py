"""vit-b16 [arXiv:2010.11929; paper], PyTorch port of ``repro.configs.vit_b16``
(numbers copied, not imported): ViT-B/16, 12 layers, d=768, 12 heads of 64,
d_ff 3072; 197 tokens at 224 px."""
import torch

from repro_torch.configs.base import VISION_SHAPES, ArchSpec
from repro_torch.models.vit import ViTConfig

CONFIG = ViTConfig(img_res=224, patch=16, n_layers=12, d_model=768, n_heads=12,
                   d_ff=3072, n_classes=1000, dtype=torch.bfloat16, remat=True)

SMOKE = ViTConfig(img_res=32, patch=8, n_layers=2, d_model=64, n_heads=4,
                  d_ff=128, n_classes=10, dtype=torch.float32)

ARCH = ArchSpec(
    name="vit-b16", family="vit", config=CONFIG, smoke_config=SMOKE,
    shapes=VISION_SHAPES, train_profile="tp", serve_profile="tp",
    source="arXiv:2010.11929",
    notes="Full Janus applies (token pruning + splitting).")
