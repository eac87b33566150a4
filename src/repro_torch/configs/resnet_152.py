"""resnet-152 [arXiv:1512.03385; paper], PyTorch port of
``repro.configs.resnet_152`` (numbers copied, not imported): bottleneck
depths 3-8-36-3, width 64. ``SMOKE`` is the reference's reduced model for
CPU tests."""
import torch

from repro_torch.configs.base import VISION_SHAPES, ArchSpec
from repro_torch.models.resnet import ResNetConfig

CONFIG = ResNetConfig(depths=(3, 8, 36, 3), width=64, n_classes=1000,
                      img_res=224, dtype=torch.bfloat16)

SMOKE = ResNetConfig(depths=(2, 2, 2, 2), width=16, n_classes=10, img_res=64,
                     dtype=torch.float32)

ARCH = ArchSpec(
    name="resnet-152", family="resnet", config=CONFIG, smoke_config=SMOKE,
    shapes=VISION_SHAPES, train_profile="tp", serve_profile="tp",
    source="arXiv:1512.03385",
    notes="Token pruning inapplicable (no tokens); Janus splitting applies at "
          "stage boundaries — the paper's own CNN motivating case (§II-C).")
