"""swin-b [arXiv:2103.14030; paper], PyTorch port of ``repro.configs.swin_b``
(numbers copied, not imported): patch 4, window 7, depths 2-2-18-2, dims
128-256-512-1024. At 384 px the official Swin-B uses window 12 (96 % 7 !=
0): ``CONFIG_384``, which ``config_for_shape`` picks. ``SMOKE`` is the
reference's reduced model for CPU tests.
"""
import torch

from repro_torch.configs.base import VISION_SHAPES, ArchSpec
from repro_torch.models.swin import SwinConfig

CONFIG = SwinConfig(img_res=224, patch=4, window=7, depths=(2, 2, 18, 2),
                    dims=(128, 256, 512, 1024), heads=(4, 8, 16, 32),
                    n_classes=1000, dtype=torch.bfloat16)

CONFIG_384 = SwinConfig(img_res=384, patch=4, window=12, depths=(2, 2, 18, 2),
                        dims=(128, 256, 512, 1024), heads=(4, 8, 16, 32),
                        n_classes=1000, dtype=torch.bfloat16)

SMOKE = SwinConfig(img_res=56, patch=4, window=7, depths=(2, 2), dims=(32, 64),
                   heads=(2, 4), n_classes=10, dtype=torch.float32)

ARCH = ArchSpec(
    name="swin-b", family="swin", config=CONFIG, smoke_config=SMOKE,
    shapes=VISION_SHAPES, train_profile="tp", serve_profile="tp",
    source="arXiv:2103.14030",
    notes="ToMe pruning inapplicable (windows need dense grids); splitting "
          "applies at stage boundaries (patch-merging halves tokens 4x/stage).")
