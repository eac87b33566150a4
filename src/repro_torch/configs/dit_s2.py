"""dit-s2 [arXiv:2212.09748; paper], PyTorch port of ``repro.configs.dit_s2``
(numbers copied, not imported).

DiT-S/2: 12 layers, d=384, 6 heads of 64, patch 2 on the 32x32x4 VAE latent
of a 256 px image (4096 tokens at 1024 px, the ``gen_1024`` shape);
34,450,960 parameters at 1024 px. ``SMOKE`` is the reference's reduced model
for CPU tests.
"""
import torch

from repro_torch.configs.base import DIFFUSION_SHAPES, ArchSpec
from repro_torch.models.dit import DiTConfig

CONFIG = DiTConfig(img_res=256, patch=2, n_layers=12, d_model=384, n_heads=6,
                   n_classes=1000, dtype=torch.bfloat16)

SMOKE = DiTConfig(img_res=64, patch=2, n_layers=2, d_model=64, n_heads=4,
                  n_classes=10, dtype=torch.float32)

ARCH = ArchSpec(
    name="dit-s2", family="dit", config=CONFIG, smoke_config=SMOKE,
    shapes=DIFFUSION_SHAPES, train_profile="tp", serve_profile="tp",
    source="arXiv:2212.09748",
    notes="DiT is a ViT over latent patches: Janus ToMe pruning applies per "
          "denoise forward (ToMe-for-SD precedent); splitting applies too.")
