"""flux-dev [BFL tech report; unverified], PyTorch port of
``repro.configs.flux_dev`` (numbers copied, not imported).

MMDiT rectified flow: 19 double + 38 single blocks, d_model 3072, 24 heads
of 128; 1024 px -> 128 px latent (16 channels), patch 2 -> 4096 image
tokens beside 512 text tokens. 11,901,414,464 parameters, 23.80 GB in bf16.
The text frontend is a stub (precomputed T5/CLIP embeddings). ``SMOKE`` is
the reference's reduced model for CPU tests.
"""
import torch

from repro_torch.configs.base import DIFFUSION_SHAPES, ArchSpec
from repro_torch.models.flux import FluxConfig

CONFIG = FluxConfig(img_res=1024, patch=2, latent_channels=16, d_model=3072,
                    n_heads=24, n_double=19, n_single=38, txt_len=512,
                    t5_dim=4096, clip_dim=768, dtype=torch.bfloat16, remat=True)

SMOKE = FluxConfig(img_res=64, patch=2, latent_channels=16, d_model=64,
                   n_heads=4, n_double=2, n_single=2, txt_len=8, t5_dim=32,
                   clip_dim=16, dtype=torch.float32)

ARCH = ArchSpec(
    name="flux-dev", family="flux", config=CONFIG, smoke_config=SMOKE,
    shapes=DIFFUSION_SHAPES, train_profile="fsdp_tp", serve_profile="fsdp_tp",
    source="BFL tech report (unverified)",
    notes="12B params: FSDP+TP required even for serving shapes. ToMe applies "
          "to the img token stream.")
