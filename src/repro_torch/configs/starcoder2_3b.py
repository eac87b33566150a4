"""starcoder2-3b [arXiv:2402.19173; hf], PyTorch port of
``repro.configs.starcoder2_3b`` (numbers copied, not imported).

30L, d_model=3072, 24 q heads over 2 kv heads (GQA group 12), head_dim 128,
d_ff=12288, vocab=49152: LayerNorm + tanh-GELU MLP with biases, RoPE
(theta 1e5), tied embeddings. 3.03 B parameters, 6.1 GB in bf16. ``SMOKE``
is the reference's reduced model for CPU tests.
"""
import torch

from repro_torch.configs.base import LM_SHAPES, ArchSpec
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    n_layers=30, d_model=3072, n_heads=24, n_kv=2, d_ff=12288, vocab=49152,
    head_dim=128, norm="ln", act="gelu", attn_bias=True, rope_theta=1e5,
    tie_embeddings=True, dtype=torch.bfloat16, remat=True)

SMOKE = LMConfig(
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=256, vocab=128,
    head_dim=16, norm="ln", act="gelu", attn_bias=True,
    tie_embeddings=True, dtype=torch.float32)

ARCH = ArchSpec(
    name="starcoder2-3b", family="lm", config=CONFIG, smoke_config=SMOKE,
    shapes=LM_SHAPES, train_profile="fsdp_tp", serve_profile="tp",
    source="arXiv:2402.19173; hf",
    notes="long_500k skipped: pure full-attention GQA (DESIGN.md).")
