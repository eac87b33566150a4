"""internlm2-1.8b [arXiv:2403.17297; hf], PyTorch port of
``repro.configs.internlm2_1_8b`` (numbers copied, not imported).

24L, d_model=2048, 16 q heads over 8 kv heads (GQA group 2), head_dim 128,
d_ff=8192, vocab=92544: RMSNorm + SwiGLU, no biases, RoPE (theta 1e6),
untied ``lm_head``. The port's tests use ``SMOKE`` to cover the RMSNorm,
SwiGLU and untied branches of ``models.lm``.
"""
import torch

from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    n_layers=24, d_model=2048, n_heads=16, n_kv=8, d_ff=8192, vocab=92544,
    head_dim=128, norm="rms", act="swiglu", attn_bias=False, rope_theta=1e6,
    tie_embeddings=False, dtype=torch.bfloat16, remat=True)

SMOKE = LMConfig(
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=128,
    head_dim=16, norm="rms", act="swiglu", attn_bias=False,
    tie_embeddings=False, dtype=torch.float32)
