"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B], PyTorch port of
``repro.configs.qwen3_moe_30b_a3b`` (numbers copied, not imported).

48L, d_model=2048, 32 q heads over 4 kv heads (GQA group 8), head_dim 128,
per-expert d_ff=768, vocab=151936, 128 experts top-8 (routing groups of
512), qk-norm, RoPE theta 1e6, untied ``lm_head``. 30.5 B parameters,
61 GB in bf16. ``SMOKE`` is the reference's reduced model for CPU tests.
"""
import torch

from repro_torch.configs.base import LM_SHAPES, ArchSpec
from repro_torch.models.lm import LMConfig
from repro_torch.models.moe import MoEConfig

MOE = MoEConfig(d_model=2048, d_ff=768, n_experts=128, top_k=8,
                capacity_factor=1.25, group_size=512)

CONFIG = LMConfig(
    n_layers=48, d_model=2048, n_heads=32, n_kv=4, d_ff=0, vocab=151936,
    head_dim=128, norm="rms", act="swiglu", attn_bias=False, qk_norm=True,
    rope_theta=1e6, tie_embeddings=False, moe=MOE, dtype=torch.bfloat16,
    remat=True)

SMOKE = LMConfig(
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=0, vocab=128,
    head_dim=16, norm="rms", act="swiglu", attn_bias=False, qk_norm=True,
    tie_embeddings=False, dtype=torch.float32,
    moe=MoEConfig(d_model=64, d_ff=32, n_experts=8, top_k=2, group_size=32))

ARCH = ArchSpec(
    name="qwen3-moe-30b-a3b", family="lm", config=CONFIG, smoke_config=SMOKE,
    shapes=LM_SHAPES, train_profile="fsdp_ep_tp", serve_profile="ep_tp",
    source="hf:Qwen/Qwen3-30B-A3B",
    notes="long_500k skipped: pure full-attention GQA (DESIGN.md). "
          "EP: 128 experts / 16-way model axis = 8 per chip.")
