"""granite-moe-3b-a800m [hf:ibm-granite], PyTorch port of
``repro.configs.granite_moe_3b_a800m`` (numbers copied, not imported).

32L, d_model=1536, 24 q heads over 8 kv heads (GQA group 3), head_dim 64,
per-expert d_ff=512, vocab=49155, 40 experts top-8 zero-padded to 48
(the reference pads for an even 16-way expert split; the router spans the
40 real experts), RoPE theta 1e4, tied embeddings. ``SMOKE`` is the
reference's reduced model for CPU tests (5 experts padded to 8).
"""
import torch

from repro_torch.configs.base import LM_SHAPES, ArchSpec
from repro_torch.models.lm import LMConfig
from repro_torch.models.moe import MoEConfig

MOE = MoEConfig(d_model=1536, d_ff=512, n_experts=40, top_k=8,
                capacity_factor=1.25, group_size=512, n_experts_padded=48)

CONFIG = LMConfig(
    n_layers=32, d_model=1536, n_heads=24, n_kv=8, d_ff=0, vocab=49155,
    head_dim=64, norm="rms", act="swiglu", attn_bias=False, rope_theta=1e4,
    tie_embeddings=True, moe=MOE, dtype=torch.bfloat16, remat=True)

SMOKE = LMConfig(
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=0, vocab=131,
    head_dim=16, norm="rms", act="swiglu", attn_bias=False,
    tie_embeddings=True, dtype=torch.float32,
    moe=MoEConfig(d_model=64, d_ff=32, n_experts=5, top_k=2, group_size=32,
                  n_experts_padded=8))

ARCH = ArchSpec(
    name="granite-moe-3b-a800m", family="lm", config=CONFIG, smoke_config=SMOKE,
    shapes=LM_SHAPES, train_profile="fsdp_ep_tp", serve_profile="ep_tp",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (family)",
    notes="long_500k skipped: pure full-attention GQA. Experts padded 40->48.")
