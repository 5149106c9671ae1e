"""Jamba-v0.1 52B (Mamba+attention 1:7 interleave, MoE) [arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16 experts top-2.
Repeating 8-layer block: attention at index 4, MoE FFN on odd indices
(1:7 attn:mamba ratio, MoE every other layer, as in the paper).
"""
from repro_torch.configs.base import ATTN, MAMBA, MAMBA_MOE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=65_536,
    pattern=(MAMBA, MAMBA_MOE, MAMBA, MAMBA_MOE,
             ATTN, MAMBA_MOE, MAMBA, MAMBA_MOE),
    moe=MoEConfig(num_experts=16, top_k=2),
    ssm_state_dim=16,
    ssm_conv_dim=4,
    ssm_expand=2,
    source="arXiv:2403.19887",
)
