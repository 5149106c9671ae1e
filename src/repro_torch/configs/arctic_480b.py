"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864(per-expert) vocab=32000,
MoE 128 experts top-2 with a dense FFN residual branch in parallel.
"""
from repro_torch.configs.base import ATTN_MOE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32_000,
    pattern=(ATTN_MOE,),
    moe=MoEConfig(num_experts=128, top_k=2, dense_residual=True,
                  dense_residual_d_ff=4864),
    sliding_window=8192,
    source="hf:Snowflake/snowflake-arctic-base",
)
