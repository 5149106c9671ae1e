"""Qwen3-MoE 235B-A22B family config [hf:Qwen/Qwen3-30B-A3B].

94L d_model=4096 64H (GQA kv=4) d_ff=1536(per-expert) vocab=151936,
MoE 128 experts top-8.  Sliding-window decode variant (window 8192) enables
the long_500k shape with bounded KV memory.
"""
from repro_torch.configs.base import ATTN_MOE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151_936,
    pattern=(ATTN_MOE,),
    moe=MoEConfig(num_experts=128, top_k=8),
    rope_theta=1_000_000.0,
    sliding_window=8192,
    source="hf:Qwen/Qwen3-30B-A3B",
)
