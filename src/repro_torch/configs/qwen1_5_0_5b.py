"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B].

24L d_model=1024 16H (GQA kv=16, i.e. MHA) d_ff=2816 vocab=151936, QKV bias.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151_936,
    pattern=(ATTN,),
    qkv_bias=True,
    tie_embeddings=True,
    sliding_window=8192,
    source="hf:Qwen/Qwen1.5-0.5B",
)
