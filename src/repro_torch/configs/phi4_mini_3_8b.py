"""Phi-4-mini 3.8B (RoPE SwiGLU GQA) [arXiv:2412.08905].

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200_064,
    pattern=(ATTN,),
    tie_embeddings=True,
    sliding_window=8192,
    source="arXiv:2412.08905",
)
