"""Minitron-8B (pruned Nemotron) [arXiv:2407.14679].

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16_384,
    vocab_size=256_000,
    pattern=(ATTN,),
    sliding_window=8192,
    source="arXiv:2407.14679",
)
