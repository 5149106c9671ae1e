"""InternVL2-26B language backbone (InternLM2-20B-class) [arXiv:2404.16821].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.  The InternViT-6B
vision encoder + MLP projector are a STUB per assignment: ``input_specs``
supplies 256 precomputed patch embeddings per image, prepended to the token
sequence.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16_384,
    vocab_size=92_553,
    pattern=(ATTN,),
    frontend="patches",
    num_prefix_embeddings=256,
    sliding_window=8192,
    source="arXiv:2404.16821",
)
