"""Whisper-tiny transformer backbone [arXiv:2212.04356].

4L enc + 4L dec, d_model=384 6H d_ff=1536 vocab=51865.  The mel-spectrogram +
conv frontend is a STUB per assignment: ``input_specs`` supplies precomputed
frame embeddings of shape (batch, frames, d_model).
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    num_encoder_layers=4,
    encoder_decoder=True,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    pattern=(ATTN,),
    frontend="frames",
    source="arXiv:2212.04356",
)
