"""xLSTM-350M (sLSTM + mLSTM blocks) [arXiv:2405.04517].

24L d_model=1024 4H d_ff=0 (block-internal up-projections) vocab=50304.
Alternating sLSTM / mLSTM pattern; recurrent O(1)-state decode runs
long_500k natively.
"""
from repro_torch.configs.base import MLSTM, SLSTM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    pattern=(SLSTM, MLSTM),
    source="arXiv:2405.04517",
)
