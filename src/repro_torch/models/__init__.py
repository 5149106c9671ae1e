"""Models of the port: the paper's experiment models (logistic
regression and the two LSTMs, ``models/small.py``) and the LM stack
(``models/transformer.py``, dense, MoE, mamba and xLSTM blocks and the
encoder-decoder; the MoE layer in ``models/moe.py``, the Mamba mixer in
``models/ssm.py``, the mLSTM and sLSTM mixers in ``models/xlstm.py``)."""
from repro_torch.models.moe import group_capacity, moe_ffn, moe_specs
from repro_torch.models.param import (ParamSpec, init_params, param_count,
                                      params_from_numpy, params_to_numpy)
from repro_torch.models.ssm import (chunked_scan, mamba_decode_step,
                                    mamba_init_state, mamba_mixer,
                                    mamba_specs)
from repro_torch.models.transformer import (decode_cache_specs, decode_step,
                                            effective_cache_len,
                                            fill_cross_cache,
                                            forward_hidden, loss_fn,
                                            model_specs, prefill)
from repro_torch.models.xlstm import (mlstm_decode_step, mlstm_init_state,
                                      mlstm_mixer, mlstm_specs,
                                      slstm_decode_step, slstm_init_state,
                                      slstm_mixer, slstm_specs)

__all__ = ["ParamSpec", "init_params", "param_count", "params_from_numpy",
           "params_to_numpy", "model_specs", "prefill", "decode_step",
           "decode_cache_specs", "effective_cache_len", "fill_cross_cache",
           "forward_hidden", "loss_fn", "moe_specs", "moe_ffn",
           "group_capacity", "mamba_specs", "mamba_mixer", "mamba_decode_step",
           "mamba_init_state", "chunked_scan", "mlstm_specs", "mlstm_mixer",
           "mlstm_decode_step", "mlstm_init_state", "slstm_specs",
           "slstm_mixer", "slstm_decode_step", "slstm_init_state"]
