"""Models of the port: the paper's experiment models (logistic
regression and the two LSTMs, ``models/small.py``) and the LM stack
(``models/transformer.py``, dense, MoE and mamba blocks; the MoE layer
in ``models/moe.py``, the Mamba mixer in ``models/ssm.py``)."""
from repro_torch.models.moe import group_capacity, moe_ffn, moe_specs
from repro_torch.models.param import (ParamSpec, init_params, param_count,
                                      params_from_numpy, params_to_numpy)
from repro_torch.models.ssm import (chunked_scan, mamba_decode_step,
                                    mamba_init_state, mamba_mixer,
                                    mamba_specs)
from repro_torch.models.transformer import (decode_cache_specs, decode_step,
                                            effective_cache_len,
                                            forward_hidden, loss_fn,
                                            model_specs, prefill)

__all__ = ["ParamSpec", "init_params", "param_count", "params_from_numpy",
           "params_to_numpy", "model_specs", "prefill", "decode_step",
           "decode_cache_specs", "effective_cache_len", "forward_hidden",
           "loss_fn", "moe_specs", "moe_ffn", "group_capacity",
           "mamba_specs", "mamba_mixer", "mamba_decode_step",
           "mamba_init_state", "chunked_scan"]
