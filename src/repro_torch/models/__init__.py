"""The paper's experiment models (PyTorch port)."""
from repro_torch.models.param import (ParamSpec, init_params,
                                      params_from_numpy, params_to_numpy)

__all__ = ["ParamSpec", "init_params", "params_from_numpy",
           "params_to_numpy"]
