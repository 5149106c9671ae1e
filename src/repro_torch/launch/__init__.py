"""Entry points of the LM stack: the step functions and the server."""
from repro_torch.launch.steps import (ShapeDtype, abstract_decode_cache,
                                      decode_batch_specs, make_decode_step,
                                      make_prefill_step, prefill_batch_specs)

__all__ = ["ShapeDtype", "abstract_decode_cache", "decode_batch_specs",
           "make_decode_step", "make_prefill_step", "prefill_batch_specs"]
