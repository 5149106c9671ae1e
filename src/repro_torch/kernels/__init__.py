"""Hand-written CUDA kernels of the port and their wrappers.

- ``dane_update`` (K1 flat, K4 per-leaf): the fused FedDANE update step;
- ``local_solve`` (K2 whole epoch, K3 one step): the fused softmax-
  regression local solve;
- ``codec`` (K5, K6): the fused codec decode + masked cohort mean, and
  the masked sum of one shard of the client mesh;
- ``flash_attention`` (K7): blockwise online-softmax attention, causal
  or not, with GQA-folded query rows (``causal_period``), the prefill
  path's self-attention;
- ``selective_scan`` (K8 and its backward K8-bwd, kernels of the port
  only): the Mamba selective scan of the SSM blocks;
- ``xlstm_scan`` (K9 mLSTM, K10 sLSTM and their backward K9-bwd,
  K10-bwd, kernels of the port only): the xLSTM blocks' recurrences;
- ``vmap_fold``: the kernels' vmap rules' fold of the mapped dim into
  their leading dim;
- ``ops``: tree-level wrappers of the update kernels and the reference's
  GQA wrapper of K7;
- ``ref``: the plain PyTorch version of each kernel;
- ``build``: nvcc at first use, ctypes binding, launch counters.
"""
from repro_torch.kernels.codec import (codec_aggregate,  # noqa: E402
                                       codec_aggregate_partial)
from repro_torch.kernels.flash_attention import flash_attention_3d

__all__ = ["codec_aggregate", "codec_aggregate_partial",
           "flash_attention_3d"]
