"""Declarative client->server wire-protocol codecs: specs + registry.

Counterpart of ``repro/core/codecs``: one :class:`CodecSpec` per wire
format (``builtin.py``: none, int8, topk, dp_gauss); both engines of
the python driver interpret them, aggregating the cohort through the
codec-aggregate kernel (``kernels/codec.py``).  Register a spec and
every path -- and ``FederatedConfig.codec`` validation and the byte
telemetry -- picks it up.
"""
from repro_torch.core.codecs.spec import (DENSE_BYTES, CodecDraws, CodecSpec,
                                          available_codecs, codec_spec,
                                          decode_aggregate, encode_stacked,
                                          init_ef, is_trivial,
                                          register_codec, round_bytes,
                                          round_draws, topk_keep,
                                          unregister_codec)
from repro_torch.core.codecs import builtin  # noqa: F401  (registers)

__all__ = [
    "CodecSpec", "CodecDraws",
    "register_codec", "unregister_codec", "codec_spec",
    "available_codecs", "is_trivial",
    "encode_stacked", "decode_aggregate", "init_ef",
    "round_draws", "round_bytes", "topk_keep",
    "DENSE_BYTES",
]
