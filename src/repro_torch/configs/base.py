"""Model and federated round configuration.

``ModelConfig``, ``MoEConfig`` and ``InputShape`` are counterparts of
``repro/configs/base.py:15-153``: the same fields, defaults, derived
properties and ``reduced()`` preset, so an architecture reads the same in
both packages.  The model path of the port takes the ``attn``,
``attn_moe``, ``mamba``, ``mamba_moe``, ``mlstm`` and ``slstm`` block
kinds and the encoder-decoder with the frames frontend, serving and
training (``models/transformer.py`` refuses the patch frontend as not
yet ported).

``FederatedConfig`` is the counterpart of the reference's
``FederatedConfig``: the same fields, defaults and validation, checked
against the port's own registries (algorithms, scenarios, codecs).
Every round driver and client source it names is ported: a streaming
source (``data.shard_source.ClientShardSource``) and the client mesh
(``mesh_devices``, ``edge_shards``, with the batched engine; its ranks
come from ``core.sharding.run_on_mesh``) run on all three drivers,
alone or together.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Block kinds used by the layer pattern of an architecture.
ATTN = "attn"          # full-attention transformer block (dense FFN)
ATTN_MOE = "attn_moe"  # attention block with MoE FFN
MAMBA = "mamba"        # Mamba mixer + dense SwiGLU FFN
MAMBA_MOE = "mamba_moe"  # Mamba mixer + MoE FFN (Jamba)
SLSTM = "slstm"        # xLSTM sLSTM block
MLSTM = "mlstm"        # xLSTM mLSTM block


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts configuration."""
    num_experts: int
    top_k: int
    # Arctic-style dense FFN residual in parallel with the MoE branch.
    dense_residual: bool = False
    # d_ff of the parallel dense branch (0 -> reuse d_ff).
    dense_residual_d_ff: int = 0
    # router load-balance auxiliary loss weight
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.

    ``pattern`` is the repeating unit of block kinds; the full layer stack is
    ``pattern`` tiled to ``num_layers`` (``num_layers % len(pattern) == 0``).
    A homogeneous arch has ``pattern=(ATTN,)``.
    """
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[str, ...] = (ATTN,)
    moe: Optional[MoEConfig] = None
    head_dim: int = 0                # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rms_norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- enc-dec (audio) ---
    encoder_decoder: bool = False
    num_encoder_layers: int = 0
    # --- modality frontend stubs ---
    # "none": token ids; "frames": precomputed audio frame embeddings;
    # "patches": precomputed vision patch embeddings prepended to tokens.
    frontend: str = "none"
    num_prefix_embeddings: int = 0   # VLM: number of stub patch embeddings
    # --- SSM ---
    ssm_state_dim: int = 16          # Mamba N
    ssm_conv_dim: int = 4            # Mamba conv kernel
    ssm_expand: int = 2              # Mamba E
    # --- long-context ---
    sliding_window: int = 0          # 0 = full attention; >0 enables SWA decode
    # provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        reps, rem = divmod(self.num_layers, len(self.pattern))
        assert rem == 0, (
            f"{self.name}: num_layers={self.num_layers} not a multiple of "
            f"pattern length {len(self.pattern)}")
        return self.pattern * reps

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    @property
    def supports_subquadratic_decode(self) -> bool:
        """True if long-context decode is bounded-memory for this arch."""
        if self.encoder_decoder:
            return False  # full cross-attention, no SWA variant in family
        kinds = set(self.pattern)
        if kinds <= {MAMBA, MAMBA_MOE, SLSTM, MLSTM}:
            return True   # recurrent: O(1) state
        return self.sliding_window > 0 or bool(
            kinds & {MAMBA, MAMBA_MOE, SLSTM, MLSTM})

    def reduced(self, *, num_layers: int = 2, d_model: int = 256,
                num_heads: int = 4, num_kv_heads: int = 0, d_ff: int = 512,
                vocab_size: int = 512, max_experts: int = 4) -> "ModelConfig":
        """A smoke-test-sized variant of the same family."""
        nkv = num_kv_heads or max(1, min(num_heads, self.num_kv_heads))
        pattern = self.pattern
        layers = num_layers * len(pattern)  # keep one full pattern repeat min
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, max_experts),
                top_k=min(self.moe.top_k, 2),
                dense_residual_d_ff=min(self.moe.dense_residual_d_ff, d_ff)
                if self.moe.dense_residual_d_ff else 0,
            )
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=layers,
            num_encoder_layers=min(self.num_encoder_layers, 2),
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=nkv,
            head_dim=0,
            d_ff=d_ff if self.d_ff else 0,
            vocab_size=vocab_size,
            moe=moe,
            num_prefix_embeddings=min(self.num_prefix_embeddings, 8),
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0,
            ssm_state_dim=min(self.ssm_state_dim, 8),
        )


@dataclass(frozen=True)
class InputShape:
    """One entry of the assigned input-shape grid."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                    LONG_500K)}


#: Solver modes of ``core/client.py`` (mirrored here: configs is a leaf
#: layer and must not import the client).
SOLVER_MODES = ("auto", "flat", "per_leaf", "fused_step", "fused_epoch")


def _not_ported(what: str) -> ValueError:
    return ValueError(f"{what} is not yet ported to repro_torch")


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


@dataclass(frozen=True)
class FederatedConfig:
    """Federated round configuration (paper Alg. 1/2 + registered
    strategies); field meanings as in the reference."""
    algorithm: str = "feddane"       # any repro_torch.core.strategies name
    num_devices: int = 30            # N
    devices_per_round: int = 10      # K
    local_epochs: int = 20           # E
    local_batch_size: int = 10
    learning_rate: float = 0.01
    mu: float = 0.0                  # proximal penalty
    sample_with_replacement: bool = False
    weighted_sampling: bool = True   # p_k = n_k / n (paper §III-A)
    correction_decay: float = 1.0    # decayed FedDANE (§V-C)
    seed: int = 0
    server_opt: str = "sgd"          # sgd | momentum | adam
    server_lr: float = 1.0
    server_momentum: float = 0.9
    center_lr: float = 0.5           # sdane center step
    # "batched" (one stacked round through the kernels), "loop" (the
    # per-device reference), "auto": batched on the card, loop on CPU
    engine: str = "auto"
    # python / scan / buffered; "auto" = scan wherever the engine is
    # batched (core/algorithms.py)
    round_driver: str = "auto"
    buffer_size: int = 0
    staleness_fn: str = "polynomial"
    max_staleness: int = 0
    local_solver: str = "auto"       # core/client.py SOLVER_MODES
    chunk_rounds: int = 32
    mesh_devices: int | str = 1
    edge_shards: int = 1
    client_source: str = "auto"
    scenario: str = "ideal"          # any repro_torch.core.scenarios name
    avail_prob: float = 0.9
    diurnal_period: int = 8
    straggler_sigma: float = 0.5
    straggler_deadline: float = 2.0
    dropout_rate: float = 0.1
    partial_min_work: float = 0.5
    codec: str = "none"              # any repro_torch.core.codecs name
    bits: int = 8
    topk_frac: float = 0.1
    clip_norm: float = 1.0
    noise_mult: float = 1.0

    def __post_init__(self):
        from repro_torch.core.codecs import codec_spec
        from repro_torch.core.scenarios import scenario_spec
        from repro_torch.core.strategies import (algorithm_spec,
                                                 validate_server_opt)
        algorithm_spec(self.algorithm)
        validate_server_opt(self.server_opt)
        scenario_spec(self.scenario)
        codec_spec(self.codec)
        if self.engine not in ("auto", "batched", "loop"):
            raise ValueError(
                f"unknown engine {self.engine!r}; choose from "
                f"auto/batched/loop")
        if self.round_driver not in ("auto", "python", "scan",
                                     "buffered"):
            raise ValueError(
                f"unknown round_driver {self.round_driver!r}; choose "
                f"from auto/python/scan/buffered")
        if not (_is_int(self.bits) and 2 <= self.bits <= 8):
            raise ValueError(
                f"bits must be an int in [2, 8], got {self.bits!r}")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(
                f"topk_frac must be in (0, 1], got {self.topk_frac}")
        if self.clip_norm <= 0.0 or self.noise_mult < 0.0:
            raise ValueError(
                f"clip_norm must be > 0 and noise_mult >= 0, got "
                f"{self.clip_norm}/{self.noise_mult}")
        if not 0.0 < self.avail_prob <= 1.0:
            raise ValueError(
                f"avail_prob must be in (0, 1], got {self.avail_prob}")
        if self.diurnal_period < 1:
            raise ValueError(
                f"diurnal_period must be >= 1, got {self.diurnal_period}")
        if not 0.0 <= self.dropout_rate < 1.0:
            raise ValueError(
                f"dropout_rate must be in [0, 1), got {self.dropout_rate}")
        if self.straggler_sigma < 0.0 or self.straggler_deadline <= 0.0:
            raise ValueError(
                f"straggler_sigma must be >= 0 and straggler_deadline "
                f"> 0, got {self.straggler_sigma}/"
                f"{self.straggler_deadline}")
        if not 0.0 < self.partial_min_work <= 1.0:
            raise ValueError(
                f"partial_min_work must be in (0, 1], got "
                f"{self.partial_min_work}")
        # the staleness-weight families live beside the weight map
        # (core/server.py), like the registries above
        from repro_torch.core.server import STALENESS_FNS
        if self.staleness_fn not in STALENESS_FNS:
            raise ValueError(
                f"unknown staleness_fn {self.staleness_fn!r}; choose "
                f"from {', '.join(STALENESS_FNS)}")
        for knob in ("buffer_size", "max_staleness"):
            v = getattr(self, knob)
            if not (_is_int(v) and v >= 0):
                raise ValueError(
                    f"{knob} must be a non-negative int (0 = default/"
                    f"unlimited), got {v!r}")
        if self.local_solver not in SOLVER_MODES:
            raise ValueError(
                f"local_solver must be one of auto/flat/per_leaf/"
                f"fused_step/fused_epoch, got {self.local_solver!r}")
        if self.mesh_devices != "auto" and not (
                _is_int(self.mesh_devices) and self.mesh_devices >= 1):
            raise ValueError(
                f"mesh_devices must be a positive int or 'auto', got "
                f"{self.mesh_devices!r}")
        # the looped per-device reference is single-process by
        # construction; "auto" may still resolve to 1, so only a concrete
        # int is rejected here (the trainer re-checks after resolution)
        if (self.engine == "loop" and _is_int(self.mesh_devices)
                and self.mesh_devices > 1):
            raise ValueError(
                f"engine='loop' does not compose with mesh_devices="
                f"{self.mesh_devices}: the looped per-device reference "
                f"path is single-process by construction (set "
                f"engine='batched' or 'auto', or mesh_devices=1)")
        if not (_is_int(self.edge_shards) and self.edge_shards >= 1):
            raise ValueError(
                f"edge_shards must be a positive int, got "
                f"{self.edge_shards!r}")
        if (_is_int(self.mesh_devices) and self.edge_shards > 1
                and self.mesh_devices % self.edge_shards != 0):
            # "auto" resolves at trainer build; core.sharding re-checks
            raise ValueError(
                f"edge_shards={self.edge_shards} must divide "
                f"mesh_devices={self.mesh_devices} (each edge "
                f"aggregates an equal leaf-device group)")
        if self.client_source not in ("auto", "stacked", "streaming"):
            raise ValueError(
                f"unknown client_source {self.client_source!r}; choose "
                f"from auto/stacked/streaming")


def one_shot_config(num_devices: int, *, local_epochs: int = 50,
                    **overrides) -> FederatedConfig:
    """The one-shot federation preset: every device trains a fully
    local model and the server aggregates once (run ``num_rounds=1``)."""
    kw = dict(algorithm="one_shot", num_devices=num_devices,
              devices_per_round=num_devices, local_epochs=local_epochs)
    kw.update(overrides)
    return FederatedConfig(**kw)
