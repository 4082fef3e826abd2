"""Model configuration for the architecture pool (port of
``repro.models.config``).

One ``ModelConfig`` describes every family in the pool (dense / GQA / MoE /
SSM / hybrid / enc-dec / stub-frontend).  The layer stack is a
``block_pattern`` (e.g. ``("rglru", "rglru", "attn")``) repeated over the
depth; homogeneous runs are stacked along a leading dim so each unit's
parameters sit in one tensor per leaf.  Fields, properties, ``SHAPES`` and
``shape_applicable`` are the reference's; ``n_params`` counts the port's
own specs (``repro_torch.models.model.param_specs``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal, Tuple

BlockKind = Literal["attn", "local_attn", "mlp", "moe", "ssd", "rglru"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    norm: str = "rms"                  # rms | layer
    act: str = "silu"                  # silu (SwiGLU) | gelu
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # Sequence-mixing pattern per layer; "attn" entries also get an "mlp".
    block_pattern: Tuple[str, ...] = ("attn",)
    local_window: int = 2048           # for local_attn blocks
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                  # per-expert hidden
    capacity_factor: float = 1.25
    moe_group_size: int = 256
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssd_bf16_intra: bool = False
    # --- hybrid (RG-LRU) ---
    rnn_width: int = 0
    rglru_c: float = 8.0
    rglru_block_diag: int = 0
    # --- serving ---
    # int8 KV cache with per (batch, head, position) scales.
    kv_quant: bool = False
    # Pad KV heads up to tp_pad (a sharding lever: ROADMAP item 14).
    pad_kv_heads: bool = False
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    n_audio_frames: int = 0
    # --- stub modality frontend ---
    input_mode: str = "tokens"         # tokens | embeddings
    # --- distribution-facing knobs ---
    tp_pad: int = 16                   # pad head counts to a multiple of this
    vocab_pad: int = 16                # pad vocab to a multiple of this
    sharding_profile: str = "2d"       # "2d" (FSDP+TP) | "fsdp" (ZeRO-only)
    param_dtype: str = "f32"           # "bf16" for serving deployments
    remat: bool = True
    microbatch: int = 1                # grad-accum microbatches in train_step
    # --- attention memory knobs ---
    attn_block_q: int = 512
    attn_block_kv: int = 1024

    # ------------------------------------------------------------------
    @property
    def padded_heads(self) -> int:
        return _round_up(self.n_heads, self.tp_pad)

    @property
    def padded_kv_heads(self) -> int:
        """KV heads are replicated when fewer than tp_pad, unless
        ``pad_kv_heads`` forces padding so the cache shards (serving)."""
        if self.n_kv_heads >= self.tp_pad or self.pad_kv_heads:
            return _round_up(self.n_kv_heads, self.tp_pad)
        return self.n_kv_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab, self.vocab_pad)

    @property
    def q_per_kv(self) -> int:
        return self.padded_heads // self.padded_kv_heads

    @property
    def d_inner(self) -> int:          # SSD inner width
        return self.ssm_expand * self.d_model

    @property
    def ssd_heads(self) -> int:
        return _round_up(self.d_inner // self.ssm_head_dim, self.tp_pad)

    @property
    def layer_pattern(self) -> Tuple[str, ...]:
        """Full per-layer pattern of length n_layers."""
        reps = math.ceil(self.n_layers / len(self.block_pattern))
        return (self.block_pattern * reps)[: self.n_layers]

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for long_500k (no full-attention layer)."""
        return all(b in ("ssd", "rglru", "local_attn")
                   for b in self.layer_pattern)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    def n_params(self) -> int:
        """Parameter count of the port's specs."""
        from . import model as _model  # lazy: avoid cycle
        from .spec import count_params
        return count_params(_model.param_specs(self))

    def n_active_params(self) -> int:
        """Active (per-token) parameters -- differs for MoE."""
        total = self.n_params()
        if self.n_experts:
            per_expert = 3 * self.d_model * self.moe_d_ff
            inactive = ((self.n_experts - self.top_k) * per_expert
                        * sum(1 for b in self.layer_pattern if b == "moe"))
            return total - inactive
        return total


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned (shape) column of the reference's dry-run."""

    name: str
    kind: Literal["train", "prefill", "decode"]
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether (arch x shape) is a live dry-run cell."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, ("full-attention architecture: 500k-token decode state "
                       "has no sub-quadratic mechanism (recorded skip)")
    return True, ""
