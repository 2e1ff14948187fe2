"""Architecture config schema.

Every assigned architecture is expressed as a ``ModelConfig``; reduced
smoke-test versions come from ``ModelConfig.reduced()``.  Configs are plain
frozen dataclasses — no framework magic — and are the single source of
truth for parameter shapes, sharding rules and the dry-run input specs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0          # always-on experts (qwen2-moe)
    d_ff_shared: int = 0               # total shared width
    dense_residual: bool = False       # parallel dense FFN (arctic)
    d_ff_dense: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16                # per-head SSD/conv state
    n_ssm_heads: int = 0               # 0 -> same as n_heads
    conv_kernel: int = 4
    chunk: int = 256                   # chunked-scan block


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder (the conv/patch frontend is a stub: the dry-run
    feeds precomputed frame/patch embeddings via input_specs)."""
    n_layers: int
    n_frames: int = 1500               # post-conv audio frames / patches
    bidirectional: bool = True


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """Llama-3.2-Vision-style cross-attention to stubbed patch embeddings."""
    n_image_tokens: int = 1601
    cross_attn_every: int = 5          # a cross-attn layer every N layers


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    gated_mlp: bool = True             # SwiGLU vs plain GELU
    activation: str = "silu"
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    positions: str = "rope"            # rope | learned | none
    max_position: int = 0              # for learned positions
    sliding_window: int = 0            # 0 = full attention
    block_pattern: str = "dense"       # dense|moe|mlstm_slstm|hymba|encdec|vlm
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None
    # runtime knobs
    dtype: str = "bfloat16"
    remat: bool = True
    logits_chunk: int = 0              # chunked loss (0 = whole)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def full_attention(self) -> bool:
        """True when the arch has no sub-quadratic path (long_500k skip)."""
        return self.family in ("dense", "moe", "audio", "vlm") and \
            self.sliding_window == 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, L = self.d_model, self.n_layers
        hd = self.hd
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
            + hd * self.n_heads * d
        if self.block_pattern == "mlstm_slstm":
            blk = 8 * d * d  # q,k,v,o + gates, rough
        else:
            mlp_mult = 3 if self.gated_mlp else 2
            mlp = mlp_mult * d * self.d_ff
            if self.moe:
                m = self.moe
                mlp = m.n_experts * mlp_mult * d * m.d_ff_expert \
                    + mlp_mult * d * m.d_ff_shared \
                    + (mlp_mult * d * m.d_ff_dense if m.dense_residual else 0) \
                    + d * m.n_experts
            blk = attn + mlp
        enc = 0
        if self.encoder:
            enc = self.encoder.n_layers * (attn + (2 if not self.gated_mlp
                                                   else 3) * d * self.d_ff)
        return int(emb + L * blk + enc)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.param_count()
        m = self.moe
        mlp_mult = 3 if self.gated_mlp else 2
        full = self.param_count()
        routed = self.n_layers * m.n_experts * mlp_mult * self.d_model * m.d_ff_expert
        active = self.n_layers * m.top_k * mlp_mult * self.d_model * m.d_ff_expert
        return int(full - routed + active)

    def reduced(self, *, n_layers: int = 2, d_model: int = 64,
                n_heads: int = 4, vocab: int = 256) -> "ModelConfig":
        """Same-family tiny config for CPU smoke tests."""
        kv = max(1, min(self.n_kv_heads, n_heads)
                 if self.n_kv_heads < self.n_heads else n_heads)
        changes = dict(
            n_layers=n_layers, d_model=d_model, n_heads=n_heads,
            n_kv_heads=kv, head_dim=d_model // n_heads,
            d_ff=0 if self.d_ff == 0 else d_model * 4 if not self.gated_mlp
            else int(d_model * 8 / 3) // 8 * 8,
            vocab_size=vocab, max_position=max(self.max_position and 512, 0),
            dtype="float32", remat=False,
        )
        if self.moe:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=min(8, self.moe.n_experts),
                top_k=min(2, self.moe.top_k), d_ff_expert=d_model * 2,
                d_ff_shared=d_model * 2 if self.moe.d_ff_shared else 0,
                d_ff_dense=d_model * 2 if self.moe.dense_residual else 0)
        if self.ssm:
            changes["ssm"] = dataclasses.replace(self.ssm, state_dim=8, chunk=32)
        if self.encoder:
            changes["encoder"] = dataclasses.replace(
                self.encoder, n_layers=n_layers, n_frames=16)
        if self.vision:
            changes["vision"] = dataclasses.replace(
                self.vision, n_image_tokens=17, cross_attn_every=2)
        if self.sliding_window:
            changes["sliding_window"] = 16
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
