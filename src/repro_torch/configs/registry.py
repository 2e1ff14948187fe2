"""The 10 assigned architectures (exact figures from the assignment table)
plus the paper's own dense-linear-algebra problem configs.

Sources are cited per entry ([arXiv/hf; tier] from the assignment).  Every
config is selectable via ``--arch <id>`` in the launchers.
"""

from __future__ import annotations

from .base import (EncoderConfig, ModelConfig, MoEConfig, SHAPES, ShapeConfig,
                   SSMConfig, VisionConfig)

ARCHS: dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# --- dense LM-family -------------------------------------------------------

# [arXiv:2405.04324; hf] llama-arch code model, MQA (kv=1)
GRANITE_20B = _register(ModelConfig(
    name="granite-20b", family="dense", n_layers=52, d_model=6144,
    n_heads=48, n_kv_heads=1, d_ff=24576, vocab_size=49152,
    gated_mlp=False, activation="gelu", positions="rope",
    block_pattern="dense", logits_chunk=512,
))

# [hf:Qwen/Qwen1.5-0.5B family; hf] QKV bias, MHA (kv=heads)
QWEN15_4B = _register(ModelConfig(
    name="qwen1.5-4b", family="dense", n_layers=40, d_model=2560,
    n_heads=20, n_kv_heads=20, d_ff=6912, vocab_size=151936,
    qkv_bias=True, gated_mlp=True, activation="silu", positions="rope",
    block_pattern="dense", logits_chunk=512,
))

# [arXiv:2402.19173; hf] GQA kv=2, RoPE, plain MLP
STARCODER2_3B = _register(ModelConfig(
    name="starcoder2-3b", family="dense", n_layers=30, d_model=3072,
    n_heads=24, n_kv_heads=2, d_ff=12288, vocab_size=49152,
    qkv_bias=True, gated_mlp=False, activation="gelu", positions="rope",
    block_pattern="dense", logits_chunk=512,
))

# [hf:Qwen/Qwen1.5-110B; hf] QKV bias, GQA kv=8
QWEN15_110B = _register(ModelConfig(
    name="qwen1.5-110b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=49152, vocab_size=152064,
    qkv_bias=True, gated_mlp=True, activation="silu", positions="rope",
    block_pattern="dense", logits_chunk=256,
))

# --- audio enc-dec -----------------------------------------------------------

# [arXiv:2212.04356; unverified] enc-dec, conv frontend STUBBED
WHISPER_TINY = _register(ModelConfig(
    name="whisper-tiny", family="audio", n_layers=4, d_model=384,
    n_heads=6, n_kv_heads=6, d_ff=1536, vocab_size=51865,
    gated_mlp=False, activation="gelu", positions="learned",
    max_position=33280,      # extended for the decode_32k dry-run cell
    block_pattern="encdec",
    encoder=EncoderConfig(n_layers=4, n_frames=1500), logits_chunk=512,
))

# --- ssm ---------------------------------------------------------------------

# [arXiv:2405.04517; unverified] alternating sLSTM + mLSTM, no FFN
XLSTM_350M = _register(ModelConfig(
    name="xlstm-350m", family="ssm", n_layers=24, d_model=1024,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=50304,
    gated_mlp=False, activation="gelu", positions="none",
    block_pattern="mlstm_slstm", ssm=SSMConfig(state_dim=16, chunk=256),
    tie_embeddings=True, logits_chunk=512,
))

# --- vlm ---------------------------------------------------------------------

# [hf:meta-llama/Llama-3.2-11B-Vision; unverified] cross-attn image layers,
# patch frontend STUBBED
LLAMA32_VISION_11B = _register(ModelConfig(
    name="llama-3.2-vision-11b", family="vlm", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=128256,
    gated_mlp=True, activation="silu", positions="rope",
    block_pattern="vlm", vision=VisionConfig(n_image_tokens=1601,
                                             cross_attn_every=5),
    logits_chunk=512,
))

# --- moe ---------------------------------------------------------------------

# [hf:Snowflake/snowflake-arctic-base; hf] 128 experts top-2 + dense residual
ARCTIC_480B = _register(ModelConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=4864, vocab_size=32000,
    gated_mlp=True, activation="silu", positions="rope",
    block_pattern="moe",
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual=True, d_ff_dense=4864),
    logits_chunk=512,
))

# [hf:Qwen/Qwen1.5-MoE-A2.7B; hf] 60 routed top-4 + 4 shared experts
QWEN2_MOE_A27B = _register(ModelConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=151936,
    qkv_bias=True, gated_mlp=True, activation="silu", positions="rope",
    block_pattern="moe",
    moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408,
                  n_shared_experts=4, d_ff_shared=4 * 1408),
    logits_chunk=512,
))

# --- hybrid --------------------------------------------------------------------

# [arXiv:2411.13676; hf] parallel attn+mamba heads, SWA + SSD (sub-quadratic)
HYMBA_15B = _register(ModelConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, d_ff=5504, vocab_size=32001,
    gated_mlp=True, activation="silu", positions="rope",
    sliding_window=1024, block_pattern="hymba",
    ssm=SSMConfig(state_dim=16, chunk=256), head_dim=64,
    logits_chunk=512,
))


# --- shape cells & skips -----------------------------------------------------

def cells(arch: str):
    """The shape cells that apply to this arch (assignment skip rules)."""
    cfg = ARCHS[arch]
    out = []
    for shape in SHAPES.values():
        if shape.name == "long_500k" and cfg.full_attention:
            continue  # pure full-attention: mandated skip (DESIGN.md §5)
        out.append(shape)
    return out


ALL_CELLS = [(a, s.name) for a in ARCHS for s in cells(a)]


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
