"""The 10 assigned architectures (exact configs from the assignment table)
plus reduced smoke variants.  One module per arch also lives alongside
(``deepseek_v3_671b.py`` etc.) re-exporting its config for --arch loading."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.base import SHAPES, ModelConfig

# ---------------------------------------------------------------------------
# Full configs
# ---------------------------------------------------------------------------

DEEPSEEK_V3_671B = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=2048, vocab_size=129280, head_dim=128,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    num_experts=256, num_experts_per_tok=8, num_shared_experts=1,
    moe_d_ff=2048, dense_d_ff=18432, first_k_dense=3,
    use_mtp=True, rope_theta=1e4,
)

OLMOE_1B_7B = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304,
    num_experts=64, num_experts_per_tok=8, moe_d_ff=1024,
    qk_norm=True, rope_theta=1e4,
)

SEAMLESS_M4T_MEDIUM = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206,
    num_encoder_layers=12, encoder_frames=1024,
    ffn_activation="gelu", rope_theta=1e4,
)

QWEN2_72B = ModelConfig(
    name="qwen2-72b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
)

QWEN3_32B = ModelConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
    d_ff=25600, vocab_size=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
)

DEEPSEEK_CODER_33B = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    num_layers=62, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=19200, vocab_size=32256, rope_theta=1e5,
)

SMOLLM_360M = ModelConfig(
    name="smollm-360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
    d_ff=2560, vocab_size=49152, tie_embeddings=True, rope_theta=1e4,
)

XLSTM_350M = ModelConfig(
    name="xlstm-350m", family="ssm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, xlstm_heads=4,
)

LLAMA_32_VISION_90B = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256, rope_theta=5e5,
    cross_attn_every=4, num_image_tokens=4096,
)

ZAMBA2_1_2B = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv_width=4,
    attn_every=6, rope_theta=1e4,
)

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (
        DEEPSEEK_V3_671B, OLMOE_1B_7B, SEAMLESS_M4T_MEDIUM, QWEN2_72B, QWEN3_32B,
        DEEPSEEK_CODER_33B, SMOLLM_360M, XLSTM_350M, LLAMA_32_VISION_90B, ZAMBA2_1_2B,
    )
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


# ---------------------------------------------------------------------------
# Smoke (reduced) configs — same family, tiny dims, CPU-runnable
# ---------------------------------------------------------------------------

def get_smoke_config(arch: str) -> ModelConfig:
    cfg = get_config(arch)
    small = dict(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, attention_impl="dense",
    )
    if cfg.family == "moe":
        small.update(num_experts=8, num_experts_per_tok=2, moe_d_ff=64,
                     moe_impl="dense")
        if cfg.use_mla:
            small.update(num_layers=3, first_k_dense=1, dense_d_ff=128,
                         q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                         qk_rope_head_dim=8, v_head_dim=16, num_heads=4,
                         num_kv_heads=4, num_shared_experts=1)
        else:
            small.update(first_k_dense=0, dense_d_ff=0, num_kv_heads=4)
    if cfg.family == "encdec":
        small.update(num_encoder_layers=2, encoder_frames=16, num_kv_heads=4)
    if cfg.family == "ssm":
        small.update(xlstm_heads=2, num_kv_heads=4)
    if cfg.family == "hybrid":
        small.update(num_layers=5, attn_every=2, ssm_state=8, ssm_head_dim=16,
                     ssm_conv_width=4, ssm_chunk=8, num_heads=8, num_kv_heads=8,
                     head_dim=0)
    if cfg.family == "vlm":
        small.update(num_layers=6, cross_attn_every=2, num_image_tokens=8,
                     num_kv_heads=2)
    if cfg.qk_norm:
        small.update(qk_norm=True)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke",
                               param_dtype="float32", compute_dtype="float32",
                               **small)


# ---------------------------------------------------------------------------
# Shape-cell applicability (DESIGN.md §4)
# ---------------------------------------------------------------------------

_FULL_ATTENTION = {"deepseek-v3-671b", "olmoe-1b-7b", "qwen2-72b", "qwen3-32b",
                   "deepseek-coder-33b", "smollm-360m", "llama-3.2-vision-90b",
                   "seamless-m4t-medium"}


def skip_reason(arch: str, shape: str) -> Optional[str]:
    if shape == "long_500k" and arch in _FULL_ATTENTION:
        return ("long_500k requires sub-quadratic attention; "
                f"{arch} is pure full-attention (assignment rule)")
    return None


def shape_cells(arch: str):
    """All (shape, skip_reason) cells for an arch — 40 total across the zoo."""
    return [(s, skip_reason(arch, s)) for s in SHAPES]
