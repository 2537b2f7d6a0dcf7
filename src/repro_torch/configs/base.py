"""Model / run configuration dataclasses shared by every architecture.

One ``ModelConfig`` covers the whole assigned zoo (dense / MoE / MLA / SSM /
hybrid / enc-dec / VLM) via family switches; one ``ShapeConfig`` per assigned
input-shape cell; ``RunConfig`` bundles them with LRD + distribution options.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "dense" | "moe" | "encdec" | "ssm" | "hybrid" | "vlm"
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # --- attention options -------------------------------------------------
    qkv_bias: bool = False  # qwen2
    qk_norm: bool = False  # qwen3
    rope_theta: float = 1e6
    attention_impl: str = "blockwise"  # "dense" | "blockwise" | "flash"
    attention_block_q: int = 512
    attention_block_kv: int = 1024
    # --- MLA (deepseek-v3) ---------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # expert hidden dim (deepseek: 2048)
    dense_d_ff: int = 0  # hidden dim of leading dense layers (deepseek: 18432)
    first_k_dense: int = 0  # leading dense layers before MoE starts
    moe_impl: str = "ep"  # "ep" (shard_map all_to_all) | "dense" (tiny tests)
    capacity_factor: float = 1.25
    # --- MTP (deepseek-v3) ---------------------------------------------------
    use_mtp: bool = False
    mtp_loss_weight: float = 0.3
    # --- enc-dec (seamless) ----------------------------------------------------
    num_encoder_layers: int = 0
    encoder_frames: int = 1024  # stub audio frontend: precomputed frames
    # --- SSM / hybrid ----------------------------------------------------------
    ssm_state: int = 0  # mamba2 d_state
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0  # zamba2: shared attn block every N mamba blocks
    xlstm_heads: int = 0  # xlstm: mLSTM heads
    # --- VLM (llama-3.2-vision) -----------------------------------------------
    cross_attn_every: int = 0  # cross-attn layer every N layers
    num_image_tokens: int = 0
    # --- activation / ffn -------------------------------------------------------
    ffn_activation: str = "swiglu"  # "swiglu" | "gelu"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- dtypes ------------------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"  # "int8": quantized cache (decode lever)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a 256 multiple so the logits/vocab axis shards on
        any mesh up to 256-way (Megatron-style padded vocab).  Padded slots
        are masked to -inf at the logits (see models.common.mask_vocab)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def pdtype(self):
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self):
        return getattr(torch, self.compute_dtype)

    def num_params(self) -> int:
        """Analytic parameter count (dense weights, before LRD)."""
        d, v, L = self.d_model, self.vocab_size, self.num_layers
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm" and self.xlstm_heads:
            per = _xlstm_layer_params(self)
            return emb + L * per + d
        total = emb + d  # final norm
        for i in range(L):
            total += _layer_params(self, i)
        if self.num_encoder_layers:
            for _ in range(self.num_encoder_layers):
                total += _enc_layer_params(self)
        if self.use_mtp:
            total += _layer_params(self, self.num_layers - 1) + 2 * d * d
        return total

    def active_params(self) -> int:
        """Params touched per token (MoE: top-k + shared experts only)."""
        if not self.num_experts:
            return self.num_params()
        d, L = self.d_model, self.num_layers
        dense_total = self.num_params()
        moe_layers = L - self.first_k_dense
        all_expert = moe_layers * self.num_experts * 3 * d * self.moe_d_ff
        active_expert = moe_layers * self.num_experts_per_tok * 3 * d * self.moe_d_ff
        return dense_total - all_expert + active_expert


def _attn_params(cfg: ModelConfig) -> int:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    if cfg.use_mla:
        qh = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        return (
            d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.num_heads * qh
            + d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
            + cfg.kv_lora_rank * cfg.num_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)
            + cfg.num_heads * cfg.v_head_dim * d
        )
    q = d * cfg.num_heads * hd
    kv = 2 * d * cfg.num_kv_heads * hd
    o = cfg.num_heads * hd * d
    b = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd if cfg.qkv_bias else 0
    return q + kv + o + b


def _ffn_params(d: int, f: int, activation: str) -> int:
    return 3 * d * f if activation == "swiglu" else 2 * d * f


def _layer_params(cfg: ModelConfig, i: int) -> int:
    d = cfg.d_model
    total = 2 * d + _attn_params(cfg)  # two norms + attention
    if cfg.family == "hybrid":
        # mamba2 layer params (attention counted via attn_every separately)
        d_in = cfg.ssm_expand * d
        nh = d_in // cfg.ssm_head_dim
        conv_dim = d_in + 2 * cfg.ssm_state
        return 2 * d + d * (2 * d_in + 2 * cfg.ssm_state + nh) + conv_dim * cfg.ssm_conv_width + d_in * d + 2 * nh
    if cfg.num_experts and i >= cfg.first_k_dense:
        total += cfg.num_experts * _ffn_params(d, cfg.moe_d_ff, "swiglu")
        total += cfg.num_shared_experts * _ffn_params(d, cfg.moe_d_ff, "swiglu")
        total += d * cfg.num_experts  # router
    else:
        f = cfg.dense_d_ff or cfg.d_ff
        total += _ffn_params(d, f, cfg.ffn_activation)
    return total


def _enc_layer_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    return 2 * d + _attn_params(cfg) + _ffn_params(d, cfg.d_ff, cfg.ffn_activation)


def _xlstm_layer_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    # mLSTM block: qkv + i/f/o gates + up/down proj
    return 2 * d + 3 * d * d + 3 * d * cfg.xlstm_heads + 2 * d * 2 * d + d * d


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class LRDConfig:
    enabled: bool = False
    alpha: float = 2.0
    rank_quantize: bool = True  # Algorithm 1 (analytic-tpu) on by default
    freeze_mode: str = "none"  # none | regular | sequential
    epochs_per_phase: int = 1  # Algorithm-2 alternation cadence (sequential)
    use_pallas_kernel: bool = False  # fused low-rank matmul (TPU only)
    min_dim: int = 128  # skip matrices smaller than this on either side
    # Pallas launch knobs (block sizes must divide the layer dims or the
    # call falls back to the jnp path; interpret runs the kernels on CPU
    # for validation — see kernels/ops.KernelPolicy):
    pallas_block_m: int = 256
    pallas_block_k: int = 512
    pallas_block_n: int = 256
    pallas_interpret: bool = False
    # Kernel autotuning + quantized decode (DESIGN.md §11):
    pallas_autotune: bool = False  # consult the active TuningTable per shape
    pallas_autotune_table: str = ""  # table JSON loaded at policy build time
    pallas_double_buffer: bool = False  # explicit 2-slot DMA pipeline (fwd/dx)
    int8_decode: str = "native"  # int8 export/KV consumption: native | bf16
    # --- in-training rank adaptation (core/rank_adapt.py, DESIGN.md §10) --
    # Fires at sequential-freezing phase boundaries only; "none" keeps the
    # decomposition ranks fixed for the whole run (the default paper flow).
    rank_schedule: str = "none"  # none | decay | energy
    rank_decay: float = 0.75  # per-boundary rank multiplier (decay policy)
    rank_energy_threshold: float = 0.98  # kept singular mass (energy policy)
    rank_min: int = 2  # scheduled ranks never drop below this
    rank_schedule_tile: int = 128  # MXU tile for scheduled-rank quantization
    rank_schedule_start: int = 1  # first phase swap that truncates


@dataclasses.dataclass(frozen=True)
class DistConfig:
    # parameter/optimizer layout:
    #  "fsdp"  — params+opt sharded over (data, model): min memory, but every
    #            matmul pays a weight-gather or split-K act-reduce per use
    #  "zero1" — params TP-only (model), optimizer state + grad accumulators
    #            sharded over (data, model): one reduce-scatter per microbatch
    #            at 1/data size + one param gather per step (§Perf A3)
    param_layout: str = "fsdp"
    fsdp: bool = True  # legacy switch; False == TP-only params AND opt
    remat: str = "full"  # "none" | "full" | "dots" | "sqrt"
    microbatches: int = 1  # gradient-accumulation microbatches
    grad_compression: str = "none"  # "none" | "int8"
    sequence_parallel: bool = False  # shard long KV caches over model axis
    accum_dtype: str = "float32"  # microbatch grad accumulator ("bfloat16" for 100B+)


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    name: str = "adamw"  # "adamw" | "sgdm" (paper uses SGD+momentum)
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 1e-4
    momentum: float = 0.9
    schedule: str = "cosine"
    state_dtype: str = "float32"  # "bfloat16": half-precision moments (HBM trick)


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Telemetry knobs (``repro_torch.obs``).

    ``enabled=False`` (default) writes no JSONL file and changes nothing
    in the step — the train/serve CLIs still mirror their legacy console
    lines.  ``run_dir`` is where ``events.jsonl`` lands (the CLI picks its
    checkpoint/run directory when empty).  ``profile_start/stop`` bracket
    an optional ``torch.profiler`` trace window by step index (both -1 =
    no trace)."""
    enabled: bool = False
    run_dir: str = ""
    log_format: str = "text"  # console mirror: text (legacy lines) | jsonl
    step_every: int = 1  # emit a train_step record every N steps
    profile_start: int = -1  # first step inside the torch.profiler trace
    profile_stop: int = -1  # first step after the trace window


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    lrd: LRDConfig = LRDConfig()
    dist: DistConfig = DistConfig()
    optim: OptimConfig = OptimConfig()
    obs: ObsConfig = ObsConfig()
    seed: int = 0
