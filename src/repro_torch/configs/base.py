"""Configuration dataclasses for the repro_torch framework.

Everything is a frozen dataclass so configs hash/compare cleanly and can be
used as cache keys and structural (static) arguments.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention dims (DeepSeek-V2/V3, MiniCPM3)."""
    q_lora_rank: int = 0            # 0 => no query compression
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    num_experts_per_tok: int = 2
    num_shared_experts: int = 0
    d_ff_expert: int = 0            # per-expert hidden dim
    router: str = "softmax"         # "softmax" | "sigmoid" (deepseek-v3)
    aux_loss_coef: float = 0.01
    first_k_dense: int = 0          # leading dense layers (deepseek)
    d_ff_dense: int = 0             # d_ff for those dense layers
    every_k: int = 1                # MoE every k-th layer (jamba: 2)
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"             # "mamba" | "rwkv6"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64              # rwkv6 head size
    dt_rank: int = 0                # 0 => d_model//16 (mamba)


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2
    num_kv_heads: int = 2
    d_ff: int = 512
    vocab_size: int = 256
    head_dim: int = 0               # 0 => d_model // num_heads
    # attention
    attn_type: str = "gqa"          # gqa | mla | none
    rope: str = "rope"              # rope | mrope | none
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    mlp_bias: bool = False
    sliding_window: int = 0         # 0 => full attention
    # position / misc
    max_seq_len: int = 8192
    norm_eps: float = 1e-5
    act: str = "swiglu"             # swiglu | gelu
    tie_embeddings: bool = False
    # sub-configs
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid layout (jamba): attention layer every `attn_period`, at `attn_offset`
    attn_period: int = 0            # 0 => all layers attention (or all ssm if attn_type=="none")
    attn_offset: int = 0
    # encoder-decoder
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    # multimodal frontend stub: "none" | "vision" | "audio"
    frontend: str = "none"
    # deepseek multi-token prediction depth
    mtp_depth: int = 0
    # dtypes
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # padding knobs (optimized configs may override)
    pad_heads_to: int = 0           # 0 => no padding; else pad num_heads up to multiple
    pad_vocab_to: int = 128         # pad vocab to multiple of this (always on)
    # remat policy for the scanned layer body: none | dots | full
    remat: str = "dots"
    # scan-over-layers (True) vs python-loop unroll (False). Unroll is used
    # by the dry-run's per-period cost probes: XLA cost_analysis counts a
    # while-loop body once regardless of trip count.
    scan_layers: bool = True
    # chunked cross-entropy: compute logits+loss per sequence chunk of this
    # many tokens instead of materializing (B, S, V) logits. 0 = off.
    loss_chunk: int = 0

    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def padded_vocab(self) -> int:
        m = max(1, self.pad_vocab_to)
        return ((self.vocab_size + m - 1) // m) * m

    def padded_heads(self) -> int:
        if self.pad_heads_to <= 0:
            return self.num_heads
        m = self.pad_heads_to
        return ((self.num_heads + m - 1) // m) * m

    def padded_kv_heads(self) -> int:
        if self.pad_heads_to <= 0:
            return self.num_kv_heads
        # keep GQA group structure: scale kv heads with the same ratio when the
        # ratio stays integral, else leave unpadded (replication fallback).
        ph = self.padded_heads()
        if ph % self.num_kv_heads == 0 and self.num_heads % self.num_kv_heads == 0:
            return self.num_kv_heads
        return self.num_kv_heads

    def is_attention_layer(self, i: int) -> bool:
        """Hybrid layouts: which layers are attention (vs SSM)."""
        if self.attn_type == "none":
            return False
        if self.attn_period <= 0:
            return True
        return (i % self.attn_period) == self.attn_offset

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        if i < self.moe.first_k_dense:
            return False
        return ((i - self.moe.first_k_dense) % max(1, self.moe.every_k)) == 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axes if a in ("pod", "data"))

    @property
    def model_axis(self) -> str:
        return "model"

    def axis_size(self, name: str) -> int:
        try:
            return self.shape[self.axes.index(name)]
        except ValueError:
            return 1

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.batch_axes:
            n *= self.axis_size(a)
        return n


SINGLE_POD_MESH = MeshConfig((16, 16), ("data", "model"))
MULTI_POD_MESH = MeshConfig((2, 16, 16), ("pod", "data", "model"))
SMOKE_MESH = MeshConfig((1, 1), ("data", "model"))


@dataclass(frozen=True)
class PacingConfig:
    """Paper §4.3/§5.3: adaptive bounded pacing of early-arriving ranks."""
    enabled: bool = True
    window: int = 32                # rolling window of observed wait times
    cv_threshold: float = 0.05      # activate when CV of step/wait exceeds this
    skew_threshold: float = 0.10    # or when relative arrival spread exceeds this
    max_delay_frac: float = 0.5     # bounded: delay <= frac * median step time
    gain: float = 0.5               # fraction of observed skew corrected per step
    decay: float = 0.9              # self-limiting decay when imbalance subsides
    warmup_iters: int = 8           # no pacing until the window has data


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"    # "bfloat16" to halve optimizer memory
    zero1: bool = True              # shard optimizer state over all mesh axes
    grad_compress: str = "none"     # "none" | "int8" (error-feedback int8 allreduce)


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    mesh: MeshConfig = field(default_factory=lambda: SMOKE_MESH)
    pacing: PacingConfig = field(default_factory=PacingConfig)
    seq_len: int = 128
    global_batch: int = 8
    microbatches: int = 1           # gradient accumulation steps
    steps: int = 10
    seed: int = 0
    log_every: int = 1
    ckpt_every: int = 0             # 0 => disabled
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_keep: int = 3
