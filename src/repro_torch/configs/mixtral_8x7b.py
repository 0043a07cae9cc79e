"""mixtral-8x7b — MoE 8e top-2 with sliding-window attention. [arXiv:2401.04088]

32L, d_model=4096, 32H (GQA kv=8), expert d_ff=14336, vocab=32000, SWA=4096.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    attn_type="gqa",
    rope="rope",
    rope_theta=1_000_000.0,
    sliding_window=4096,
    act="swiglu",
    max_seq_len=131072,
    moe=MoEConfig(
        num_experts=8,
        num_experts_per_tok=2,
        d_ff_expert=14336,
        router="softmax",
        aux_loss_coef=0.02,
        every_k=1,
    ),
)

SMOKE = FULL.replace(
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    sliding_window=64,
    max_seq_len=512,
    remat="none",
    moe=FULL.moe.__class__(
        num_experts=4,
        num_experts_per_tok=2,
        d_ff_expert=64,
        router="softmax",
        aux_loss_coef=0.02,
        every_k=1,
    ),
)
