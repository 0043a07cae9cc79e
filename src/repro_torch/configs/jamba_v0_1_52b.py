"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 with MoE 16e top-2. [arXiv:2403.19887]

32L, d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab=65536.
Attention every 8th layer at offset 4 (1 attn : 7 mamba);
MoE every 2nd layer at offset 1 (d_ff_expert=14336), others dense.
Mamba: d_state=16, d_conv=4, expand=2.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

FULL = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    attn_type="gqa",
    rope="none",                   # jamba uses no positional encoding in attn
    act="swiglu",
    max_seq_len=262144,
    attn_period=8,
    attn_offset=4,
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(
        num_experts=16,
        num_experts_per_tok=2,
        d_ff_expert=14336,
        router="softmax",
        aux_loss_coef=0.01,
        first_k_dense=1,           # offset 1: MoE on layers 1,3,5,...
        d_ff_dense=14336,
        every_k=2,
    ),
)

SMOKE = FULL.replace(
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    max_seq_len=512,
    remat="none",
    attn_period=2,                 # keep the hybrid pattern visible at depth 4
    attn_offset=1,
    ssm=SSMConfig(kind="mamba", d_state=8, d_conv=4, expand=2),
    moe=FULL.moe.__class__(
        num_experts=4,
        num_experts_per_tok=2,
        d_ff_expert=64,
        router="softmax",
        aux_loss_coef=0.01,
        first_k_dense=1,
        d_ff_dense=256,
        every_k=2,
    ),
)
