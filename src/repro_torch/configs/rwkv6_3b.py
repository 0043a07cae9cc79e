"""rwkv6-3b — RWKV-6 "Finch" 3B. [arXiv:2404.05892; hf]

Attention-free: data-dependent decay WKV6 recurrence + channel-mix.
32L, d_model=2560 (40 heads x 64), d_ff=8960, vocab=65536.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

FULL = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,               # d_model / head_dim(64); used for state sharding
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    attn_type="none",
    rope="none",
    ssm=SSMConfig(kind="rwkv6", head_dim=64),
    max_seq_len=1 << 20,        # recurrent: unbounded context
)

SMOKE = FULL.replace(
    num_layers=2,
    d_model=128,
    num_heads=2,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    max_seq_len=512,
    remat="none",
)
