"""starcoder2-15b — dense GQA code model. [arXiv:2402.19173; hf]

40L, d_model=6144, 48H (GQA kv=4), d_ff=24576, vocab=49152, RoPE,
GELU MLP with biases (per the published config).
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    attn_type="gqa",
    rope="rope",
    rope_theta=100_000.0,
    qkv_bias=True,
    mlp_bias=True,
    act="gelu",
    max_seq_len=32768,
)

SMOKE = FULL.replace(
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    max_seq_len=512,
    remat="none",
)
