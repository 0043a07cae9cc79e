"""qwen2-7b — dense GQA with QKV bias. [arXiv:2407.10671; hf]

28L, d_model=3584, 28H (GQA kv=4), d_ff=18944, vocab=152064, SwiGLU.
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    attn_type="gqa",
    rope="rope",
    rope_theta=1_000_000.0,
    qkv_bias=True,
    act="swiglu",
    max_seq_len=131072,
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
