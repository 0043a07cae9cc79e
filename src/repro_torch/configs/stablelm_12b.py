"""stablelm-12b — dense GQA. [hf:stabilityai/stablelm-2-12b family; hf]

40L, d_model=5120, 32H (GQA kv=8), d_ff=13824, vocab=100352, SwiGLU, RoPE.
head_dim = 160.
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    attn_type="gqa",
    rope="rope",
    rope_theta=10_000.0,
    act="swiglu",
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
