"""qwen2-vl-2b — VLM backbone with M-RoPE. [arXiv:2409.12191; hf]

28L, d_model=1536, 12H (GQA kv=2), d_ff=8960, vocab=151936.
Vision frontend is a STUB per assignment: input_specs() provides precomputed
patch embeddings that are scattered into the token stream, plus (3, B, S)
M-RoPE position ids (temporal / height / width).
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    attn_type="gqa",
    rope="mrope",
    rope_theta=1_000_000.0,
    qkv_bias=True,
    act="swiglu",
    max_seq_len=131072,
    frontend="vision",
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
