"""minicpm3-4b — dense with Multi-head Latent Attention. [hf:openbmb/MiniCPM3-4B]

62L, d_model=2560, 40H, d_ff=6400, vocab=73448.
MLA dims from the published config: q_lora=768, kv_lora=256,
qk_nope=64, qk_rope=32, v_head=64.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig

FULL = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attn_type="mla",
    rope="rope",
    rope_theta=10_000.0,
    act="swiglu",
    max_seq_len=32768,
    mla=MLAConfig(
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
)

SMOKE = FULL.replace(
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    max_seq_len=512,
    remat="none",
    mla=MLAConfig(
        q_lora_rank=32,
        kv_lora_rank=16,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
    ),
)
