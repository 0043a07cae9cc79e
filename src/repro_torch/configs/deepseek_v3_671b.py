"""deepseek-v3-671b — MoE 256e top-8 with MLA + MTP. [arXiv:2412.19437; hf]

61L, d_model=7168, 128H, expert d_ff=2048, vocab=129280.
1 shared + 256 routed experts, top-8, sigmoid router.
First 3 layers dense (d_ff=18432). MLA: q_lora=1536, kv_lora=512,
qk_nope=128, qk_rope=64, v_head=128. MTP depth 1.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

FULL = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,                    # dense-layer d_ff
    vocab_size=129280,
    attn_type="mla",
    rope="rope",
    rope_theta=10_000.0,
    act="swiglu",
    max_seq_len=131072,
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256,
        num_experts_per_tok=8,
        num_shared_experts=1,
        d_ff_expert=2048,
        router="sigmoid",
        aux_loss_coef=0.0001,       # v3 is aux-loss-light
        first_k_dense=3,
        d_ff_dense=18432,
        every_k=1,
    ),
    mtp_depth=1,
)

SMOKE = FULL.replace(
    num_layers=3,                   # 1 dense + 2 MoE
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
    moe=FULL.moe.__class__(
        num_experts=4,
        num_experts_per_tok=2,
        num_shared_experts=1,
        d_ff_expert=64,
        router="sigmoid",
        aux_loss_coef=0.0001,
        first_k_dense=1,
        d_ff_dense=256,
        every_k=1,
    ),
    mtp_depth=1,
)
