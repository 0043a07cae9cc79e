"""seamless-m4t-large-v2 — encoder-decoder multimodal backbone. [arXiv:2308.11596]

24L encoder + 24L decoder, d_model=1024, 16H (kv=16), d_ff=8192, vocab=256206.
The audio frontend is a STUB per assignment: input_specs() provides precomputed
frame embeddings (B, S_enc, d_model); the transformer backbone is real.
Shape budget: S_enc = S_dec = seq_len/2 (see DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,                 # decoder layers
    num_encoder_layers=24,
    is_encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    attn_type="gqa",
    rope="none",                   # conformer/nllb stacks use learned/relative pos;
                                   # backbone here uses rope-free attn + learned emb
    act="gelu",
    max_seq_len=16384,
    frontend="audio",
)

SMOKE = FULL.replace(
    num_layers=2,
    num_encoder_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    max_seq_len=512,
    remat="none",
)
