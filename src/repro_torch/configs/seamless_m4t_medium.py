"""seamless-m4t-medium — encoder-decoder multimodal (audio) transformer.

[arXiv:2308.11596; hf]  12L enc + 12L dec, d_model=1024, 16H (GQA kv=16),
d_ff=4096, vocab=256206. The audio frontend (speech encoder conv stack) is a
STUB: ``input_specs()`` provides precomputed frame embeddings at d=1024.
Full attention -> long_500k skipped (see DESIGN.md §Arch-applicability).
"""

from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    source="arXiv:2308.11596; hf",
    n_layers=24,            # 12 enc + 12 dec
    enc_layers=12,
    dec_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab_size=256206,
    qkv_bias=True,
    mlp_act="relu",
    norm_type="layernorm",
    pos_embed="sincos",
    frontend="audio_frames",
    frontend_len=4096,
    frontend_dim=1024,
    recipe="tp_fsdp",
    remat="full",
    microbatches=4,
)

SMOKE = ArchConfig(
    name="seamless-m4t-medium-smoke",
    family="encdec",
    n_layers=4,
    enc_layers=2,
    dec_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=503,
    vocab_pad_multiple=16,
    qkv_bias=True,
    mlp_act="relu",
    norm_type="layernorm",
    pos_embed="sincos",
    frontend="audio_frames",
    frontend_len=16,
    frontend_dim=64,
    param_dtype="float32",
    compute_dtype="float32",
    recipe="dp",
    remat="none",
    seq_shard=False,
    attn_chunk=64,
)

register("seamless-m4t-medium", FULL, SMOKE)
