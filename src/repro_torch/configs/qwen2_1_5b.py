"""qwen2-1.5b — dense decoder-only, aggressive GQA (kv=2), QKV bias.

[arXiv:2407.10671; hf]  28L, d_model=1536, 12H (GQA kv=2), d_ff=8960,
vocab=151936. 12 heads not divisible by model axis 16 -> FSDP recipe.
"""

from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    source="arXiv:2407.10671",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_head=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    mlp_act="silu_glu",
    tie_embeddings=True,
    recipe="fsdp",
    remat="full",
    microbatches=1,
)

SMOKE = ArchConfig(
    name="qwen2-1.5b-smoke",
    family="dense",
    n_layers=3,
    d_model=48,
    n_heads=3,
    n_kv_heads=1,
    d_head=16,
    d_ff=112,
    vocab_size=512,
    vocab_pad_multiple=16,
    qkv_bias=True,
    mlp_act="silu_glu",
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
    recipe="dp",
    remat="none",
    seq_shard=False,
)

register("qwen2-1.5b", FULL, SMOKE)
