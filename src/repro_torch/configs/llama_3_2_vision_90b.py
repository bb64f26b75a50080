"""llama-3.2-vision-90b — VLM with interleaved cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]  100L, d_model=8192,
64H (GQA kv=8), d_ff=28672, vocab=128256; a cross-attention layer every 5
layers attends to stubbed image patch embeddings. Full attention ->
long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    source="hf:meta-llama/Llama-3.2-90B-Vision",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab_size=128256,
    mlp_act="silu_glu",
    rope_theta=500_000.0,
    cross_attn_period=5,
    frontend="image_patches",
    frontend_len=1600,
    frontend_dim=7680,
    recipe="tp_fsdp",
    remat="full",
    microbatches=8,
)

SMOKE = ArchConfig(
    name="llama-3.2-vision-90b-smoke",
    family="vlm",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=160,
    vocab_size=499,
    vocab_pad_multiple=16,
    cross_attn_period=2,
    frontend="image_patches",
    frontend_len=12,
    frontend_dim=48,
    param_dtype="float32",
    compute_dtype="float32",
    recipe="dp",
    remat="none",
    seq_shard=False,
)

register("llama-3.2-vision-90b", FULL, SMOKE)
