"""mistral-large-123b — dense decoder-only transformer.

[hf:mistralai/Mistral-Large-Instruct-2407; unverified]  88L, d_model=12288,
96H (GQA kv=8), d_ff=28672, vocab=32768. Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab_size=32768,
    mlp_act="silu_glu",
    rope_theta=1_000_000.0,
    recipe="tp_fsdp",
    remat="full",
    microbatches=8,
)

SMOKE = ArchConfig(
    name="mistral-large-123b-smoke",
    family="dense",
    n_layers=3,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_head=16,
    d_ff=224,
    vocab_size=512,
    vocab_pad_multiple=16,
    mlp_act="silu_glu",
    param_dtype="float32",
    compute_dtype="float32",
    recipe="dp",
    remat="none",
    seq_shard=False,
)

register("mistral-large-123b", FULL, SMOKE)
