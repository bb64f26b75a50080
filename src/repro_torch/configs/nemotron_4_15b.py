"""nemotron-4-15b — dense decoder-only with squared-ReLU MLP.

[arXiv:2402.16819; unverified]  32L, d_model=6144, 48H (GQA kv=8),
d_ff=24576 (non-gated, squared ReLU), vocab=256000. Full attention ->
long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    source="arXiv:2402.16819",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab_size=256000,
    mlp_act="relu2",
    norm_type="layernorm",
    recipe="tp_fsdp",
    remat="full",
    microbatches=4,
)

SMOKE = ArchConfig(
    name="nemotron-4-15b-smoke",
    family="dense",
    n_layers=3,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_head=16,
    d_ff=384,
    vocab_size=512,
    vocab_pad_multiple=16,
    mlp_act="relu2",
    norm_type="layernorm",
    param_dtype="float32",
    compute_dtype="float32",
    recipe="dp",
    remat="none",
    seq_shard=False,
)

register("nemotron-4-15b", FULL, SMOKE)
