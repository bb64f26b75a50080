"""granite-moe-1b-a400m — small MoE, 32 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]  24L, d_model=1024,
16H (GQA kv=8), expert d_ff=512, vocab=49155, every layer MoE, tied
embeddings. Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig, MoEConfig, register

FULL = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    vocab_size=49155,
    vocab_pad_multiple=256,
    mlp_act="silu_glu",
    tie_embeddings=True,
    moe=MoEConfig(num_experts=32, top_k=8, d_ff_expert=512,
                  layer_period=1, capacity_factor=1.25),
    recipe="ep_fsdp",
    remat="full",
    microbatches=1,
)

SMOKE = ArchConfig(
    name="granite-moe-1b-a400m-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=64,
    vocab_size=499,
    vocab_pad_multiple=16,
    tie_embeddings=True,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64,
                  layer_period=1, capacity_factor=2.0),
    param_dtype="float32",
    compute_dtype="float32",
    recipe="dp",
    remat="none",
    seq_shard=False,
)

register("granite-moe-1b-a400m", FULL, SMOKE)
