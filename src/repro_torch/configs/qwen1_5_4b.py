"""qwen1.5-4b — dense decoder-only with QKV bias.

[hf:Qwen/Qwen1.5-4B; hf-tier family config]  40L, d_model=2560, 20H (kv=20),
d_ff=6912, vocab=151936. 20 heads are not divisible by the 16-wide model
axis -> FSDP recipe (no head-TP); see DESIGN.md §Arch-applicability.
"""

from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    source="hf:Qwen/Qwen1.5-4B",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_head=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    mlp_act="silu_glu",
    recipe="fsdp",
    remat="full",
    microbatches=1,
)

SMOKE = ArchConfig(
    name="qwen1.5-4b-smoke",
    family="dense",
    n_layers=3,
    d_model=80,
    n_heads=5,
    n_kv_heads=5,
    d_head=16,
    d_ff=192,
    vocab_size=512,
    vocab_pad_multiple=16,
    qkv_bias=True,
    mlp_act="silu_glu",
    param_dtype="float32",
    compute_dtype="float32",
    recipe="dp",
    remat="none",
    seq_shard=False,
)

register("qwen1.5-4b", FULL, SMOKE)
