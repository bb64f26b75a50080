"""jamba-1.5-large-398b — hybrid Mamba + attention (1:7) with MoE.

[arXiv:2403.19887; hf]  72L, d_model=8192, 64H (GQA kv=8), d_ff=24576,
vocab=65536; one attention layer per 8 (rest Mamba), MoE 16 experts top-2
every other layer. Hybrid -> runs long_500k (Mamba layers O(1) state; the
9 attention layers hold a sharded 500k KV cache, O(S) per decoded token).
bf16 optimizer states for memory (DESIGN.md §8).
"""

from repro_torch.configs.base import ArchConfig, MambaConfig, MoEConfig, register

FULL = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab_size=65536,
    pos_embed="none",          # jamba uses no positional embedding
    attn_period=8,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, chunk=256),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576,
                  layer_period=2, capacity_factor=1.25),
    recipe="ep_tp_fsdp",
    remat="full",
    microbatches=8,
    opt_state_dtype="bfloat16",
    fp32_master=False,            # 398B: bf16 m/v, no master (memory budget)
)

SMOKE = ArchConfig(
    name="jamba-1.5-large-398b-smoke",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=512,
    vocab_pad_multiple=16,
    pos_embed="none",
    attn_period=4,
    mamba=MambaConfig(d_state=4, d_conv=4, expand=2, chunk=16),
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                  layer_period=2, capacity_factor=2.0),
    param_dtype="float32",
    compute_dtype="float32",
    recipe="dp",
    remat="none",
    seq_shard=False,
)

register("jamba-1.5-large-398b", FULL, SMOKE)
