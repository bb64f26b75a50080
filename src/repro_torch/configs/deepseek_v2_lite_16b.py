"""deepseek-v2-lite-16b — MoE with Multi-head Latent Attention (MLA).

[arXiv:2405.04434; hf]  27L, d_model=2048, 16H, MLA kv_lora=512,
rope/nope head dims 64/128; layer 0 dense (d_ff=10944), layers 1..26 MoE
with 64 routed experts (d_ff=1408, top-6) + 2 shared experts.
MLA is full attention -> long_500k skipped; its compressed KV cache is a
first-class serving feature (kv cache = kv_lora + rope dims per token).
"""

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register

FULL = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    source="arXiv:2405.04434",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=10944,               # dense layers (layer 0)
    vocab_size=102400,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared=2, d_ff_shared=2816,
                  layer_period=1, first_dense=1, capacity_factor=1.25),
    recipe="ep_fsdp",
    remat="full",
    microbatches=1,
)

SMOKE = ArchConfig(
    name="deepseek-v2-lite-16b-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=160,
    vocab_size=512,
    vocab_pad_multiple=16,
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0,
                  rope_head_dim=8, nope_head_dim=16, v_head_dim=16),
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=48,
                  num_shared=1, d_ff_shared=48,
                  layer_period=1, first_dense=1, capacity_factor=2.0),
    param_dtype="float32",
    compute_dtype="float32",
    recipe="dp",
    remat="none",
    seq_shard=False,
)

register("deepseek-v2-lite-16b", FULL, SMOKE)
