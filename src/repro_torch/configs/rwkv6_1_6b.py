"""rwkv6-1.6b ("Finch") — attention-free RNN with data-dependent decay.

[arXiv:2404.05892; unverified]  24L, d_model=2048, d_ff=7168 (channel mix),
vocab=65536, head_size=64 -> 32 wkv heads. Sub-quadratic: runs long_500k.
"""

from repro_torch.configs.base import ArchConfig, RWKVConfig, register

FULL = ArchConfig(
    name="rwkv6-1.6b",
    family="rwkv",
    source="arXiv:2404.05892",
    n_layers=24,
    d_model=2048,
    n_heads=32,               # d_model / head_size
    n_kv_heads=32,
    d_head=64,
    d_ff=7168,
    vocab_size=65536,
    norm_type="layernorm",
    pos_embed="none",
    rwkv=RWKVConfig(head_size=64, decay_lora=64, mix_lora=32, chunk=32),
    recipe="tp_fsdp",
    remat="full",
    microbatches=4,
)

SMOKE = ArchConfig(
    name="rwkv6-1.6b-smoke",
    family="rwkv",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=224,
    vocab_size=500,
    vocab_pad_multiple=16,
    norm_type="layernorm",
    pos_embed="none",
    rwkv=RWKVConfig(head_size=16, decay_lora=8, mix_lora=4, chunk=16),
    param_dtype="float32",
    compute_dtype="float32",
    recipe="dp",
    remat="none",
    seq_shard=False,
)

register("rwkv6-1.6b", FULL, SMOKE)
