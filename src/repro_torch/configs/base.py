"""Base configuration system of the model path, copied from the JAX
package's ``configs/base.py`` (plain dataclasses, no JAX).

Every assigned architecture is expressed as an :class:`ArchConfig`. Configs are
plain frozen dataclasses (hashable). A registry maps ``--arch <id>`` strings
to factory functions; each ``src/repro_torch/configs/<id>.py`` registers
exactly one full-size config plus a reduced "smoke" variant used by CPU
tests. :meth:`ArchConfig.param_counts` is what placement prices DL ops with.

Input shapes are global (pre-sharding) and defined once here so that every
(arch x shape) dry-run cell is well defined.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from dataclasses import dataclass, field, replace
from typing import Optional


# ---------------------------------------------------------------------------
# Input shapes (assigned): seq_len x global_batch
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0          # routed experts (0 => dense MLP)
    top_k: int = 0
    d_ff_expert: int = 0
    num_shared: int = 0           # shared (always-on) experts
    layer_period: int = 1         # MoE every `period` layers (1 = all)
    first_dense: int = 0          # leading dense layers before MoE starts
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01
    d_ff_shared: int = 0          # shared-expert hidden (default = d_ff_expert * num_shared)


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 => full-rank q projection
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 => ceil(d_model / 16)
    chunk: int = 256


@dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64          # rank of the data-dependent decay LoRA
    mix_lora: int = 32            # rank of token-shift mix LoRA
    chunk: int = 64


@dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str = "unnamed"
    family: str = "dense"         # dense|moe|ssm|hybrid|encdec|vlm|rwkv
    source: str = ""

    # core dims
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    d_head: int = 64
    d_ff: int = 256
    vocab_size: int = 1024
    vocab_pad_multiple: int = 256

    # flavour knobs
    qkv_bias: bool = False
    mlp_act: str = "silu_glu"     # silu_glu|gelu_glu|relu2|relu|gelu
    norm_type: str = "rmsnorm"    # rmsnorm|layernorm
    norm_eps: float = 1e-5
    pos_embed: str = "rope"       # rope|sincos|none
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    logits_softcap: float = 0.0

    # family extensions
    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None

    # hybrid (jamba): within each period of `attn_period` layers, 1 is attention
    attn_period: int = 0          # 0 => all layers are attention (or none for ssm/rwkv)
    # vlm (llama-vision): a cross-attn layer every `cross_attn_period` layers
    cross_attn_period: int = 0
    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    # frontend stubs: "none"|"audio_frames"|"image_patches"
    frontend: str = "none"
    frontend_len: int = 0         # tokens produced by the stub frontend
    frontend_dim: int = 0

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    fp32_master: bool = True      # keep fp32 master weights in the optimizer
    # distribution defaults
    recipe: str = "tp_fsdp"       # dist/sharding.py recipe name
    remat: str = "full"           # none|dots|full
    microbatches: int = 1
    seq_shard: bool = True        # sequence-parallel residual stream
    attn_chunk: int = 1024        # kv-block size for chunked attention
    scan_layers: bool = True

    # serving
    kv_cache_dtype: str = "bfloat16"   # or "int8"

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return int(math.ceil(self.vocab_size / m) * m)

    @property
    def is_attention_free(self) -> bool:
        return self.family in ("ssm", "rwkv")

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / linear-attn / hybrid)."""
        return self.family in ("ssm", "rwkv", "hybrid")

    @property
    def d_inner_mamba(self) -> int:
        assert self.mamba is not None
        return self.mamba.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        assert self.mamba is not None
        return self.mamba.dt_rank or max(1, math.ceil(self.d_model / 16))

    def moe_layer_mask(self, n_layers: Optional[int] = None) -> tuple:
        """True per layer index if that layer uses MoE."""
        n = n_layers if n_layers is not None else self.n_layers
        if self.moe.num_experts == 0:
            return tuple(False for _ in range(n))
        out = []
        for i in range(n):
            if i < self.moe.first_dense:
                out.append(False)
            else:
                out.append((i - self.moe.first_dense) % self.moe.layer_period == 0)
        return tuple(out)

    def attn_layer_mask(self) -> tuple:
        """True per layer index if that layer is (self-)attention (hybrid)."""
        if self.attn_period <= 0:
            return tuple(True for _ in range(self.n_layers))
        # jamba convention: within each period, the middle-ish layer is attention
        out = []
        for i in range(self.n_layers):
            out.append(i % self.attn_period == self.attn_period // 2)
        return tuple(out)

    def cross_layer_mask(self) -> tuple:
        if self.cross_attn_period <= 0:
            return tuple(False for _ in range(self.n_layers))
        return tuple((i + 1) % self.cross_attn_period == 0 for i in range(self.n_layers))

    # --- parameter counting (for roofline MODEL_FLOPS) -----------------
    def param_counts(self) -> dict:
        """Returns dict with total and active parameter counts (approx, exact
        enough for 6ND roofline accounting)."""
        d, ff, V = self.d_model, self.d_ff, self.padded_vocab
        emb = V * d * (1 if self.tie_embeddings else 2)
        total = emb
        active = emb

        def attn_params() -> int:
            if self.mla is not None:
                m = self.mla
                qdim = self.n_heads * (m.nope_head_dim + m.rope_head_dim)
                p = d * m.kv_lora_rank + d * m.rope_head_dim  # kv down + rope k
                p += m.kv_lora_rank * self.n_heads * (m.nope_head_dim + m.v_head_dim)
                if m.q_lora_rank:
                    p += d * m.q_lora_rank + m.q_lora_rank * qdim
                else:
                    p += d * qdim
                p += self.n_heads * m.v_head_dim * d  # out proj
                return p
            hq = self.n_heads * self.d_head
            hkv = self.n_kv_heads * self.d_head
            return d * hq + 2 * d * hkv + hq * d

        def mlp_params(hidden: int) -> int:
            mult = 3 if self.mlp_act.endswith("_glu") else 2
            return mult * d * hidden

        def mamba_params() -> int:
            di = self.d_inner_mamba
            n = self.mamba.d_state
            r = self.dt_rank
            p = d * 2 * di              # in_proj (x and z)
            p += di * self.mamba.d_conv  # conv
            p += di * (r + 2 * n)        # x -> dt, B, C
            p += r * di                  # dt proj
            p += di * n + di             # A_log, D
            p += di * d                  # out proj
            return p

        def rwkv_params() -> int:
            c = self.rwkv
            p = 4 * d * d + d * d        # r,k,v,g + output
            p += 2 * (d * c.decay_lora + c.decay_lora * d)  # decay + dt LoRAs
            p += 6 * (d * c.mix_lora + c.mix_lora * d)      # token-shift mix LoRAs
            p += 2 * d                   # u (bonus), ln_x
            p += 2 * d * ff              # channel-mix key/value mats
            return p

        n_layers = self.n_layers if self.family != "encdec" else (self.enc_layers + self.dec_layers)
        attn_mask = self.attn_layer_mask() if self.family == "hybrid" else None
        moe_mask = self.moe_layer_mask(self.n_layers)

        for i in range(n_layers):
            if self.family == "rwkv":
                total += rwkv_params(); active += rwkv_params(); continue
            if self.family == "ssm":
                total += mamba_params(); active += mamba_params(); continue
            if self.family == "hybrid" and attn_mask is not None and not attn_mask[i % self.n_layers]:
                layer_attn = mamba_params()
            else:
                layer_attn = attn_params()
            if self.family == "encdec" and i >= self.enc_layers:
                layer_attn += attn_params()  # cross attention in decoder
            if self.family == "vlm" and self.cross_layer_mask()[i % self.n_layers]:
                layer_attn += attn_params()  # cross layers add cross-attn
            total += layer_attn
            active += layer_attn
            if i < len(moe_mask) and moe_mask[i] and self.moe.num_experts:
                e = self.moe
                per_expert = mlp_params(e.d_ff_expert)
                shared = e.num_shared * mlp_params(e.d_ff_shared or e.d_ff_expert)
                total += e.num_experts * per_expert + shared
                active += e.top_k * per_expert + shared
            else:
                total += mlp_params(ff)
                active += mlp_params(ff)
        return {"total": total, "active": active}

    def with_overrides(self, **kw) -> "ArchConfig":
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}
_SMOKE_REGISTRY: dict = {}

ARCH_IDS = (
    "seamless-m4t-medium",
    "rwkv6-1.6b",
    "llama-3.2-vision-90b",
    "mistral-large-123b",
    "qwen1.5-4b",
    "nemotron-4-15b",
    "qwen2-1.5b",
    "jamba-1.5-large-398b",
    "deepseek-v2-lite-16b",
    "granite-moe-1b-a400m",
)

_MODULE_BY_ID = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def register(name: str, full: ArchConfig, smoke: ArchConfig) -> None:
    _REGISTRY[name] = full
    _SMOKE_REGISTRY[name] = smoke


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _REGISTRY:
        mod = _MODULE_BY_ID.get(name)
        if mod is None:
            raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULE_BY_ID)}")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return (_SMOKE_REGISTRY if smoke else _REGISTRY)[name]


def all_configs(smoke: bool = False):
    return {a: get_config(a, smoke=smoke) for a in ARCH_IDS}


def shapes_for(cfg: ArchConfig):
    """The input shapes applicable to this architecture (skips recorded)."""
    out = []
    for s in ALL_SHAPES:
        if s.name == "long_500k" and not cfg.sub_quadratic:
            continue
        out.append(s)
    return tuple(out)


def skipped_shapes_for(cfg: ArchConfig):
    return tuple(s for s in ALL_SHAPES if s not in shapes_for(cfg))
