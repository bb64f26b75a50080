"""Core layers: norms, rotary/sinusoidal positions, MLPs, embeddings.

The JAX package's ``models/layers.py`` in PyTorch, with its casts kept
operation for operation (reductions in fp32, results dropped to the
activation dtype where the reference drops them). All functions are
pure; parameters are plain dicts materialized from Spec trees
(:mod:`repro_torch.models.params`). Activation sharding annotations use
logical axes via :func:`repro_torch.dist.shard`. Every function is
differentiable by torch autograd; :func:`cot_cast` is the reference's
backward-only cast of the residual stream's cotangent.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import shard, tp
from repro_torch.models.params import Spec

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


class _CotCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def cot_cast(x: torch.Tensor) -> torch.Tensor:
    """Identity whose BACKWARD casts the cotangent to the primal's dtype,
    as the reference's ``custom_vjp``: one fp32 contribution (a norm's
    VJP) must not widen the whole residual stream's cotangent chain.
    Outside autograd (no grad mode, or nothing to differentiate) it
    returns ``x`` itself."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _CotCast.apply(x)
    return x


def cast_like_xla(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.astype(dtype)`` as XLA converts: a float going to an integer
    type saturates at the type's range and then truncates toward zero
    (torch's ``.to`` wraps instead: 200.7 -> -56 in int8)."""
    if x.is_floating_point() and not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        x = torch.clamp(x.float(), info.min, info.max)
    return x.to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_specs(cfg: ArchConfig):
    d = cfg.d_model
    if cfg.norm_type == "layernorm":
        return {"scale": Spec((d,), ("embed",), "ones"),
                "bias": Spec((d,), ("embed",), "zeros")}
    return {"scale": Spec((d,), ("embed",), "ones")}


def apply_norm(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Reductions in fp32; the normalized product drops to x.dtype BEFORE
    the scale multiply, as in the reference."""
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = ((xf - mu) * torch.rsqrt(var + cfg.norm_eps)).to(x.dtype)
        y = y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)
    else:  # rmsnorm
        ms = torch.square(xf).mean(-1, keepdim=True)
        y = (xf * torch.rsqrt(ms + cfg.norm_eps)).to(x.dtype)
        y = y * p["scale"].to(x.dtype)
    return y


def groupnorm_heads(scale, bias, x: torch.Tensor, n_heads: int,
                    eps: float) -> torch.Tensor:
    """GroupNorm with one group per head over (..., H, hs) flattened input."""
    *lead, d = x.shape
    hs = d // n_heads
    xf = x.float().reshape(*lead, n_heads, hs)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y.reshape(*lead, d) * scale.float() + bias.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Positional encodings
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float32) / d_head))


_ROPE_FREQS: dict = {}


def _rope_freqs_on(d_head: int, theta: float, device) -> torch.Tensor:
    """:func:`rope_freqs` on ``device``, made at first use and kept: a copy
    from the host at every call could not be captured in a CUDA graph."""
    key = (d_head, float(theta), torch.device(device))
    freqs = _ROPE_FREQS.get(key)
    if freqs is None:
        freqs = torch.from_numpy(rope_freqs(d_head, theta)).to(device)
        _ROPE_FREQS[key] = freqs
    return freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) or (S,)."""
    d = x.shape[-1]
    freqs = _rope_freqs_on(d, theta, x.device)                   # (d/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions.to(x.device)[..., None].float() * freqs      # (B,S,d/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sincos_pos_embed(seq: int, d: int, device="cpu") -> torch.Tensor:
    """(seq, d) fp32 sinusoidal embedding of positions 0..seq-1."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-np.log(10000.0) / d))
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# ---------------------------------------------------------------------------
# MLP (dense feed-forward)
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ArchConfig):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_act.endswith("_glu"):
        return {
            "w_gate": Spec((d, f), ("embed", "ff")),
            "w_up": Spec((d, f), ("embed", "ff")),
            "w_down": Spec((f, d), ("ff", "embed")),
        }
    return {
        "w_up": Spec((d, f), ("embed", "ff")),
        "b_up": Spec((f,), ("ff",), "zeros"),
        "w_down": Spec((f, d), ("ff", "embed")),
        "b_down": Spec((d,), ("embed",), "zeros"),
    }


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name.startswith("silu"):
        return F.silu(x)
    if name.startswith("gelu"):
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    if name == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(name)


def apply_mlp(p, cfg: ArchConfig, x: torch.Tensor,
              scatter: bool = False) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D). Where ``ff`` is the rank's slice
    (:mod:`repro_torch.dist.tp`), ``w_up``/``w_gate`` are column-parallel
    and ``w_down`` row-parallel (:func:`repro_torch.dist.tp.
    row_product`). With ``scatter`` (``transformer.apply_slot``'s split
    residual stream) the output is the rank's slice of the sequence."""
    split = tp.parts(p["w_up"].shape[-1], cfg.d_ff) > 1
    if split:
        x = tp.copy_in(x)
    if cfg.mlp_act.endswith("_glu"):
        h = _act(cfg.mlp_act, x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = _act(cfg.mlp_act, x @ p["w_up"] + p["b_up"].to(x.dtype))
    h = shard(h, "batch", None, "ff")
    out = tp.row_product(h, p["w_down"], scatter) if split else \
        tp.seq_out(h @ p["w_down"], scatter)
    if "b_down" in p:
        b = tp.on_slice(p["b_down"]) if scatter else p["b_down"]
        out = out + b.to(x.dtype)
    return out


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------

def embed_specs(cfg: ArchConfig):
    V, d = cfg.padded_vocab, cfg.d_model
    sp = {"tok": Spec((V, d), ("vocab", "embed"), scale=1.0)}
    if not cfg.tie_embeddings:
        sp["head"] = Spec((d, V), ("embed", "vocab"))
    return sp


def embed_tokens(p, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings. Where ``vocab`` is the rank's slice
    (:mod:`repro_torch.dist.tp`) the lookup is vocab-parallel: ids
    outside the rank's rows give zeros, and the ranks' rows are summed
    over ``model``."""
    tok = p["tok"]
    ids = tokens.to(tok.device).long()
    table = tok.to(dtype_of(cfg.compute_dtype))
    if tp.parts(tok.shape[0], cfg.padded_vocab) == 1:
        return shard(table[ids], "batch", None, "embed")
    local = ids - tp.group().rank * tok.shape[0]
    mine = (local >= 0) & (local < tok.shape[0])
    x = table[torch.where(mine, local, torch.zeros_like(local))]
    x = torch.where(mine[..., None], x, torch.zeros_like(x))
    return shard(tp.reduce_out(x), "batch", None, "embed")


def lm_logits(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Final-norm'ed hidden -> (B, S, padded_vocab) fp32 logits (pads
    masked). Where ``vocab`` is the rank's slice (:mod:`repro_torch.dist.
    tp`) the logits are too: the product is column-parallel, and the pad
    mask falls on the rank that holds the pads."""
    w = p["tok"] if cfg.tie_embeddings else p["head"]
    v = w.shape[0] if cfg.tie_embeddings else w.shape[1]
    if tp.parts(v, cfg.padded_vocab) > 1:
        x = tp.copy_in(x)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, w.to(x.dtype))
    else:
        logits = x @ w
    logits = logits.float()
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits / c)
    if cfg.padded_vocab != cfg.vocab_size:
        lo = 0 if v == cfg.padded_vocab else tp.group().rank * v
        ids = lo + torch.arange(v, device=logits.device)
        mask = torch.where(
            ids < cfg.vocab_size,
            torch.zeros((), dtype=torch.float32, device=logits.device),
            torch.full((), -1e30, dtype=torch.float32, device=logits.device))
        logits = logits + mask
    return shard(logits, "batch", None, "vocab")
