"""Attention: GQA self-attention with a KV cache, MLA (DeepSeek latent
attention) and cross-attention.

The JAX package's ``models/attention.py`` in PyTorch. Three execution
paths, numerically equivalent (the tests hold each to the reference):

* ``dense``   — materialized scores.
* ``chunked`` — online softmax over KV blocks; O(S * chunk) memory.
* ``kernel``  — the flash-attention kernel (:mod:`repro_torch.kernels.
                flash_attention`), the counterpart of the reference's
                ``pallas``. Taken exactly where the reference takes its
                Pallas kernel (:func:`repro_torch.kernels.ops.
                flash_supported`): with no query offset and no KV length.
                ``self_attention`` always derives its offset from the
                positions tensor, and MLA's value dim differs from its
                query dim, so only ``cross_attention`` reaches the
                kernel, as in the reference.

Under tensor parallelism KV heads are duplicated (``kv_repeat_factor``,
standard Megatron-GQA duplication) so both q and kv shard evenly over
``heads``; the repeat keeps each query head on its own KV head, so the
values are those of plain GQA grouping. The cache keeps the model's
``n_kv_heads``: the repeat is taken after it. Without a mesh the factor
is 1 and every ``shard`` is the identity.

Inside a step on shards whose ``model`` axis splits the heads
(:mod:`repro_torch.dist.tp`), each rank computes its own query heads:
q (and k, v where ``kv_heads`` divides too) are column-parallel, ``wo``
row-parallel with its partial sums reduced over ``model``, and the KV
cache holds the rank's KV heads. Where ``kv_heads`` does not divide, k
and v are computed whole from the replicated weights, repeated as
:func:`_expand_kv` repeats them, and the rank takes the KV heads its
query heads read (:func:`_rank_kv`). MLA splits its per-head up-
projections and keeps the latent cache replicated, as the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import axis_size, shard, tp
from repro_torch.models.layers import apply_rope, cast_like_xla
from repro_torch.models.params import Spec

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def attn_specs(cfg: ArchConfig, cross: bool = False):
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    sp = {
        "wq": Spec((d, H, Dh), ("embed", "heads", "head_dim")),
        "wk": Spec((d, KV, Dh), ("embed", "kv_heads", "head_dim")),
        "wv": Spec((d, KV, Dh), ("embed", "kv_heads", "head_dim")),
        "wo": Spec((H, Dh, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        sp["bq"] = Spec((H, Dh), ("heads", "head_dim"), "zeros")
        sp["bk"] = Spec((KV, Dh), ("kv_heads", "head_dim"), "zeros")
        sp["bv"] = Spec((KV, Dh), ("kv_heads", "head_dim"), "zeros")
    return sp


def mla_specs(cfg: ArchConfig):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qdim = m.nope_head_dim + m.rope_head_dim
    sp = {
        "w_dkv": Spec((d, m.kv_lora_rank), ("embed", "lora")),
        "w_kr": Spec((d, m.rope_head_dim), ("embed", "head_dim")),
        "kv_norm": Spec((m.kv_lora_rank,), ("lora",), "ones"),
        "w_uk": Spec((m.kv_lora_rank, H, m.nope_head_dim), ("lora", "heads", "head_dim")),
        "w_uv": Spec((m.kv_lora_rank, H, m.v_head_dim), ("lora", "heads", "head_dim")),
        "wo": Spec((H, m.v_head_dim, d), ("heads", "head_dim", "embed")),
    }
    if m.q_lora_rank:
        sp["w_dq"] = Spec((d, m.q_lora_rank), ("embed", "lora"))
        sp["q_norm"] = Spec((m.q_lora_rank,), ("lora",), "ones")
        sp["w_uq"] = Spec((m.q_lora_rank, H, qdim), ("lora", "heads", "head_dim"))
    else:
        sp["wq"] = Spec((d, H, qdim), ("embed", "heads", "head_dim"))
    return sp


# ---------------------------------------------------------------------------
# KV repeat for TP (Megatron-GQA duplication)
# ---------------------------------------------------------------------------

def kv_repeat_factor(cfg: ArchConfig) -> int:
    tp = axis_size("heads")
    if tp <= cfg.n_kv_heads:
        return 1
    rep = tp // cfg.n_kv_heads
    if (cfg.n_kv_heads * rep) > cfg.n_heads or cfg.n_heads % (cfg.n_kv_heads * rep):
        return 1  # cannot repeat evenly; fall back to plain GQA grouping
    return rep


def _expand_kv(k: torch.Tensor, rep: int) -> torch.Tensor:
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def _head_split(p, cfg: ArchConfig) -> int:
    """How many ``model`` ranks split this attention's query heads (1
    outside tensor parallelism)."""
    return tp.parts(p["wo"].shape[0], cfg.n_heads)


def _out_proj(o: torch.Tensor, wo: torch.Tensor, split: bool,
              scatter: bool) -> torch.Tensor:
    """The heads' output projection, (B, S, H, E) x (H, E, D); over the
    rank's heads, row-parallel (:func:`repro_torch.dist.tp.row_product`).
    With ``scatter``, the rank's slice of the sequence (reduce-scattered
    where it is row-parallel)."""
    if not split:
        return tp.seq_out(torch.einsum("bshe,hed->bsd", o, wo), scatter)
    B, S, H, E = o.shape
    return tp.row_product(o.reshape(B, S, H * E), wo.reshape(H * E, -1),
                          scatter)


def _rank_kv(k: torch.Tensor, n_heads: int, split: int) -> torch.Tensor:
    """The rank's KV heads from whole (repeated) ``k`` (B, T, KV, D): those
    its ``n_heads / split`` query heads read, with each query head on its
    own KV head as in plain grouping; one KV head a query head where the
    rank's query heads do not cover whole groups."""
    KV = k.shape[2]
    group = n_heads // KV
    local = n_heads // split
    if local % group:
        k = torch.repeat_interleave(k, group, dim=2)
    return tp.take(k, 2)


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------

def _group(q: torch.Tensor, n_kv: int):
    B, S, H, Dh = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, Dh)


def _int_on(x, device) -> torch.Tensor:
    """``torch.as_tensor(x).to(device)``, made on ``device`` where ``x`` is
    a Python int: a tensor built on the host would be copied to the card,
    which a CUDA graph cannot capture."""
    if isinstance(x, int):
        return torch.full((), x, dtype=torch.int64, device=device)
    return torch.as_tensor(x).to(device)


def _make_mask(S, T, causal, q_offset, kv_len, B, device):
    """(B, S, T) bool validity mask."""
    ar_s = torch.arange(S, device=device)
    kpos = torch.arange(T, device=device)[None, :]
    if isinstance(q_offset, torch.Tensor) and q_offset.dim() > 0:
        qpos = ar_s[None, :, None] + q_offset.to(device).reshape(-1, 1, 1)
        kpos = kpos[None]
    else:
        off = q_offset.to(device) if isinstance(q_offset, torch.Tensor) \
            else q_offset
        qpos = ar_s[:, None] + off                     # (S,1)
    if causal:
        m = kpos <= qpos
    else:
        m = torch.ones((S, T), dtype=torch.bool, device=device)
    if m.dim() == 2:
        m = m[None].expand(B, S, T)
    if kv_len is not None:
        kl = _int_on(kv_len, device).reshape(-1, 1, 1)
        m = m & (torch.arange(T, device=device)[None, None, :] < kl)
    return m


def dense_attention(q, k, v, *, causal: bool, q_offset=0,
                    kv_len=None) -> torch.Tensor:
    """Materialized-scores attention. q:(B,S,H,Dh) k,v:(B,T,KV,Dh)."""
    B, S, H, Dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg = _group(q, KV)
    scale = 1.0 / math.sqrt(Dh)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    mask = _make_mask(S, T, causal, q_offset, kv_len, B, q.device)
    s = torch.where(mask[:, None, None], s,
                    torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool, chunk: int = 512, q_offset=0,
                      kv_len=None) -> torch.Tensor:
    """Online-softmax attention over KV blocks; O(S*chunk) memory."""
    B, S, H, Dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KV
    dev = q.device
    chunk = min(chunk, T)
    nblk = -(-T // chunk)
    Tp = nblk * chunk
    if Tp != T:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, Tp - T))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, Tp - T))
    qg = _group(q, KV).float()
    scale = 1.0 / math.sqrt(Dh)

    qoff = _int_on(q_offset, dev)
    if qoff.dim() == 0:
        qpos_b = (torch.arange(S, device=dev)[None] + qoff).expand(B, S)
    else:
        qpos_b = torch.arange(S, device=dev)[None] + qoff.reshape(-1, 1)
    kl = None if kv_len is None else _int_on(kv_len, dev).reshape(-1)

    m = torch.full((B, KV, G, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, S, Dv), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    for blk in range(nblk):
        kb = k[:, blk * chunk:(blk + 1) * chunk]
        vb = v[:, blk * chunk:(blk + 1) * chunk]
        kpos = blk * chunk + torch.arange(chunk, device=dev)
        s = torch.einsum("bskgd,bckd->bkgsc", qg, kb.float()) * scale
        valid = (kpos[None, None, :] < T).expand(B, S, chunk)
        if causal:
            valid = valid & (kpos[None, None, :] <= qpos_b[:, :, None])
        if kl is not None:
            valid = valid & (kpos[None, None, :] < kl[:, None, None])
        s = torch.where(valid[:, None, None], s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgsc,bckd->bkgsd", p, vb.float())
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    o = torch.movedim(o, 3, 1)                           # (B,S,KV,G,Dv)
    return o.reshape(B, S, H, Dv).to(q.dtype)


def attention(q, k, v, *, causal: bool, impl: str = "dense", chunk: int = 512,
              q_offset=0, kv_len=None) -> torch.Tensor:
    if impl not in ("dense", "chunked", "kernel"):
        raise ValueError(f"attention impl {impl!r} not in "
                         "('dense', 'chunked', 'kernel')")
    if impl == "kernel":
        from repro_torch.kernels import ops as kops
        if kops.flash_supported(q, k, v, causal, q_offset, kv_len):
            return kops.flash_attention(q, k, v, causal=causal)
        impl = "chunked"
    if impl == "chunked" and k.shape[1] > chunk:
        return chunked_attention(q, k, v, causal=causal, chunk=chunk,
                                 q_offset=q_offset, kv_len=kv_len)
    return dense_attention(q, k, v, causal=causal, q_offset=q_offset,
                           kv_len=kv_len)


# ---------------------------------------------------------------------------
# Self-attention block (GQA)
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor          # (B, T, KV, Dh)
    v: torch.Tensor
    length: torch.Tensor     # () int32 — filled prefix; kept on the CPU


def _project(p, cfg, x, name):
    w = p["w" + name]
    y = torch.einsum("bsd,dhe->bshe", x, w.to(x.dtype))
    if cfg.qkv_bias and ("b" + name) in p:
        y = y + p["b" + name].to(x.dtype)
    return y


def _write_cache(buf: torch.Tensor, new: torch.Tensor, start: int):
    """Write ``new`` into ``buf[:, start:start+S]`` IN PLACE (the reference
    donates the cache to its decode step and updates it with
    ``dynamic_update_slice``). Where the reference clamps a start that
    would run past the end, this raises: a request's prompt plus its new
    tokens must fit ``max_len``."""
    S, T = new.shape[1], buf.shape[1]
    if start < 0 or start + S > T:
        raise ValueError(f"KV cache overflow: writing {S} positions at "
                         f"{start} into a cache of length {T}")
    buf[:, start:start + S] = cast_like_xla(new, buf.dtype)
    return buf


def self_attention(p, cfg: ArchConfig, x: torch.Tensor, *, positions,
                   cache: Optional[KVCache] = None, causal: bool = True,
                   impl: str = "chunked", scatter: bool = False):
    """x: (B,S,D). Returns (out, new_cache); a given cache is updated in
    place. With ``scatter`` (``transformer.apply_slot``'s split residual
    stream) ``out`` is the rank's slice of the sequence."""
    split = _head_split(p, cfg)
    xm = tp.copy_in(x) if split > 1 else x
    kv_whole = p["wk"].shape[1] == cfg.n_kv_heads
    q = _project(p, cfg, xm, "q")
    k = _project(p, cfg, x if kv_whole else xm, "k")
    v = _project(p, cfg, x if kv_whole else xm, "v")
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = shard(q, "batch", None, "heads", None)

    new_cache = None
    kv_len = None
    if isinstance(positions, torch.Tensor):
        q_offset = positions[:, 0] if positions.dim() == 2 else positions[0]
    else:
        q_offset = positions
    if cache is not None:
        start = int(cache.length)
        k_all = _write_cache(cache.k, k, start)
        v_all = _write_cache(cache.v, v, start)
        new_cache = KVCache(k_all, v_all, cache.length + k.shape[1])
        k, v = k_all.to(x.dtype), v_all.to(x.dtype)
        kv_len = cache.length + q.shape[1]
        q_offset = cache.length
    rep = kv_repeat_factor(cfg)
    kvh = "heads" if rep > 1 else "kv_heads"
    k, v = _expand_kv(k, rep), _expand_kv(v, rep)
    if split > 1 and kv_whole:
        k, v = (_rank_kv(t, cfg.n_heads, split) for t in (k, v))
    k = shard(k, "batch", "kv_seq", kvh, None)
    v = shard(v, "batch", "kv_seq", kvh, None)

    o = attention(q, k, v, causal=causal, impl=impl, chunk=cfg.attn_chunk,
                  q_offset=q_offset, kv_len=kv_len)
    o = shard(o, "batch", None, "heads", None)
    return _out_proj(o, p["wo"].to(x.dtype), split > 1, scatter), new_cache


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                  device="cpu") -> KVCache:
    """A zeroed cache; inside a step on shards that splits ``kv_heads``
    over ``model``, of the rank's KV heads."""
    KV, Dh = tp.local_size(cfg.n_kv_heads, "kv_heads"), cfg.d_head
    return KVCache(
        k=torch.zeros((batch, max_len, KV, Dh), dtype=dtype, device=device),
        v=torch.zeros((batch, max_len, KV, Dh), dtype=dtype, device=device),
        length=torch.zeros((), dtype=torch.int32),
    )


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------

class MLACache(NamedTuple):
    c_kv: torch.Tensor       # (B, T, r)  compressed latent
    k_rope: torch.Tensor     # (B, T, dr) shared rope key
    length: torch.Tensor     # () int32 — filled prefix; kept on the CPU


def mla_attention(p, cfg: ArchConfig, x: torch.Tensor, *, positions,
                  cache: Optional[MLACache] = None, impl: str = "chunked",
                  scatter: bool = False):
    """x: (B,S,D). Returns (out, new_cache); a given cache is updated in
    place; ``scatter`` as :func:`self_attention`'s. Keys are nope + rope wide, values ``v_head_dim``: the flash
    gate refuses the pair, so every impl runs the chunked/dense path."""
    m = cfg.mla
    B, S, d = x.shape
    H = p["wo"].shape[0]                 # the rank's heads under TP
    split = tp.parts(H, cfg.n_heads) > 1
    dn, dr = m.nope_head_dim, m.rope_head_dim

    if m.q_lora_rank:
        cq = x @ p["w_dq"]
        cq = cq * torch.rsqrt(torch.square(cq.float()).mean(-1, keepdim=True)
                              + cfg.norm_eps).to(x.dtype)
        q = torch.einsum("bsr,rhe->bshe", tp.copy_in(cq) if split else cq,
                         p["w_uq"].to(x.dtype))
    else:
        q = torch.einsum("bsd,dhe->bshe", tp.copy_in(x) if split else x,
                         p["wq"].to(x.dtype))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    c = x @ p["w_dkv"]                                   # (B,S,r)
    cf = c.float()
    c = (cf * torch.rsqrt(torch.square(cf).mean(-1, keepdim=True)
                          + cfg.norm_eps) * p["kv_norm"].float()).to(x.dtype)
    kr = apply_rope((x @ p["w_kr"])[:, :, None, :], positions, cfg.rope_theta)
    kr = kr[:, :, 0, :]                                  # (B,S,dr)

    q_offset = 0
    kv_len = None
    new_cache = None
    if cache is not None:
        start = int(cache.length)
        c_all = _write_cache(cache.c_kv, c, start)
        kr_all = _write_cache(cache.k_rope, kr, start)
        new_cache = MLACache(c_all, kr_all, cache.length + S)
        c, kr = c_all.to(x.dtype), kr_all.to(x.dtype)
        kv_len = cache.length + S
        q_offset = cache.length

    # expand latent -> per-head keys/values (the reference's naive path;
    # the absorbed variant is a speed change); the replicated latent
    # enters the rank's heads
    if split:
        c, kr = tp.copy_in(c), tp.copy_in(kr)
    k_nope = torch.einsum("btr,rhe->bthe", c, p["w_uk"].to(x.dtype))
    vv = torch.einsum("btr,rhe->bthe", c, p["w_uv"].to(x.dtype))
    T = k_nope.shape[1]
    k = torch.cat([k_nope, kr[:, :, None, :].expand(B, T, H, dr)], -1)
    qq = torch.cat([q_nope, q_rope], -1)
    qq = shard(qq, "batch", None, "heads", None)
    k = shard(k, "batch", "kv_seq", "heads", None)
    vv = shard(vv, "batch", "kv_seq", "heads", None)

    o = attention(qq, k, vv, causal=True, impl=impl, chunk=cfg.attn_chunk,
                  q_offset=q_offset, kv_len=kv_len)
    return _out_proj(o, p["wo"].to(x.dtype), split, scatter), new_cache


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                   device="cpu") -> MLACache:
    m = cfg.mla
    return MLACache(
        c_kv=torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, max_len, m.rope_head_dim), dtype=dtype,
                           device=device),
        length=torch.zeros((), dtype=torch.int32),
    )


# ---------------------------------------------------------------------------
# Cross-attention (enc-dec / VLM)
# ---------------------------------------------------------------------------

class CrossCache(NamedTuple):
    k: torch.Tensor          # (B, T_src, KV, Dh) — precomputed from memory
    v: torch.Tensor


def cross_attention(p, cfg: ArchConfig, x: torch.Tensor,
                    memory: Optional[torch.Tensor] = None,
                    cache: Optional[CrossCache] = None,
                    impl: str = "chunked", scatter: bool = False):
    """K/V from `memory` (encoder output / image embeds) or from
    `cache`. Under tensor parallelism the rank's heads, as
    :func:`self_attention`'s (the flash kernel runs on them); ``scatter``
    as there."""
    split = _head_split(p, cfg)
    kv_whole = p["wk"].shape[1] == cfg.n_kv_heads
    q = _project(p, cfg, tp.copy_in(x) if split > 1 else x, "q")
    q = shard(q, "batch", None, "heads", None)
    if cache is None:
        if memory is None:
            raise ValueError("cross_attention needs memory or a cache")
        mem = memory if kv_whole else tp.copy_in(memory)
        k = _project(p, cfg, mem, "k")
        v = _project(p, cfg, mem, "v")
        new_cache = CrossCache(k, v)
    else:
        k, v = cache.k.to(x.dtype), cache.v.to(x.dtype)
        new_cache = cache
    rep = kv_repeat_factor(cfg)
    kvh = "heads" if rep > 1 else "kv_heads"
    k, v = _expand_kv(k, rep), _expand_kv(v, rep)
    if split > 1 and kv_whole:
        k, v = (_rank_kv(t, cfg.n_heads, split) for t in (k, v))
    k = shard(k, "batch", None, kvh, None)
    v = shard(v, "batch", None, kvh, None)
    o = attention(q, k, v, causal=False, impl=impl, chunk=cfg.attn_chunk)
    return _out_proj(o, p["wo"].to(x.dtype), split > 1, scatter), new_cache
