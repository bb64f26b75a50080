"""Public model API of the port: build/init any architecture of the repo
and run eval / prefill / decode, as the JAX package's
``models/model_zoo.py``.

Cache layout mirrors the layer plan: ``{"prefix": [slot_cache...],
"stack": stacked_slot_caches}`` (+ ``"memory"`` for enc-dec / VLM), with
the reference's NamedTuples (``KVCache``, ``MLACache``, ``CrossCache``,
``MambaState``, ``RWKVState``) as leaves' parents. The reference donates the cache to its jitted decode
step; here :func:`decode_step` (and :func:`prefill`, on the cache it
allocates) update the given cache IN PLACE and return it. Each
``KVCache.length`` and ``MLACache.length`` is a CPU int32 tensor, so reading the cache's length
costs no device sync.
"""

from __future__ import annotations

import re

import torch

from repro_torch import resolve_device
from repro_torch._tree import tree_flatten_with_path, tree_map, tree_unflatten
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.dist import tp
from repro_torch.models import attention as attn_mod
from repro_torch.models import params as pmod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm, dtype_of, embed_tokens, lm_logits
from repro_torch.models.transformer import (
    Slot, forward_lm, layer_plan, lm_loss, model_specs,
    run_prefix, run_stack,
)

__all__ = [
    "model_specs", "init_params", "param_axes", "param_shapes",
    "param_count", "forward_lm", "lm_loss", "init_caches", "prefill",
    "decode_step", "cache_axes", "constrain_caches", "input_specs",
]


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda"):
    """Random parameters from ``seed``, materialized on ``device``."""
    return pmod.materialize(model_specs(cfg), seed, dtype_of(cfg.param_dtype),
                            resolve_device(device))


def param_axes(cfg: ArchConfig):
    """The parameter tree's logical axes (``Spec.axes`` leaf for leaf)."""
    return pmod.axes_of(model_specs(cfg))


def param_shapes(cfg: ArchConfig):
    """The parameter tree as ``meta`` tensors (no storage)."""
    return pmod.shape_tree(model_specs(cfg), dtype_of(cfg.param_dtype))


def param_count(cfg: ArchConfig) -> int:
    return pmod.param_count(model_specs(cfg))


def params_device(params) -> torch.device:
    return params["embed"]["tok"].device


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _cross(cfg, batch, src_len, dtype, device):
    shape = (batch, src_len, tp.local_size(cfg.n_kv_heads, "kv_heads"),
             cfg.d_head)
    return attn_mod.CrossCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device))


def _slot_cache(cfg: ArchConfig, slot: Slot, batch: int, max_len: int,
                src_len: int, dtype, device):
    if slot.mixer == "attn":
        return {"kv": attn_mod.init_kv_cache(cfg, batch, max_len, dtype,
                                             device)}
    if slot.mixer == "mla":
        return {"kv": attn_mod.init_mla_cache(cfg, batch, max_len, dtype,
                                              device)}
    if slot.mixer == "cross":
        return {"cross": _cross(cfg, batch, src_len, dtype, device)}
    if slot.mixer == "attn_cross":
        return {"kv": attn_mod.init_kv_cache(cfg, batch, max_len, dtype,
                                             device),
                "cross": _cross(cfg, batch, src_len, dtype, device)}
    if slot.mixer == "mamba":
        return {"mamba": ssm_mod.init_mamba_state(cfg, batch, device)}
    if slot.mixer == "rwkv":
        return {"rwkv": rwkv_mod.init_rwkv_state(cfg, batch, device)}
    raise ValueError(slot.mixer)


def _stack_cache(cfg, pattern, rep, batch, max_len, src_len, dtype, device):
    per_slot = [_slot_cache(cfg, s, batch, max_len, src_len, dtype, device)
                for s in pattern]
    return tree_map(
        lambda x: x[None].expand((rep,) + tuple(x.shape)).clone(), per_slot)


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                src_len: int = 0, dtype=None, device="cuda"):
    """A zeroed cache tree on ``device`` (the card unless asked
    otherwise); ``device="meta"`` gives shapes only. Lengths stay on the
    CPU. Inside a step on shards whose ``model`` axis splits the heads
    or ``dinner``, each leaf holds the rank's share of them."""
    device = resolve_device(device)
    dtype = dtype or dtype_of(cfg.kv_cache_dtype)
    if cfg.family == "encdec":
        pre, rep, pat = layer_plan(cfg, cfg.dec_layers, decoder=True)
    else:
        pre, rep, pat = layer_plan(cfg, cfg.n_layers)
    out = {
        "prefix": [_slot_cache(cfg, s, batch, max_len, src_len, dtype, device)
                   for s in pre],
        "stack": (_stack_cache(cfg, pat, rep, batch, max_len, src_len, dtype,
                               device) if rep else []),
    }
    if cfg.family in ("encdec", "vlm"):
        out["memory"] = torch.zeros((batch, src_len, cfg.d_model),
                                    dtype=dtype_of(cfg.compute_dtype),
                                    device=device)
    return out


# ---------------------------------------------------------------------------
# Cached forward (prefill and decode share this)
# ---------------------------------------------------------------------------

def _sincos_at(cfg, S, offset, device):
    """The reference's ``_sincos_at`` (its log is taken in fp32, unlike
    ``sincos_pos_embed``'s)."""
    pos = (torch.arange(S, device=device) + offset).float()[:, None]
    d = cfg.d_model
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-torch.log(torch.full((), 10000.0, device=device)) / d))
    pe = torch.zeros((S, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def forward_cached(params, cfg: ArchConfig, tokens, caches, *, offset,
                   memory=None, impl: str = "chunked"):
    """tokens: (B,S) starting at absolute position `offset` (an int or a
    0-dim tensor). Updates ``caches`` in place; returns (last-token
    logits, caches). Inside a step on shards (``dist.fsdp.sharded``)
    ``params`` are the rank's shards, each layer's gathered where it runs
    and freed after it."""
    specs = tfm.param_specs(cfg)
    return _forward_cached(tfm.gather_entry(params, specs), cfg, tokens,
                           caches, offset=offset, memory=memory, impl=impl,
                           specs=specs)


def _forward_cached(params, cfg, tokens, caches, *, offset, memory, impl,
                    specs):
    """:func:`forward_cached` on params whose entry leaves are gathered."""
    B, S = tokens.shape
    x = embed_tokens(params["embed"], cfg, tokens)
    off = int(offset)
    if cfg.pos_embed == "sincos":
        x = x + _sincos_at(cfg, S, off, x.device).to(x.dtype)[None]
    positions = tfm._positions(B, S, off, device=x.device)
    which = "dec/" if cfg.family == "encdec" else ""
    if cfg.family == "encdec":
        pre, rep, pat = layer_plan(cfg, cfg.dec_layers, decoder=True)
        prefix_params, stack_params = params["dec"]["prefix"], params["dec"]["stack"]
    else:
        pre, rep, pat = layer_plan(cfg, cfg.n_layers)
        prefix_params, stack_params = params["prefix"], params["stack"]
    new = dict(caches)
    x = tfm.split_stream(x, positions)
    x, pc, _ = run_prefix(prefix_params, cfg, pre, x, positions=positions,
                          memory=memory, caches=caches["prefix"], impl=impl,
                          specs=tfm._sub(specs, which + "prefix"))
    new["prefix"] = pc
    if rep:
        x, sc, _ = run_stack(stack_params, cfg, pat, x, positions=positions,
                             memory=memory, caches=caches["stack"] or None,
                             impl=impl,
                             stack_specs=tfm._sub(specs, which + "stack"))
        new["stack"] = sc
    x = apply_norm(params["final_norm"], cfg, tfm.gather_stream(x, positions))
    logits = lm_logits(params["embed"], cfg, x[:, -1:, :])
    # the last position's logits whole on every rank (B x V, small)
    if logits.shape[-1] != cfg.padded_vocab:
        logits = tp.gather_out(logits, -1)
    return logits, new


def _clear_cross(tree):
    """The cache tree with every ``cross`` entry ``None`` (a module-level
    recursion: a closure calling itself is a reference cycle)."""
    if isinstance(tree, dict):
        return {k: (None if k == "cross" else _clear_cross(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clear_cross(v) for v in tree]
    return tree


def constrain_caches(caches):
    """Apply logical-axis sharding constraints to a cache tree (no-op
    without an active mesh). Inside a step on shards the caches are plain
    tensors made at the rank's size (its KV heads, ``dinner`` channels or
    RWKV heads under tensor parallelism: :func:`init_caches`), which
    this leaves as they are."""
    from repro_torch.dist import mesh_active, shard
    from repro_torch.dist.api import is_axes
    if not mesh_active():
        return caches
    return tree_map(lambda x, ax: shard(x, *ax), caches, cache_axes(caches),
                    is_leaf=is_axes)


def prefill(params, cfg: ArchConfig, batch: dict, max_len: int,
            impl: str = "chunked"):
    """Fill caches from a prompt. Returns (last-token logits, caches)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds max_len {max_len}")
    dev = params_device(params)
    specs = tfm.param_specs(cfg)
    params = tfm.gather_entry(params, specs)
    memory = None
    src_len = 0
    if cfg.family == "encdec":
        memory = tfm.encode_gathered(params, cfg, batch, impl, specs)
        src_len = memory.shape[1]
    elif cfg.family == "vlm":
        memory = tfm.frontend_memory(params, cfg, batch)
        src_len = memory.shape[1]
    caches = constrain_caches(init_caches(cfg, B, max_len, src_len,
                                          device=dev))
    # cross caches start empty -> computed from memory on first pass
    caches = _clear_cross(caches)
    logits, caches = _forward_cached(params, cfg, tokens, caches, offset=0,
                                     memory=memory, impl=impl, specs=specs)
    if memory is not None:
        caches["memory"] = memory
    return logits, caches


def decode_step(params, cfg: ArchConfig, caches, tokens, *,
                impl: str = "chunked"):
    """One decode step. tokens: (B,1). Offset derives from cache lengths;
    the cache is updated in place."""
    offset = _cache_length(caches)
    memory = caches.get("memory")
    return forward_cached(params, cfg, tokens, caches, offset=offset,
                          memory=memory, impl=impl)


def _lengths(t, out: list) -> None:
    """Append every KV and MLA cache's length under ``t`` to ``out``."""
    if isinstance(t, dict):
        for v in t.values():
            _lengths(v, out)
    elif isinstance(t, list):
        for v in t:
            _lengths(v, out)
    elif isinstance(t, (attn_mod.KVCache, attn_mod.MLACache)):
        out.append(t.length)


def _cache_length(caches) -> torch.Tensor:
    """The filled prefix of the first KV or MLA cache; 0 for a cache tree
    with no attention leaf (pure ssm, rwkv), as in the reference."""
    leaves = []
    _lengths({k: v for k, v in caches.items() if k != "memory"}, leaves)
    if not leaves:
        return torch.zeros((), dtype=torch.int32)
    l0 = leaves[0]
    return l0.reshape(-1)[0] if l0.dim() else l0


_CACHE_FIELD_AXES = {
    "k": ("batch", "kv_seq", "kv_heads", None),
    "v": ("batch", "kv_seq", "kv_heads", None),
    "c_kv": ("batch", "kv_seq", None),
    "k_rope": ("batch", "kv_seq", None),
    "length": (),
    "conv": ("batch", None, "dinner"),
    "h": ("batch", "dinner", None),
    "tm_shift": ("batch", None),
    "cm_shift": ("batch", None),
    "wkv": ("batch", "heads", None, None),
    "memory": ("batch", None, None),
}


def cache_axes(caches):
    """Logical-axes tree mirroring a cache tree: each leaf's axes by its
    field name (the innermost NamedTuple field or dict key that names
    one), with ``layers`` in front on a stacked leaf."""
    flat, treedef = tree_flatten_with_path(caches)
    out = []
    for path, x in flat:
        names = [a or b for a, b in re.findall(r"\.(\w+)|\['(\w+)'\]",
                                                path)]
        name = next(n for n in reversed(names) if n in _CACHE_FIELD_AXES)
        base = _CACHE_FIELD_AXES[name]
        rank = len(x.shape)
        if rank == len(base) + 1:
            base = ("layers",) + base
        if rank != len(base):
            raise ValueError(f"cache leaf {path}: rank {rank} vs {base}")
        out.append(base)
    return tree_unflatten(treedef, out)


# ---------------------------------------------------------------------------
# Input specs (``meta`` tensors: shapes and dtypes, no storage)
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Global-shape inputs for a (arch x shape) cell, as ``meta``
    tensors (the reference's ShapeDtypeStruct stand-ins)."""
    B, S = shape.global_batch, shape.seq_len
    f = dtype_of(cfg.compute_dtype)

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        out = {"tokens": spec((B, S), torch.int32)}
        if cfg.family == "vlm":
            out["patches"] = spec((B, cfg.frontend_len, cfg.frontend_dim), f)
        if cfg.family == "encdec":
            out["frames"] = spec((B, S, cfg.frontend_dim), f)
        return out
    # decode: one new token against caches of length S
    src_len = cfg.frontend_len if cfg.family in ("encdec", "vlm") else 0
    return {"tokens": spec((B, 1), torch.int32),
            "caches": init_caches(cfg, B, S, src_len, device="meta")}
