"""Unified LM assembly for every architecture family, ported from the
JAX package's ``models/transformer.py``.

A config compiles to a *layer plan*: a short prefix plus a periodic
pattern of per-layer "slots" over stacked parameters (every leaf of the
pattern's parameters carries a leading ``layers`` dimension). The
reference scans over that dimension; here :func:`run_stack` is a Python
loop over it, differentiable by torch autograd, with the reference's
rematerialisation (``cfg.remat``, :func:`_remat_wrap`) when it runs
under autograd. The reference's gather barrier (``_diff_barrier``) has
no counterpart: it is an XLA scheduling barrier (it keeps the partitioner
from hoisting FSDP all-gathers out of the scan) with no numeric effect.
Inside a step on shards (:func:`repro_torch.dist.fsdp.sharded`) the
params are the rank's shards, gathered where the reference pins them: a
layer's inside its body, a prefix slot's before the slot, and the leaves
outside the stacks once at each entry point (:func:`gather_entry`). A
dim the recipe keeps on ``model`` (heads, ``ff``, ``vocab``, ``dinner``,
experts) is not gathered over it: the layers compute on the rank's slice
(:mod:`repro_torch.dist.tp`).
Slot mixers: attn | mla | cross | attn_cross | mamba | rwkv; slot MLPs:
dense | moe | rwkv_cm | none.

Families:
  dense/moe      -> decoder-only stack (MLA where ``cfg.mla`` is set)
  rwkv/ssm       -> recurrent mixers, O(1) decode state
  hybrid (jamba) -> periodic (mamba + 1 attn a period), alternating MoE
  vlm            -> gated cross-attention layer every N (image stub memory)
  encdec         -> bidirectional encoder stack + decoder with cross-attn
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch._tree import (tree_flatten, tree_flatten_with_path,
                               tree_map, tree_unflatten)
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import fsdp, shard, tp
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    apply_mlp, apply_norm, cot_cast, dtype_of, embed_specs, embed_tokens,
    lm_logits, mlp_specs, norm_specs, sincos_pos_embed,
)
from repro_torch.models.params import Spec, stack_specs


# ---------------------------------------------------------------------------
# Layer plans
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Slot:
    mixer: str            # attn|mla|cross|attn_cross|mamba|rwkv
    mlp: str              # dense|moe|rwkv_cm|none
    causal: bool = True
    gated: bool = False   # vlm-style gated cross layer


def _slot_list(cfg: ArchConfig, n_layers: int, decoder: bool = True):
    moe_mask = cfg.moe_layer_mask(n_layers)
    attn_mask = cfg.attn_layer_mask() if cfg.family == "hybrid" else None
    cross_mask = cfg.cross_layer_mask() if cfg.family == "vlm" else None
    slots = []
    for i in range(n_layers):
        mlp = "moe" if (moe_mask[i] and cfg.moe.num_experts) else "dense"
        if cfg.family == "rwkv":
            slots.append(Slot("rwkv", "rwkv_cm"))
        elif cfg.family == "ssm":
            slots.append(Slot("mamba", mlp))
        elif cfg.family == "hybrid":
            slots.append(Slot("attn" if attn_mask[i] else "mamba", mlp))
        elif cfg.family == "vlm":
            slots.append(Slot("cross", mlp, gated=True) if cross_mask[i]
                         else Slot("attn", mlp))
        elif cfg.family == "encdec" and decoder:
            slots.append(Slot("attn_cross", mlp))
        elif cfg.family == "encdec":
            slots.append(Slot("attn", mlp, causal=False))
        else:
            slots.append(Slot("mla" if cfg.mla is not None else "attn", mlp))
    return slots


def layer_plan(cfg: ArchConfig, n_layers: int, decoder: bool = True):
    """-> (prefix_slots, repeat, pattern_slots)."""
    slots = _slot_list(cfg, n_layers, decoder)
    for prefix in range(0, min(4, n_layers)):
        rest = slots[prefix:]
        if not rest:
            continue
        for period in range(1, min(len(rest), 16) + 1):
            if len(rest) % period:
                continue
            if all(rest[i] == rest[i % period] for i in range(len(rest))):
                if len(rest) // period == 1 and period > 1:
                    continue  # prefer true repetition over one fat block
                return tuple(slots[:prefix]), len(rest) // period, tuple(rest[:period])
    return tuple(slots), 0, ()


# ---------------------------------------------------------------------------
# Per-slot specs
# ---------------------------------------------------------------------------

def _mixer_specs(cfg: ArchConfig, slot: Slot):
    if slot.mixer in ("attn", "cross"):
        return attn.attn_specs(cfg)
    if slot.mixer == "mla":
        return attn.mla_specs(cfg)
    if slot.mixer == "attn_cross":
        return {"self": attn.attn_specs(cfg), "cross": attn.attn_specs(cfg)}
    if slot.mixer == "mamba":
        return ssm_mod.mamba_specs(cfg)
    if slot.mixer == "rwkv":
        return rwkv_mod.rwkv_time_mix_specs(cfg)
    raise ValueError(slot.mixer)


def _mlp_specs(cfg: ArchConfig, slot: Slot):
    if slot.mlp == "dense":
        return mlp_specs(cfg)
    if slot.mlp == "moe":
        return moe_mod.moe_specs(cfg)
    if slot.mlp == "rwkv_cm":
        return rwkv_mod.rwkv_channel_mix_specs(cfg)
    return {}


def slot_specs(cfg: ArchConfig, slot: Slot):
    sp = {"norm1": norm_specs(cfg), "mixer": _mixer_specs(cfg, slot)}
    if slot.mixer == "attn_cross":
        sp["norm_cross"] = norm_specs(cfg)
    if slot.mlp != "none":
        sp["norm2"] = norm_specs(cfg)
        sp["mlp"] = _mlp_specs(cfg, slot)
    if slot.gated:
        sp["gate_attn"] = Spec((), (), "zeros")
        sp["gate_mlp"] = Spec((), (), "zeros")
    return sp


def model_specs(cfg: ArchConfig):
    sp: dict = {"embed": embed_specs(cfg), "final_norm": norm_specs(cfg)}
    if cfg.family == "encdec":
        pre_e, rep_e, pat_e = layer_plan(cfg, cfg.enc_layers, decoder=False)
        pre_d, rep_d, pat_d = layer_plan(cfg, cfg.dec_layers, decoder=True)
        sp["enc"] = {
            "prefix": [slot_specs(cfg, s) for s in pre_e],
            "stack": stack_specs([slot_specs(cfg, s) for s in pat_e], rep_e),
            "final_norm": norm_specs(cfg),
        }
        sp["dec"] = {
            "prefix": [slot_specs(cfg, s) for s in pre_d],
            "stack": stack_specs([slot_specs(cfg, s) for s in pat_d], rep_d),
        }
    else:
        pre, rep, pat = layer_plan(cfg, cfg.n_layers)
        sp["prefix"] = [slot_specs(cfg, s) for s in pre]
        sp["stack"] = stack_specs([slot_specs(cfg, s) for s in pat], rep)
    if cfg.frontend != "none":
        sp["frontend_proj"] = Spec((cfg.frontend_dim, cfg.d_model),
                                   ("embed", None))
    return sp


# ---------------------------------------------------------------------------
# Slot application
# ---------------------------------------------------------------------------

def _seq_split(positions) -> bool:
    """Whether the layers keep the residual stream as the rank's slice of
    the sequence: the active act rules map ``seq_sp`` to ``model`` and
    the sequence (``positions``' length) divides (:func:`repro_torch.dist.
    tp.seq_parts`); never at a decode step of one position."""
    return tp.seq_parts(positions.shape[-1]) > 1


def split_stream(x, positions):
    """The residual stream as the layers take it: the rank's slice of the
    sequence where :func:`_seq_split` says so, else ``x``."""
    return tp.seq_slice(x, 1) if _seq_split(positions) else x


def gather_stream(x, positions):
    """The residual stream whole after the last layer (the ranks' slices
    all-gathered where :func:`split_stream` split it)."""
    return tp.gather_in(x, 1) if _seq_split(positions) else x


def _norm_in(p_norm, cfg: ArchConfig, x, split: bool):
    """A pre-norm's output for the next mixer or MLP, whole: where the
    stream is the rank's slice, normed there (the scale's gradient summed
    over ``model``) and all-gathered along the sequence."""
    if not split:
        return shard(apply_norm(p_norm, cfg, x), "batch", None, "embed")
    return tp.gather_in(apply_norm(tp.on_slice(p_norm), cfg, x), 1)


def _gate(o, gate, split: bool):
    """``o`` through a tanh gate (on the slice, its gradient summed)."""
    g = tp.on_slice(gate) if split else gate
    return o * torch.tanh(g.to(o.dtype))


def apply_slot(p, cfg: ArchConfig, slot: Slot, x, *, positions, memory,
               cache, impl: str):
    """Returns (x, new_cache, aux). ``aux`` is the MoE MLP's auxiliary
    loss, a tensor, or the Python float 0.0 where the slot has none (a
    zero tensor a layer would cost every model a launch a layer). Where
    the act rules map ``seq_sp`` to ``model`` (:func:`_seq_split`) ``x``
    comes in (:func:`split_stream`) and goes out as the rank's slice of
    the sequence: the norms run on the slice, their outputs are
    all-gathered before the mixer and the MLP, and each mixer and MLP is
    asked for its output as the slice (``scatter``: its output product
    reduce-scatters, :func:`repro_torch.dist.tp.row_product`)."""
    split = _seq_split(positions)
    aux = 0.0
    h = _norm_in(p["norm1"], cfg, x, split)
    new_cache = cache

    if slot.mixer == "attn":
        o, kv = attn.self_attention(
            p["mixer"], cfg, h, positions=positions,
            cache=cache.get("kv") if cache else None,
            causal=slot.causal, impl=impl, scatter=split)
        new_cache = {"kv": kv} if cache else None
    elif slot.mixer == "mla":
        o, kv = attn.mla_attention(
            p["mixer"], cfg, h, positions=positions,
            cache=cache.get("kv") if cache else None, impl=impl,
            scatter=split)
        new_cache = {"kv": kv} if cache else None
    elif slot.mixer == "cross":
        o, cc = attn.cross_attention(
            p["mixer"], cfg, h, memory=memory,
            cache=cache.get("cross") if cache and cache.get("cross") is not None else None,
            impl=impl, scatter=split)
        new_cache = {"cross": cc} if cache else None
    elif slot.mixer == "attn_cross":
        o, kv = attn.self_attention(
            p["mixer"]["self"], cfg, h, positions=positions,
            cache=cache.get("kv") if cache else None,
            causal=slot.causal, impl=impl, scatter=split)
        x = x + shard(o, "batch", "seq_sp", "embed")   # reduce-scatter form
        h2 = _norm_in(p["norm_cross"], cfg, x, split)
        o, cc = attn.cross_attention(
            p["mixer"]["cross"], cfg, h2, memory=memory,
            cache=cache.get("cross") if cache and cache.get("cross") is not None else None,
            impl=impl, scatter=split)
        new_cache = {"kv": kv, "cross": cc} if cache else None
    elif slot.mixer == "mamba":
        st = cache.get("mamba") if cache else None
        if st is not None and h.shape[1] == 1:
            o, st = ssm_mod.mamba_decode_step(p["mixer"], cfg, h, st)
        else:
            o, st = ssm_mod.mamba_mixer(p["mixer"], cfg, h, st,
                                        scatter=split)
        new_cache = {"mamba": st} if cache else None
    elif slot.mixer == "rwkv":
        st = cache.get("rwkv") if cache else None
        o, tm_shift, wkv = rwkv_mod.rwkv_time_mix(p["mixer"], cfg, h, st,
                                                  impl=impl, scatter=split)
        cm_prev = st.cm_shift if st is not None else None
    else:
        raise ValueError(slot.mixer)

    o = shard(o, "batch", "seq_sp", "embed")       # reduce-scatter form
    if slot.gated:
        o = _gate(o, p["gate_attn"], split)
    if slot.mixer == "rwkv":
        x = x + o
        h = _norm_in(p["norm2"], cfg, x, split)
        o2, cm_shift = rwkv_mod.rwkv_channel_mix(
            p["mlp"], cfg, h,
            rwkv_mod.RWKVState(tm_shift, cm_prev, wkv) if st is not None else None,
            scatter=split)
        x = x + shard(o2, "batch", "seq_sp", "embed")
        if cache:
            new_cache = {"rwkv": rwkv_mod.RWKVState(tm_shift, cm_shift, wkv)}
        return shard(cot_cast(x), "batch", "seq_sp", "embed"), new_cache, aux

    x = x + o
    if slot.mlp != "none":
        h = _norm_in(p["norm2"], cfg, x, split)
        if slot.mlp == "moe":
            o2, a = moe_mod.apply_moe(p["mlp"], cfg, h, scatter=split)
            aux = aux + a
        else:
            o2 = apply_mlp(p["mlp"], cfg, h, scatter=split)
        o2 = shard(o2, "batch", "seq_sp", "embed")
        if slot.gated:
            o2 = _gate(o2, p["gate_mlp"], split)
        x = x + o2
    return shard(cot_cast(x), "batch", "seq_sp", "embed"), new_cache, aux


# ---------------------------------------------------------------------------
# Stack runner (a loop over stacked params / caches)
# ---------------------------------------------------------------------------

def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree: views into the stacked tensors."""
    return tree_map(lambda t: t[i], tree)


def _layers(tree, n: int):
    """Every layer of a stacked tree, by one ``torch.unbind`` a leaf: its
    backward is one ``stack`` a leaf, where ``t[i]`` a layer would run n
    ``select_backward``s, each a zero tensor the size of the whole
    stack."""
    leaves, treedef = tree_flatten(tree)
    per_leaf = [torch.unbind(t) for t in leaves]
    return [tree_unflatten(treedef, [u[i] for u in per_leaf])
            for i in range(n)]


# the matrix products a "dots" policy saves (the reference's
# ``checkpoint_dots``): einsum and ``@`` run as these
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn, cfg: ArchConfig):
    """``fn(x, layer_params)`` under the reference's remat policy:
    ``"none"`` saves every activation, ``"dots"`` saves the matrix
    products' outputs and recomputes the rest, and anything else
    (``"full"``) saves only the layer's input and recomputes its body in
    the backward. The model draws no random numbers, so the RNG state is
    not carried into the recompute. The recompute re-enters the mesh and
    sharded contexts the forward ran under (``dist.fsdp.contexts``): on
    the card it runs on the autograd engine's thread, which has none."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _dots_policy)

    def wrapped(x, lp):
        ctx = fsdp.contexts()

        def body(x, lp):
            with fsdp.entered(ctx):
                return fn(x, lp)
        return torch_checkpoint.checkpoint(
            body, x, lp, use_reentrant=False, preserve_rng_state=False, **kw)
    return wrapped


def _constrain_layer_params(lp, specs):
    """A layer's params as the layer uses them: the reference pins each
    sliced per-layer param to its sharded layout inside its scan body;
    here, inside a step on shards, each is gathered to its full value
    (:func:`repro_torch.dist.fsdp.gather`; ``specs``: the layer's specs,
    :func:`_layer_specs`). The identity where ``specs`` is None."""
    return fsdp.gather(lp, specs)


def _layer_specs(stack_specs):
    """The stack's specs without their leading ``layers`` entry (never
    sharded): one layer's; None stays None."""
    if stack_specs is None:
        return None
    return tree_map(lambda s: type(s)(*s[1:]), stack_specs,
                    is_leaf=fsdp.is_spec)


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``a`` is ``b``'s elements: the same storage, offset and dtype (not
    compared by data pointer, which a fake tensor of the dry run lacks)."""
    return (a.dtype == b.dtype and a.storage_offset() == b.storage_offset()
            and a.untyped_storage()._cdata == b.untyped_storage()._cdata)


def _write_back(stacked, per_layer):
    """The stacked cache tree after the loop. A leaf the stacked tree
    already holds is updated IN PLACE, layer by layer (a layer's KV
    cache was written through its view and is skipped); a leaf it does
    not hold (the cross-attention K/V that prefill computes where the
    cache held ``None``) is stacked anew."""
    old = dict(tree_flatten_with_path(stacked)[0])
    flat0, treedef = tree_flatten_with_path(per_layer[0])
    flats = [tree_flatten_with_path(c)[0] for c in per_layer]
    leaves = []
    for j, (path, _) in enumerate(flat0):
        news = [f[j][1] for f in flats]
        buf = old.get(path)
        if isinstance(buf, torch.Tensor) and buf.shape[1:] == news[0].shape:
            for i, t in enumerate(news):
                dst = buf[i]
                if not _same_memory(t, dst):
                    dst.copy_(t)
            leaves.append(buf)
        else:
            leaves.append(torch.stack(news))
    return tree_unflatten(treedef, leaves)


def run_stack(params, cfg: ArchConfig, pattern, x, *, positions, memory,
              caches, impl, stack_specs=None):
    """params: stacked slot-param list; caches: stacked cache trees or
    None (updated in place where given). Without caches and under
    autograd each layer runs under ``cfg.remat``. ``stack_specs`` (the
    stack's specs inside a step on shards, :func:`param_specs`; else
    None) gathers each layer's params where the layer runs: inside the
    body ``cfg.remat`` checkpoints, so under ``"full"`` and ``"dots"``
    the gathered weights are freed after their layer and the backward
    gathers them again, while under ``"none"`` autograd keeps every
    layer's gathered weights until the backward; with caches (serving),
    under ``no_grad``, freed after the layer. Returns (x, caches, aux),
    aux summed over the layers."""
    n = len(tree_flatten_with_path(params)[0][0][1])
    layers = _layers(params, n)
    specs = _layer_specs(stack_specs)
    aux = 0.0
    if caches is None:
        def body(x, lp):
            lp = _constrain_layer_params(lp, specs)
            a_layer = 0.0
            for i, slot in enumerate(pattern):
                x, _, a = apply_slot(lp[i], cfg, slot, x, positions=positions,
                                     memory=memory, cache=None, impl=impl)
                a_layer = a_layer + a
            return x, a_layer
        if torch.is_grad_enabled():
            body = _remat_wrap(body, cfg)
        for lp in layers:
            x, a = body(x, lp)
            aux = aux + a
        return x, None, aux
    per_layer = []
    for l, lp in enumerate(layers):
        with torch.no_grad():
            lp = _constrain_layer_params(lp, specs)
        lc = _layer(caches, l)
        new_caches = []
        a_layer = 0.0
        for i, slot in enumerate(pattern):
            x, nc, a = apply_slot(lp[i], cfg, slot, x, positions=positions,
                                  memory=memory, cache=lc[i], impl=impl)
            new_caches.append(nc)
            a_layer = a_layer + a
        per_layer.append(new_caches)
        aux = aux + a_layer
    return x, _write_back(caches, per_layer), aux


def run_prefix(params, cfg: ArchConfig, slots, x, *, positions, memory,
               caches, impl, specs=None):
    """The layers before the stack, one slot at a time; ``specs`` (the
    prefix's, inside a step on shards) gathers each slot's params before
    it runs."""
    aux = 0.0
    new_caches = []
    for i, slot in enumerate(slots):
        c = caches[i] if caches is not None else None
        p = fsdp.gather(params[i], None if specs is None else specs[i])
        x, nc, a = apply_slot(p, cfg, slot, x, positions=positions,
                              memory=memory, cache=c, impl=impl)
        new_caches.append(nc)
        aux = aux + a
    return x, (new_caches if caches is not None else None), aux


# ---------------------------------------------------------------------------
# The params' specs inside a step on shards
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _param_specs(cfg: ArchConfig, sizes: tuple, table: tuple, act: tuple):
    """The use-spec tree from the model's ``Spec`` leaves (their shapes
    and axes: no tensor is made, so a traced step counts no op for
    it)."""
    mesh, table, act = fsdp.MeshShape(dict(sizes)), dict(table), dict(act)
    return tree_map(lambda sp: fsdp.use_spec(
        sp.axes, fsdp.leaf_spec(sp.axes, sp.shape, table, mesh), act),
        model_specs(cfg))


def _frozen(table: dict) -> tuple:
    return tuple(sorted((k, v if isinstance(v, str) else tuple(v))
                        for k, v in table.items()))


def param_specs(cfg: ArchConfig):
    """What :func:`repro_torch.dist.fsdp.gather` gathers of every
    parameter of ``cfg`` (a tree like its params) inside a step on shards
    (:func:`repro_torch.dist.fsdp.sharded`): its spec by that step's mesh
    and param rules, less ``model`` where the act rules keep the dim on
    ``model`` (:func:`repro_torch.dist.fsdp.use_spec`: the layer computes
    on the rank's slice); None outside one. Computed once a (config,
    mesh shape, rules)."""
    from repro_torch.dist.api import mesh_sizes
    ctx = fsdp.current()
    if ctx is None:
        return None
    return _param_specs(cfg, tuple(mesh_sizes(ctx.mesh).items()),
                        _frozen(ctx.rules.get("param", {})),
                        _frozen(ctx.rules.get("act", {})))


def _sub(specs, path: str):
    """``specs`` at ``path`` ("stack", "enc/prefix", ...); None stays
    None."""
    if specs is None:
        return None
    for k in path.split("/"):
        specs = specs[k]
    return specs


_LAYER_KEYS = ("prefix", "stack")


def gather_entry(params, specs):
    """``params`` with every leaf outside the layer stacks and prefixes
    (``embed``, the final norms, ``frontend_proj``) gathered once to its
    full value, by ``specs`` (:func:`param_specs`); the prefixes and
    stacks stay shards, gathered where their layers run. ``params`` as
    it is where ``specs`` is None. A tied embedding is gathered once for
    both its uses, so both gradients reach its one shard."""
    if specs is None:
        return params
    out = {}
    for k, v in params.items():
        if k in _LAYER_KEYS:
            out[k] = v
        elif k in ("enc", "dec"):
            out[k] = {kk: (vv if kk in _LAYER_KEYS
                           else fsdp.gather(vv, specs[k][kk]))
                      for kk, vv in v.items()}
        else:
            out[k] = fsdp.gather(v, specs[k])
    return out


# ---------------------------------------------------------------------------
# Frontend stubs
# ---------------------------------------------------------------------------

def frontend_memory(params, cfg: ArchConfig, batch: dict):
    """Project stubbed modality embeddings into d_model memory tokens."""
    if cfg.frontend == "none":
        return None
    key = "frames" if cfg.frontend == "audio_frames" else "patches"
    cd = dtype_of(cfg.compute_dtype)
    proj = params["frontend_proj"]
    mem = batch[key].to(device=proj.device, dtype=cd) @ proj.to(cd)
    return shard(mem, "batch", None, "embed")


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _positions(B, S, offset=0, device="cpu"):
    """(1 or B, S) positions from ``offset``, an int or a per-sequence
    tensor. An int stays a scalar operand: a tensor built from it would be
    a host-to-card copy, which a CUDA graph cannot capture."""
    pos = torch.arange(S, device=device)[None, :]
    if isinstance(offset, torch.Tensor):
        return pos + offset.to(device).reshape(-1, 1)
    return pos + offset


def forward_lm(params, cfg: ArchConfig, batch: dict, *, impl: str = "chunked"):
    """Eval forward. Returns (logits fp32, aux_loss fp32 scalar). Inside
    a step on shards ``params`` are the rank's shards (gathered at use)."""
    specs = param_specs(cfg)
    params = gather_entry(params, specs)
    if cfg.family == "encdec":
        return _forward_encdec(params, cfg, batch, impl=impl, specs=specs)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(params["embed"], cfg, tokens)
    if cfg.pos_embed == "sincos":
        x = x + sincos_pos_embed(S, cfg.d_model, device=x.device).to(x.dtype)[None]
    memory = frontend_memory(params, cfg, batch)
    pre, rep, pat = layer_plan(cfg, cfg.n_layers)
    positions = _positions(B, S, device=x.device)
    x = split_stream(x, positions)
    x, _, aux1 = run_prefix(params["prefix"], cfg, pre, x,
                            positions=positions, memory=memory, caches=None,
                            impl=impl, specs=_sub(specs, "prefix"))
    aux2 = 0.0
    if rep:
        x, _, aux2 = run_stack(params["stack"], cfg, pat, x,
                               positions=positions, memory=memory,
                               caches=None, impl=impl,
                               stack_specs=_sub(specs, "stack"))
    x = apply_norm(params["final_norm"], cfg, gather_stream(x, positions))
    return lm_logits(params["embed"], cfg, x), aux_tensor(aux1 + aux2,
                                                          x.device)


def aux_tensor(aux, device) -> torch.Tensor:
    """The auxiliary loss as an fp32 scalar tensor on the model's device:
    a model with no MoE slot summed Python zeros (a CPU zero moved to the
    card would be a copy no CUDA graph captures)."""
    if isinstance(aux, torch.Tensor):
        return aux
    return torch.full((), float(aux), dtype=torch.float32, device=device)


def encode(params, cfg: ArchConfig, batch: dict, impl: str):
    """The encoder of an enc-dec model: frontend memory + sincos, the
    bidirectional stack, the final norm."""
    specs = param_specs(cfg)
    return encode_gathered(gather_entry(params, specs), cfg, batch, impl,
                           specs)


def encode_gathered(params, cfg: ArchConfig, batch: dict, impl: str, specs):
    """:func:`encode` on params whose entry leaves are gathered
    (:func:`gather_entry`; ``specs``: :func:`param_specs`)."""
    mem_in = frontend_memory(params, cfg, batch)        # (B,Se,D)
    Se = mem_in.shape[1]
    x = mem_in + sincos_pos_embed(Se, cfg.d_model, device=mem_in.device
                                  ).to(mem_in.dtype)[None]
    pre, rep, pat = layer_plan(cfg, cfg.enc_layers, decoder=False)
    pos = _positions(x.shape[0], Se, device=x.device)
    x = split_stream(x, pos)
    x, _, _ = run_prefix(params["enc"]["prefix"], cfg, pre, x, positions=pos,
                         memory=None, caches=None, impl=impl,
                         specs=_sub(specs, "enc/prefix"))
    if rep:
        x, _, _ = run_stack(params["enc"]["stack"], cfg, pat, x,
                            positions=pos, memory=None, caches=None,
                            impl=impl, stack_specs=_sub(specs, "enc/stack"))
    return apply_norm(params["enc"]["final_norm"], cfg,
                      gather_stream(x, pos))


def _forward_encdec(params, cfg: ArchConfig, batch: dict, *, impl="chunked",
                    specs=None):
    memory = encode_gathered(params, cfg, batch, impl, specs)
    tgt = batch["tokens"]
    B, Sd = tgt.shape
    x = embed_tokens(params["embed"], cfg, tgt)
    if cfg.pos_embed == "sincos":
        x = x + sincos_pos_embed(Sd, cfg.d_model, device=x.device).to(x.dtype)[None]
    pre, rep, pat = layer_plan(cfg, cfg.dec_layers, decoder=True)
    pos_d = _positions(B, Sd, device=x.device)
    x = split_stream(x, pos_d)
    x, _, aux1 = run_prefix(params["dec"]["prefix"], cfg, pre, x,
                            positions=pos_d, memory=memory, caches=None,
                            impl=impl, specs=_sub(specs, "dec/prefix"))
    aux2 = 0.0
    if rep:
        x, _, aux2 = run_stack(params["dec"]["stack"], cfg, pat, x,
                               positions=pos_d, memory=memory, caches=None,
                               impl=impl,
                               stack_specs=_sub(specs, "dec/stack"))
    x = apply_norm(params["final_norm"], cfg, gather_stream(x, pos_d))
    return lm_logits(params["embed"], cfg, x), aux_tensor(aux1 + aux2,
                                                          x.device)


def lm_loss(params, cfg: ArchConfig, batch: dict, *, impl: str = "chunked"):
    """Next-token cross-entropy (+ aux), differentiable by torch autograd
    (the train step's loss). Returns (loss, metrics). Under tensor
    parallelism the logits are the rank's vocab slice and the
    cross-entropy is vocab-parallel (:func:`repro_torch.dist.tp.
    vocab_cross_entropy`)."""
    logits, aux = forward_lm(params, cfg, batch, impl=impl)
    tokens = batch["tokens"].to(logits.device)
    labels = tokens[:, 1:].long()
    # fp32; over the rank's vocab slice where the logits are one
    nll = tp.vocab_cross_entropy(logits[:, :-1], labels, cfg.padded_vocab)
    mask = batch.get("loss_mask")
    mask = (mask[:, 1:].to(device=nll.device, dtype=torch.float32)
            if mask is not None else torch.ones_like(nll))
    ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    aux = aux.to(ce.device)
    return ce + aux, {"ce": ce, "aux": aux}
