"""Mixture-of-Experts with grouped sort-based capacity dispatch.

The JAX package's ``models/moe.py`` in PyTorch. Token->expert routing is
a stable sort over expert ids plus a positional scatter into an
``(E, C, d)`` buffer; overflow beyond capacity is dropped (GShard/Switch
semantics) into the slot ``E*C``; only int32 indices are scattered and
the payload moves by gather. The dispatch is *grouped*: tokens are
reshaped to ``(G, t/G, d)`` and the sort and scatter run per group, so
capacity, and so which tokens are dropped, is decided per group. G is
the size of the ``expert_groups`` axis under the active mesh (1 without
one), falling back to 1 where it does not divide the tokens, as in the
reference. Shared experts run densely.

Expert parallelism (inside a step on shards whose ``model`` axis splits
``experts``, :mod:`repro_torch.dist.tp`): the router's columns are the
rank's experts too, so each rank computes its experts' logits and they
are all-gathered; the softmax and top-k then run on every rank on the
same logits, so every rank routes alike. Each rank gathers the tokens of
its E/m experts' slots only, runs its experts' products and combines
their contributions, which are summed over ``model``. Shared experts
whose ``ff`` is split (``ep_tp_fsdp``) are column- then row-parallel.

Nothing here reads a value back to the host: per-expert counts come
from ``scatter_add_`` into a length-E tensor (``torch.bincount``'s
output length depends on the data, which syncs the card every layer),
capacity is a Python int from shapes, and drops are ``torch.where``s.

Returns the load-balancing auxiliary loss alongside the output.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import axis_size, shard, tp
from repro_torch.models.layers import _act
from repro_torch.models.params import Spec


def moe_specs(cfg: ArchConfig):
    e = cfg.moe
    d, f = cfg.d_model, e.d_ff_expert
    glu = cfg.mlp_act.endswith("_glu")
    sp = {
        "router": Spec((d, e.num_experts), ("embed", "experts"), scale=0.02),
        "w_up": Spec((e.num_experts, d, f), ("experts", "embed", "ff")),
        "w_down": Spec((e.num_experts, f, d), ("experts", "ff", "embed")),
    }
    if glu:
        sp["w_gate"] = Spec((e.num_experts, d, f), ("experts", "embed", "ff"))
    if e.num_shared:
        fs = e.d_ff_shared or e.num_shared * f
        sp["shared"] = {
            "w_up": Spec((d, fs), ("embed", "ff")),
            "w_down": Spec((fs, d), ("ff", "embed")),
        }
        if glu:
            sp["shared"]["w_gate"] = Spec((d, fs), ("embed", "ff"))
    return sp


def _capacity(cfg: ArchConfig, n_tokens: int) -> int:
    e = cfg.moe
    c = int(n_tokens * e.top_k * e.capacity_factor / e.num_experts)
    return max(8, -(-c // 8) * 8)   # round up to 8


def top_k(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest, ties to the lower
    index. A stable descending sort keeps equal values in index order;
    ``torch.topk`` makes no such promise."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_group(cfg: ArchConfig, C: int, xf, expert_ids,
                    experts: Optional[Tuple[int, int]] = None):
    """Per-group dispatch. xf: (t,D); expert_ids: (t,K); ``experts``
    ``(first, count)``: the experts whose slots the buffer holds (all of
    them when None). Returns (buf (count,C,D), dest (t*K,), order
    (t*K,), keep (t*K,)); ``dest`` indexes every expert's slots."""
    e = cfg.moe
    t, D = xf.shape
    E, K = e.num_experts, e.top_k
    dev = xf.device
    flat_e = expert_ids.reshape(-1)                                # (t*K,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    tok_of = order // K
    counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts                      # exclusive
    pos = torch.arange(t * K, device=dev) - starts[sorted_e]
    keep = pos < C
    overflow = torch.full((), E * C, dtype=torch.int64, device=dev)
    dest = torch.where(keep, sorted_e * C + pos, overflow)
    # scatter ONLY int32 indices; the payload moves via gather. Dropped
    # assignments all land on the overflow slot, which is cut off
    slot_to_assign = torch.full((E * C + 1,), t * K, dtype=torch.int32,
                                device=dev)
    slot_to_assign[dest] = torch.arange(t * K, dtype=torch.int32, device=dev)
    filled = slot_to_assign[:-1].long()
    sentinel = torch.full((), t, dtype=torch.int64, device=dev)
    slot_tok = torch.where(filled < t * K,
                           tok_of[torch.clamp(filled, max=t * K - 1)],
                           sentinel)
    first, count = experts if experts is not None else (0, E)
    if count != E:
        slot_tok = slot_tok[first * C:(first + count) * C]
    xf_pad = torch.cat([xf, xf.new_zeros((1, D))])
    buf = xf_pad[slot_tok]                                     # (count*C, D)
    return buf.reshape(count, C, D), dest, order, keep


def _combine_group(out_buf, dest, order, keep, gate_flat, t, K, D,
                   first_slot: Optional[int] = None):
    """out_buf: (E,C,D) -> y (t,D) weighted by gates (all gathers). With
    ``first_slot`` ``out_buf`` holds only the slots from there on (a
    rank's experts): assignments to other slots contribute nothing, and
    the rank's partial sum stays in fp32 for its sum over ``model``."""
    flat_out = torch.cat([out_buf.reshape(-1, D), out_buf.new_zeros((1, D))])
    if first_slot is not None:
        n = flat_out.shape[0] - 1
        rel = dest - first_slot
        dest = torch.where((rel >= 0) & (rel < n), rel,
                           torch.full((), n, dtype=rel.dtype,
                                      device=rel.device))
    y_sorted = flat_out[dest] * gate_flat[order][:, None]          # (t*K,D)
    # the inverse permutation (the reference's argsort of ``order``)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    y_assign = y_sorted[inv].reshape(t, K, D)
    if first_slot is not None:
        # a rank's partial sum, kept in fp32 for the sum over ``model``
        return y_assign.sum(dim=1, dtype=torch.float32)
    return y_assign.sum(dim=1)


def apply_moe(p, cfg: ArchConfig, x: torch.Tensor,
              gen: Optional[torch.Generator] = None, scatter: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> (out (B,S,D), aux_loss scalar fp32). ``gen`` draws the
    router jitter (``cfg.moe.router_jitter``), where the reference takes
    a key; without one there is no jitter, as there. With ``scatter``
    (``transformer.apply_slot``'s split residual stream) ``out`` is the
    rank's slice of the sequence."""
    e = cfg.moe
    B, S, D = x.shape
    t = B * S
    E, K = e.num_experts, e.top_k
    G = max(1, axis_size("expert_groups"))
    if t % G:
        G = 1
    tg = t // G
    xg = shard(x.reshape(G, tg, D), "expert_groups", None, None)

    # expert parallelism: the router's columns and the experts are this
    # rank's; the tokens' gradient from both is summed over ``model``
    n_local = p["w_up"].shape[0]
    ep = tp.parts(n_local, E) > 1
    xd = tp.copy_in(xg) if ep else xg
    router = p["router"].to(xg.dtype)
    if tp.parts(router.shape[1], E) > 1:
        # the rank's experts' logits, gathered
        logits = tp.gather_out(xd @ router, -1).float()
    else:
        logits = (xg @ router).float()
    if e.router_jitter and gen is not None:
        logits = logits + e.router_jitter * torch.randn(
            logits.shape, generator=gen, device=logits.device)
    probs = torch.softmax(logits, dim=-1)                          # (G,tg,E)
    gate_vals, expert_ids = top_k(probs, K)                        # (G,tg,K)
    gate_vals = (gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)).to(xg.dtype)

    # load-balance aux (Switch): E * sum_e f_e * P_e, averaged over groups
    me = probs.mean(dim=1)                                         # (G,E)
    fe = torch.nn.functional.one_hot(expert_ids[..., 0], E).float().mean(
        dim=1)                                                     # (G,E)
    aux = e.aux_loss_coef * E * torch.mean(torch.sum(fe * me, dim=-1))

    C = _capacity(cfg, tg)
    # this rank's experts' slots only; the gates' gradient summed over
    # ``model`` (every rank routes alike)
    first = tp.group().rank * n_local if ep else 0
    mine = ((first, n_local),) if ep else ()
    groups = [_dispatch_group(cfg, C, xd[g], expert_ids[g], *mine)
              for g in range(G)]
    buf = torch.stack([gr[0] for gr in groups])                 # (G,El,C,D)
    buf = shard(buf, "expert_groups", "experts", None, None)

    if "w_gate" in p:
        h = _act(cfg.mlp_act, torch.einsum(
            "gecd,edf->gecf", buf, p["w_gate"].to(buf.dtype)))
        h = h * torch.einsum("gecd,edf->gecf", buf, p["w_up"].to(buf.dtype))
    else:
        h = _act(cfg.mlp_act, torch.einsum(
            "gecd,edf->gecf", buf, p["w_up"].to(buf.dtype)))
    h = shard(h, "expert_groups", "experts", None, "ff")
    out_buf = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(buf.dtype))
    out_buf = shard(out_buf, "expert_groups", "experts", None, None)

    gate_flat = (tp.copy_in(gate_vals) if ep else gate_vals).reshape(
        G, tg * K)
    y = torch.stack([
        _combine_group(out_buf[g], dest, order, keep, gate_flat[g], tg, K, D,
                       first * C if ep else None)
        for g, (_, dest, order, keep) in enumerate(groups)])
    y = shard(y, "expert_groups", None, None)
    y = y.reshape(B, S, D)
    y = tp.reduce_out(y, scatter).to(x.dtype) if ep else \
        tp.seq_out(y, scatter)

    if e.num_shared:
        sp = p["shared"]
        split = tp.parts(sp["w_up"].shape[-1],
                         e.d_ff_shared or e.num_shared * e.d_ff_expert) > 1
        xf = x.reshape(t, D)
        if split:
            xf = tp.copy_in(xf)
        if "w_gate" in sp:
            hs = _act(cfg.mlp_act, xf @ sp["w_gate"].to(xf.dtype)) * (
                xf @ sp["w_up"].to(xf.dtype))
        else:
            hs = _act(cfg.mlp_act, xf @ sp["w_up"].to(xf.dtype))
        w = sp["w_down"].to(xf.dtype)
        if split:
            ys = tp.row_product(hs.reshape(B, S, -1), w, scatter)
        else:
            ys = tp.seq_out((hs @ w).reshape(B, S, D), scatter)
        y = y + ys

    return y, aux

