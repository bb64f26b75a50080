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
from repro_torch.dist import axis_size, shard
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


def _dispatch_group(cfg: ArchConfig, C: int, xf, expert_ids):
    """Per-group dispatch. xf: (t,D); expert_ids: (t,K).
    Returns (buf (E,C,D), dest (t*K,), order (t*K,), keep (t*K,))."""
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
    xf_pad = torch.cat([xf, xf.new_zeros((1, D))])
    buf = xf_pad[slot_tok]                                         # (E*C, D)
    return buf.reshape(E, C, D), dest, order, keep


def _combine_group(out_buf, dest, order, keep, gate_flat, t, K, D):
    """out_buf: (E,C,D) -> y (t,D) weighted by gates (all gathers)."""
    flat_out = torch.cat([out_buf.reshape(-1, D), out_buf.new_zeros((1, D))])
    y_sorted = flat_out[dest] * gate_flat[order][:, None]          # (t*K,D)
    # the inverse permutation (the reference's argsort of ``order``)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    y_assign = y_sorted[inv]
    return y_assign.reshape(t, K, D).sum(dim=1)


def apply_moe(p, cfg: ArchConfig, x: torch.Tensor,
              gen: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> (out (B,S,D), aux_loss scalar fp32). ``gen`` draws the
    router jitter (``cfg.moe.router_jitter``), where the reference takes
    a key; without one there is no jitter, as there."""
    e = cfg.moe
    B, S, D = x.shape
    t = B * S
    E, K = e.num_experts, e.top_k
    G = max(1, axis_size("expert_groups"))
    if t % G:
        G = 1
    tg = t // G
    xg = shard(x.reshape(G, tg, D), "expert_groups", None, None)

    logits = (xg @ p["router"].to(xg.dtype)).float()
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
    groups = [_dispatch_group(cfg, C, xg[g], expert_ids[g])
              for g in range(G)]
    buf = torch.stack([gr[0] for gr in groups])                    # (G,E,C,D)
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

    gate_flat = gate_vals.reshape(G, tg * K)
    y = torch.stack([
        _combine_group(out_buf[g], dest, order, keep, gate_flat[g], tg, K, D)
        for g, (_, dest, order, keep) in enumerate(groups)])
    y = shard(y, "expert_groups", None, None)
    y = y.reshape(B, S, D)

    if e.num_shared:
        sp = p["shared"]
        xf = x.reshape(t, D)
        if "w_gate" in sp:
            hs = _act(cfg.mlp_act, xf @ sp["w_gate"].to(xf.dtype)) * (
                xf @ sp["w_up"].to(xf.dtype))
        else:
            hs = _act(cfg.mlp_act, xf @ sp["w_up"].to(xf.dtype))
        y = y + (hs @ sp["w_down"].to(xf.dtype)).reshape(B, S, D)

    return y, aux

