"""RWKV6 ("Finch") mixer: data-dependent decay WKV recurrence + channel mix.

The JAX package's ``models/rwkv.py`` in PyTorch. Chunked evaluation:
within a chunk the pairwise decay exponent L_excl[t] - L_incl[s] (s < t)
is always <= 0, so the intra-chunk part is computed in a numerically safe
pairwise form; inter-chunk contributions flow through the per-head state
(hs_k x hs_v). ``rwkv_time_mix(impl="kernel")`` runs the WKV kernel
(:mod:`repro_torch.kernels.rwkv6_wkv`), the counterpart of the
reference's ``impl="pallas"``; any other impl runs :func:`wkv_chunked`.

Decode state per layer: (tm_shift (B,D), cm_shift (B,D), wkv (B,H,hk,hv)).

Under tensor parallelism (:mod:`repro_torch.dist.tp`, ``dinner``,
``heads`` and ``ff`` split over ``model``) the time mix runs the rank's
H/m heads: r, k, v, g column-parallel, the decay and the group norm's
scale taken at the rank's channels, the WKV kernel on its heads, the
output row-parallel; its ``wkv`` state holds the rank's heads. The
channel mix is column/row-parallel over ``ff``; its receptance (over
``dinner``) is all-gathered.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import shard, tp
from repro_torch.models.layers import groupnorm_heads
from repro_torch.models.params import Spec


class RWKVState(NamedTuple):
    tm_shift: torch.Tensor   # (B, D) last input to time-mix
    cm_shift: torch.Tensor   # (B, D) last input to channel-mix
    wkv: torch.Tensor        # (B, H, hs, hs) fp32


_MIX_NAMES = ("w", "k", "v", "r", "g")


def rwkv_time_mix_specs(cfg: ArchConfig):
    c = cfg.rwkv
    d, H, hs = cfg.d_model, cfg.n_heads, c.head_size
    return {
        "mu_x": Spec((d,), ("embed",), "zeros"),
        "mu": Spec((5, d), (None, "embed"), "zeros"),
        "mix_w1": Spec((d, 5 * c.mix_lora), ("embed", "lora"), scale=0.02),
        "mix_w2": Spec((5, c.mix_lora, d), (None, "lora", "embed"), scale=0.02),
        "w0": Spec((d,), ("embed",), "constant", const=-2.0),
        "dec_w1": Spec((d, c.decay_lora), ("embed", "lora"), scale=0.02),
        "dec_w2": Spec((c.decay_lora, d), ("lora", "embed"), scale=0.02),
        "u": Spec((H, hs), ("heads", None), scale=0.5),
        "wr": Spec((d, d), ("embed", "dinner")),
        "wk": Spec((d, d), ("embed", "dinner")),
        "wv": Spec((d, d), ("embed", "dinner")),
        "wg": Spec((d, d), ("embed", "dinner")),
        "wo": Spec((d, d), ("dinner", "embed")),
        "lnx_scale": Spec((d,), ("embed",), "ones"),
        "lnx_bias": Spec((d,), ("embed",), "zeros"),
    }


def rwkv_channel_mix_specs(cfg: ArchConfig):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": Spec((d,), ("embed",), "zeros"),
        "mu_r": Spec((d,), ("embed",), "zeros"),
        "wk": Spec((d, f), ("embed", "ff")),
        "wv": Spec((f, d), ("ff", "embed")),
        "wr": Spec((d, d), ("embed", "dinner")),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """xx[t] = x[t-1]; xx[0] = prev (or 0). x:(B,S,D), prev:(B,D)."""
    first = (prev if prev is not None
             else x.new_zeros((x.shape[0], x.shape[2])))[:, None, :]
    return torch.cat([first.to(x.dtype), x[:, :-1, :]], dim=1)


def wkv_chunked(r, k, v, lw, u, h0, chunk: int):
    """RWKV6 WKV, chunked. r,k,v: (B,S,H,hs); lw: (B,S,H,hs) log-decay (<=0);
    u: (H,hs); h0: (B,H,hs,hs) fp32. Returns (out (B,S,H,hs), h_last).

    As in the reference, a sequence that is not a multiple of ``chunk``
    falls back to one chunk of length S: a (B,S,S,H,hs) pairwise tensor
    (the WKV kernel pads instead)."""
    B, S, H, hs = r.shape
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    n = S // chunk
    rf, kf, vf = (t.float() for t in (r, k, v))
    lwf = lw.float()
    uf = u.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                device=r.device), diagonal=-1)
    zero = torch.zeros((), dtype=torch.float32, device=r.device)
    h = h0
    outs = []
    for idx in range(n):
        sl = slice(idx * chunk, (idx + 1) * chunk)
        rc, kc, vc, lc = rf[:, sl], kf[:, sl], vf[:, sl], lwf[:, sl]
        L = torch.cumsum(lc, dim=1)                    # inclusive (B,Lc,H,hs)
        L_excl = L - lc
        # inter-chunk: o_t += (r_t * exp(L_excl_t)) @ h
        q_in = rc * torch.exp(L_excl)
        o = torch.einsum("blhi,bhij->blhj", q_in, h)
        # intra-chunk (pairwise-stable): exponent L_excl[t]-L[s] <= 0 for s<t.
        # minimum, not clamp: at an exponent of exactly 0 (s = t-1 often
        # rounds there) it halves the gradient, as the reference's
        # jnp.minimum does, where clamp would pass all of it
        dpair = torch.exp(torch.minimum(L_excl[:, :, None] - L[:, None],
                                        zero))        # (B,t,s,H,hs)
        scores = torch.einsum("blhi,blshi,bshi->blsh", rc, dpair, kc)
        scores = scores * tri[None, :, :, None]
        o = o + torch.einsum("blsh,bshj->blhj", scores, vc)
        # diagonal bonus: (r_t . (u*k_t)) v_t
        diag = torch.einsum("blhi,hi,blhi->blh", rc, uf, kc)
        o = o + diag[..., None] * vc
        # state update: h' = exp(L_end)*h + sum_s exp(L_end - L_s) k_s v_s^T
        L_end = L[:, -1]                               # (B,H,hs)
        kdec = kc * torch.exp(L_end[:, None] - L)
        h = torch.exp(L_end)[..., None] * h + torch.einsum(
            "bshi,bshj->bhij", kdec, vc)
        outs.append(o)
    out = torch.cat(outs, dim=1)
    return out.to(r.dtype), h


def rwkv_time_mix(p, cfg: ArchConfig, x: torch.Tensor,
                  state: Optional[RWKVState] = None,
                  impl: str = "chunked", scatter: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out, new_tm_shift, new_wkv_state); with ``scatter``
    (``transformer.apply_slot``'s split residual stream) ``out`` is the
    rank's slice of the sequence."""
    c = cfg.rwkv
    B, S, D = x.shape
    hs = c.head_size
    split = tp.parts(p["wr"].shape[1], D)
    if split > 1 and cfg.n_heads % split:
        raise ValueError(f"{cfg.n_heads} heads do not split over "
                         f"{split} model ranks as dinner does")
    H = cfg.n_heads // split           # the rank's heads
    dt = x.dtype

    xx = _token_shift(x, state.tm_shift if state else None)
    dx = xx - x
    xxx = x + dx * p["mu_x"].to(dt)
    lo = torch.tanh(xxx @ p["mix_w1"].to(dt))
    lo = lo.reshape(B, S, 5, c.mix_lora)
    deltas = torch.einsum("bsrm,rmd->bsrd", lo, p["mix_w2"].to(dt))
    mixed = {name: x + dx * (p["mu"][i].to(dt) + deltas[:, :, i])
             for i, name in enumerate(_MIX_NAMES)}

    if split > 1:
        mixed = {n: (t if n == "w" else tp.copy_in(t))
                 for n, t in mixed.items()}
    r = (mixed["r"] @ p["wr"].to(dt)).reshape(B, S, H, hs)
    k = (mixed["k"] @ p["wk"].to(dt)).reshape(B, S, H, hs)
    v = (mixed["v"] @ p["wv"].to(dt)).reshape(B, S, H, hs)
    g = F.silu(mixed["g"] @ p["wg"].to(dt))
    r = shard(r, "batch", None, "heads", None)
    k = shard(k, "batch", None, "heads", None)
    v = shard(v, "batch", None, "heads", None)

    dec = torch.tanh(mixed["w"] @ p["dec_w1"].to(dt)) @ p["dec_w2"].to(dt)
    lw = -torch.exp(p["w0"].float() + dec.float())
    if split > 1:
        lw = tp.take(lw, -1)
    lw = lw.reshape(B, S, H, hs)                       # log decay, < 0

    h0 = state.wkv if state is not None else torch.zeros(
        (B, H, hs, hs), dtype=torch.float32, device=x.device)
    if impl == "kernel":
        from repro_torch.kernels import ops as kops
        o, h_last = kops.rwkv6_wkv(r, k, v, lw, p["u"], h0, chunk=c.chunk)
    else:
        o, h_last = wkv_chunked(r, k, v, lw, p["u"], h0, c.chunk)

    scale, bias = p["lnx_scale"], p["lnx_bias"]
    if split > 1:
        scale, bias = tp.take(scale, 0), tp.take(bias, 0)
    o = groupnorm_heads(scale, bias, o.reshape(B, S, H * hs), H,
                        cfg.norm_eps)
    o = o * g
    out = tp.row_product(o, p["wo"].to(dt), scatter) if split > 1 else \
        tp.seq_out(o @ p["wo"].to(dt), scatter)
    return out, x[:, -1, :], h_last


def rwkv_channel_mix(p, cfg: ArchConfig, x: torch.Tensor,
                     state: Optional[RWKVState] = None,
                     scatter: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out, new_cm_shift); ``scatter`` as
    :func:`rwkv_time_mix`'s."""
    dt = x.dtype
    xx = _token_shift(x, state.cm_shift if state else None)
    dx = xx - x
    xk = x + dx * p["mu_k"].to(dt)
    xr = x + dx * p["mu_r"].to(dt)
    split = tp.parts(p["wk"].shape[1], cfg.d_ff) > 1
    if split:
        xk = tp.copy_in(xk)
    kk = torch.square(F.relu(xk @ p["wk"].to(dt)))
    kk = shard(kk, "batch", None, "ff")
    vv = tp.row_product(kk, p["wv"].to(dt), scatter) if split else \
        tp.seq_out(kk @ p["wv"].to(dt), scatter)
    if tp.parts(p["wr"].shape[1], x.shape[-1]) > 1:
        r = tp.gather_out(tp.copy_in(xr) @ p["wr"].to(dt), -1)
    else:
        r = xr @ p["wr"].to(dt)
    out = torch.sigmoid(tp.seq_out(r, scatter)) * vv
    return out, x[:, -1, :]


def init_rwkv_state(cfg: ArchConfig, batch: int, device="cpu") -> RWKVState:
    """A zeroed state; inside a step on shards that splits ``heads`` over
    ``model``, its ``wkv`` of the rank's heads."""
    H, hs = tp.local_size(cfg.n_heads, "heads"), cfg.rwkv.head_size
    return RWKVState(
        tm_shift=torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                             device=device),
        cm_shift=torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                             device=device),
        wkv=torch.zeros((batch, H, hs, hs), dtype=torch.float32,
                        device=device),
    )
