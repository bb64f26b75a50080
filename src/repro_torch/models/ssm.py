"""Mamba (S6) selective-state-space mixer, chunked.

The JAX package's ``models/ssm.py`` in PyTorch. The selective scan
``h_t = a_t * h_{t-1} + b_t`` is evaluated chunk by chunk (a loop over
chunks, a parallel scan within a chunk), so the (B, Lc, d_inner, N)
working set stays bounded. The reference's within-chunk scan is
``lax.associative_scan``; torch has none, so :func:`_ssm_chunk` runs a
log-depth doubling over the ``(a, b)`` pairs (the same combine, another
tree: rounding differs at fp32 level). It never divides: a prefix
product divided back out would divide by products that underflow.

As in the reference, the mixer does not call the Mamba scan kernel
(``kernels.ops.mamba_scan``); that kernel is reached only through the
ops dispatcher.

State for decoding: (conv_state (B, d_conv-1, dI), h (B, dI, N)), both
fp32. A given state is updated IN PLACE (the reference donates it).

Under tensor parallelism (:mod:`repro_torch.dist.tp`, ``dinner`` split
over ``model``) the mixer runs the rank's dI/m channels: ``in_proj`` is
column-parallel (its shard holds a contiguous block of the x and z
halves together, so its output is all-gathered and the rank takes its
channels of each half), the conv and the scan run on the rank's
channels, ``x_proj`` contracts over them (its partial sums reduced over
``model``), ``dt_proj`` is column-parallel and ``out_proj``
row-parallel; the state holds the rank's channels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import shard, tp
from repro_torch.models.params import Spec


class MambaState(NamedTuple):
    conv: torch.Tensor    # (B, d_conv-1, dI) fp32
    h: torch.Tensor       # (B, dI, N) fp32


def mamba_specs(cfg: ArchConfig):
    m = cfg.mamba
    d, dI, N, R = cfg.d_model, cfg.d_inner_mamba, m.d_state, cfg.dt_rank
    return {
        "in_proj": Spec((d, 2 * dI), ("embed", "dinner")),
        "conv_w": Spec((m.d_conv, dI), (None, "dinner"), scale=0.5),
        "conv_b": Spec((dI,), ("dinner",), "zeros"),
        "w_xdbc": Spec((dI, R + 2 * N), ("dinner", None)),
        "dt_proj": Spec((R, dI), (None, "dinner")),
        "dt_bias": Spec((dI,), ("dinner",), "constant", const=-4.6),  # softplus ~= 0.01
        "A_log": Spec((dI, N), ("dinner", None), "zeros"),            # A = -1
        "D": Spec((dI,), ("dinner",), "ones"),
        "out_proj": Spec((dI, d), ("dinner", "embed")),
    }


def _split(p, cfg: ArchConfig) -> bool:
    """Whether ``dinner`` is the rank's slice (tensor parallelism)."""
    return tp.parts(p["conv_w"].shape[1], cfg.d_inner_mamba) > 1


def _in_proj(p, x: torch.Tensor, split: bool):
    """``(x_in, z)``: the input projection's two halves, each the rank's
    channels under tensor parallelism."""
    if not split:
        return torch.chunk(x @ p["in_proj"].to(x.dtype), 2, dim=-1)
    xz = tp.gather_out(tp.copy_in(x) @ p["in_proj"].to(x.dtype), -1)
    return tuple(tp.take(h, -1) for h in torch.chunk(xz, 2, dim=-1))


def _x_proj(p, x_conv: torch.Tensor, split: bool) -> torch.Tensor:
    """``x_proj``'s (dt_rank + 2N) outputs, whole on every rank: under
    tensor parallelism the rank's channels' partial sums, reduced over
    ``model``, then used on the rank's channels."""
    w = p["w_xdbc"].to(x_conv.dtype)
    return tp.copy_in(tp.row_product(x_conv, w)) if split else x_conv @ w


def _out_proj(p, y: torch.Tensor, split: bool,
              scatter: bool = False) -> torch.Tensor:
    """``out_proj``, row-parallel over the rank's channels under tensor
    parallelism; with ``scatter``, the rank's slice of the sequence."""
    w = p["out_proj"].to(y.dtype)
    return tp.row_product(y, w, scatter) if split else \
        tp.seq_out(y @ w, scatter)


def _causal_conv(p, x: torch.Tensor, prev: Optional[torch.Tensor]):
    """Depthwise causal conv1d. x:(B,S,dI); prev:(B,dc-1,dI) or None."""
    dc = p["conv_w"].shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], dc - 1, x.shape[2]))
    xp = torch.cat([prev.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = xp[:, 0:S, :] * p["conv_w"][0].to(x.dtype)
    for j in range(1, dc):
        y = y + xp[:, j:j + S, :] * p["conv_w"][j].to(x.dtype)
    new_prev = xp[:, -(dc - 1):, :].float() if dc > 1 else prev
    return y + p["conv_b"].to(x.dtype), new_prev


def _ssm_chunk(a, bx, h0):
    """Inclusive scan within one chunk by doubling. a,bx: (B,Lc,dI,N)
    fp32; h0: (B,dI,N). Step d combines each position with the one d
    back, ``(a, b)[t] <- (a[t-d] * a[t], a[t] * b[t-d] + b[t])``: after
    log2(Lc) steps ``(A_cum, B_cum)[t]`` is the combine of 0..t, as the
    reference's associative scan gives it."""
    L = a.shape[1]
    d = 1
    while d < L:
        bx = torch.cat([bx[:, :d], a[:, d:] * bx[:, :-d] + bx[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    h = a * h0[:, None] + bx
    return h, h[:, -1]


def _chunk_body(dt_c, B_c, C_c, x_c, A, h):
    a = torch.exp(dt_c[..., None] * A)                        # (B,Lc,dI,N)
    bx = (dt_c * x_c)[..., None] * B_c[:, :, None, :]
    h_all, h_last = _ssm_chunk(a, bx, h)
    y_c = torch.einsum("blin,bln->bli", h_all, C_c)           # (B,Lc,dI)
    return h_last, y_c


def _write_state(state: MambaState, conv: torch.Tensor,
                 h: torch.Tensor) -> MambaState:
    state.conv.copy_(conv)
    state.h.copy_(h)
    return state


def mamba_mixer(p, cfg: ArchConfig, x: torch.Tensor,
                state: Optional[MambaState] = None, scatter: bool = False
                ) -> Tuple[torch.Tensor, MambaState]:
    """x: (B,S,D) -> (out (B,S,D), new_state); a given state is updated in
    place and returned. With ``scatter`` (``transformer.apply_slot``'s
    split residual stream) ``out`` is the rank's slice of the sequence."""
    m = cfg.mamba
    B, S, D = x.shape
    split = _split(p, cfg)
    dI, N, R = p["conv_w"].shape[1], m.d_state, cfg.dt_rank

    x_in, z = _in_proj(p, x, split)
    x_in = shard(x_in, "batch", None, "dinner")
    x_conv, conv_state = _causal_conv(p, x_in,
                                      state.conv if state else None)
    x_conv = F.silu(x_conv)

    xdbc = _x_proj(p, x_conv, split)
    dt_in, Bm, Cm = torch.split(xdbc, [R, N, N], dim=-1)
    dt = F.softplus(dt_in @ p["dt_proj"].to(x.dtype)
                    + p["dt_bias"].to(x.dtype))               # (B,S,dI)
    dt = dt.float()
    A = -torch.exp(p["A_log"].float())                       # (dI,N)

    h = state.h if state is not None else torch.zeros(
        (B, dI, N), dtype=torch.float32, device=x.device)
    Bf, Cf, xf = Bm.float(), Cm.float(), x_conv.float()

    chunk = min(m.chunk, S)
    if S % chunk:
        chunk = S  # fall back to single chunk for ragged smoke shapes
    # the reference's nested remat: under autograd a chunk's fp32 scan
    # residuals are recomputed in the backward, not kept
    body = _chunk_body
    if torch.is_grad_enabled() and x.requires_grad:
        def body(*args):
            return torch_checkpoint.checkpoint(
                _chunk_body, *args, use_reentrant=False,
                preserve_rng_state=False)
    ys = []
    for i in range(S // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        h, y_c = body(dt[:, sl], Bf[:, sl], Cf[:, sl], xf[:, sl], A, h)
        ys.append(y_c)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)

    y = (y + xf * p["D"].float()).to(x.dtype)
    y = y * F.silu(z)
    y = shard(y, "batch", None, "dinner")
    out = _out_proj(p, y, split, scatter)
    if state is not None:
        return out, _write_state(state, conv_state, h)
    return out, MambaState(conv_state, h)


def mamba_decode_step(p, cfg: ArchConfig, x: torch.Tensor,
                      state: MambaState
                      ) -> Tuple[torch.Tensor, MambaState]:
    """Single-token step. x: (B,1,D); ``state`` is updated in place."""
    m = cfg.mamba
    R, N = cfg.dt_rank, m.d_state
    split = _split(p, cfg)
    x_in, z = _in_proj(p, x, split)
    x_conv, conv_state = _causal_conv(p, x_in, state.conv)
    x_conv = F.silu(x_conv)
    xdbc = _x_proj(p, x_conv, split)
    dt_in, Bm, Cm = torch.split(xdbc, [R, N, N], dim=-1)
    dt = F.softplus(dt_in @ p["dt_proj"].to(x.dtype)
                    + p["dt_bias"].to(x.dtype)).float()
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt[:, 0, :, None] * A)                      # (B,dI,N)
    bx = (dt[:, 0] * x_conv.float()[:, 0])[..., None] \
        * Bm.float()[:, 0, None, :]
    h = a * state.h + bx
    y = torch.einsum("bin,bn->bi", h, Cm.float()[:, 0])[:, None, :]
    y = (y + x_conv.float() * p["D"].float()).to(x.dtype)
    y = y * F.silu(z)
    return _out_proj(p, y, split), _write_state(state, conv_state, h)


def init_mamba_state(cfg: ArchConfig, batch: int,
                     device="cpu") -> MambaState:
    """A zeroed state; inside a step on shards that splits ``dinner``
    over ``model``, of the rank's channels."""
    m = cfg.mamba
    dI = tp.local_size(cfg.d_inner_mamba, "dinner")
    return MambaState(
        conv=torch.zeros((batch, m.d_conv - 1, dI), dtype=torch.float32,
                         device=device),
        h=torch.zeros((batch, dI, m.d_state), dtype=torch.float32,
                      device=device),
    )
