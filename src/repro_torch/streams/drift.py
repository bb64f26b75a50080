"""Concept-drift detectors as per-event torch step functions (S2CE §2.4).

Each detector is ``(state, x) -> (state, level)`` with level 0=stable,
1=warning, 2=drift, on 0-dim fp32 tensors of any device. These are the
plain versions: a scan over a batch is a loop of steps
(:func:`run_detector`). The pipeline's drift op runs every detector
through the ``detector_scan`` kernel on the card
(``kernels/detector_scan.py``), which repeats these steps operation by
operation.

Implemented: DDM (Gama'04), EDDM (Baena-Garcia'06), Page-Hinkley, and a
fixed-memory ADWIN variant (exponential bucket histogram with capped
bucket rows, so the state has a static shape).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

STABLE, WARNING, DRIFT = 0, 1, 2


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _i32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def _level(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32)


# ---------------------------------------------------------------------------
# DDM
# ---------------------------------------------------------------------------

class DDMState(NamedTuple):
    n: torch.Tensor
    p: torch.Tensor          # running error rate
    s_min: torch.Tensor      # min of p + s
    p_min: torch.Tensor
    level: torch.Tensor


def ddm_init(device="cpu") -> DDMState:
    return DDMState(_f32(0.0, device), _f32(0.0, device), _f32(1e9, device),
                    _f32(1e9, device), _i32(0, device))


def ddm_step(state: DDMState, error: torch.Tensor, warn: float = 2.0,
             drift: float = 3.0) -> Tuple[DDMState, torch.Tensor]:
    n = state.n + 1.0
    p = state.p + (error - state.p) / n
    s = torch.sqrt(p * (1 - p) / torch.clamp(n, min=1.0))
    # track minima only after warm-up (MOA does the same)
    better = (n >= 30) & ((p + s) < (state.p_min + state.s_min))
    p_min = torch.where(better, p, state.p_min)
    s_min = torch.where(better, s, state.s_min)
    level = torch.where(
        (p + s) > (p_min + drift * s_min), DRIFT,
        torch.where((p + s) > (p_min + warn * s_min), WARNING, STABLE))
    level = _level(torch.where(n < 30, STABLE, level))   # warm-up (MOA)
    reset = level == DRIFT
    new = DDMState(
        n=torch.where(reset, 0.0, n),
        p=torch.where(reset, 0.0, p),
        s_min=torch.where(reset, 1e9, s_min),
        p_min=torch.where(reset, 1e9, p_min),
        level=level,
    )
    return new, level


# ---------------------------------------------------------------------------
# EDDM (distance-between-errors)
# ---------------------------------------------------------------------------

class EDDMState(NamedTuple):
    n_err: torch.Tensor
    since_last: torch.Tensor
    mean_d: torch.Tensor
    var_d: torch.Tensor
    best: torch.Tensor       # max of mean + 2*std
    level: torch.Tensor


def eddm_init(device="cpu") -> EDDMState:
    return EDDMState(_f32(0.0, device), _f32(0.0, device), _f32(0.0, device),
                     _f32(0.0, device), _f32(-1e9, device), _i32(0, device))


def eddm_step(state: EDDMState, error: torch.Tensor, alpha: float = 0.92,
              beta: float = 0.85) -> Tuple[EDDMState, torch.Tensor]:
    since = state.since_last + 1.0
    # the on-error branch, selected below (lax.cond in the JAX package)
    n = state.n_err + 1.0
    delta = since - state.mean_d
    mean_d = state.mean_d + delta / n
    var_d = state.var_d + delta * (since - mean_d)
    std = torch.sqrt(var_d / torch.clamp(n, min=1.0))
    metric = mean_d + 2 * std
    best = torch.maximum(state.best, metric)
    ratio = metric / torch.clamp(best, min=1e-9)
    level = torch.where(ratio < beta, DRIFT,
                        torch.where(ratio < alpha, WARNING, STABLE))
    level = _level(torch.where(n < 50, STABLE, level))
    reset = level == DRIFT
    hit = error > 0.5
    zero = torch.zeros_like(since)
    new = EDDMState(
        n_err=torch.where(hit, torch.where(reset, 0.0, n), state.n_err),
        since_last=torch.where(hit, zero, since),
        mean_d=torch.where(hit, torch.where(reset, 0.0, mean_d),
                           state.mean_d),
        var_d=torch.where(hit, torch.where(reset, 0.0, var_d), state.var_d),
        best=torch.where(hit, torch.where(reset, -1e9, best), state.best),
        level=_level(torch.where(hit, level, STABLE)))
    return new, new.level


# ---------------------------------------------------------------------------
# Page-Hinkley
# ---------------------------------------------------------------------------

class PHState(NamedTuple):
    n: torch.Tensor
    mean: torch.Tensor
    cum: torch.Tensor
    cum_min: torch.Tensor
    level: torch.Tensor


def ph_init(device="cpu") -> PHState:
    return PHState(_f32(0.0, device), _f32(0.0, device), _f32(0.0, device),
                   _f32(0.0, device), _i32(0, device))


def ph_step(state: PHState, x: torch.Tensor, delta: float = 0.005,
            lam: float = 50.0) -> Tuple[PHState, torch.Tensor]:
    n = state.n + 1.0
    mean = state.mean + (x - state.mean) / n
    cum = state.cum + x - mean - delta
    cum_min = torch.minimum(state.cum_min, cum)
    level = _level(torch.where(cum - cum_min > lam, DRIFT, STABLE))
    reset = level == DRIFT
    new = PHState(torch.where(reset, 0.0, n), torch.where(reset, 0.0, mean),
                  torch.where(reset, 0.0, cum),
                  torch.where(reset, 0.0, cum_min), level)
    return new, level


# ---------------------------------------------------------------------------
# Fixed-memory ADWIN (exponential bucket histogram)
# ---------------------------------------------------------------------------

class AdwinState(NamedTuple):
    # buckets[l, m]: (count, sum) — level l holds buckets of size 2^l
    counts: torch.Tensor     # (L, M)
    sums: torch.Tensor       # (L, M)
    n_buckets: torch.Tensor  # (L,) used slots per level
    level: torch.Tensor


ADWIN_LEVELS = 12
ADWIN_M = 5               # buckets per level before merge (MOA default)


def adwin_init(device="cpu") -> AdwinState:
    return AdwinState(
        counts=torch.zeros((ADWIN_LEVELS, ADWIN_M), device=device),
        sums=torch.zeros((ADWIN_LEVELS, ADWIN_M), device=device),
        n_buckets=torch.zeros((ADWIN_LEVELS,), dtype=torch.int32,
                              device=device),
        level=_i32(0, device),
    )


def _insert(counts, sums, n_buckets, c, s):
    """Insert bucket (c, s) at level 0; cascade merges when full. Every
    branch of the JAX package's cond chain is taken as a masked select,
    so no value is read back to the host."""
    dev = counts.device
    slots = torch.arange(ADWIN_M, device=dev)
    counts, sums = counts.clone(), sums.clone()
    n_buckets = n_buckets.clone()
    pending = torch.ones((), dtype=torch.bool, device=dev)
    zero2 = torch.zeros(2, device=dev)
    for l in range(ADWIN_LEVELS):
        nb = n_buckets[l]
        room = nb < ADWIN_M
        ins = pending & room
        hot = (slots == nb) & ins
        counts[l] = torch.where(hot, c, counts[l])
        sums[l] = torch.where(hot, s, sums[l])
        n_buckets[l] = nb + ins.to(torch.int32)
        # merge the two oldest into one bucket for the next level
        merge = pending & ~room
        mc = counts[l, 0] + counts[l, 1]
        ms = sums[l, 0] + sums[l, 1]
        counts[l] = torch.where(merge, torch.cat([counts[l, 2:], zero2]),
                                counts[l])
        sums[l] = torch.where(merge, torch.cat([sums[l, 2:], zero2]),
                              sums[l])
        n_buckets[l] = n_buckets[l] - 2 * merge.to(torch.int32)
        # ... then insert the pending bucket here (there is room now)
        hot2 = (slots == n_buckets[l]) & merge
        counts[l] = torch.where(hot2, c, counts[l])
        sums[l] = torch.where(hot2, s, sums[l])
        n_buckets[l] = n_buckets[l] + merge.to(torch.int32)
        # and cascade the merged bucket upward
        c = torch.where(merge, mc, c)
        s = torch.where(merge, ms, s)
        pending = merge
    return counts, sums, n_buckets


def adwin_step(state: AdwinState, x: torch.Tensor,
               delta: float = 0.002) -> Tuple[AdwinState, torch.Tensor]:
    one = torch.ones((), device=state.counts.device)
    counts, sums, n_buckets = _insert(state.counts, state.sums,
                                      state.n_buckets, one, x.float())
    # drift check: scan cut points old->new (levels high..low); ADWIN
    # cuts where |mean_old - mean_new| exceeds eps(delta)
    total_n = counts.sum()
    total_s = sums.sum()
    flat_c = counts.flip(0).reshape(-1)
    flat_s = sums.flip(0).reshape(-1)
    cum_c = torch.cumsum(flat_c, 0)
    cum_s = torch.cumsum(flat_s, 0)
    n0, s0 = cum_c, cum_s                    # "old" window prefix
    n1, s1 = total_n - cum_c, total_s - cum_s
    valid = (n0 >= 1) & (n1 >= 1)
    m0 = s0 / torch.clamp(n0, min=1.0)
    m1 = s1 / torch.clamp(n1, min=1.0)
    m = 1.0 / (1.0 / torch.clamp(n0, min=1.0) + 1.0 / torch.clamp(n1, min=1.0))
    dp = torch.log(2.0 * torch.log(torch.clamp(total_n, min=2.0)) / delta)
    eps = torch.sqrt(dp / (2.0 * torch.clamp(m, min=1e-9)))
    cut = valid & (torch.abs(m0 - m1) > eps)
    drift = torch.any(cut)
    # on drift: drop the oldest half of the window (clear highest levels)
    half = ADWIN_LEVELS // 2
    old = torch.arange(ADWIN_LEVELS, device=counts.device) >= half
    drop = drift & old
    counts = torch.where(drop[:, None], 0.0, counts)
    sums = torch.where(drop[:, None], 0.0, sums)
    n_buckets = torch.where(drop, 0, n_buckets).to(torch.int32)
    level = _level(torch.where(drift, DRIFT, STABLE))
    return AdwinState(counts, sums, n_buckets, level), level


# ---------------------------------------------------------------------------
# Batched stream evaluation
# ---------------------------------------------------------------------------

def run_detector(step_fn, init_state, xs: torch.Tensor):
    """Run a detector over a whole stream, one step per event.
    Returns ``(final_state, levels (n,) int32)``."""
    state = init_state
    levels = []
    for x in xs:
        state, lv = step_fn(state, x)
        levels.append(lv)
    if not levels:
        return state, torch.zeros((0,), dtype=torch.int32, device=xs.device)
    return state, torch.stack(levels)
