"""Streaming (non-DL) learners — the S2CE ML library layer (§2.4, §5.5).

All learners are (state, batch) -> state functions on tensors with a
``predict``; they run identically on edge (pre-models) and cloud.

  * online logistic regression (SGD / AdaGrad), drift-resettable
  * streaming k-means (MacQueen / mini-batch)
  * half-space-trees-style anomaly scorer (random projection histograms)

Random initial states come from seeded torch generators; the JAX
package draws them with ``jax.random``, and ``convert.states_from_numpy``
carries its draws across.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


# ---------------------------------------------------------------------------
# Online logistic regression
# ---------------------------------------------------------------------------

class LogRegState(NamedTuple):
    w: torch.Tensor          # (d,)
    b: torch.Tensor
    g2: torch.Tensor         # AdaGrad accumulator
    n: torch.Tensor


def logreg_init(dim: int, device="cpu") -> LogRegState:
    return LogRegState(torch.zeros((dim,), device=device),
                       torch.zeros((), device=device),
                       torch.full((dim,), 1e-8, device=device),
                       torch.zeros((), device=device))


def logreg_predict(state: LogRegState, x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x @ state.w + state.b)


def logreg_update(state: LogRegState, x: torch.Tensor, y: torch.Tensor,
                  lr: float = 0.5, l2: float = 1e-4) -> LogRegState:
    """One AdaGrad step on a batch. x: (n,d); y: (n,) in {0,1}."""
    p = logreg_predict(state, x)
    err = p - y.float()
    gw = x.T @ err / x.shape[0] + l2 * state.w
    gb = err.mean()
    g2 = state.g2 + torch.square(gw)
    w = state.w - lr * gw * torch.rsqrt(g2)
    b = state.b - lr * gb
    return LogRegState(w, b, g2, state.n + x.shape[0])


def logreg_reset_soft(state: LogRegState, keep: float = 0.5) -> LogRegState:
    """Drift response: shrink weights toward zero, reset curvature."""
    return LogRegState(state.w * keep, state.b * keep,
                       torch.full_like(state.g2, 1e-8),
                       torch.zeros_like(state.n))


# ---------------------------------------------------------------------------
# Streaming k-means
# ---------------------------------------------------------------------------

class KMeansState(NamedTuple):
    centers: torch.Tensor    # (k, d)
    counts: torch.Tensor     # (k,)


def kmeans_init(k: int, dim: int, seed: int = 0, device="cpu") -> KMeansState:
    g = torch.Generator().manual_seed(seed)
    c = torch.randn((k, dim), generator=g)
    return KMeansState(c.to(device), torch.ones((k,), device=device))


def _one_hot(idx: torch.Tensor, k: int) -> torch.Tensor:
    """``F.one_hot(idx, k)`` without its check of the values, which reads
    them on the host for a CPU tensor (a CUDA graph holds no host read)."""
    return (idx[..., None] == torch.arange(k, device=idx.device)).long()


def kmeans_assign(state: KMeansState, x: torch.Tensor) -> torch.Tensor:
    d2 = torch.square(x[:, None, :] - state.centers[None]).sum(-1)
    return torch.argmin(d2, dim=-1)


def kmeans_update(state: KMeansState, x: torch.Tensor) -> KMeansState:
    a = kmeans_assign(state, x)
    k = state.centers.shape[0]
    one = _one_hot(a, k).to(x.dtype)                     # (n, k)
    batch_counts = one.sum(0)
    batch_sums = one.T @ x
    counts = state.counts + batch_counts
    centers = state.centers + (
        (batch_sums - batch_counts[:, None] * state.centers)
        / torch.clamp(counts, min=1.0)[:, None])
    return KMeansState(centers, counts)


# ---------------------------------------------------------------------------
# Anomaly scoring via random-projection histograms (HS-trees flavour)
# ---------------------------------------------------------------------------

class AnomalyState(NamedTuple):
    proj: torch.Tensor       # (d, m) random projections
    edges: torch.Tensor      # (m, bins+1) histogram edges
    counts: torch.Tensor     # (m, bins)
    n: torch.Tensor


def anomaly_init(dim: int, m: int = 8, bins: int = 32, span: float = 4.0,
                 seed: int = 0, device="cpu") -> AnomalyState:
    g = torch.Generator().manual_seed(seed)
    proj = torch.randn((dim, m), generator=g) / math.sqrt(dim)
    edges = torch.linspace(-span, span, bins + 1)
    return AnomalyState(proj.to(device), edges[None].repeat(m, 1).to(device),
                        torch.ones((m, bins), device=device),
                        torch.zeros((), device=device))


def _bin_index(state: AnomalyState, z: torch.Tensor) -> torch.Tensor:
    bins = state.counts.shape[1]
    idx = torch.searchsorted(state.edges[0].contiguous(), z.contiguous()) - 1
    return torch.clamp(idx, 0, bins - 1)


def anomaly_update(state: AnomalyState, x: torch.Tensor) -> AnomalyState:
    z = x @ state.proj                                    # (n, m)
    bins = state.counts.shape[1]
    one = _one_hot(_bin_index(state, z), bins).float()    # (n, m, bins)
    return state._replace(counts=state.counts + one.sum(0),
                          n=state.n + x.shape[0])


def anomaly_score(state: AnomalyState, x: torch.Tensor) -> torch.Tensor:
    """Mean negative log-frequency across projections; higher = more anomalous."""
    z = x @ state.proj
    idx = _bin_index(state, z)                            # (n, m)
    m = state.counts.shape[0]
    freq = (state.counts[torch.arange(m, device=x.device)[None, :], idx]
            / torch.clamp(state.counts.sum(-1), min=1.0)[None])
    return -torch.log(freq + 1e-9).mean(-1)
