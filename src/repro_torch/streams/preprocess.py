"""Streaming preprocessing (S2CE Transformations component).

Instance/attribute transforms with O(1) running state: normalization
(Welford), missing-value imputation, streaming PCA-lite projection
(Oja's rule) for online dimensionality reduction (§2.5), and feature
hashing. All are (state, batch) -> (state, batch) functions on tensors,
so the orchestrator can place them on edge or cloud interchangeably.

Two entry points go through the port's kernels on the card:
:func:`norm_impute_fused` (and so :func:`preprocess_batch`) through
``fused_normalize``, and :func:`hash_features` through
``fused_hash_features``. On the CPU they run the kernels' plain
versions.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.streams.events import StreamBatch


# ---------------------------------------------------------------------------
# Running normalization (Welford)
# ---------------------------------------------------------------------------

class NormState(NamedTuple):
    n: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor


def norm_init(dim: int, device="cpu") -> NormState:
    return NormState(torch.zeros((), device=device),
                     torch.zeros((dim,), device=device),
                     torch.zeros((dim,), device=device))


def norm_update_apply(state: NormState, x: torch.Tensor
                      ) -> Tuple[NormState, torch.Tensor]:
    """x: (n, d). Updates running stats with the batch, then normalizes."""
    n_b = x.shape[0]
    mean_b = x.mean(0)
    m2_b = torch.square(x - mean_b).sum(0)
    n = state.n + n_b
    delta = mean_b - state.mean
    mean = state.mean + delta * (n_b / torch.clamp(n, min=1.0))
    m2 = (state.m2 + m2_b
          + torch.square(delta) * state.n * n_b / torch.clamp(n, min=1.0))
    var = m2 / torch.clamp(n - 1.0, min=1.0)
    y = (x - mean) * torch.rsqrt(var + 1e-6)
    return NormState(n, mean, m2), y


# ---------------------------------------------------------------------------
# Missing-value imputation (NaN -> running mean)
# ---------------------------------------------------------------------------

def impute_with_mean(state: NormState, x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), state.mean[None, :], x)


def norm_impute_fused(state: NormState, x: torch.Tensor, *,
                      impute: bool = True) -> Tuple[NormState, torch.Tensor]:
    """Impute + Welford update + normalize as ONE fused step: the
    ``fused_normalize`` kernel on the card, its plain version (the
    composition ``impute_with_mean`` + ``norm_update_apply``) on the
    CPU. The two are tolerance-equal: the kernel accumulates raw
    moments, the plain version centres first."""
    y, n1, mean1, m21 = kops.fused_normalize(x, state.n, state.mean,
                                             state.m2, impute=impute)
    return NormState(n1, mean1, m21), y


# ---------------------------------------------------------------------------
# Online PCA-lite (Oja's rule) — streaming dimensionality reduction
# ---------------------------------------------------------------------------

class OjaState(NamedTuple):
    w: torch.Tensor          # (d, k) projection
    n: torch.Tensor


def oja_init(dim: int, k: int, seed: int = 0, device="cpu") -> OjaState:
    """A random (dim, k) start from a seeded torch generator. (The JAX
    package draws it with ``jax.random``; ``convert.states_from_numpy``
    carries its draw across.)"""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((dim, k), generator=g) / math.sqrt(dim)
    return OjaState(w.to(device), torch.zeros((), device=device))


def oja_update_project(state: OjaState, x: torch.Tensor, lr: float = 1e-2
                       ) -> Tuple[OjaState, torch.Tensor]:
    """One Oja step on the batch covariance, then project."""
    y = x @ state.w                              # (n, k)
    grad = x.T @ y / x.shape[0]                  # (d, k)
    w = state.w + lr * (grad - state.w @ torch.triu(state.w.T @ grad))
    # orthonormalize softly via QR every step (cheap for small k)
    q, r = torch.linalg.qr(w)
    w = q * torch.sign(torch.diagonal(r))[None, :]
    return OjaState(w, state.n + x.shape[0]), x @ w


# ---------------------------------------------------------------------------
# Feature hashing (sparse/categorical -> fixed dim)
# ---------------------------------------------------------------------------

def hash_features(ids: torch.Tensor, vals: torch.Tensor, dim: int,
                  seed: int = 17) -> torch.Tensor:
    """ids/vals: (n, f) -> dense (n, dim) via signed feature hashing, the
    ``fused_hash_features`` kernel on the card. Bitwise equal on both
    paths: the hash is integer arithmetic and each row's features are
    added in feature order."""
    return kops.hash_features(ids.to(torch.int32), vals, dim,
                              seed=seed).to(vals.dtype)


def preprocess_batch(state, batch: StreamBatch, normalize: bool = True,
                     impute: bool = True) -> Tuple[object, StreamBatch]:
    """The standard edge-side preprocessing pipeline for feature streams.

    When normalizing, routes through :func:`norm_impute_fused`, so the
    whole impute+update+normalize step runs as the fused kernel on the
    card."""
    x = batch.data["x"]
    if normalize:
        state, x = norm_impute_fused(state, x, impute=impute)
    elif impute:
        x = impute_with_mean(state, x)
    return state, batch.with_data(x=x)
