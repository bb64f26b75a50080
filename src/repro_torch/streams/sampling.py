"""Stream sampling for edge-side volume reduction (S2CE O2).

Property-preserving (unbiased) sampling is what lets the edge cut volume
without biasing downstream models: Algorithm-R reservoir sampling
(uniform over the whole history) and per-batch Bernoulli thinning.

Randomness comes from explicit ``torch.Generator``s seeded from integer
seeds that the state (reservoir) or the batch (thinning) carries; no
global RNG is read. The draws differ from ``jax.random``'s, so the tests
inject the JAX package's draws or check distributions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

SEED_MASK = (1 << 63) - 1     # seeds are non-negative int64


def next_seed(seed: int) -> int:
    """A new 63-bit seed from ``seed`` (one step of Knuth's MMIX LCG):
    how a generator-carrying state advances between batches."""
    return (int(seed) * 6364136223846793005 + 1442695040888963407) & SEED_MASK


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) & SEED_MASK)


class ReservoirState(NamedTuple):
    buf: torch.Tensor        # (k, d)
    extra: torch.Tensor      # (k,) payload (e.g. labels)
    seen: torch.Tensor       # () total items observed
    rng: torch.Tensor        # () int64 generator seed


def reservoir_init(k: int, dim: int, seed: int = 0,
                   device="cpu") -> ReservoirState:
    return ReservoirState(
        buf=torch.zeros((k, dim), device=device),
        extra=torch.zeros((k,), dtype=torch.int32, device=device),
        seen=torch.zeros((), dtype=torch.int32, device=device),
        rng=torch.tensor(seed, dtype=torch.int64, device=device),
    )


def reservoir_update(state: ReservoirState, x: torch.Tensor, y: torch.Tensor,
                     j: Optional[torch.Tensor] = None) -> ReservoirState:
    """Algorithm R over a batch, vectorised and exact. x: (n, d); y: (n,).

    Item ``i`` is the ``seen0 + i + 1``-th item ever seen; it draws ``j_i``
    uniform in ``[0, seen)`` and takes slot ``seen - 1`` while the
    reservoir fills, else slot ``j_i`` when ``j_i < k``. Applied in order,
    each slot ends up holding the LAST item that took it, so the batch is
    one scatter-max of item index per slot followed by a gather: the same
    state as the per-item scan. ``j`` (n,) replaces the draws (the tests
    inject the JAX package's)."""
    k = state.buf.shape[0]
    n = x.shape[0]
    dev = x.device
    seen = (state.seen.to(torch.int64)
            + torch.arange(1, n + 1, device=dev, dtype=torch.int64))
    new_seed = state.rng
    if j is None:
        seed = int(state.rng)
        draws = torch.randint(0, 1 << 62, (n,), generator=generator(seed, dev),
                              device=dev, dtype=torch.int64)
        j = draws % seen
        new_seed = torch.tensor(next_seed(seed), dtype=torch.int64,
                                device=state.rng.device)
    j = j.to(device=dev, dtype=torch.int64)
    filling = seen <= k
    idx = torch.clamp(torch.where(filling, seen - 1, j), 0, k - 1)
    take = filling | (j < k)
    items = torch.arange(n, device=dev, dtype=torch.int64)
    last = torch.full((k,), -1, dtype=torch.int64, device=dev)
    last = last.scatter_reduce(0, idx[take], items[take], reduce="amax")
    hit = last >= 0
    src = torch.clamp(last, min=0)
    buf = torch.where(hit[:, None], x[src].to(state.buf.dtype), state.buf)
    extra = torch.where(hit, y[src].to(torch.int32), state.extra)
    return ReservoirState(buf, extra,
                          (state.seen + n).to(state.seen.dtype), new_seed)


def bernoulli_thin(seed: int, x: torch.Tensor, rate: float
                   ) -> Tuple[torch.Tensor, int]:
    """Unbiased thinning: keep each item w.p. ``rate``; returns
    ``(mask, next seed)``. Downstream estimators reweight by 1/rate."""
    g = generator(seed, x.device)
    mask = torch.rand((x.shape[0],), generator=g, device=x.device) < rate
    return mask, next_seed(seed)
