"""Stream sampling for edge-side volume reduction (S2CE O2).

Property-preserving (unbiased) sampling is what lets the edge cut volume
without biasing downstream models: Algorithm-R reservoir sampling
(uniform over the whole history), per-batch Bernoulli thinning, and
stratified reservoirs (one reservoir a class) for label balance.

Randomness is counter-based: each draw is :func:`mix64` of a seed and
the item's index, in int64 tensor ops on the op's device. The seed is an
int64 tensor that the state (reservoir) or the batch (thinning) carries,
and it advances on the device by the same function. So the CPU and the
card draw the same bits, nothing is read back to the host, and a CUDA
graph of the op replays fresh draws. The draws differ from
``jax.random``'s, so the tests inject the JAX package's draws or check
distributions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

SEED_MASK = (1 << 63) - 1     # seeds are non-negative int64

# splitmix64's constants, written as the int64 values of their bits
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def mix64(seed: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer of ``seed * golden + counter + 1``, as int64
    bits: the same function as ``core/orchestrator.py::step_seed`` on the
    host. Multiplication wraps in two's complement on both devices."""
    z = seed * _GOLDEN + (counter + 1)
    z = (z ^ _shr(z, 30)) * _MIX1
    z = (z ^ _shr(z, 27)) * _MIX2
    return z ^ _shr(z, 31)


def advance(seed: torch.Tensor) -> torch.Tensor:
    """The next seed: ``mix64`` at counter -2, which no item index takes
    (at -1 the finalizer would keep seed 0 at 0)."""
    return mix64(seed, -2) & SEED_MASK


def draws(seed: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """Non-negative 63-bit draws, one per entry of ``counter``."""
    return mix64(seed, counter) & SEED_MASK


class ReservoirState(NamedTuple):
    buf: torch.Tensor        # (k, d)
    extra: torch.Tensor      # (k,) payload (e.g. labels)
    seen: torch.Tensor       # () total items observed
    rng: torch.Tensor        # () int64 seed


def reservoir_init(k: int, dim: int, seed: int = 0,
                   device="cpu") -> ReservoirState:
    return ReservoirState(
        buf=torch.zeros((k, dim), device=device),
        extra=torch.zeros((k,), dtype=torch.int32, device=device),
        seen=torch.zeros((), dtype=torch.int32, device=device),
        rng=torch.tensor(seed, dtype=torch.int64, device=device),
    )


def _last_taker(slot: torch.Tensor, take: torch.Tensor,
                n_slots: int) -> torch.Tensor:
    """Per slot, the largest item index that took it (-1 if none): one
    scatter-max. An item that takes nothing writes to a slot of its own
    past the reservoir's, dropped after: no boolean index (which would
    read a count on the host), and no two such items contend for one
    address (once the reservoir is full, most items take nothing)."""
    n = slot.shape[0]
    items = torch.arange(n, device=slot.device, dtype=torch.int64)
    last = torch.full((n_slots + n,), -1, dtype=torch.int64,
                      device=slot.device)
    dest = torch.where(take, slot, n_slots + items)
    return last.scatter_reduce(0, dest, items, reduce="amax")[:n_slots]


def reservoir_update(state: ReservoirState, x: torch.Tensor, y: torch.Tensor,
                     j: Optional[torch.Tensor] = None) -> ReservoirState:
    """Algorithm R over a batch, vectorised and exact. x: (n, d); y: (n,).

    Item ``i`` is the ``seen0 + i + 1``-th item ever seen; it draws ``j_i``
    uniform in ``[0, seen)`` and takes slot ``seen - 1`` while the
    reservoir fills, else slot ``j_i`` when ``j_i < k``. Applied in order,
    each slot ends up holding the LAST item that took it, so the batch is
    one scatter-max of item index per slot followed by a gather: the same
    state as the per-item scan. ``j`` (n,) replaces the draws (the tests
    inject the JAX package's) and then the seed does not advance."""
    k = state.buf.shape[0]
    n = x.shape[0]
    dev = x.device
    counter = torch.arange(n, device=dev, dtype=torch.int64)
    seen = state.seen.to(torch.int64) + counter + 1
    new_seed = state.rng
    if j is None:
        j = draws(state.rng, counter) % seen
        new_seed = advance(state.rng)
    j = j.to(device=dev, dtype=torch.int64)
    filling = seen <= k
    idx = torch.clamp(torch.where(filling, seen - 1, j), 0, k - 1)
    last = _last_taker(idx, filling | (j < k), k)
    hit = last >= 0
    src = torch.clamp(last, min=0)
    buf = torch.where(hit[:, None], x[src].to(state.buf.dtype), state.buf)
    extra = torch.where(hit, y[src].to(torch.int32), state.extra)
    return ReservoirState(buf, extra,
                          (state.seen + n).to(state.seen.dtype), new_seed)


def bernoulli_thin(seed: Union[torch.Tensor, int], x: torch.Tensor,
                   rate: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unbiased thinning: keep each item w.p. ``rate``; returns
    ``(mask, next seed)``. Item ``i`` is kept when the top 53 bits of
    ``mix64(seed, i)`` fall below ``rate * 2**53``. Downstream estimators
    reweight by 1/rate."""
    seed = torch.as_tensor(seed, dtype=torch.int64).to(x.device)
    counter = torch.arange(x.shape[0], device=x.device, dtype=torch.int64)
    u = _shr(mix64(seed, counter), 11)
    mask = u < int(min(max(rate, 0.0), 1.0) * (1 << 53))
    return mask, advance(seed)


class StratifiedReservoir(NamedTuple):
    states: ReservoirState          # stacked per class (C leading dim)


def stratified_init(n_classes: int, k: int, dim: int, seed: int = 0,
                    device="cpu") -> StratifiedReservoir:
    """One reservoir a class, class ``c`` seeded ``seed + c``, stacked."""
    one = [reservoir_init(k, dim, seed + c, device)
           for c in range(n_classes)]
    return StratifiedReservoir(ReservoirState(
        *[torch.stack(f) for f in zip(*one)]))


def stratified_update(sr: StratifiedReservoir, x: torch.Tensor,
                      y: torch.Tensor, n_classes: int,
                      j: Optional[torch.Tensor] = None
                      ) -> StratifiedReservoir:
    """Algorithm R per class over a batch, in one pass for every class.

    Item ``i`` of class ``c`` is the ``r_i + 1``-th item of its class in
    the batch (``r_i`` from a cumulative sum of the one-hot labels), so it
    is the ``seen_c + r_i + 1``-th item its class's reservoir has seen;
    it draws from ``mix64(seed_c, r_i)`` and takes slot ``c * k + idx``
    as :func:`reservoir_update` would. One scatter-max of item index per
    slot and a gather then give every class's reservoir: the state the
    JAX package's per-class scans give with the same draws. Items whose
    label is outside ``[0, n_classes)`` join no class. ``j`` (n,), item
    ``i``'s draw in its class's sequence, replaces the draws; a class's
    seed advances when the batch holds one of its items and ``j`` is not
    given."""
    st = sr.states
    C = n_classes
    k = st.buf.shape[1]
    dev = x.device
    labels = y.to(device=dev, dtype=torch.int64)
    onehot = labels[:, None] == torch.arange(C, device=dev)[None, :]
    member = onehot.any(1)
    c = torch.clamp(labels, 0, C - 1)
    rank = (torch.cumsum(onehot.to(torch.int64), 0).gather(1, c[:, None])[:, 0]
            - 1)
    seen = st.seen.to(torch.int64)[c] + rank + 1
    counts = onehot.sum(0)
    new_seed = st.rng
    if j is None:
        j = draws(st.rng[c], rank) % seen
        new_seed = torch.where(counts > 0, advance(st.rng), st.rng)
    j = j.to(device=dev, dtype=torch.int64)
    filling = seen <= k
    idx = torch.clamp(torch.where(filling, seen - 1, j), 0, k - 1)
    last = _last_taker(c * k + idx, member & (filling | (j < k)),
                       C * k).view(C, k)
    hit = last >= 0
    src = torch.clamp(last, min=0)
    buf = torch.where(hit[..., None], x[src].to(st.buf.dtype), st.buf)
    extra = torch.where(hit, y[src].to(torch.int32), st.extra)
    return StratifiedReservoir(ReservoirState(
        buf, extra, (st.seen + counts).to(st.seen.dtype), new_seed))
