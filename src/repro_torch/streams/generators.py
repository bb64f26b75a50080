"""Synthetic stream generators (S2CE O4).

Controllable volume / velocity / skew / concept drift, plus a
privacy-preserving *fitted* generator that releases only moment statistics
of a real stream (mean/cov/class priors) and synthesizes surrogate data —
the paper's mechanism for sharing "closed business data" across companies.

All generators are deterministic functions of (seed, batch_index): streams
are replayable (required for fault-tolerant training restarts) and
parallelizable across feeder shards.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from repro_torch.streams.events import StreamBatch


@dataclass
class DriftSpec:
    kind: str = "none"            # none|abrupt|gradual|recurring
    at: float = 0.5               # position (fraction of horizon) of change
    width: float = 0.05           # transition width for gradual
    period: float = 0.25          # for recurring
    magnitude: float = 2.0


def _drift_mix(spec: DriftSpec, t: float, horizon: float) -> float:
    """Mixing weight in [0,1] between concept A and concept B at time t."""
    x = t / max(horizon, 1e-9)
    if spec.kind == "none":
        return 0.0
    if spec.kind == "abrupt":
        return float(x >= spec.at)
    if spec.kind == "gradual":
        return float(np.clip((x - spec.at) / max(spec.width, 1e-9), 0, 1))
    if spec.kind == "recurring":
        return float(0.5 * (1 + math.sin(2 * math.pi * x / spec.period)))
    raise ValueError(spec.kind)


@dataclass
class HyperplaneStream:
    """Rotating-hyperplane classification stream (the MOA classic)."""
    dim: int = 16
    noise: float = 0.05
    drift: DriftSpec = field(default_factory=DriftSpec)
    horizon: float = 1e6          # events until drift schedule completes
    rate: float = 1e4             # events/sec (velocity; drives timestamps)
    seed: int = 0
    source_id: int = 0

    def _concepts(self):
        rng = np.random.default_rng(self.seed)
        wa = rng.normal(size=self.dim)
        wb = rng.normal(size=self.dim) * self.drift.magnitude
        return wa / np.linalg.norm(wa), wb / np.linalg.norm(wb)

    def batch(self, idx: int, n: int) -> StreamBatch:
        rng = np.random.default_rng((self.seed, idx))
        wa, wb = self._concepts()
        t0 = idx * n / self.rate
        mix = _drift_mix(self.drift, idx * n, self.horizon)
        w = (1 - mix) * wa + mix * wb
        x = rng.normal(size=(n, self.dim)).astype(np.float32)
        margin = x @ w
        y = (margin > 0).astype(np.int32)
        flip = rng.random(n) < self.noise
        y = np.where(flip, 1 - y, y)
        ts = t0 + np.arange(n) / self.rate
        return StreamBatch(data={"x": x, "y": y}, ts=ts,
                           source_id=self.source_id, seq_no=idx,
                           watermark=float(ts[-1]))


@dataclass
class TokenStream:
    """Synthetic token stream for LM continual training: a Zipfian unigram
    mixture whose distribution drifts between two "domains"."""
    vocab_size: int = 1024
    seq_len: int = 128
    zipf_a: float = 1.3
    drift: DriftSpec = field(default_factory=DriftSpec)
    horizon: float = 1e6
    rate: float = 1e5
    seed: int = 0
    source_id: int = 0

    def _domain_perm(self) -> np.ndarray:
        """Domain B's vocabulary permutation, drawn once per stream rather
        than once per batch (2^24 entries take about a second to draw) and
        freed with it; int32 holds any token. The batches are the same."""
        key = (self.seed, self.vocab_size)
        if getattr(self, "_perm_key", None) != key:
            self._perm = np.random.default_rng(self.seed + 1).permutation(
                self.vocab_size).astype(np.int32)
            self._perm_key = key
        return self._perm

    def batch(self, idx: int, n_seqs: int) -> StreamBatch:
        rng = np.random.default_rng((self.seed, idx))
        mix = _drift_mix(self.drift, idx * n_seqs * self.seq_len, self.horizon)
        # domain B permutes the vocabulary (same marginal, drifted mapping)
        perm = self._domain_perm()
        raw = rng.zipf(self.zipf_a, size=(n_seqs, self.seq_len))
        toks = (raw % self.vocab_size).astype(np.int32)
        use_b = rng.random(n_seqs) < mix
        toks = np.where(use_b[:, None], perm[toks], toks).astype(np.int32)
        t0 = idx * n_seqs / self.rate
        ts = t0 + np.arange(n_seqs) / self.rate
        return StreamBatch(data={"tokens": toks}, ts=ts,
                           source_id=self.source_id, seq_no=idx,
                           watermark=float(ts[-1]))


@dataclass
class FittedGaussianGenerator:
    """Privacy-preserving generator: fit per-class moments on real data,
    release ONLY the moments, synthesize surrogate streams from them."""
    means: np.ndarray = None
    chols: np.ndarray = None
    priors: np.ndarray = None
    seed: int = 0

    @classmethod
    def fit(cls, x: np.ndarray, y: np.ndarray, ridge: float = 1e-3,
            seed: int = 0) -> "FittedGaussianGenerator":
        classes = np.unique(y)
        means, chols, priors = [], [], []
        for c in classes:
            xc = x[y == c]
            mu = xc.mean(0)
            cov = np.cov(xc.T) + ridge * np.eye(x.shape[1])
            means.append(mu)
            chols.append(np.linalg.cholesky(cov))
            priors.append(len(xc) / len(x))
        return cls(np.stack(means), np.stack(chols), np.asarray(priors), seed)

    def batch(self, idx: int, n: int) -> StreamBatch:
        rng = np.random.default_rng((self.seed, idx))
        ys = rng.choice(len(self.priors), size=n, p=self.priors)
        z = rng.normal(size=(n, self.means.shape[1])).astype(np.float32)
        x = self.means[ys] + np.einsum("nij,nj->ni", self.chols[ys], z)
        return StreamBatch(data={"x": x.astype(np.float32),
                                 "y": ys.astype(np.int32)},
                           ts=np.arange(n, dtype=np.float64), seq_no=idx,
                           watermark=float(n))


@dataclass
class BurstyRateModulator:
    """Wraps a generator to modulate batch sizes (volume bursts) — used by
    the offload benchmarks to trigger edge->cloud migration."""
    inner: object
    burst_every: int = 50
    burst_factor: float = 4.0

    def batch(self, idx: int, n: int) -> StreamBatch:
        if self.burst_every and idx % self.burst_every == 0 and idx > 0:
            n = int(n * self.burst_factor)
        return self.inner.batch(idx, n)
