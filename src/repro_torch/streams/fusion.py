"""Multi-stream fusion: time-window joins and delayed-label alignment
(S2CE Input Interface / Transformations; §2.5 delayed labels), the port
of the JAX package's ``streams/fusion.py``.

Host-side (numpy) ring buffers: fusion is an ingest-time, latency-bound
operation that runs before device dispatch, as in the reference, and its
outputs are bitwise the reference's on the same arrays. The joined
output is a :class:`~repro_torch.streams.events.StreamBatch` of numpy
arrays; the orchestrator moves it to its device when it executes the
batch (the fusion-fed entry is ``core/pipeline.py::concat_op``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.streams.events import StreamBatch


@dataclass
class WindowJoin:
    """Join two streams on event time: for each left event, attach the
    nearest right event within `tolerance` seconds (as-of join).

    The ring is a TRUE circular buffer: a pair of preallocated numpy
    arrays (capacity ``2 * max_buffer``) with head/tail indices. A push
    writes in place at the tail and eviction just advances the head —
    amortized O(1) per event (the buffer compacts to the front at most
    once per ``max_buffer`` pushed events, instead of reallocating the
    whole ring on *every* push as the concatenate version did). The live
    window ``buf[head:tail]`` stays contiguous and time-sorted, so the
    as-of match remains one vectorized ``np.searchsorted`` over the whole
    left batch.
    """
    tolerance: float = 1.0
    max_buffer: int = 100_000
    _buf_t: Optional[np.ndarray] = field(default=None, repr=False)
    _buf_v: Optional[np.ndarray] = field(default=None, repr=False)
    _head: int = 0
    _tail: int = 0

    @property
    def _rt(self) -> np.ndarray:
        """The live (time-sorted, contiguous) timestamp window."""
        if self._buf_t is None:
            return np.empty(0, np.float64)
        return self._buf_t[self._head:self._tail]

    @property
    def _rv(self) -> Optional[np.ndarray]:
        if self._buf_v is None:
            return None
        return self._buf_v[self._head:self._tail]

    def push_right(self, batch: StreamBatch, key: str = "x"):
        ts = np.asarray(batch.ts, np.float64)
        vals = np.asarray(batch.data[key])
        if len(ts) > self.max_buffer:       # oversized push: newest survive
            ts, vals = ts[-self.max_buffer:], vals[-self.max_buffer:]
        n = len(ts)
        if self._buf_t is None:             # value width known on first push
            cap = max(2 * self.max_buffer, n)
            self._buf_t = np.empty(cap, np.float64)
            self._buf_v = np.empty((cap,) + vals.shape[1:], vals.dtype)
        cap = len(self._buf_t)
        want = np.promote_types(self._buf_v.dtype, vals.dtype)
        if want != self._buf_v.dtype:       # dtype widened mid-stream:
            self._buf_v = self._buf_v.astype(want)   # promote (rare; the
            # old concatenate path upcast the same way)
        if self._tail + n > cap:            # wrap: compact live window to 0
            live = self._tail - self._head
            self._buf_t[:live] = self._buf_t[self._head:self._tail]
            self._buf_v[:live] = self._buf_v[self._head:self._tail]
            self._head, self._tail = 0, live
        self._buf_t[self._tail:self._tail + n] = ts
        self._buf_v[self._tail:self._tail + n] = vals
        self._tail += n
        if self._tail - self._head > self.max_buffer:   # evict: O(1)
            self._head = self._tail - self.max_buffer

    def join_left(self, batch: StreamBatch, out_key: str = "joined"
                  ) -> Tuple[StreamBatch, np.ndarray]:
        """Returns (batch with `out_key` column, matched mask).

        Before the first ``push_right`` the value width is unknown and the
        joined column is width-0; once anything has been pushed the column
        keeps the right stream's value shape (zeros where unmatched), so
        downstream consumers see a stable shape from then on.
        """
        ts = np.asarray(batch.ts, np.float64)
        n_left, n_right = len(ts), len(self._rt)
        if n_right == 0:
            return (batch.with_data(**{out_key: np.zeros((n_left, 0),
                                                         np.float32)}),
                    np.zeros(n_left, bool))
        # nearest right neighbour of each left timestamp: one of the two
        # events bracketing the insertion point (ties prefer the later one,
        # matching the old scalar scan)
        j = np.searchsorted(self._rt, ts)
        jl = np.clip(j - 1, 0, n_right - 1)
        jr = np.clip(j, 0, n_right - 1)
        dl = np.where(j > 0, np.abs(self._rt[jl] - ts), np.inf)
        dr = np.where(j < n_right, np.abs(self._rt[jr] - ts), np.inf)
        use_r = dr <= dl
        best = np.where(use_r, jr, jl)
        dist = np.where(use_r, dr, dl)
        matched = dist <= self.tolerance
        out = np.zeros((n_left,) + self._rv.shape[1:], self._rv.dtype)
        out[matched] = self._rv[best[matched]]
        return batch.with_data(**{out_key: out}), matched


@dataclass
class DelayedLabelAligner:
    """Features arrive now; labels arrive `delay` seconds later. Buffers
    features until their label shows up, then emits joined batches —
    the §2.5 "verification latency" setting."""
    delay_tolerance: float = 0.5
    _pending: Dict[int, Tuple[float, np.ndarray]] = field(default_factory=dict)

    def push_features(self, ids: np.ndarray, ts: np.ndarray, x: np.ndarray):
        for i, t, xi in zip(ids, ts, x):
            self._pending[int(i)] = (float(t), xi)

    def push_labels(self, ids: np.ndarray, y: np.ndarray
                    ) -> Optional[StreamBatch]:
        xs, ys, tss = [], [], []
        for i, yi in zip(ids, y):
            hit = self._pending.pop(int(i), None)
            if hit is not None:
                tss.append(hit[0])
                xs.append(hit[1])
                ys.append(yi)
        if not xs:
            return None
        return StreamBatch(
            data={"x": np.stack(xs).astype(np.float32),
                  "y": np.asarray(ys, np.int32)},
            ts=np.asarray(tss), watermark=float(max(tss)))

    @property
    def backlog(self) -> int:
        return len(self._pending)
