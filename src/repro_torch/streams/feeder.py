"""Host->device stream feeder with prefetch and straggler mitigation.

The feeder owns N worker "shards" (one per source partition). Each shard
produces batches on a deadline; a shard that misses its deadline is a
*straggler* and its batch is served from a backup generator replica instead
(generators are deterministic in (seed, index), so the backup produces the
identical batch — no data loss, no duplicates). This is the data-plane half
of S2CE fault tolerance; the compute-plane half is dist/elastic.py.

Batches stay as ``make_batch`` builds them (the generators' numpy-backed
``StreamBatch``); the consumer moves them to its device.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from repro_torch.streams.events import StreamBatch


@dataclass
class FeederStats:
    batches: int = 0
    straggler_rescues: int = 0
    wait_s: float = 0.0


class StreamFeeder:
    """Pulls from `make_batch(shard, idx, n)` across shards, prefetches up
    to `prefetch` batches, rescues stragglers from the deterministic replay
    path."""

    def __init__(self, make_batch: Callable[[int, int, int], StreamBatch],
                 n_shards: int = 2, batch_per_shard: int = 64,
                 deadline_s: float = 1.0, prefetch: int = 2,
                 inject_straggle: Optional[Callable[[int, int], float]] = None,
                 start_idx: int = 0):
        self.make_batch = make_batch
        self.n_shards = n_shards
        self.batch_per_shard = batch_per_shard
        self.deadline_s = deadline_s
        self.prefetch = prefetch
        self.inject_straggle = inject_straggle     # (shard, idx) -> sleep s
        self.stats = FeederStats()
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._idx = start_idx        # first batch index (resume support)
        self._thread: Optional[threading.Thread] = None

    @property
    def backlog(self) -> int:
        """Prefetched batches waiting to be consumed. A persistently full
        queue means the producers outpace the consumer — the offered-load
        signal elastic scaling uses when no demand curve is given."""
        return self._q.qsize()

    # -- worker ------------------------------------------------------------
    def _produce_one(self, idx: int) -> StreamBatch:
        results: List[Optional[StreamBatch]] = [None] * self.n_shards

        def work(shard):
            if self.inject_straggle:
                time.sleep(self.inject_straggle(shard, idx))
            results[shard] = self.make_batch(shard, idx, self.batch_per_shard)

        threads = [threading.Thread(target=work, args=(s,), daemon=True)
                   for s in range(self.n_shards)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        deadline = t0 + self.deadline_s
        for t in threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        # straggler rescue: deterministic replay on the caller thread
        for s in range(self.n_shards):
            if results[s] is None:
                results[s] = self.make_batch(s, idx, self.batch_per_shard)
                self.stats.straggler_rescues += 1
        out = results[0]
        for b in results[1:]:
            out = out.concat(b)
        self.stats.batches += 1
        return out

    def _run(self):
        while not self._stop.is_set():
            b = self._produce_one(self._idx)
            self._idx += 1
            while not self._stop.is_set():
                try:
                    self._q.put(b, timeout=0.1)
                    break
                except queue.Full:
                    continue

    # -- public ------------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def next(self, timeout: float = 30.0) -> StreamBatch:
        t0 = time.perf_counter()
        b = self._q.get(timeout=timeout)
        self.stats.wait_s += time.perf_counter() - t0
        return b

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
