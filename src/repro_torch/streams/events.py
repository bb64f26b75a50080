"""Stream events: the unit of data flowing through an S2CE pipeline.

A :class:`StreamBatch` is a tree of equal-leading-dim arrays plus
watermark/ordering metadata. Its ``data`` holds numpy arrays (as the
generators make them) or torch tensors; the orchestrator moves them to
its device when it executes the batch.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict

import numpy as np
import torch

from repro_torch._tree import tree_flatten, tree_leaves, tree_unflatten


def _concat(a, b):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.cat([torch.as_tensor(a), torch.as_tensor(b)])
    return np.concatenate([a, b])


@dataclass
class StreamBatch:
    data: Dict[str, Any]                  # str -> array (n, ...)
    ts: Any = None                        # (n,) event timestamps (float64 sec)
    source_id: int = 0
    seq_no: int = 0                       # per-source monotone batch counter
    watermark: float = 0.0                # max event time fully observed
    labels_delay: float = 0.0             # label availability lag (§2.5)

    @property
    def n(self) -> int:
        return int(tree_leaves(self.data)[0].shape[0])

    def with_data(self, **kw) -> "StreamBatch":
        d = dict(self.data)
        d.update(kw)
        return replace(self, data=d)

    def select(self, idx) -> "StreamBatch":
        leaves, treedef = tree_flatten(self.data)
        return replace(
            self,
            data=tree_unflatten(treedef, [a[idx] for a in leaves]),
            ts=None if self.ts is None else self.ts[idx],
        )

    def concat(self, other: "StreamBatch") -> "StreamBatch":
        la, treedef = tree_flatten(self.data)
        lb, _ = tree_flatten(other.data)
        data = tree_unflatten(treedef, [_concat(a, b) for a, b in zip(la, lb)])
        ts = None
        if self.ts is not None and other.ts is not None:
            ts = np.concatenate([np.asarray(self.ts), np.asarray(other.ts)])
        return replace(self, data=data, ts=ts,
                       watermark=max(self.watermark, other.watermark))


def merge_watermark(batches) -> float:
    """Pipeline watermark = min over sources (an event-time barrier)."""
    return min(b.watermark for b in batches)
