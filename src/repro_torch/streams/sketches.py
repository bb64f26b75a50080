"""Stream summarization sketches (edge-side, S2CE O2).

Count-Min (frequency estimation; the count-min kernels on the card),
Misra-Gries heavy hitters (the MG scan kernel on the card), and streaming
moments: the summaries an edge node ships upstream instead of raw
events. Integer sketches are bitwise the JAX package's on the same ids:
the seeds come from the same numpy draw, and a sketch carried over with
``convert.state_from_numpy`` continues as it would there.

``countmin_init`` and ``mg_init`` build on the card unless given
``device="cpu"``. Every other function runs on its sketch's device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import (cms_hash, countmin_add_ref,
                                     countmin_update_query_ref)


class CountMin(NamedTuple):
    table: torch.Tensor   # (depth, width) int32
    seeds: torch.Tensor   # (depth, 2) int32 odd constants < 2^15


def countmin_init(depth: int = 4, width: int = 1024, seed: int = 0,
                  device="cuda") -> CountMin:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    seeds = (rng.integers(1, 2**14, (depth, 2)) * 2 + 1).astype(np.int32)
    return CountMin(torch.zeros((depth, width), dtype=torch.int32, device=dev),
                    torch.from_numpy(seeds).to(dev))


# Which path ran, per count-min call: "kernel" (the CUDA kernels) or
# "plain" (their plain versions). Module-level, as in the JAX package, so
# the sketch stays a plain tuple of tensors.
_DISPATCH_COUNTS = {"kernel": 0, "plain": 0}


def dispatch_counts() -> dict:
    """Snapshot of ``{"kernel": n, "plain": n}`` calls since last reset."""
    return dict(_DISPATCH_COUNTS)


def reset_dispatch_counts() -> None:
    _DISPATCH_COUNTS["kernel"] = 0
    _DISPATCH_COUNTS["plain"] = 0


def _resolve_kernel(use_kernel: Optional[bool], device: torch.device,
                    who: str) -> bool:
    """None -> the kernel for a sketch on the card, the plain version on
    the CPU; False -> the plain version on any device; True -> the kernel,
    which needs the card. There is no fallback: ``True`` for a sketch on
    the CPU raises (the JAX package warns and falls back: ROADMAP fault
    10)."""
    if use_kernel is None:
        picked = device.type == "cuda"
    elif use_kernel and device.type != "cuda":
        raise ValueError(f"{who}: use_kernel=True needs a sketch on a CUDA "
                         f"device, this one is on {device}")
    else:
        picked = bool(use_kernel)
    _DISPATCH_COUNTS["kernel" if picked else "plain"] += 1
    return picked


def _ids(like: torch.Tensor, ids) -> torch.Tensor:
    """``ids`` as a flat tensor on the sketch's device."""
    return torch.as_tensor(ids, device=like.device).reshape(-1)


def countmin_add(cm: CountMin, ids,
                 use_kernel: Optional[bool] = None) -> CountMin:
    """Fold ``ids`` into the sketch: ``table +`` their increment, a new
    table (on the card one C call: a copy of the table, then the add);
    ``cm`` is left as it was."""
    ids = _ids(cm.table, ids)
    if _resolve_kernel(use_kernel, cm.table.device, "countmin_add"):
        table = kops.countmin_add(ids, cm.table, cm.seeds)
    else:
        table = countmin_add_ref(ids, cm.table, cm.seeds)
    return cm._replace(table=table)


def countmin_add_query(cm: CountMin, ids,
                       use_kernel: Optional[bool] = None
                       ) -> Tuple[CountMin, torch.Tensor]:
    """Fold ``ids`` into the sketch AND estimate each id's count against
    the updated table: ``(cm', est (n,) int32)``. Both paths are exact
    int32 and agree bitwise."""
    ids = _ids(cm.table, ids)
    if _resolve_kernel(use_kernel, cm.table.device, "countmin_add_query"):
        table, est = kops.countmin_update_query(ids, cm.table, cm.seeds)
    else:
        table, est = countmin_update_query_ref(ids, cm.table, cm.seeds)
    return cm._replace(table=table), est


def countmin_query(cm: CountMin, ids) -> torch.Tensor:
    """The estimate of each id: min over depths of its cells (a gather)."""
    depth, width = cm.table.shape
    ids = _ids(cm.table, ids)
    ests = [cm.table[d][cms_hash(ids, cm.seeds[d, 0], cm.seeds[d, 1], width)]
            for d in range(depth)]
    return torch.stack(ests).amin(0)


# ---------------------------------------------------------------------------
# Misra-Gries heavy hitters
# ---------------------------------------------------------------------------

class MisraGries(NamedTuple):
    keys: torch.Tensor    # (k,) item ids, -1 = empty
    counts: torch.Tensor  # (k,)


def mg_init(k: int = 64, device="cuda") -> MisraGries:
    dev = resolve_device(device)
    return MisraGries(torch.full((k,), -1, dtype=torch.int32, device=dev),
                      torch.zeros((k,), dtype=torch.int32, device=dev))


def mg_update(mg: MisraGries, ids) -> MisraGries:
    """Step the summary over ``ids`` in order: the MG scan kernel on the
    card, its plain loop on the CPU."""
    keys, counts = kops.mg_scan(mg.keys, mg.counts, _ids(mg.keys, ids))
    return MisraGries(keys, counts)


# ---------------------------------------------------------------------------
# Streaming moments (count / mean / var / min / max per feature)
# ---------------------------------------------------------------------------

class Moments(NamedTuple):
    n: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor


def moments_init(dim: int, device="cpu") -> Moments:
    return Moments(torch.zeros((), device=device),
                   torch.zeros((dim,), device=device),
                   torch.zeros((dim,), device=device),
                   torch.full((dim,), float("inf"), device=device),
                   torch.full((dim,), float("-inf"), device=device))


def moments_update(m: Moments, x: torch.Tensor) -> Moments:
    nb = x.shape[0]
    mean_b = x.mean(0)
    m2_b = torch.square(x - mean_b).sum(0)
    n = m.n + nb
    delta = mean_b - m.mean
    mean = m.mean + delta * nb / torch.clamp(n, min=1.0)
    m2 = m.m2 + m2_b + torch.square(delta) * m.n * nb / torch.clamp(n, min=1.0)
    return Moments(n, mean, m2, torch.minimum(m.min, x.amin(0)),
                   torch.maximum(m.max, x.amax(0)))
