"""The comparisons that decide ``correct``: gaps between what the program
produced and what the plain reference gives, each held to its limit."""

from __future__ import annotations

from typing import Dict, Iterable

import torch


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """How far ``got`` lies from ``want``: for floats the largest absolute
    difference over the largest magnitude of ``want`` (so an element near
    zero is judged at the tensor's scale); for integers and flags 0.0 when
    equal, else 1.0. A shape mismatch or a NaN reads infinity."""
    got = torch.as_tensor(got).detach().cpu()
    want = torch.as_tensor(want).detach().cpu()
    if got.shape != want.shape:
        return float("inf")
    if not want.is_floating_point():
        return 0.0 if torch.equal(got.to(want.dtype), want) else 1.0
    g, w = got.double(), want.double()
    if torch.isnan(g).any() or torch.isnan(w).any():
        return float("inf")
    fin = torch.isfinite(w)
    if not torch.equal(torch.isfinite(g), fin) or not torch.equal(g[~fin],
                                                                  w[~fin]):
        return float("inf")
    if not fin.any():
        return 0.0
    diff = (g[fin] - w[fin]).abs().max().item()
    scale = w[fin].abs().max().item()
    return diff / max(scale, 1e-30)


def grouped_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                 groups: Dict[str, Iterable[str]]) -> Dict[str, float]:
    """The largest :func:`gap` of each group's tensors; ``groups`` maps a
    check's name to the prefixes (before the first dot) of its tensors. A
    tensor on one side only reads infinity."""
    out = {}
    for check, prefixes in groups.items():
        keys = sorted(k for k in set(got) | set(want)
                      if k.split(".")[0] in prefixes)
        out[check] = max((gap(got[k], want[k]) if k in got and k in want
                          else float("inf")) for k in keys) if keys else 0.0
    return out


def held(values: Dict[str, float], limits: Dict[str, float]) -> dict:
    """``{name: {"value", "limit"}}``: each number beside its limit."""
    return {k: {"value": float(v), "limit": float(limits[k])}
            for k, v in values.items()}


def correct(held_values: dict) -> bool:
    """Whether every number of :func:`held`'s record is within its limit."""
    return all(c["value"] <= c["limit"] for c in held_values.values())
