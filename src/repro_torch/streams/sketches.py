"""Stream summarization sketches (edge-side, S2CE O2).

Streaming moments (count / mean / var / min / max per feature), the
summary the standard pipeline's sketch op keeps. The JAX package's
Count-Min and Misra-Gries sketches come to the port with the count-min
kernels (ROADMAP).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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
