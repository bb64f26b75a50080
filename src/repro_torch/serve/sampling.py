"""Token sampling: greedy / temperature / top-k / top-p (nucleus), as the
JAX package's ``serve/sampling.py``.

The top-k and top-p masks are the reference's. Under tensor
parallelism the model's logits are split over ``vocab``; ``zoo.prefill``
and ``zoo.decode_step`` all-gather the last position's (B x V, small)
over ``model``, so :func:`sample` sees the whole vocabulary on every
rank and greedy takes the lowest index of a tie, as one rank's
``argmax``. The categorical draw
takes an explicit ``torch.Generator`` on the logits' device; it cannot
give ``jax.random``'s draws, so sampled tokens agree with the reference
in distribution only (greedy decoding agrees token for token).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

NEG = -1e30


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_k: int = 0          # 0 = off
    top_p: float = 1.0      # 1 = off
    greedy: bool = False


def masked_logits(logits: torch.Tensor, p: SamplingParams) -> torch.Tensor:
    """The temperature-scaled logits with everything outside the top-k and
    the nucleus set to -1e30 (the reference's masks)."""
    logits = logits / max(p.temperature, 1e-6)
    neg = torch.tensor(NEG, dtype=logits.dtype, device=logits.device)
    if p.top_k:
        kth = torch.topk(logits, p.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, neg, logits)
    if p.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # smallest set with cumulative mass >= top_p
        cutoff_idx = torch.sum(cum < p.top_p, dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, neg, logits)
    return logits


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           p: SamplingParams = SamplingParams()) -> torch.Tensor:
    """logits: (B, V) fp32 -> token ids (B,) int32."""
    if p.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("sampling without greedy needs a generator")
    probs = torch.softmax(masked_logits(logits, p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
