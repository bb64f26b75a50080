"""Prequential (test-then-train) evaluation for streaming models (§2.4)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class PrequentialState(NamedTuple):
    n: torch.Tensor
    correct: torch.Tensor
    loss_sum: torch.Tensor
    ewma_acc: torch.Tensor   # fading-factor accuracy (tracks drift recovery)


def preq_init(device="cpu") -> PrequentialState:
    z = torch.zeros((), device=device)
    return PrequentialState(z, z.clone(), z.clone(),
                            torch.tensor(0.5, device=device))


def preq_update(st: PrequentialState, p: torch.Tensor, y: torch.Tensor,
                fading: float = 0.995) -> PrequentialState:
    """p: (n,) predicted probability of class 1; y: (n,) labels."""
    yhat = (p > 0.5).to(torch.int32)
    acc_b = (yhat == y).float().mean()
    ll = -torch.mean(y * torch.log(p + 1e-9) + (1 - y) * torch.log(1 - p + 1e-9))
    n = st.n + p.shape[0]
    correct = st.correct + acc_b * p.shape[0]
    decay = fading ** p.shape[0]
    ewma = decay * st.ewma_acc + (1 - decay) * acc_b
    return PrequentialState(n, correct, st.loss_sum + ll * p.shape[0], ewma)


def preq_metrics(st: PrequentialState) -> dict:
    return {
        "accuracy": float(st.correct / torch.clamp(st.n, min=1.0)),
        "logloss": float(st.loss_sum / torch.clamp(st.n, min=1.0)),
        "ewma_accuracy": float(st.ewma_acc),
        "n": int(st.n),
    }
