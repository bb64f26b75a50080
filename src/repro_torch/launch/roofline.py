"""Chip constants of the analytic cost model, the roofline flops rules
that declare a DL op's cost, and the per-event costs a counted op step
measures (:func:`op_event_costs`).

These are the modelled-cluster numbers the placement cost model prices
plans with (``core/costmodel.py``'s ``Resource`` defaults and the
``CLOUD_POD`` preset). They are kept numerically identical to the JAX
package's so that both packages choose the same plans on the same
inputs. They describe the modelled cloud accelerator of the cost model,
not a measurement of the card the port runs on.
"""

from __future__ import annotations

from typing import Tuple

PEAK_FLOPS = 197e12        # modelled flop/s per chip
HBM_BW = 819e9             # modelled memory bytes/s per chip
LINK_BW = 50e9             # modelled link bytes/s per link


def op_event_costs(count, n_events: int) -> Tuple[float, float]:
    """Per-event ``(flops, bytes)`` of one counted pipeline-op step — the
    measured replacements for the hand-written
    ``OperatorCost.flops_per_event`` / ``bytes_per_event`` guesses
    (:func:`repro_torch.core.selftune.measure_operator_costs` divides a
    whole batch step by its event count). ``count`` is the
    :class:`~repro_torch.launch.op_count.OpCount` the step ran under: the
    port's counterpart of the reference's compiled cost analysis."""
    n = max(int(n_events), 1)
    return count.flops / n, count.bytes / n


def model_flops(cfg, shape) -> float:
    """6*N*D for train (N=active params, D=tokens); 2*N*D for inference."""
    counts = cfg.param_counts()
    n_active = counts["active"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def dl_operator_cost(name: str, cfg, *, phase: str, batch: int,
                     seq_len: int, new_tokens: int = 1,
                     param_bytes: float = 0.0, state_bytes: float = 0.0,
                     out_bytes_per_event: float = 0.0,
                     edge_capable: bool = True, downlink_ok: bool = False):
    """Declared :class:`~repro_torch.core.costmodel.OperatorCost` for a DL
    op from the roofline flops rules (6ND train, 2ND prefill, 2N per
    generated token), copied from the JAX package. An *event* is one
    request/sequence. ``bytes_per_event`` models the weight stream:
    parameters are read once per step and amortize over the ``batch``
    sequences sharing it, except decode, which re-reads the weights for
    every generated token."""
    from repro_torch.core.costmodel import OperatorCost
    if phase not in ("train", "prefill", "decode"):
        raise ValueError(f"phase {phase!r} not in ('train', 'prefill', "
                         "'decode')")
    n_active = float(cfg.param_counts()["active"])
    b = max(int(batch), 1)
    if phase == "train":
        flops = 6.0 * n_active * seq_len
        hbm = 3.0 * param_bytes / b          # fwd read + grad + update
    elif phase == "prefill":
        flops = 2.0 * n_active * seq_len
        hbm = param_bytes / b
    else:
        flops = 2.0 * n_active * new_tokens
        hbm = param_bytes * new_tokens / b   # weight re-read per token
    return OperatorCost(name, flops_per_event=flops, bytes_per_event=hbm,
                        out_bytes_per_event=out_bytes_per_event,
                        state_bytes=state_bytes, edge_capable=edge_capable,
                        downlink_ok=downlink_ok)
