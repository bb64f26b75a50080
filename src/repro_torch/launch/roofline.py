"""Chip constants of the analytic cost model, the dry run's roofline
terms (:class:`Roofline`, :func:`from_trace`, :func:`collective_bytes`),
the roofline flops rules that declare a DL op's cost, and the per-event
costs a counted op step measures (:func:`op_event_costs`).

The constants are the modelled-cluster numbers the placement cost model
prices plans with (``core/costmodel.py``'s ``Resource`` defaults and the
``CLOUD_POD`` preset) and the dry run's roofline divides by. They are
kept numerically identical to the JAX package's so that both packages
choose the same plans and the tuner the same candidates on the same
inputs. They describe the modelled cloud accelerator of the cost model,
not a measurement of the card the port runs on: a roofline time here is
a modelled time, never the card's.

    compute term    = product flops (per rank) / PEAK_FLOPS
    memory term     = bytes (per rank)         / HBM_BW
    collective term = link bytes (per rank)    / LINK_BW
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

PEAK_FLOPS = 197e12        # modelled flop/s per chip
HBM_BW = 819e9             # modelled memory bytes/s per chip
LINK_BW = 50e9             # modelled link bytes/s per link

# link bytes per byte of a collective's result (ring algorithms), the JAX
# package's factors
_COLLECTIVE_FACTORS = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
    "collective-broadcast": 1.0,
}


def collective_bytes(record: dict) -> Dict[str, float]:
    """Per-rank link bytes by collective kind, factors applied, and their
    ``"total"``, from a traced record's ``collective_out_bytes`` (each
    kind's result bytes, as :func:`repro_torch.launch.hlo_analysis.
    analyze` counts them)."""
    out = {k: v * _COLLECTIVE_FACTORS[k]
           for k, v in record.get("collective_out_bytes", {}).items()}
    out["total"] = sum(out.values())
    return out


@dataclass
class Roofline:
    flops_per_dev: float
    hbm_bytes_per_dev: float
    link_bytes_per_dev: float
    chips: int
    model_flops_global: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_dev / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.link_bytes_per_dev / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        traced_global = self.flops_per_dev * self.chips
        return self.model_flops_global / traced_global if traced_global \
            else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak the step achieves if it runs at the bound:
        useful MODEL_FLOPS / (chips * peak * bound_time)."""
        denom = self.chips * PEAK_FLOPS * self.bound_time
        return self.model_flops_global / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops_per_dev,
            "hbm_bytes_per_dev": self.hbm_bytes_per_dev,
            "link_bytes_per_dev": self.link_bytes_per_dev,
            "chips": self.chips,
            "model_flops_global": self.model_flops_global,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def from_trace(record: dict, cfg, shape, chips: int) -> Roofline:
    """Roofline terms of one rank's traced step (the record of
    :func:`repro_torch.launch.hlo_analysis.analyze`): its matrix products'
    flops (the JAX package's HLO flops count products alone), its
    unfused bytes (an upper bound next to XLA's fused traffic) and its
    link bytes. Eager PyTorch unrolls every loop, so nothing is scaled
    by trip counts."""
    return Roofline(
        flops_per_dev=record["dot_flops"],
        hbm_bytes_per_dev=record["hbm_bytes"],
        link_bytes_per_dev=record["collective_bytes_total"],
        chips=chips,
        model_flops_global=model_flops(cfg, shape),
    )


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
