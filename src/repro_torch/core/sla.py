"""SLA specification and tracking (S2CE S3: workload shift must not
violate agreed SLAs), plus SLA-driven uplink codec admission.

Admission has two modes:

* **static** (:func:`pick_codec` without a report) — the cheapest
  :class:`~repro_torch.core.codecs.UplinkCodec` whose tested accumulated-error
  bound fits the job's ``error_budget``. This is the one-shot choice the
  orchestrator makes at job start.
* **rate-aware** (:func:`pick_codec` / :func:`codec_candidates` with a
  ``report``) — re-admission at replan time against *windowed* SLA
  telemetry: when the bottleneck uplink is saturated
  (``uplink_utilization >= UPLINK_SATURATED``) every budget-admissible
  codec is on the table and the plan search escalates toward cheaper
  wire; when violations come from latency/staleness rather than
  bandwidth, or the link has clear headroom
  (``<= UPLINK_RELAXED``), admission de-escalates toward lossless. In
  between the two thresholds the incumbent codec is kept — the
  hysteresis dead band that stops codec flapping when utilization
  hovers around a threshold.

:class:`SLATracker` supplies the telemetry: every statistic it reports
is computed over the last ``window`` observations (rolling violation
counts, windowed deques), so a clean stretch ages earlier violations
out and ``ok()`` recovers — a lifetime violation counter would make the
controller replan forever on stale history.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterable, List, Mapping, Optional, Tuple

# -- rate-aware admission thresholds (shared by the offload controller
# and the tests so the hysteresis band has one definition) -------------------
UPLINK_SATURATED = 0.9   # escalate: modeled bottleneck-link utilization >= this
UPLINK_RELAXED = 0.5     # de-escalate toward lossless below this
VIOLATION_TOLERANCE = 0.01   # windowed violation rate SLATracker.ok allows


@dataclass(frozen=True)
class SLA:
    max_latency_s: float = 0.5          # end-to-end event latency
    min_throughput: float = 0.0         # events/s
    max_staleness_s: float = 5.0        # model update staleness
    max_error_rate: Optional[float] = None
    # accumulated relative error the uplink codec may introduce (the
    # error-feedback residual bound, normalized by the stream's peak
    # magnitude). 0.0 = lossless uplink required -> identity codec.
    error_budget: float = 0.0


def _admissible(sla: SLA, candidates: Optional[Iterable]) -> List:
    from repro_torch.core.codecs import DEFAULT_CODECS, identity_codec
    cands = list(candidates) if candidates is not None else list(DEFAULT_CODECS)
    budget = max(0.0, sla.error_budget)
    admissible = [c for c in cands if c.error_bound <= budget]
    # the identity codec has bound 0.0 and is therefore always admissible
    # — a zero budget degrades gracefully to a lossless uplink, never to
    # an inadmissible codec
    return admissible or [identity_codec()]


def codec_candidates(sla: SLA, report: Optional[Mapping] = None,
                     candidates: Optional[Iterable] = None) -> List:
    """The codec candidate set admission allows, rate-aware.

    Every returned codec fits ``sla.error_budget`` (the hard admission
    invariant — telemetry can narrow the set but never widen it past the
    budget). Without a ``report`` the full budget-admissible set is
    returned. With a windowed report (an :meth:`SLATracker.report` dict,
    optionally extended with the modeled ``uplink_utilization`` of the
    current plan and the incumbent ``codec`` name):

    * ``uplink_utilization >= UPLINK_SATURATED`` — the link is the
      bottleneck: the full admissible set is returned so the plan search
      can escalate to the cheapest wire that restores feasibility;
    * windowed *non-bandwidth* violations without saturation, or
      ``uplink_utilization <= UPLINK_RELAXED`` — compression is not
      buying anything (the violations come from latency/staleness, or
      the link has headroom): de-escalate to the most faithful
      admissible codec (lossless when the budget allows identity). A
      report carrying the per-cause ``latency_violation_rate`` is judged
      on that (throughput violations are bandwidth symptoms — starving
      the wire harder by going lossless would make them worse); a bare
      report falls back to the aggregate ``violation_rate``;
    * otherwise (the hysteresis dead band between the thresholds) — keep
      the incumbent ``report["codec"]`` when it is still admissible.
    """
    admissible = _admissible(sla, candidates)
    if report is None:
        return admissible
    util = float(report.get("uplink_utilization", 0.0))
    vrate = float(report.get("latency_violation_rate",
                             report.get("violation_rate", 0.0)))
    if util >= UPLINK_SATURATED:
        return admissible
    if vrate >= VIOLATION_TOLERANCE or util <= UPLINK_RELAXED:
        return [min(admissible, key=lambda c: (c.error_bound, c.ratio))]
    current = report.get("codec")
    kept = [c for c in admissible if c.name == current]
    return kept or admissible


def pick_codec(sla: SLA, candidates: Optional[Iterable] = None,
               report: Optional[Mapping] = None):
    """The uplink codec the SLA admits — cheapest wire among the
    rate-aware candidate set.

    Without a ``report`` this is the classic static admission: among the
    codecs whose property-tested ``error_bound`` fits
    ``sla.error_budget``, the smallest wire ``ratio`` wins (ties broken
    toward the smaller error bound). With a windowed SLA ``report`` the
    candidate set first passes :func:`codec_candidates`, so the choice
    escalates under bandwidth pressure and de-escalates toward lossless
    when violations are not bandwidth-bound. An admitted codec NEVER
    exceeds the budget.
    """
    cands = codec_candidates(sla, report=report, candidates=candidates)
    return min(cands, key=lambda c: (c.ratio, c.error_bound))


def plan_violation(plan, sla: SLA) -> Optional[str]:
    """Why a modeled :class:`~repro_torch.core.costmodel.PipelinePlan` cannot
    meet ``sla`` — a loud human-readable reason, or ``None`` when the
    plan is admissible. This is the fleet scheduler's admission predicate
    (:mod:`repro_torch.core.fleet`): a tenant whose *best* plan under residual
    capacity trips any clause here is rejected or queued, never silently
    degraded.

    Checks, in order of loudness:

    * placement feasibility (some pool or link over capacity — the plan's
      own ``notes`` carry the specifics);
    * modeled critical-path latency against ``sla.max_latency_s``.

    Throughput is rate-implicit — an infeasible plan at the tenant's
    demand rate *is* the throughput failure — so no separate clause.
    """
    if not plan.feasible:
        detail = "; ".join(plan.notes) if plan.notes else "over capacity"
        return f"infeasible plan: {detail}"
    if plan.latency_s > sla.max_latency_s:
        return (f"modeled latency {plan.latency_s:.4f}s exceeds SLA "
                f"max_latency_s={sla.max_latency_s:.4f}s")
    return None


@dataclass
class SLATracker:
    """Windowed SLA telemetry: every reported statistic covers the last
    ``window`` observations only, so violations age out after a clean
    stretch. ``violations``/``checks`` remain as *lifetime* counters for
    audit/back-compat; decisions (``ok``, ``violation_rate``) are
    strictly windowed."""
    sla: SLA
    window: int = 100
    latencies: Deque[float] = field(default_factory=collections.deque)
    throughputs: Deque[float] = field(default_factory=collections.deque)
    violations: int = 0              # lifetime count (audit only)
    checks: int = 0                  # lifetime count (audit only)

    def __post_init__(self):
        if self.window <= 0:
            raise ValueError(f"window must be positive, got {self.window}")
        # honor `window`: the deques carry exactly the last `window`
        # observations (they used to hardcode maxlen=1000, silently
        # ignoring `window`)
        self.latencies = collections.deque(self.latencies,
                                           maxlen=self.window)
        self.throughputs = collections.deque(self.throughputs,
                                             maxlen=self.window)
        # per-observation violation flags (latency_bad, throughput_bad)
        # with rolling counts so the windowed rates are O(1) per step
        self._flags: Deque[Tuple[bool, bool]] = collections.deque(
            maxlen=self.window)
        self._win_viol = 0
        self._win_lat = 0
        self._win_thr = 0

    def observe(self, latency_s: float, throughput: float):
        self.latencies.append(latency_s)
        self.throughputs.append(throughput)
        self.checks += 1
        lat_bad = latency_s > self.sla.max_latency_s
        thr_bad = throughput < self.sla.min_throughput
        if len(self._flags) == self._flags.maxlen:   # evict the aged-out flag
            old_lat, old_thr = self._flags[0]
            self._win_viol -= int(old_lat or old_thr)
            self._win_lat -= int(old_lat)
            self._win_thr -= int(old_thr)
        self._flags.append((lat_bad, thr_bad))
        self._win_viol += int(lat_bad or thr_bad)
        self._win_lat += int(lat_bad)
        self._win_thr += int(thr_bad)
        if lat_bad or thr_bad:
            self.violations += 1

    @property
    def window_checks(self) -> int:
        return len(self._flags)

    @property
    def p99_latency(self) -> float:
        if not self.latencies:
            return 0.0
        xs = sorted(self.latencies)
        return xs[min(len(xs) - 1, int(0.99 * len(xs)))]

    @property
    def violation_rate(self) -> float:
        """Fraction of the last ``window`` observations violating the SLA."""
        return self._win_viol / max(len(self._flags), 1)

    @property
    def latency_violation_rate(self) -> float:
        return self._win_lat / max(len(self._flags), 1)

    @property
    def throughput_violation_rate(self) -> float:
        return self._win_thr / max(len(self._flags), 1)

    def ok(self) -> bool:
        return self.violation_rate < VIOLATION_TOLERANCE

    def report(self) -> Dict[str, float]:
        """The windowed telemetry dict rate-aware codec admission reads
        (:func:`codec_candidates`); the caller may extend it with the
        modeled ``uplink_utilization`` and incumbent ``codec``."""
        import numpy as np
        return {
            "p99_latency_s": self.p99_latency,
            "mean_throughput": (float(np.mean(self.throughputs))
                                if self.throughputs else 0.0),
            "violation_rate": self.violation_rate,
            "latency_violation_rate": self.latency_violation_rate,
            "throughput_violation_rate": self.throughput_violation_rate,
            "window": float(self.window),
            "window_checks": float(self.window_checks),
        }
