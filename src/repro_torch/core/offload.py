"""Dynamic cloud<->edge workload shifting (S2CE O2, S3).

A hysteresis controller re-plans operator placement when the observed
event rate leaves the band the current plan was built for, or the SLA
tracker reports violations. Replanning uses the same cost model as static
placement; hysteresis (enter/exit thresholds + cooldown) prevents
thrashing when the rate oscillates around a cut point.

Decisions carry the full *assignment* — op name -> pool name over the
job's :class:`~repro_torch.core.costmodel.ClusterSpec` — plus the ``frontier``
view: the downward-closed set of op names resident on *any* edge pool.
For a linear pipeline the frontier is exactly the prefix ``ops[:cut]``
and ``cut`` keeps its old meaning; for an operator DAG the frontier can
hold parallel branches independently and ``cut`` reports its size.
Hysteresis and the migration count key on **plan identity** — the pool
assignment (which pool each op runs on, not merely which side of the
cut) together with the uplink codec — so a multi-pool rebalance that
keeps the frontier set but moves ops between pods still counts as a
migration.

**Rate-adaptive codec control** (``sla_spec`` + ``codec_candidates``):
the uplink codec is a runtime control dimension, not a construction-time
constant. On every replan event (``rate_up``/``rate_down``/``sla``) the
controller re-runs codec admission against the *windowed* SLA report
(:func:`repro_torch.core.sla.codec_candidates`), extended with the modeled
bottleneck-link utilization of the *current* plan at the new rate: when
the uplink saturates, every budget-admissible codec enters the plan
search and the winning (frontier, pool-assignment, codec) triple
escalates toward cheaper wire; when violations come from latency or the
link has headroom, admission de-escalates toward lossless. Codec changes
carry their own hysteresis (``codec_cooldown`` decisions between swaps,
plus the saturated/relaxed dead band) so codec flapping cannot thrash.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.core.costmodel import (ClusterSpec, MigrationCost, OperatorCost,
                                  PipelinePlan, ResourcesLike,
                                  migration_cost)
from repro_torch.core.placement import (Objective, place, place_frontier,
                                  stale_pools)
from repro_torch.core.sla import SLA, SLATracker
from repro_torch.core.sla import codec_candidates as sla_codec_candidates


@dataclass
class OffloadDecision:
    step: int
    rate: float
    cut: int                 # edge-resident op count (prefix cut if linear)
    reason: str
    plan: PipelinePlan
    frontier: FrozenSet[str] = frozenset()   # op names on any edge pool
    assignment: Dict[str, str] = field(default_factory=dict)
    codec: str = "identity"                  # uplink codec in force
    # the one-shot price of adopting this decision from the previous
    # plan: every moved op ships its resident state_bytes (raw — state
    # never takes the lossy codec) over the old->new link. Empty for
    # holds, initial plans, and codec-only swaps.
    migration: MigrationCost = field(default_factory=MigrationCost)


@dataclass
class OffloadController:
    ops: List[OperatorCost]
    resources: ResourcesLike
    objective: Objective = field(default_factory=Objective)
    # an OpGraph to plan over frontier cuts; None -> prefix cuts over `ops`
    graph: Optional[object] = None
    # uplink codec the plan executes with (part of plan identity)
    codec: str = "identity"
    # rate-adaptive codec control: the SLA whose error budget gates
    # admission, and the candidate codec names re-admission may pick
    # from. sla_spec=None (or a single candidate) pins the codec — the
    # historical fixed-codec behavior.
    sla_spec: Optional[SLA] = None
    codec_candidates: Optional[List[str]] = None
    headroom: float = 1.3      # replan when rate moves x1.3 outside band
    cooldown: int = 5          # min decisions between migrations
    codec_cooldown: int = 10   # min decisions between codec swaps
    # placement engine for DAG replans ("auto" | "enumerate" | "dp").
    # The controller replans inside the control loop, so it defaults to
    # the polynomial DP — cost-identical to the enumeration with the
    # same canonical tie-break, but it stays fast when the graph or the
    # ClusterSpec grows past toy sizes.
    placement_method: str = "dp"
    planned_rate: float = 0.0
    cut: int = 0
    frontier: FrozenSet[str] = frozenset()
    assignment: Dict[str, str] = field(default_factory=dict)
    _last_change: int = -10**9
    _last_codec_change: int = -10**9
    history: List[OffloadDecision] = field(default_factory=list)

    def __post_init__(self):
        self.set_resources(self.resources)
        if self.codec_candidates is None:
            if self.sla_spec is not None:
                self.codec_candidates = [
                    c.name for c in sla_codec_candidates(self.sla_spec)]
            else:
                self.codec_candidates = [self.codec]
        if self.codec not in self.codec_candidates:
            self.codec_candidates = [self.codec, *self.codec_candidates]

    def set_resources(self, resources: ResourcesLike) -> None:
        """Swap the topology replans run over. The fleet scheduler calls
        this with a *residual* :class:`ClusterSpec` (the shared cluster
        minus other tenants' reservations) before every fleet-arbitrated
        replan, so a tenant controller prices exactly what is left for
        it. Membership churn may also swap in a spec that DROPS a pool
        the incumbent plan uses: :meth:`wants_replan` then fires
        ``pool_lost`` unconditionally and :meth:`hold_decision` refuses,
        so the stale plan can never be silently held."""
        self.resources = ClusterSpec.of(resources)
        self._edge_pools = {r.name for r in self.resources.edge_pools}

    @property
    def _adaptive(self) -> bool:
        return self.sla_spec is not None and len(self.codec_candidates) > 1

    def _identity(self, assignment: Dict[str, str], codec: str
                  ) -> Tuple[Tuple[Tuple[str, str], ...], str]:
        """Plan identity: pool assignment + codec (hashable)."""
        return tuple(sorted(assignment.items())), codec

    def _frontier_of(self, assignment: Dict[str, str]) -> FrozenSet[str]:
        return frozenset(n for n, r in assignment.items()
                         if r in self._edge_pools)

    def _plan(self, rate: float, codecs: Optional[Sequence[str]] = None):
        """Best plan at ``rate`` over the codec candidate names (default:
        the codec currently in force). ``plan.uplink_codec`` records the
        winning codec."""
        codecs = list(codecs) if codecs else [self.codec]
        if self.graph is not None:
            plan, _ = place_frontier(self.graph, self.resources, rate,
                                     self.objective, codecs=codecs,
                                     method=self.placement_method)
        else:
            plan = None
            best_score = float("inf")
            for cname in codecs:
                spec = self.resources.with_uplink_codec(cname)
                cand, _ = place(self.ops, spec, rate, self.objective)
                cand.uplink_codec = cname
                s = self.objective.score(cand)
                if plan is None or s < best_score:
                    plan, best_score = cand, s
        return plan, self._frontier_of(plan.assignment)

    def probe_plan(self, rate: float):
        """Side-effect-free placement probe: the plan :meth:`initial_plan`
        at ``rate`` WOULD take over the current resources, without
        touching controller state. The fleet scheduler's admission check
        prices a candidate tenant through this (after
        :meth:`set_resources` with the residual spec) and only commits
        via :meth:`initial_plan` when the probe meets the SLA."""
        return self._plan(rate)

    def _replan_codecs(self, rate: float, sla: Optional[SLATracker]):
        """A replan with codec re-admission. The saturation signal is
        the bottleneck-link utilization of the best plan under the MOST
        FAITHFUL admissible codec — "what would the lossless wire see" —
        so a compressed incumbent cannot mask a saturated link into a
        bogus de-escalation (an infeasible faithful plan counts as fully
        saturated; a purely compute-infeasible plan escalates too, but
        the search then keeps the most faithful candidate because
        compression does not improve its score)."""
        from repro_torch.core.codecs import get_codec
        cands = [get_codec(n) for n in self.codec_candidates]
        faithful = min(cands, key=lambda c: (c.error_bound, c.ratio)).name
        plan_f, frontier_f = self._plan(rate, [faithful])
        report = dict(sla.report()) if sla is not None else {}
        report.setdefault("violation_rate", 0.0)
        report["codec"] = self.codec
        report["uplink_utilization"] = (
            plan_f.uplink_utilization if plan_f.feasible else float("inf"))
        names = [c.name for c in sla_codec_candidates(
            self.sla_spec, report=report, candidates=cands)]
        if names == [faithful]:
            return plan_f, frontier_f
        # the faithful probe is already the best plan for its codec:
        # search only the remaining candidates and keep the probe when
        # it scores no worse (ties resolve most-faithful-first, matching
        # the combined search) — halves the escalation-path search cost
        rest = [n for n in names if n != faithful]
        plan_r, frontier_r = self._plan(rate, rest)
        if len(rest) < len(names) and \
                self.objective.score(plan_f) <= self.objective.score(plan_r):
            return plan_f, frontier_f
        return plan_r, frontier_r

    def _decide(self, step: int, rate: float, reason: str,
                plan: PipelinePlan, frontier: FrozenSet[str]
                ) -> OffloadDecision:
        return OffloadDecision(step, rate, len(frontier), reason, plan,
                               frontier, dict(plan.assignment), self.codec)

    def initial_plan(self, rate: float, step: int = 0) -> OffloadDecision:
        plan, frontier = self._plan(rate)
        # the initial admission starts the codec-hysteresis clock: the
        # first swap also has to wait out codec_cooldown
        self._last_codec_change = step
        self.planned_rate, self.frontier = rate, frontier
        self.assignment = dict(plan.assignment)
        self.cut = len(frontier)
        d = self._decide(step, rate, "initial", plan, frontier)
        self.history.append(d)
        return d

    def wants_replan(self, step: int, rate: float,
                     sla: Optional[SLATracker] = None) -> Optional[str]:
        """Pure trigger check (no state change): the replan reason a call
        to :meth:`observe` at these arguments would act on, or ``None``
        for a hold. Split out so a fleet scheduler can *collect* triggers
        across tenants and batch them into one arbitration pass instead
        of letting every tenant replan the moment it fires."""
        if not self.history:
            return "initial"
        if stale_pools(self.assignment, self.resources):
            # membership churn removed a pool the incumbent plan still
            # references: replan unconditionally — no band or cooldown
            # gate may hold a plan whose pool no longer exists
            return "pool_lost"
        out_of_band = (rate > self.planned_rate * self.headroom
                       or rate < self.planned_rate / self.headroom)
        sla_bad = sla is not None and not sla.ok()
        if (not out_of_band and not sla_bad) or \
                step - self._last_change < self.cooldown:
            return None
        return "sla" if sla_bad else (
            "rate_up" if rate > self.planned_rate else "rate_down")

    def hold_decision(self, step: int, rate: float) -> OffloadDecision:
        """The no-change decision (not appended to history, matching the
        historical observe() hold path). Raises when the incumbent plan
        references a pool that left the topology — holding such a plan
        would execute ops on a pool that no longer exists."""
        stale = stale_pools(self.assignment, self.resources)
        if stale:
            raise ValueError(
                f"cannot hold a plan placed on departed pool(s) {stale}: "
                "the topology no longer contains them; replan first")
        return OffloadDecision(step, rate, self.cut, "hold",
                               self.history[-1].plan, self.frontier,
                               dict(self.assignment), self.codec)

    def replan(self, step: int, rate: float,
               sla: Optional[SLATracker] = None,
               reason: Optional[str] = None) -> OffloadDecision:
        """Execute a replan event: re-run codec admission against the
        windowed SLA report; when admission widens or moves the candidate
        set, the (frontier x pool x codec) search decides. Codec
        hysteresis: within codec_cooldown of the last swap only the
        incumbent codec is searched. Callers normally go through
        :meth:`observe`; the fleet scheduler calls this directly (after
        :meth:`set_resources` with the tenant's residual spec) for the
        tenants its arbitration pass granted a replan."""
        if not self.history:
            return self.initial_plan(rate, step=step)
        if reason is None:
            reason = ("sla" if sla is not None and not sla.ok() else
                      "rate_up" if rate > self.planned_rate else "rate_down")
        old_identity = self._identity(self.assignment, self.codec)
        old_assign = dict(self.assignment)
        if self._adaptive and \
                step - self._last_codec_change >= self.codec_cooldown:
            plan, frontier = self._replan_codecs(rate, sla)
        else:
            plan, frontier = self._plan(rate)
        new_codec = plan.uplink_codec or self.codec
        if new_codec != self.codec:
            self.codec = new_codec
            self._last_codec_change = step
        mig = MigrationCost()
        if self._identity(plan.assignment, self.codec) != old_identity:
            self._last_change = step
            # price the state move this adoption implies (ops whose pool
            # changed ship their resident bytes over the old->new link)
            mig = migration_cost(self.ops, old_assign, plan.assignment,
                                 self.resources)
        self.planned_rate, self.frontier = rate, frontier
        self.assignment = dict(plan.assignment)
        self.cut = len(frontier)
        d = self._decide(step, rate, reason, plan, frontier)
        d.migration = mig
        self.history.append(d)
        return d

    def observe(self, step: int, rate: float,
                sla: Optional[SLATracker] = None) -> OffloadDecision:
        """Called periodically with the measured ingest rate."""
        if not self.history:
            # observe() before initial_plan() used to IndexError on
            # history[-1]; take the initial plan lazily instead
            return self.initial_plan(rate, step=step)
        reason = self.wants_replan(step, rate, sla)
        if reason is None:
            return self.hold_decision(step, rate)
        return self.replan(step, rate, sla, reason)

    def migrations(self) -> int:
        ids = [(tuple(sorted(d.assignment.items())), d.codec)
               for d in self.history]
        return sum(1 for a, b in zip(ids, ids[1:]) if a != b)
