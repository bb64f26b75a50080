"""Multi-tenant fleet scheduling: N concurrent stream jobs over ONE
shared :class:`~repro_torch.core.costmodel.ClusterSpec` (S2CE's "many
concurrent ML/DL workloads" promise; the multi-application elasticity
problem of the resource-elasticity survey, arxiv 1709.01363, and ECHO's
adaptive multi-dataflow orchestration, arxiv 1707.00889).

Three layers:

* :class:`FleetLedger` — per-tenant reservations against the shared
  topology. Each admitted tenant holds a fraction of every pool it uses
  and bytes/s on every link it crosses, all expressed against the
  ORIGINAL capacities, so the invariant "no link's summed per-tenant
  reserved bytes exceeds its capacity" (and likewise pool fractions
  vs. 1.0) is checkable by direct summation. The ledger derives the
  **residual** :class:`ClusterSpec` a tenant's placement search may
  assume — :meth:`ClusterSpec.residual` shrinks pool rates by the other
  tenants' shares and link bandwidth by their reserved bytes, so
  ``evaluate_graph_plan`` prices the tenant against what is actually
  left, not the whole cluster.

* :class:`FleetScheduler` — admission control and fleet-batched replan
  arbitration over :class:`~repro_torch.core.offload.OffloadController`
  handles. Admission probes the tenant's best plan (the controller's
  own placement engine, ``place_frontier(method="dp")`` for DAGs) under
  residual capacity and REJECTS (or queues) a tenant whose best plan
  cannot meet its SLA — with a loud reason, never a silent degrade.
  Replans batch globally: each arbitration pass collects every tenant's
  replan trigger (:meth:`OffloadController.wants_replan`), grants them
  in priority order under per-tenant fleet cooldowns, and holds the
  rest — one tenant's codec escalation or migration re-prices ITS
  residual slice without stampeding the others into replans they did
  not ask for.

* :class:`FleetOrchestrator` — steps all admitted jobs round-robin
  (each tenant a real :class:`~repro_torch.core.orchestrator.Orchestrator`
  with its own `SLATracker` window and `JobMetrics`), routing every
  control decision through one arbitration pass per round. Tenants may
  join and leave mid-run; a departure returns its reservations to the
  ledger and immediately re-attempts admission for queued tenants (the
  "within one arbitration pass" contract).

Differential contract (tested): a fleet of ONE tenant prices against a
residual spec with zero foreign load — :meth:`ClusterSpec.residual`
then returns the very same pool/link objects — and the fleet round
drives exactly the standalone run-loop sequence (execute ->
wants_replan/replan-or-hold -> apply -> elastic), so plans, codec
trajectory, and migration history are identical to a standalone
:class:`StreamJob` on the same spec.

The JAX package's ``core/fleet.py`` in the port. Scheduling and the
ledger are host-side; each tenant's ``StreamJob.device`` decides where
that tenant's states, batches and uplink residuals live (the card by
default, as for every entry point of the port), and an involuntary
rescale brings its states back there.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.core import membership as ms
from repro_torch.core.costmodel import ClusterSpec, PipelinePlan
from repro_torch.core.offload import OffloadController, OffloadDecision
from repro_torch.core.orchestrator import JobMetrics, Orchestrator, StreamJob
from repro_torch.core.sla import SLA, SLATracker, plan_violation


@dataclass(frozen=True)
class TenantSpec:
    """What a tenant asks the fleet for."""
    name: str
    priority: int = 1          # tier: LOWER is more important (0 = premium)
    sla: SLA = field(default_factory=SLA)
    demand_rate: float = 1e4   # events/s admission must support
    # fleet-level hysteresis: arbitration passes a granted replan blocks
    # further grants for this tenant. 0 = only the controller's own
    # cooldown/codec_cooldown govern (the single-tenant parity default).
    replan_cooldown: int = 0


@dataclass
class AdmissionResult:
    name: str
    admitted: bool
    reason: str                      # "admitted" or the loud rejection
    queued: bool = False
    decision: Optional[OffloadDecision] = None


@dataclass
class Reservation:
    """One tenant's booked slice, in ORIGINAL-capacity units (fractions
    of each pool, bytes/s of each link, resident state bytes per pool)
    so fleet-wide sums are directly comparable to the spec's capacity."""
    pool_frac: Dict[str, float] = field(default_factory=dict)
    link_bytes: Dict[Tuple[str, str], float] = field(default_factory=dict)
    state_bytes: Dict[str, float] = field(default_factory=dict)


class FleetLedger:
    """Per-tenant capacity bookkeeping over one shared ClusterSpec.

    Reservations are derived from a plan priced on the tenant's residual
    spec: a pool utilization ``u`` of the residual capacity converts to
    ``u * (1 - sum(others))`` of the original pool, and a link
    utilization ``lu`` of the residual bandwidth to ``lu * (orig_bw -
    others_bytes)`` bytes/s — so feasible plans (``u, lu <= 1``) can
    never push a fleet-wide sum past the original capacity (the sums
    telescope). Infeasible plans are clamped at the residual remainder
    and flagged, never silently over-booked.
    """

    def __init__(self, spec) -> None:
        self.spec = ClusterSpec.of(spec)
        self.reservations: Dict[str, Reservation] = {}

    # -- aggregate loads (optionally excluding one tenant) ------------------
    def pool_load(self, exclude: Optional[str] = None) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, r in self.reservations.items():
            if name == exclude:
                continue
            for pool, f in r.pool_frac.items():
                out[pool] = min(out.get(pool, 0.0) + f, 1.0)
        return out

    def link_load(self, exclude: Optional[str] = None
                  ) -> Dict[Tuple[str, str], float]:
        out: Dict[Tuple[str, str], float] = {}
        for name, r in self.reservations.items():
            if name == exclude:
                continue
            for key, b in r.link_bytes.items():
                out[key] = out.get(key, 0.0) + b
        return out

    def state_load(self, exclude: Optional[str] = None) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, r in self.reservations.items():
            if name == exclude:
                continue
            for pool, b in r.state_bytes.items():
                out[pool] = out.get(pool, 0.0) + b
        return out

    def residual_spec(self, exclude: Optional[str] = None) -> ClusterSpec:
        """The spec a tenant's placement may assume: everything minus the
        OTHER tenants' reservations (zero foreign load returns the pool
        and link objects of the base spec unchanged — the single-tenant
        bitwise-parity path)."""
        return self.spec.residual(pool_load=self.pool_load(exclude),
                                  link_load=self.link_load(exclude),
                                  pool_state_bytes=self.state_load(exclude))

    # -- booking ------------------------------------------------------------
    def reserve(self, tenant: str, plan: PipelinePlan,
                state_bytes: Optional[Mapping[str, float]] = None
                ) -> Reservation:
        """Book ``tenant``'s slice from a plan priced on its residual
        spec (replacing any prior booking). Returns the reservation; an
        infeasible plan books the clamped residual remainder and the
        clamp is recorded in the reservation maps by construction."""
        others_pool = self.pool_load(exclude=tenant)
        others_link = self.link_load(exclude=tenant)
        pool_frac = {}
        for pool, u in plan.utilization.items():
            if u <= 0.0:
                continue
            share = max(1.0 - others_pool.get(pool, 0.0), 0.0)
            pool_frac[pool] = min(u, 1.0) * share
        link_bytes = {}
        for key, lu in plan.link_utilization.items():
            if lu <= 0.0:
                continue
            orig = self.spec.link(*key).bw
            resid = max(orig - others_link.get(key, 0.0), 0.0)
            link_bytes[key] = min(lu, 1.0) * resid
        res = Reservation(pool_frac, link_bytes,
                          {p: float(b) for p, b in (state_bytes or {}).items()
                           if b > 0.0})
        self.reservations[tenant] = res
        return res

    def release(self, tenant: str) -> Optional[Reservation]:
        return self.reservations.pop(tenant, None)

    # -- membership churn ----------------------------------------------------
    def set_spec(self, spec) -> None:
        """Re-point the ledger at a new topology generation (a join or a
        probe-driven latency refresh). Every existing reservation must
        still reference known pools — a DEPARTURE must go through
        :meth:`drop_pool`, which scrubs the dead pool's bookings."""
        new = ClusterSpec.of(spec)
        for name, r in self.reservations.items():
            missing = sorted(
                (set(r.pool_frac) | set(r.state_bytes)
                 | {p for key in r.link_bytes for p in key})
                - set(new.pools))
            if missing:
                raise ValueError(
                    f"set_spec: tenant {name!r} still books on pool(s) "
                    f"{missing} absent from the new spec; scrub "
                    "departures through drop_pool")
        self.spec = new

    def drop_pool(self, pool: str, spec=None) -> List[str]:
        """A pool left or failed: scrub every reservation's bookings on
        it (pool fraction, resident state, link bytes on any link
        touching it) and re-point at the survivor spec (derived via
        :meth:`ClusterSpec.without_pool` unless given). Returns the
        tenants whose bookings were touched — exactly the set whose
        plans the scheduler must re-probe."""
        new = ClusterSpec.of(spec) if spec is not None else \
            self.spec.without_pool(pool)
        if pool in new.pools:
            raise ValueError(
                f"drop_pool: new spec still contains pool {pool!r}")
        touched = []
        for name, r in self.reservations.items():
            hit = r.pool_frac.pop(pool, None) is not None
            hit = (r.state_bytes.pop(pool, None) is not None) or hit
            for key in [k for k in r.link_bytes if pool in k]:
                r.link_bytes.pop(key)
                hit = True
            if hit:
                touched.append(name)
        self.spec = new
        return touched

    # -- invariants (property-tested) ---------------------------------------
    def check(self, tol: float = 1e-9) -> List[str]:
        """Capacity-invariant violations across ALL tenants (empty =
        healthy): summed pool fractions vs 1.0 and summed link bytes/s
        vs each link's original bandwidth."""
        bad = []
        for pool, f in self.pool_load().items():
            if f > 1.0 + tol:
                bad.append(f"pool {pool!r} booked {f:.6f} > 1.0")
        for (src, dst), b in self.link_load().items():
            cap = self.spec.link(src, dst).bw
            if b > cap + tol * max(cap, 1.0):
                bad.append(f"link {src}->{dst} booked {b:.6g} B/s "
                           f"> capacity {cap:.6g} B/s")
        return bad


class _Tenant:
    """Internal per-tenant scheduler state."""

    def __init__(self, spec: TenantSpec, controller: OffloadController,
                 tracker: Optional[SLATracker] = None) -> None:
        self.spec = spec
        self.controller = controller
        self.tracker = tracker
        self.last_grant: Optional[int] = None


class FleetScheduler:
    """Admission control + fleet-batched replan arbitration.

    Works on bare :class:`OffloadController` handles so it can be
    driven without executing pipelines (property tests, capacity
    planning); :class:`FleetOrchestrator` wires it to real running
    jobs. ``log`` carries the loud audit trail (admissions, rejections,
    grants, cooldown holds, clamped over-capacity replans)."""

    def __init__(self, spec) -> None:
        self.ledger = FleetLedger(spec)
        self.tenants: Dict[str, _Tenant] = {}
        # rejected-but-queued tenants, FIFO within priority
        self.queue: List[_Tenant] = []
        self.log: List[str] = []

    @property
    def admitted(self) -> List[str]:
        return list(self.tenants)

    @property
    def queued(self) -> List[str]:
        return [t.spec.name for t in self.queue]

    def _state_bytes(self, t: _Tenant, plan: PipelinePlan
                     ) -> Dict[str, float]:
        by_name = {op.name: op.state_bytes for op in t.controller.ops}
        out: Dict[str, float] = {}
        for op, pool in plan.assignment.items():
            out[pool] = out.get(pool, 0.0) + by_name.get(op, 0.0)
        return out

    def _try_admit(self, t: _Tenant) -> AdmissionResult:
        spec = t.spec
        residual = self.ledger.residual_spec()
        t.controller.set_resources(residual)
        plan, _ = t.controller.probe_plan(spec.demand_rate)
        why = plan_violation(plan, spec.sla)
        if why is not None:
            reason = (f"tenant {spec.name!r} cannot be admitted at "
                      f"demand_rate={spec.demand_rate:g} ev/s: {why}")
            return AdmissionResult(spec.name, False, reason)
        d = t.controller.initial_plan(spec.demand_rate)
        self.ledger.reserve(spec.name, d.plan,
                            self._state_bytes(t, d.plan))
        self.tenants[spec.name] = t
        self.log.append(f"admit {spec.name} (tier {spec.priority}, "
                        f"rate {spec.demand_rate:g})")
        return AdmissionResult(spec.name, True, "admitted", decision=d)

    def submit(self, spec: TenantSpec, controller: OffloadController,
               tracker: Optional[SLATracker] = None,
               queue: bool = True) -> AdmissionResult:
        """Admission-control a tenant. On rejection the tenant is queued
        (unless ``queue=False``) and re-considered whenever capacity
        returns (:meth:`leave`)."""
        if spec.name in self.tenants or spec.name in self.queued:
            raise ValueError(f"tenant {spec.name!r} already submitted")
        t = _Tenant(spec, controller, tracker)
        res = self._try_admit(t)
        if not res.admitted:
            self.log.append(res.reason + ("; queued" if queue else ""))
            if queue:
                self.queue.append(t)
                res.queued = True
        return res

    def drain_queue(self) -> List[AdmissionResult]:
        """Re-attempt admission for queued tenants in priority order
        (FIFO within a tier). Runs inside :meth:`leave` so a departure
        re-admits waiting tenants within the same arbitration pass."""
        admitted: List[AdmissionResult] = []
        remaining: List[_Tenant] = []
        for t in sorted(self.queue, key=lambda t: t.spec.priority):
            res = self._try_admit(t)
            if res.admitted:
                admitted.append(res)
            else:
                remaining.append(t)
        # preserve original FIFO order among the still-queued
        self.queue = [t for t in self.queue if t in remaining]
        return admitted

    def leave(self, name: str) -> List[AdmissionResult]:
        """A tenant departs: release its reservations and immediately
        re-attempt admission for the queue. Returns the re-admissions."""
        t = self.tenants.pop(name, None)
        if t is None:
            # allow cancelling a queued tenant too
            self.queue = [q for q in self.queue if q.spec.name != name]
            return []
        self.ledger.release(name)
        self.log.append(f"leave {name}")
        return self.drain_queue()

    # -- membership churn ----------------------------------------------------
    def pool_joined(self, spec) -> List[AdmissionResult]:
        """Capacity joined the fleet: re-point the shared ledger at the
        new topology and immediately re-attempt admission for the queue
        (priority order, FIFO within a tier — the same contract as a
        departure's re-admission pass)."""
        self.ledger.set_spec(spec)
        self.log.append(
            f"topology: capacity joined (spec v{self.ledger.spec.version})"
            "; re-draining queue")
        return self.drain_queue()

    def pool_lost(self, pool: str, spec, step: int,
                  offered: Optional[Mapping[str, float]] = None
                  ) -> Dict[str, OffloadDecision]:
        """A pool left or failed: scrub its ledger bookings, then force
        a replan for every admitted tenant whose EXECUTING plan touched
        it — in priority order, each re-priced against its residual
        slice of the survivor spec and re-booked. Unaffected tenants
        keep their plans and reservations untouched (their controllers
        pick up the survivor spec at their next granted replan).
        Returns the forced decisions, keyed by tenant."""
        offered = dict(offered or {})
        self.ledger.drop_pool(pool, spec)
        affected = sorted(
            (t.spec.priority, i, name)
            for i, (name, t) in enumerate(self.tenants.items())
            if pool in set(t.controller.assignment.values()))
        decisions: Dict[str, OffloadDecision] = {}
        for _, _, name in affected:
            t = self.tenants[name]
            rate = float(offered.get(name, t.spec.demand_rate))
            self.ledger.release(name)
            t.controller.set_resources(self.ledger.residual_spec())
            d = t.controller.replan(step, rate, t.tracker,
                                    reason="pool_lost")
            self.ledger.reserve(name, d.plan,
                                self._state_bytes(t, d.plan))
            t.last_grant = step
            decisions[name] = d
            note = "" if d.plan.feasible else \
                " [OVER CAPACITY: booked clamped residual remainder]"
            self.log.append(
                f"{step}: pool {pool!r} lost -> forced replan {name} "
                f"codec={d.codec} cut={d.cut}{note}")
        if not affected:
            self.log.append(
                f"{step}: pool {pool!r} lost; no admitted plan touched it")
        return decisions

    def arbitrate(self, step: int, offered: Mapping[str, float]
                  ) -> Dict[str, OffloadDecision]:
        """ONE fleet-batched control pass: collect every admitted
        tenant's replan trigger, grant the triggered ones in priority
        order (each re-priced against its residual spec, its reservation
        re-booked), hold everyone else. Per-tenant ``replan_cooldown``
        blocks back-to-back grants; an over-capacity replan books the
        clamped remainder and is logged loudly. Returns a decision per
        admitted tenant — exactly what ``controller.observe`` would have
        produced, but synchronized fleet-wide."""
        decisions: Dict[str, OffloadDecision] = {}
        wants: List[Tuple[int, int, str, str, float]] = []
        for i, (name, t) in enumerate(self.tenants.items()):
            rate = float(offered.get(name, t.spec.demand_rate))
            reason = t.controller.wants_replan(step, rate, t.tracker)
            if reason is None:
                decisions[name] = t.controller.hold_decision(step, rate)
            elif (t.spec.replan_cooldown > 0 and t.last_grant is not None
                  and step - t.last_grant < t.spec.replan_cooldown):
                decisions[name] = t.controller.hold_decision(step, rate)
                self.log.append(
                    f"{step}: {name} wants replan ({reason}) but fleet "
                    f"cooldown holds until "
                    f"{t.last_grant + t.spec.replan_cooldown}")
            else:
                wants.append((t.spec.priority, i, name, reason, rate))
        # priority tiers first (lower tier number wins), admission order
        # within a tier — deterministic, no stampede: each grant re-prices
        # only ITS tenant; the others keep their plans and reservations
        for _, _, name, reason, rate in sorted(wants):
            t = self.tenants[name]
            self.ledger.release(name)
            t.controller.set_resources(self.ledger.residual_spec())
            d = t.controller.replan(step, rate, t.tracker, reason)
            self.ledger.reserve(name, d.plan,
                                self._state_bytes(t, d.plan))
            t.last_grant = step
            decisions[name] = d
            note = "" if d.plan.feasible else \
                " [OVER CAPACITY: booked clamped residual remainder]"
            self.log.append(f"{step}: grant {name} replan ({reason}) "
                            f"codec={d.codec} cut={d.cut}{note}")
        return decisions


class FleetOrchestrator:
    """Round-robin execution of admitted tenant jobs over one shared
    cluster, with fleet-arbitrated control.

    Per round each tenant executes one batch through its own
    :class:`Orchestrator` (own pipeline state, `SLATracker` window,
    `JobMetrics`), then ONE :meth:`FleetScheduler.arbitrate` pass
    produces every tenant's decision, which is applied alongside the
    tenant's elastic sizing step — the standalone run-loop order, fleet
    synchronized."""

    def __init__(self, cluster=None, membership=None) -> None:
        if (cluster is None) == (membership is None):
            raise ValueError("FleetOrchestrator takes exactly one of "
                             "cluster= (static) or membership= (live "
                             "MembershipDirectory)")
        self.membership = membership
        # the fleet drains topology events CENTRALLY (one subscription,
        # one ledger scrub, one forced-replan pass) — tenant jobs get
        # static spec snapshots, not their own subscriptions
        self._topo_sub = (membership.subscribe()
                          if membership is not None else None)
        self.cluster = ClusterSpec.of(
            membership.spec if membership is not None else cluster)
        self.scheduler = FleetScheduler(self.cluster)
        self.orchestrators: Dict[str, Orchestrator] = {}
        # queued tenants waiting for capacity: name -> (spec, orch, seed)
        self._waiting: Dict[str, Tuple[TenantSpec, Orchestrator, int]] = {}
        self.step = 0

    def add_tenant(self, spec: TenantSpec, job: StreamJob,
                   seed: int = 0) -> AdmissionResult:
        """Admission-control a job into the fleet. The job runs over the
        SHARED cluster (its own ``cluster`` field, if set, must be the
        fleet's). Admitted jobs are armed immediately (the admission
        decision IS the initial plan — taken once, through the job's own
        controller); rejected jobs queue for capacity."""
        if job.membership is not None:
            raise ValueError(
                f"tenant {spec.name!r} job carries its own membership "
                "directory; the fleet drains topology events centrally "
                "— pass membership= to FleetOrchestrator instead")
        if job.cluster is None:
            job = replace(job, cluster=self.cluster, sla=spec.sla)
        elif ClusterSpec.of(job.cluster) is not self.cluster and \
                dict(ClusterSpec.of(job.cluster).pools) != \
                dict(self.cluster.pools):
            raise ValueError(
                f"tenant {spec.name!r} job declares a different cluster "
                "than the fleet's shared spec")
        orch = Orchestrator(job)
        res = self.scheduler.submit(spec, orch.controller, tracker=orch.sla)
        if res.admitted:
            orch.begin(spec.demand_rate, seed=seed, decision=res.decision)
            self.orchestrators[spec.name] = orch
        elif res.queued:
            self._waiting[spec.name] = (spec, orch, seed)
        return res

    def _activate(self, admissions: List[AdmissionResult]) -> None:
        for res in admissions:
            spec, orch, seed = self._waiting.pop(res.name)
            if self.membership is not None:
                # the tenant may have queued under an older topology
                # generation; align it with the spec it was admitted on
                orch.set_cluster(self.cluster)
            orch.begin(spec.demand_rate, seed=seed, decision=res.decision)
            self.orchestrators[spec.name] = orch

    def leave(self, name: str
              ) -> Tuple[Optional[JobMetrics], List[AdmissionResult]]:
        """A tenant departs mid-run: finalize its metrics, return its
        capacity, and activate any queued tenants the freed capacity
        admits — all within this one pass."""
        orch = self.orchestrators.pop(name, None)
        metrics = orch.finish() if orch is not None else None
        admissions = self.scheduler.leave(name)
        self._activate(admissions)
        return metrics, admissions

    def step_round(self, batches: Mapping[str, object],
                   rates: Optional[Mapping[str, float]] = None,
                   record_outputs: bool = False) -> Dict[str, float]:
        """One fleet round: every admitted tenant with a batch executes
        it, then one arbitration pass decides and applies all control.
        ``rates`` optionally overrides the offered rate per tenant (the
        standalone ``rate_fn`` analogue); default is the measured rate.
        Returns the measured rates."""
        step = self.step
        # membership churn first: a dead pool's ledger bookings and plans
        # must be scrubbed (and its tenants' states carried through the
        # rescale checkpoint) before any batch executes this
        # round; joined capacity re-admits the queue before it steps
        if self._topo_sub is not None:
            self.membership.tick(step)
            for ev in self._topo_sub.poll():
                self._apply_topology_event(step, ev, rates or {})
        measured: Dict[str, float] = {}
        for name, orch in self.orchestrators.items():
            if name in batches:
                measured[name] = orch.execute_batch(
                    step, batches[name], record_outputs)
        offered = {
            name: float((rates or {}).get(name, measured.get(
                name, self.scheduler.tenants[name].spec.demand_rate)))
            for name in self.orchestrators}
        decisions = self.scheduler.arbitrate(step, offered)
        for name, orch in self.orchestrators.items():
            d = decisions.get(name)
            if d is not None:
                orch.apply_decision(step, d)
            if name in measured:
                orch.elastic_step(step, offered[name], measured[name])
        self.step += 1
        return measured

    def _apply_topology_event(self, step: int, ev,
                              offered: Mapping[str, float]) -> None:
        """React to one membership event fleet-wide: the scheduler
        scrubs the ledger and forces replans (pool loss) or re-drains
        the queue (join); each affected tenant orchestrator rides the
        involuntary checkpoint-rescale path before adopting its forced
        decision; every orchestrator's candidate set moves to the new
        topology generation."""
        spec_now = self.membership.spec
        self.cluster = spec_now
        if ev.kind in (ms.POOL_FAILED, ms.POOL_LEFT):
            lost = ev.subject
            decisions = self.scheduler.pool_lost(lost, spec_now, step,
                                                 offered)
            for name, orch in self.orchestrators.items():
                d = decisions.get(name)
                orch.metrics.decisions.append(
                    f"{step}:topology {ev.kind} {lost} v{ev.version}"
                    + (" [in plan]" if d is not None else ""))
                if d is not None and \
                        lost in set(orch._exec_assignment.values()):
                    plan = orch.elastic.involuntary(
                        step, reason=f"pool {lost} {ev.kind}")
                    orch._apply_rescale(step, plan)
                orch.set_cluster(spec_now)
                if d is not None:
                    orch.apply_decision(step, d)
        elif ev.kind == ms.POOL_JOINED:
            for orch in self.orchestrators.values():
                orch.metrics.decisions.append(
                    f"{step}:topology pool_joined {ev.subject} "
                    f"v{ev.version}")
                orch.set_cluster(spec_now)
            self._activate(self.scheduler.pool_joined(spec_now))
        elif ev.kind == ms.LINK_UPDATE:
            self.scheduler.ledger.set_spec(spec_now)
            for orch in self.orchestrators.values():
                orch.set_cluster(spec_now)

    def finish(self) -> Dict[str, JobMetrics]:
        """Finalize all still-admitted tenants (does not release their
        reservations — call :meth:`leave` per tenant for churn)."""
        return {name: orch.finish()
                for name, orch in self.orchestrators.items()}
