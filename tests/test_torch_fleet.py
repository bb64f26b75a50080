"""The port's multi-tenant fleet (``repro_torch.core.fleet``) on the CPU:
every test of the JAX package's ``tests/test_fleet.py`` run against the
port with ``device="cpu"``, then the two packages side by side: the
scheduler under the same random churn (admissions, queues, ledger
bookings and audit log equal), and a membership-backed fleet of the
fleet example's tenants, one pool failing mid-run, on the same numpy
batches (admitted and queued sets, ledger bookings, audit log and each
tenant's ``JobMetrics`` equal, preq within 1e-4, decisions after the
mesh/devices normalisation of ``test_torch_membership.py``)."""

import random

import numpy as np
import pytest
import torch

import jax

from repro.core import costmodel as jcm
from repro.core import fleet as jfleet
from repro.core import membership as jms
from repro.core import offload as joff
from repro.core import orchestrator as jorch
from repro.core import pipeline as jpl
from repro.core import sla as jsla
from repro.streams import generators as jgen

from repro_torch._tree import tree_leaves
from repro_torch.core import costmodel as cm
from repro_torch.core import fleet as tfleet
from repro_torch.core import membership as tms
from repro_torch.core import offload as toff
from repro_torch.core import orchestrator as torch_orch
from repro_torch.core import pipeline as pl
from repro_torch.core import sla as tsla
from repro_torch.core.fleet import (FleetOrchestrator, FleetScheduler,
                                    TenantSpec)
from repro_torch.core.offload import OffloadController
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.sla import SLA, pick_codec
from repro_torch.streams import generators as tgen
from repro_torch.streams.generators import HyperplaneStream

from test_torch_orchestrator import _compare_metrics


def StreamJob(*args, **kw):
    """The port's StreamJob on the CPU (its default is the card)."""
    return torch_orch.StreamJob(*args, device="cpu", **kw)


LOOSE = SLA(max_latency_s=1e3, error_budget=11.0)


def two_pool_spec(**link_kw) -> cm.ClusterSpec:
    links = [cm.Link("edge", "cloud", **link_kw)] if link_kw else []
    return cm.ClusterSpec(pools=[cm.EDGE_NODE, cm.CLOUD_POD], links=links)


def make_controller(spec, sla=LOOSE, dim=8, **kw) -> OffloadController:
    # start from the codec static admission picks, exactly like the
    # Orchestrator does — calibrated link sizes then transfer between
    # scheduler-level and orchestrator-level tests
    kw.setdefault("codec", pick_codec(sla).name)
    return OffloadController(pl.standard_stream_pipeline(dim=dim).costs(),
                             spec, sla_spec=sla, **kw)


def _batches(n, dim=8, n_per=32, seed=0):
    gen = HyperplaneStream(dim=dim, seed=seed, horizon=n * n_per)
    return [gen.batch(i, n_per) for i in range(n)]


# ---------------------------------------------------------------------------
# residual-capacity pricing (ClusterSpec.residual)
# ---------------------------------------------------------------------------

def test_residual_zero_load_returns_identical_objects():
    """The single-tenant bitwise-parity path: no foreign load means the
    residual spec carries the very same pool and link objects."""
    spec = two_pool_spec(bw=1e9, latency=20e-3)
    r = spec.residual()
    assert r["edge"] is spec["edge"] and r["cloud"] is spec["cloud"]
    assert r.link("edge", "cloud") is spec.link("edge", "cloud")


def test_residual_scales_pool_rates_and_link_bw():
    spec = two_pool_spec(bw=1e9, latency=20e-3)
    r = spec.residual(pool_load={"edge": 0.75},
                      link_load={("edge", "cloud"): 4e8},
                      pool_state_bytes={"cloud": 256e9})
    assert r["edge"].flops == pytest.approx(cm.EDGE_NODE.flops * 0.25)
    assert r["edge"].mem_bw == pytest.approx(cm.EDGE_NODE.mem_bw * 0.25)
    assert r.link("edge", "cloud").bw == pytest.approx(6e8)
    # state shrinks per-chip mem_cap
    assert r["cloud"].mem_cap == pytest.approx(
        cm.CLOUD_POD.mem_cap - 256e9 / cm.CLOUD_POD.chips)
    # untouched dimensions pass through
    assert r["cloud"].flops == cm.CLOUD_POD.flops
    assert r.link("edge", "cloud").latency == 20e-3


def test_residual_fully_reserved_pool_prices_infeasible_not_div0():
    spec = two_pool_spec()
    r = spec.residual(pool_load={"edge": 1.0})
    # epsilon share, not zero: no div-by-zero, but hopelessly slow
    assert 0.0 < r["edge"].flops <= cm.EDGE_NODE.flops * 1e-6
    plan = cm.evaluate_plan(pl.standard_stream_pipeline(dim=8).costs(),
                            {op.name: "edge" for op in
                             pl.standard_stream_pipeline(dim=8).costs()
                             if True},
                            r, rate=1e4)
    assert not plan.feasible


def test_residual_validates_inputs():
    spec = two_pool_spec()
    with pytest.raises(ValueError, match="unknown pool"):
        spec.residual(pool_load={"nope": 0.5})
    with pytest.raises(ValueError, match="not in"):
        spec.residual(pool_load={"edge": 1.5})
    with pytest.raises(ValueError, match="unknown link"):
        spec.residual(link_load={("edge", "nope"): 1.0})


def test_second_tenant_prices_against_residual_not_whole_link():
    """The same demand rate costs MORE uplink utilization once another
    tenant holds part of the link — evaluate_graph_plan via the residual
    spec sees only what is left."""
    spec = two_pool_spec(bw=1e9, latency=20e-3)
    sched = FleetScheduler(spec)
    c0 = make_controller(spec)
    r0 = sched.submit(TenantSpec("t0", sla=LOOSE, demand_rate=2e4), c0)
    assert r0.admitted
    alone_util = r0.decision.plan.uplink_utilization
    booked = sum(sched.ledger.link_load().values())
    assert booked > 0.0
    c1 = make_controller(spec)
    r1 = sched.submit(TenantSpec("t1", sla=LOOSE, demand_rate=2e4), c1)
    assert r1.admitted
    # identical demand, but priced on (bw - t0's bytes): utilization up
    assert r1.decision.plan.uplink_utilization > alone_util
    resid_bw = sched.ledger.spec.link("edge", "cloud").bw - booked
    assert c1.resources.link("edge", "cloud").bw == pytest.approx(resid_bw)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

def test_overdemand_tenant_rejected_with_loud_reason():
    sched = FleetScheduler(two_pool_spec())
    res = sched.submit(TenantSpec("hog", sla=LOOSE, demand_rate=1e9),
                       make_controller(two_pool_spec()), queue=False)
    assert not res.admitted and not res.queued
    assert "hog" in res.reason and "cannot be admitted" in res.reason
    assert "infeasible" in res.reason
    assert "1e+09" in res.reason  # the demand it failed at
    assert "hog" not in sched.admitted and "hog" not in sched.queued
    # the rejection is also in the audit log
    assert any("hog" in line for line in sched.log)


def test_latency_sla_rejection_names_the_clause():
    tight = SLA(max_latency_s=1e-9, error_budget=11.0)
    sched = FleetScheduler(two_pool_spec())
    res = sched.submit(TenantSpec("t", sla=tight, demand_rate=1e4),
                       make_controller(two_pool_spec(), sla=tight),
                       queue=False)
    assert not res.admitted
    assert "exceeds SLA" in res.reason and "latency" in res.reason


def test_duplicate_submit_rejected():
    sched = FleetScheduler(two_pool_spec())
    sched.submit(TenantSpec("a", sla=LOOSE), make_controller(two_pool_spec()))
    with pytest.raises(ValueError, match="already submitted"):
        sched.submit(TenantSpec("a", sla=LOOSE),
                     make_controller(two_pool_spec()))


def test_departure_readmits_queued_tenant_within_one_pass():
    """A link sized for ONE tenant: the second queues at admission; the
    first tenant's departure must re-admit it in the same pass."""
    spec, rate = _one_tenant_link_spec()
    sched = FleetScheduler(spec)
    a = sched.submit(TenantSpec("a", sla=LOOSE, demand_rate=rate),
                     make_controller(spec))
    assert a.admitted
    b = sched.submit(TenantSpec("b", sla=LOOSE, demand_rate=rate),
                     make_controller(spec))
    assert not b.admitted and b.queued
    assert sched.queued == ["b"]
    out = sched.leave("a")
    assert [(r.name, r.admitted) for r in out] == [("b", True)]
    assert sched.admitted == ["b"] and sched.queued == []
    assert sched.ledger.check() == []


def _one_tenant_link_spec():
    """A spec whose uplink fits one standard-pipeline tenant at the
    returned rate but not two (calibrated from the actual booking)."""
    probe_spec = two_pool_spec(bw=1e9, latency=20e-3)
    sched = FleetScheduler(probe_spec)
    rate = 1e4
    res = sched.submit(TenantSpec("probe", sla=LOOSE, demand_rate=rate),
                       make_controller(probe_spec))
    assert res.admitted
    need = sum(sched.ledger.link_load().values())
    assert need > 0.0
    return two_pool_spec(bw=need * 1.5, latency=20e-3), rate


# ---------------------------------------------------------------------------
# fleet-batched arbitration
# ---------------------------------------------------------------------------

def test_one_tenants_trigger_does_not_stampede_the_other():
    spec = two_pool_spec()
    sched = FleetScheduler(spec)
    ca = make_controller(spec, cooldown=0, codec_cooldown=0)
    cb = make_controller(spec, cooldown=0, codec_cooldown=0)
    sched.submit(TenantSpec("a", sla=LOOSE, demand_rate=1e4), ca)
    sched.submit(TenantSpec("b", sla=LOOSE, demand_rate=1e4), cb)
    # steady state: everyone holds, no history growth
    d = sched.arbitrate(1, {"a": 1e4, "b": 1e4})
    assert d["a"].reason == "hold" and d["b"].reason == "hold"
    assert len(ca.history) == 1 and len(cb.history) == 1
    # only a's rate leaves its band -> only a replans
    d = sched.arbitrate(2, {"a": 5e4, "b": 1e4})
    assert d["a"].reason == "rate_up" and d["b"].reason == "hold"
    assert len(ca.history) == 2 and len(cb.history) == 1
    assert any("grant a" in line for line in sched.log)
    assert not any("grant b" in line for line in sched.log)


def test_fleet_cooldown_holds_back_to_back_grants():
    spec = two_pool_spec()
    sched = FleetScheduler(spec)
    c = make_controller(spec, cooldown=0, codec_cooldown=0)
    sched.submit(TenantSpec("a", sla=LOOSE, demand_rate=1e4,
                            replan_cooldown=5), c)
    d = sched.arbitrate(1, {"a": 5e4})
    assert d["a"].reason == "rate_up"
    # wants another replan immediately, but the FLEET cooldown holds it
    d = sched.arbitrate(2, {"a": 1e4})
    assert d["a"].reason == "hold"
    assert any("cooldown holds" in line for line in sched.log)
    # past the cooldown the replan goes through
    d = sched.arbitrate(6, {"a": 1e4})
    assert d["a"].reason == "rate_down"


def test_priority_tier_order_in_one_pass():
    """When several tenants trigger in one pass, grants run lower-tier
    first (tier 0 re-prices before tier 1 eats its residual)."""
    spec = two_pool_spec()
    sched = FleetScheduler(spec)
    c_lo = make_controller(spec, cooldown=0, codec_cooldown=0)
    c_hi = make_controller(spec, cooldown=0, codec_cooldown=0)
    sched.submit(TenantSpec("cheap", sla=LOOSE, demand_rate=1e4,
                            priority=5), c_lo)
    sched.submit(TenantSpec("prem", sla=LOOSE, demand_rate=1e4,
                            priority=0), c_hi)
    sched.arbitrate(1, {"cheap": 5e4, "prem": 5e4})
    grants = [line for line in sched.log if "grant" in line]
    assert len(grants) == 2
    assert "prem" in grants[0] and "cheap" in grants[1]


# ---------------------------------------------------------------------------
# capacity invariants (property-tested)
# ---------------------------------------------------------------------------

def test_ledger_capacity_invariant_under_random_churn():
    """Randomized admit/leave/arbitrate churn: at every point, summed
    per-tenant reserved link bytes stay within each link's capacity and
    pool fractions within 1.0 (FleetLedger.check)."""
    rng = random.Random(7)
    spec = two_pool_spec(bw=3e5, latency=20e-3)  # tight: rejections happen
    sched = FleetScheduler(spec)
    live, nxt, admitted_ever, rejected_ever = {}, 0, 0, 0
    for step in range(60):
        op = rng.random()
        if op < 0.35 and len(live) < 6:
            name = f"t{nxt}"
            nxt += 1
            rate = rng.choice([5e3, 1e4, 3e4, 8e4])
            res = sched.submit(
                TenantSpec(name, sla=LOOSE, demand_rate=rate,
                           priority=rng.randint(0, 2)),
                make_controller(spec, cooldown=rng.choice([0, 2])),
                queue=False)
            if res.admitted:
                live[name] = rate
                admitted_ever += 1
            else:
                rejected_ever += 1
        elif op < 0.5 and live:
            gone = rng.choice(sorted(live))
            del live[gone]
            for r in sched.leave(gone):
                if r.admitted:
                    live[r.name] = 0.0
        elif live:
            offered = {n: rng.choice([5e3, 1e4, 3e4, 8e4]) for n in live}
            sched.arbitrate(step, offered)
        bad = sched.ledger.check()
        assert bad == [], f"step {step}: {bad}\nlog tail: {sched.log[-4:]}"
        assert set(sched.ledger.reservations) == set(live)
    # the churn actually exercised both admission outcomes
    assert admitted_ever >= 3 and rejected_ever >= 3


# ---------------------------------------------------------------------------
# single-tenant differential vs standalone StreamJob
# ---------------------------------------------------------------------------

def test_fleet_of_one_matches_standalone_run():
    """Plans, codec trajectory, and migration history of a 1-tenant
    fleet must be IDENTICAL to a standalone run on the same spec — the
    fleet layer is a no-op until a second tenant shows up."""
    def rate_fn(s):
        return 1e4 * (4.0 if s >= 6 else 1.0)

    n = 12
    solo = Orchestrator(StreamJob("solo", dim=8, sla=LOOSE))
    m_solo = solo.run(_batches(n), rate_fn=rate_fn, seed=0)

    fleet = FleetOrchestrator(two_pool_spec())
    res = fleet.add_tenant(
        TenantSpec("solo", sla=LOOSE, demand_rate=rate_fn(0)),
        StreamJob("solo", dim=8, sla=LOOSE), seed=0)
    assert res.admitted
    for i, b in enumerate(_batches(n)):
        fleet.step_round({"solo": b}, rates={"solo": rate_fn(i)})
    m_fleet = fleet.finish()["solo"]

    assert m_fleet.plan_identities == m_solo.plan_identities
    assert m_fleet.codecs == m_solo.codecs
    assert m_fleet.cuts == m_solo.cuts
    assert m_fleet.assignments == m_solo.assignments
    assert m_fleet.migrations == m_solo.migrations
    assert m_fleet.events == m_solo.events

    def control_lines(m):
        # elastic lines embed measured wall-clock rates; the CONTROL
        # trajectory (init/replan/codec/repartition) must match exactly
        return [d for d in m.decisions if "elastic" not in d]

    assert control_lines(m_fleet) == control_lines(m_solo)


# ---------------------------------------------------------------------------
# FleetOrchestrator: multi-tenant rounds + churn
# ---------------------------------------------------------------------------

def test_three_tenant_round_robin_with_mid_run_churn():
    spec = two_pool_spec()
    fleet = FleetOrchestrator(spec)
    for i in range(3):
        res = fleet.add_tenant(
            TenantSpec(f"t{i}", sla=LOOSE, demand_rate=1e4,
                       priority=i % 2),
            StreamJob(f"t{i}", dim=8, sla=LOOSE), seed=i)
        assert res.admitted, res.reason
    assert fleet.scheduler.admitted == ["t0", "t1", "t2"]

    feeds = {f"t{i}": _batches(6, seed=10 + i) for i in range(3)}
    for step in range(3):
        measured = fleet.step_round(
            {n: feeds[n][step] for n in fleet.orchestrators})
        assert set(measured) == {"t0", "t1", "t2"}
        assert fleet.scheduler.ledger.check() == []

    # t1 departs mid-run; its metrics close out, capacity returns
    m1, readmits = fleet.leave("t1")
    assert m1.events == 3 * 32
    assert readmits == []
    assert "t1" not in fleet.scheduler.ledger.reservations

    for step in range(3, 5):
        fleet.step_round({n: feeds[n][step] for n in fleet.orchestrators})
        assert fleet.scheduler.ledger.check() == []
    out = fleet.finish()
    assert set(out) == {"t0", "t2"}
    for m in out.values():
        assert m.events == 5 * 32
        assert m.sla is not None and m.preq is not None
    # per-tenant trackers stayed independent (each fed only its own run)
    assert all(m.sla["window_checks"] == 5.0 for m in out.values())


def test_fleet_orchestrator_queued_tenant_activates_on_leave():
    spec, rate = _one_tenant_link_spec()
    fleet = FleetOrchestrator(spec)
    ra = fleet.add_tenant(TenantSpec("a", sla=LOOSE, demand_rate=rate),
                          StreamJob("a", dim=8, sla=LOOSE))
    rb = fleet.add_tenant(TenantSpec("b", sla=LOOSE, demand_rate=rate),
                          StreamJob("b", dim=8, sla=LOOSE))
    assert ra.admitted and not rb.admitted and rb.queued
    assert list(fleet.orchestrators) == ["a"]
    fa = _batches(2, seed=1)
    fleet.step_round({"a": fa[0]})
    m_a, readmits = fleet.leave("a")
    assert m_a.events == 32
    assert [(r.name, r.admitted) for r in readmits] == [("b", True)]
    # b is live and steps immediately
    assert list(fleet.orchestrators) == ["b"]
    fleet.step_round({"b": _batches(1, seed=2)[0]})
    m_b = fleet.finish()["b"]
    assert m_b.events == 32
    assert fleet.scheduler.ledger.check() == []


def test_fleet_rejects_mismatched_job_cluster():
    fleet = FleetOrchestrator(two_pool_spec())
    other = cm.ClusterSpec(pools=[
        cm.Resource("edge2", "edge"), cm.Resource("cloud2", "cloud")])
    with pytest.raises(ValueError, match="different cluster"):
        fleet.add_tenant(TenantSpec("x", sla=LOOSE),
                         StreamJob("x", dim=8, sla=LOOSE, cluster=other))


# ---------------------------------------------------------------------------
# queue re-admission ordering (drain_queue)
# ---------------------------------------------------------------------------

def _queue_three(sched, spec, rate):
    """Queue three tenants — a premium one submitted LAST and two
    standard ones in FIFO order — behind a full link."""
    for name, prio in [("std1", 1), ("std2", 1), ("prem", 0)]:
        res = sched.submit(TenantSpec(name, priority=prio, sla=LOOSE,
                                      demand_rate=rate),
                           make_controller(spec))
        assert not res.admitted and res.queued
    assert sched.queued == ["std1", "std2", "prem"]


def test_drain_queue_priority_then_fifo_after_departure():
    """drain_queue re-admits in priority order, FIFO within a tier: the
    late-arriving premium tenant jumps the queue, and among equal-tier
    tenants arrival order decides."""
    spec, rate = _one_tenant_link_spec()
    sched = FleetScheduler(spec)
    a = sched.submit(TenantSpec("a", sla=LOOSE, demand_rate=rate),
                     make_controller(spec))
    assert a.admitted
    _queue_three(sched, spec, rate)
    # one slot frees; exactly one re-admission — the premium tier wins
    out = sched.leave("a")
    assert [(r.name, r.admitted) for r in out] == [("prem", True)]
    assert sched.queued == ["std1", "std2"]  # FIFO order preserved
    # next slot goes to the older standard tenant
    out = sched.leave("prem")
    assert [r.name for r in out] == ["std1"]
    assert sched.queued == ["std2"]
    assert sched.ledger.check() == []


def test_drain_queue_priority_then_fifo_after_membership_join():
    """The same ordering contract when the capacity arrives as a
    membership POOL_JOINED event: the round's event drain re-admits
    the premium tenant before the standard ones, FIFO within a tier.
    Queued tenants are DAG jobs — linear pipelines collapse to the
    first edge pool and could never use a joiner."""
    from repro_torch.core.membership import MembershipDirectory

    d = MembershipDirectory(two_pool_spec(bw=2e6, latency=20e-3))
    fleet = FleetOrchestrator(membership=d)
    a = fleet.add_tenant(TenantSpec("a", sla=LOOSE, demand_rate=1e4),
                         StreamJob("a", dim=8, sla=LOOSE), seed=0)
    assert a.admitted
    for i, (name, prio) in enumerate([("std1", 1), ("std2", 1),
                                      ("prem", 0)]):
        res = fleet.add_tenant(
            TenantSpec(name, priority=prio, sla=LOOSE, demand_rate=1e6),
            StreamJob(name, dim=8, sla=LOOSE,
                      pipeline=pl.fanout_stream_graph(8)), seed=i + 1)
        assert not res.admitted and res.queued
    assert fleet.scheduler.queued == ["std1", "std2", "prem"]
    # a fat pool joins; next round's drain re-attempts the queue in
    # tier-then-FIFO order (admissions land in that order)
    d.register(cm.Resource("edge_big", "edge", chips=4, flops=8e12,
                           mem_bw=200e9, mem_cap=16e9, net_bw=10e9,
                           net_latency=2e-3),
               links=[cm.Link("edge_big", "cloud", bw=1e9, latency=2e-3)],
               now=1, monitored=False)
    gen = HyperplaneStream(dim=8, seed=9, horizon=2 * 32.0)
    fleet.step_round({"a": gen.batch(0, 32)}, rates={"a": 1e4})
    re_admitted = [n for n in fleet.scheduler.admitted if n != "a"]
    assert re_admitted and re_admitted[0] == "prem"
    assert re_admitted == sorted(
        re_admitted, key=lambda n: (0 if n == "prem" else 1, n))
    # anyone still waiting kept FIFO order
    assert fleet.scheduler.queued == [
        n for n in ["std1", "std2"] if n not in re_admitted]
    assert fleet.scheduler.ledger.check() == []


# ---------------------------------------------------------------------------
# the two packages side by side
# ---------------------------------------------------------------------------

def _churn(cm_, fleet_, off_, pl_, sla_):
    """The random churn of the capacity-invariant test through one
    package's scheduler: each step's admissions, releases and grants,
    the ledger's bookings and the audit log."""
    rng = random.Random(7)
    loose = sla_.SLA(max_latency_s=1e3, error_budget=11.0)
    spec = cm_.ClusterSpec(pools=[cm_.EDGE_NODE, cm_.CLOUD_POD],
                           links=[cm_.Link("edge", "cloud", bw=3e5,
                                           latency=20e-3)])
    sched = fleet_.FleetScheduler(spec)
    live, nxt, trace = set(), 0, []
    for step in range(60):
        op = rng.random()
        if op < 0.35 and len(live) < 6:
            name = f"t{nxt}"
            nxt += 1
            ctl = off_.OffloadController(
                pl_.standard_stream_pipeline(dim=8).costs(), spec,
                sla_spec=loose, codec=sla_.pick_codec(loose).name,
                cooldown=rng.choice([0, 2]))
            res = sched.submit(fleet_.TenantSpec(
                name, sla=loose, demand_rate=rng.choice([5e3, 1e4, 3e4, 8e4]),
                priority=rng.randint(0, 2)), ctl, queue=rng.random() < 0.5)
            if res.admitted:
                live.add(name)
            out = (res.name, res.admitted, res.reason, res.queued)
        elif op < 0.5 and live:
            gone = sorted(live)[rng.randrange(len(live))]
            live.discard(gone)
            out = [(r.name, r.admitted) for r in sched.leave(gone)]
            live |= {n for n, ok in out if ok}
        elif live:
            offered = {n: rng.choice([5e3, 1e4, 3e4, 8e4]) for n in
                       sorted(live)}
            out = sorted((n, d.reason, d.codec, d.cut) for n, d in
                         sched.arbitrate(step, offered).items())
        else:
            out = None
        trace.append((out, sched.admitted, sched.queued,
                      {n: (r.pool_frac, r.link_bytes, r.state_bytes)
                       for n, r in sched.ledger.reservations.items()},
                      sched.ledger.check()))
    return trace, sched.log


def test_scheduler_churn_matches_the_reference():
    """Admission, queueing, departures with re-admission and arbitration
    under the same random churn: every step's outcome, the admitted and
    queued lists, every booking (pool fractions, link bytes, state bytes)
    and the audit log equal the reference's."""
    want, wlog = _churn(jcm, jfleet, joff, jpl, jsla)
    got, glog = _churn(cm, tfleet, toff, pl, tsla)
    assert glog == wlog
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"step {i}"
    assert len(got) == len(want)
    assert any(t[2] for t in got), "the churn never queued a tenant"


def _fleet_tenants(fleet_, orch_, sla_, dims, pin=False, **job_kw):
    """The four tenants of the fleet example: ``dl`` (tier 0, 4e4 ev/s,
    two workers), two best-effort sketch jobs and a hog at 1e9 ev/s,
    with the example's error budgets. Their latency limits are loose
    (the example's 2 s and 10 s would let a slow first batch, the JAX
    side's compilation, trip an SLA replan), and ``pin`` caps each job's
    workers at its start: neither an SLA replan nor a voluntary rescale
    can then read the wall clock."""
    def job(name, dim, workers=1):
        cap = {"max_workers": workers} if pin else {}
        return orch_.StreamJob(name, dim=dim, workers=workers, **cap,
                               **job_kw)

    loose = sla_.SLA(max_latency_s=1e3, error_budget=11.0)
    return [
        (fleet_.TenantSpec("dl", priority=0, demand_rate=4e4,
                           replan_cooldown=2,
                           sla=sla_.SLA(max_latency_s=1e3, error_budget=0.5)),
         job("dl", dims["dl"], workers=2)),
        (fleet_.TenantSpec("sketch_a", priority=2, demand_rate=1e4,
                           sla=loose),
         job("sketch_a", dims["sketch"])),
        (fleet_.TenantSpec("sketch_b", priority=2, demand_rate=1e4,
                           sla=loose),
         job("sketch_b", dims["sketch"])),
        (fleet_.TenantSpec("hog", priority=1, demand_rate=1e9, sla=loose),
         job("hog", dims["sketch"])),
    ]


def _fleet_run(cm_, ms_, fleet_, orch_, sla_, feeds, dims, rounds=8,
               fail_at=4, **job_kw):
    """The fleet example on a live directory: the example's edge and
    cloud with its uplink, a rack edge registered at t = 0, the four
    tenants, ``rounds`` rounds at the declared demand; the seed edge
    heartbeats at round 0 only, so its lease (3 ticks) runs out at round
    ``fail_at`` and every tenant planned onto it is replanned onto the
    rack. Returns the fleet, each round's ledger check and the metrics."""
    link = dict(energy_per_byte=3e-7)
    d = ms_.MembershipDirectory(cm_.ClusterSpec(
        pools=[cm_.EDGE_NODE, cm_.CLOUD_POD],
        links=[cm_.Link("edge", "cloud", bw=2e6, latency=20e-3, **link)]),
        lease_ticks=fail_at - 1)
    d.register(cm_.Resource("edge_rack", "edge", chips=2, flops=4e12,
                            mem_bw=100e9, mem_cap=8e9, net_bw=1e9,
                            net_latency=5e-3),
               links=[cm_.Link("edge_rack", "cloud", bw=8e6, latency=5e-3,
                               **link)],
               locality=ms_.Locality(0.5, 0.0, region="metro"), now=0,
               monitored=False)
    fleet = fleet_.FleetOrchestrator(membership=d)
    for i, (spec, job) in enumerate(_fleet_tenants(fleet_, orch_, sla_, dims,
                                                   **job_kw)):
        fleet.add_tenant(spec, job, seed=i)
    demand = {"dl": 4e4, "sketch_a": 1e4, "sketch_b": 1e4}
    checks = []
    for r in range(rounds):
        if r == 0:
            d.heartbeat("edge", now=0)
        fleet.step_round({n: feeds[n][r] for n in fleet.orchestrators},
                         rates=demand)
        checks.append(fleet.scheduler.ledger.check())
    return fleet, checks, fleet.finish()


def _feeds(gen_mod, rounds, n, dims):
    out = {}
    for i, name in enumerate(("dl", "sketch_a", "sketch_b", "hog")):
        dim = dims["dl"] if name == "dl" else dims["sketch"]
        kw = {"drift": gen_mod.DriftSpec("gradual", at=0.5, width=0.3)} \
            if name == "dl" else {}
        g = gen_mod.HyperplaneStream(dim=dim, seed=i + 1,
                                     horizon=rounds * float(n), **kw)
        out[name] = [g.batch(r, n) for r in range(rounds)]
    return out


def test_fleet_with_a_failing_pool_matches_the_reference(monkeypatch):
    """The fleet example's tenants on a live directory whose seed edge
    fails at round 4, through both packages on the same numpy batches:
    the admitted and queued sets, the ledger's bookings and audit log
    equal the reference's after every round, no tenant keeps the dead
    pool, and each tenant's ``JobMetrics`` (every event kept, worker
    counts pinned so no voluntary rescale reads the wall clock) and
    decisions equal the reference's, line for line, at equal device
    counts: the reference's rescale sees one host device (``jax.devices``
    cut to its first), as the port's world has one rank, so both name a
    (1, 1) mesh. The port's states stay on the CPU through the
    involuntary rescales."""
    dims = {"dl": 32, "sketch": 8}
    jf, tf = _feeds(jgen, 8, 64, dims), _feeds(tgen, 8, 64, dims)
    for name in jf:
        for a, b in zip(jf[name], tf[name]):
            np.testing.assert_array_equal(a.data["x"], b.data["x"])
    kw = dict(sample_rate=1.0, pin=True)
    with monkeypatch.context() as m:
        m.setenv("JAX_PALLAS_INTERPRET", "1")
        m.setattr(jax, "devices", lambda *a, _all=jax.devices: _all(*a)[:1])
        jfl, jchecks, jm = _fleet_run(jcm, jms, jfleet, jorch, jsla, jf,
                                      dims, **kw)
    tfl, tchecks, tm = _fleet_run(cm, tms, tfleet, torch_orch, tsla, tf,
                                  dims, device="cpu", **kw)
    assert tchecks == jchecks == [[]] * 8
    assert tfl.scheduler.admitted == jfl.scheduler.admitted
    assert tfl.scheduler.queued == jfl.scheduler.queued == ["hog"]
    assert tfl.scheduler.log == jfl.scheduler.log
    assert {n: vars(r) for n, r in tfl.scheduler.ledger.reservations.items()} \
        == {n: vars(r) for n, r in jfl.scheduler.ledger.reservations.items()}
    assert sorted(tfl.cluster.pools) == ["cloud", "edge_rack"]
    assert any("forced replan" in ln for ln in tfl.scheduler.log)
    assert set(tm) == set(jm) == {"dl", "sketch_a", "sketch_b"}
    for name in tm:
        _compare_metrics(jm[name], tm[name])
        assert tm[name].events == 8 * 64
        assert tm[name].migrations == jm[name].migrations
        assert tm[name].rescales == jm[name].rescales
        assert tm[name].decisions == jm[name].decisions
        orch = tfl.orchestrators[name]
        assert "edge" not in set(orch._exec_assignment.values())
        assert orch._exec_assignment == \
            jfl.orchestrators[name]._exec_assignment
        assert all(t.device.type == "cpu" for t in tree_leaves(orch.states))
    assert any("elastic-recover" in ln for m in tm.values()
               for ln in m.decisions)
    assert any("mesh=(1, 1)" in ln for ln in tm["dl"].decisions)


def test_chip_smoke_phases_10_and_11_rehearse_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s topology and fleet phases run end to end on
    the CPU at a small batch (the card's calls stubbed, and launch counts
    that rise at every read, since the CPU's plain versions count none):
    their checks pass and their control trajectories equal those of the
    same scripts at another batch size."""
    import itertools
    import pathlib

    root = str(pathlib.Path(__file__).resolve().parents[1])
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs
    from repro_torch.kernels import ops

    monkeypatch.setattr(cs, "N_EVENTS", 256)
    monkeypatch.setattr(cs, "CONTROL_EVENTS", 128)
    monkeypatch.setattr(cs, "nvidia_smi_line", lambda: "no card")
    monkeypatch.setattr(cs, "log", lambda *a: None)
    monkeypatch.setattr(cs, "profiled_window", lambda profile: _Null())
    monkeypatch.setattr(cs, "device_busy", lambda prof, secs: {})
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    tick = itertools.count(1)
    names = list(ops.launch_counts())
    monkeypatch.setattr(ops, "launch_counts",
                        lambda: dict.fromkeys(names, next(tick)))
    dev = torch.device("cpu")
    assert set(cs.topology_phase(dev)) == set(names)
    assert set(cs.fleet_phase(dev)) == set(names)


class _Null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False
