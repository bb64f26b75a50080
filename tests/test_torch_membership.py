"""The port's dynamic topology (``repro_torch.core.membership`` and the
orchestrator's topology hooks) on the CPU: every test of the JAX
package's ``tests/test_membership.py`` run against the port with
``device="cpu"``, then the two packages side by side on the same calls
and the same numpy batches — the directory's events, versions, specs and
probe estimates equal, and the pool-loss, join and zero-event runs'
``JobMetrics`` equal to the reference's (preq within 1e-4), decisions
included: both packages' rescale lines name the mesh they rebuilt
(``mesh=(d, m)``), compared at equal device counts."""

import os
import pathlib
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

from repro.core import costmodel as jcm
from repro.core import membership as jms
from repro.core import orchestrator as jorch
from repro.core import pipeline as jpl
from repro.core import sla as jsla
from repro.streams import generators as jgen

from repro_torch._tree import tree_flatten_with_path
from repro_torch.dist import elastic as elastic_mod
from repro_torch.core import costmodel as cm
from repro_torch.core import membership as tms
from repro_torch.core import orchestrator as torch_orch
from repro_torch.core import pipeline as pl
from repro_torch.core import sla as tsla
from repro_torch.core.fleet import FleetOrchestrator, TenantSpec
from repro_torch.core.membership import (LINK_UPDATE, POOL_FAILED,
                                         POOL_JOINED, POOL_LEFT, Locality,
                                         MembershipDirectory)
from repro_torch.core.offload import OffloadController
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.placement import (edge_cloud_pools, place_frontier,
                                        stale_pools)
from repro_torch.core.sla import SLA, pick_codec
from repro_torch.streams.generators import HyperplaneStream

from test_torch_orchestrator import _compare_metrics


def StreamJob(*args, **kw):
    """The port's StreamJob on the CPU (its default is the card)."""
    return torch_orch.StreamJob(*args, device="cpu", **kw)


_SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

LOOSE = SLA(max_latency_s=1e3, error_budget=11.0)


def two_pool_spec(**link_kw) -> cm.ClusterSpec:
    links = [cm.Link("edge", "cloud", **link_kw)] if link_kw else []
    return cm.ClusterSpec(pools=[cm.EDGE_NODE, cm.CLOUD_POD], links=links)


def edge_b(name="edge_b", **kw) -> cm.Resource:
    """A strictly better second edge pool, so the frontier search
    prefers it over the seed edge the moment it joins."""
    kw = {"chips": 2, "flops": 4e12, "mem_bw": 100e9, "mem_cap": 8e9,
          "net_bw": 1e9, "net_latency": 5e-3, **kw}
    return cm.Resource(name, "edge", **kw)


def _batches(n, dim=8, n_per=32, seed=0):
    gen = HyperplaneStream(dim=dim, seed=seed, horizon=n * n_per)
    return [gen.batch(i, n_per) for i in range(n)]


def make_controller(spec, sla=LOOSE, dim=8, **kw) -> OffloadController:
    kw.setdefault("codec", pick_codec(sla).name)
    return OffloadController(pl.standard_stream_pipeline(dim=dim).costs(),
                             spec, sla_spec=sla, **kw)


# ---------------------------------------------------------------------------
# directory: versioning, events, subscriptions
# ---------------------------------------------------------------------------

def test_directory_versioning_and_event_flow():
    d = MembershipDirectory(two_pool_spec(bw=2e6, latency=20e-3))
    assert d.version == 0 and d.spec.version == 0
    assert d.pool_names == ["cloud", "edge"]
    sub = d.subscribe()

    ev = d.register(edge_b(), links=[cm.Link("edge_b", "cloud",
                                             bw=5e6, latency=5e-3)], now=1)
    assert ev.kind == POOL_JOINED and ev.subject == "edge_b"
    assert ev.version == 1 and ev.clock == 1
    assert d.spec.version == 1 and "edge_b" in d.spec.pools
    assert d.spec.link("edge_b", "cloud").bw == 5e6

    ev = d.deregister("edge_b", now=3)
    assert ev.kind == POOL_LEFT and ev.version == 2
    assert "edge_b" not in d.spec.pools
    # links touching the departed pool vanish with it
    assert all("edge_b" not in (ln.src, ln.dst) for ln in d.spec.links)

    # the cursor drains exactly once; a late subscriber sees nothing old
    kinds = [e.kind for e in sub.poll()]
    assert kinds == [POOL_JOINED, POOL_LEFT]
    assert sub.poll() == []
    assert d.subscribe().poll() == []


def test_register_validations():
    d = MembershipDirectory(two_pool_spec())
    with pytest.raises(ValueError, match="already a member"):
        d.register(cm.EDGE_NODE)
    with pytest.raises(ValueError, match="does not touch"):
        d.register(edge_b(), links=[cm.Link("edge", "cloud", bw=1e6,
                                            latency=1e-3)])
    with pytest.raises(ValueError, match="not a member"):
        d.register(edge_b(), links=[cm.Link("edge_b", "nope", bw=1e6,
                                            latency=1e-3)])
    with pytest.raises(ValueError, match="unknown pool"):
        d.deregister("nope")
    with pytest.raises(ValueError, match="unknown pool"):
        d.heartbeat("nope")


def test_lease_expiry_declares_silent_pool_dead():
    d = MembershipDirectory(two_pool_spec(), lease_ticks=3)
    d.register(edge_b(), now=0)
    sub = d.subscribe()
    # heartbeats keep the lease alive
    for t in range(1, 6):
        d.heartbeat("edge_b", now=t)
        assert d.tick(t) == []
    # silence: expires when now - last_seen > lease_ticks
    assert d.tick(8) == []          # 8 - 5 == 3, not yet
    assert d.tick(9) == ["edge_b"]  # 9 - 5 > 3
    assert "edge_b" not in d.spec.pools
    (ev,) = sub.poll()
    assert ev.kind == POOL_FAILED and "lease expired" in ev.detail
    # idempotent: re-ticking expires nothing new
    assert d.tick(9) == [] and d.tick(10) == []


def test_seed_pools_are_not_lease_monitored():
    """A static core topology never expires for want of heartbeats it
    was never promised — only registered (or heartbeating) pools carry
    a lease."""
    d = MembershipDirectory(two_pool_spec(), lease_ticks=2)
    assert not d.monitored("edge") and not d.monitored("cloud")
    assert d.tick(1000) == []
    assert d.pool_names == ["cloud", "edge"]
    # a heartbeat enrolls a seed pool into monitoring
    d.heartbeat("edge", now=1000)
    assert d.monitored("edge")
    assert d.tick(1003) == ["edge"]


# ---------------------------------------------------------------------------
# latency probes (EWMA) + locality
# ---------------------------------------------------------------------------

def test_latency_probe_ewma_rewrites_spec_link():
    d = MembershipDirectory(two_pool_spec(bw=2e6, latency=20e-3),
                            ewma_alpha=0.5, latency_tol=0.2)
    sub = d.subscribe()
    # one big sample: EWMA moves halfway, beyond the 20% dead band
    ev = d.observe_latency("edge", "cloud", 60e-3, now=1)
    assert ev is not None and ev.kind == LINK_UPDATE
    assert ev.subject == "edge->cloud"
    assert d.spec.link("edge", "cloud").latency == pytest.approx(40e-3)
    assert d.probe_estimate("edge", "cloud") == pytest.approx(40e-3)
    # samples at the current estimate: spec stays fresh, no announcement
    v = d.version
    assert d.observe_latency("edge", "cloud", 40e-3, now=2) is None
    assert d.version > v            # the estimate still versions the spec
    assert [e.kind for e in sub.poll()] == [LINK_UPDATE]
    # probing an unknown pool is loud
    with pytest.raises(ValueError, match="unknown pool"):
        d.observe_latency("edge", "nope", 1e-3)


def test_probes_converge_and_placement_follows_them():
    """Two identical edge pools; probes reveal one uplink is slow
    (80ms) and one fast (1ms). The frontier DP must route the cloud
    hop over the probed-fast link — and swap its choice when the
    probes swap."""
    def probed_spec(far_lat, near_lat):
        d = MembershipDirectory(cm.ClusterSpec(pools=[cm.CLOUD_POD]))
        d.register(edge_b("edge_far"),
                   links=[cm.Link("edge_far", "cloud", bw=5e6,
                                  latency=5e-3)], monitored=False)
        d.register(edge_b("edge_near"),
                   links=[cm.Link("edge_near", "cloud", bw=5e6,
                                  latency=5e-3)], monitored=False)
        for t in range(20):
            d.observe_latency("edge_far", "cloud", far_lat, now=t)
            d.observe_latency("edge_near", "cloud", near_lat, now=t)
        return d.spec

    spec = probed_spec(80e-3, 1e-3)
    assert spec.link("edge_far", "cloud").latency > \
        10 * spec.link("edge_near", "cloud").latency
    graph = pl.fanout_stream_graph(8)
    plan, _ = place_frontier(graph, spec, rate=1e4)
    # the plan dodges the 80ms probed link: the near pool carries the
    # cloud hop and the end-to-end latency stays an order below it
    assert "edge_near" in set(plan.assignment.values())
    assert plan.latency_s < 10e-3
    # swapped probes flip the routing — the DP is probe-driven, not
    # name-driven
    swapped, _ = place_frontier(graph, probed_spec(1e-3, 80e-3), rate=1e4)
    assert swapped.assignment != plan.assignment
    assert "edge_near" not in set(swapped.assignment.values())
    assert swapped.latency_s < 10e-3


def test_locality_derives_distance_latency():
    d = MembershipDirectory(cm.ClusterSpec(pools=[cm.CLOUD_POD]),
                            base_latency=1e-3, latency_per_km=0.05e-3)
    d.register(edge_b("edge_a"), locality=Locality(0.0, 0.0),
               monitored=False)
    d.register(edge_b("edge_c"), locality=Locality(30.0, 40.0),
               monitored=False)
    # derived both ways from the 50km separation: 1ms + 50*0.05ms
    want = 1e-3 + 50.0 * 0.05e-3
    assert d.spec.link("edge_a", "edge_c").latency == pytest.approx(want)
    assert d.spec.link("edge_c", "edge_a").latency == pytest.approx(want)
    # a declared link is never overwritten by the geometric prior
    d.register(edge_b("edge_d"), locality=Locality(3.0, 4.0),
               links=[cm.Link("edge_d", "edge_a", bw=1e9, latency=9e-3)],
               monitored=False)
    assert d.spec.link("edge_d", "edge_a").latency == 9e-3
    assert d.spec.link("edge_a", "edge_d").latency == pytest.approx(
        1e-3 + 5.0 * 0.05e-3)


# ---------------------------------------------------------------------------
# ClusterSpec churn support
# ---------------------------------------------------------------------------

def test_without_pool_removes_pool_links_and_bumps_version():
    spec = cm.ClusterSpec(
        pools=[cm.EDGE_NODE, edge_b(), cm.CLOUD_POD],
        links=[cm.Link("edge", "cloud", bw=2e6, latency=20e-3),
               cm.Link("edge_b", "cloud", bw=5e6, latency=5e-3)])
    out = spec.without_pool("edge_b")
    assert sorted(out.pools) == ["cloud", "edge"]
    assert all("edge_b" not in (ln.src, ln.dst) for ln in out.links)
    assert out.version == spec.version + 1
    # the original is untouched (specs are snapshots)
    assert "edge_b" in spec.pools
    with pytest.raises(ValueError, match=r"unknown pool 'nope'.*edge_b"):
        spec.without_pool("nope")


def test_link_unknown_pool_raises_valueerror_naming_pools():
    """Under churn a stale plan's pool name must fail loudly
    in link(), naming the missing pool AND the known set — not as an
    ambiguous KeyError or a bogus derived default."""
    spec = two_pool_spec()
    with pytest.raises(ValueError) as ei:
        spec.link("edge", "gone")
    msg = str(ei.value)
    assert "'gone'" in msg and "edge" in msg and "cloud" in msg
    with pytest.raises(ValueError, match="unknown pool 'gone'"):
        spec.link("gone", "cloud")


def test_edge_cloud_pools_shim_warns_once():
    """The two-pool shim emits a real DeprecationWarning."""
    with pytest.warns(DeprecationWarning, match="two-pool shim"):
        e, c = edge_cloud_pools(two_pool_spec())
    assert e.name == "edge" and c.name == "cloud"
    # the default "once per location" filter dedups repeat calls
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("default")
        for _ in range(3):
            edge_cloud_pools(two_pool_spec())
    assert len([w for w in rec
                if issubclass(w.category, DeprecationWarning)]) == 1


def test_prefix_cut_engine_does_not_warn():
    """place() IS the two-pool engine: its internal collapse must not
    spam a deprecation warning on every replan."""
    from repro_torch.core.placement import place
    ops = pl.standard_stream_pipeline(dim=8).costs()
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        place(ops, two_pool_spec(), rate=1e4)


# ---------------------------------------------------------------------------
# stale-plan guard (placement.stale_pools + controller)
# ---------------------------------------------------------------------------

def test_stale_pools_reports_departed_assignment_pools():
    spec = two_pool_spec()
    assert stale_pools({"a": "edge", "b": "cloud"}, spec) == []
    assert stale_pools({"a": "edge_b", "b": "cloud", "c": "edge_b"},
                       spec) == ["edge_b"]


def test_controller_cannot_hold_a_stale_plan():
    """After churn removes a pool the incumbent plan uses, wants_replan
    fires pool_lost straight through the cooldown gate and
    hold_decision refuses outright."""
    big = cm.ClusterSpec(
        pools=[cm.EDGE_NODE, edge_b(), cm.CLOUD_POD],
        links=[cm.Link("edge", "cloud", bw=2e6, latency=20e-3),
               cm.Link("edge_b", "cloud", bw=8e6, latency=5e-3)])
    c = OffloadController(pl.fanout_stream_graph(8).costs(), big,
                          graph=pl.fanout_stream_graph(8), sla_spec=LOOSE,
                          codec=pick_codec(LOOSE).name, cooldown=10**6)
    c.initial_plan(1e4, step=0)
    assert "edge_b" in set(c.assignment.values())
    # in-band rate + gigantic cooldown: a healthy topology would hold
    assert c.wants_replan(1, 1e4) is None
    c.set_resources(big.without_pool("edge_b"))
    assert c.wants_replan(1, 1e4) == "pool_lost"
    with pytest.raises(ValueError, match="departed pool"):
        c.hold_decision(1, 1e4)
    d = c.replan(1, 1e4, reason="pool_lost")
    assert "edge_b" not in set(d.assignment.values())
    assert c.wants_replan(2, 1e4) is None  # healthy again


# ---------------------------------------------------------------------------
# orchestrator integration: the headline scenarios
# ---------------------------------------------------------------------------

def _seeded_directory():
    d = MembershipDirectory(two_pool_spec(bw=2e6, latency=20e-3))
    d.register(edge_b(), links=[cm.Link("edge_b", "cloud", bw=8e6,
                                        latency=5e-3)], now=0)
    return d


def test_pool_loss_recovery_scenario():
    """THE headline: a pool carrying the plan goes silent mid-stream ->
    lease expiry -> checkpoint rescale_cycle -> forced replan with the
    dead pool excluded from the candidate set -> state migrates -> the
    SLA recovers within the telemetry window."""
    d = _seeded_directory()
    job = StreamJob("dyn", dim=8, sla=LOOSE, membership=d,
                    pipeline=pl.fanout_stream_graph(8), sla_window=5)
    orch = Orchestrator(job)
    batches = _batches(14)

    def stream():
        for i, b in enumerate(batches):
            if i < 6:   # heartbeats stop after step 5: silent death
                d.heartbeat("edge_b", now=i)
            yield b

    m = orch.run(stream(), rate_fn=lambda s: 1e4)
    # the plan actually used the pool that died
    assert any("pool_failed edge_b" in ln and "[in plan]" in ln
               for ln in m.decisions)
    # recovery rode the involuntary checkpoint-rescale path
    assert any("elastic-recover" in ln for ln in m.decisions)
    assert m.rescales >= 1
    # the forced replan executed (a real migration), excluding the dead
    # pool from the surviving assignment
    assert any(":pool_lost" in ln for ln in m.decisions)
    assert m.migrations >= 1
    assert "edge_b" not in set(orch._exec_assignment.values())
    assert "edge_b" not in orch.controller.resources.pools
    # the job kept running and its (windowed) SLA recovered
    assert m.events == sum(b.n for b in batches)
    assert orch.sla.ok()


def test_zero_event_parity_with_static_spec():
    """Differential contract: a membership-backed run with ZERO topology
    events is plan/codec/migration-identical to the static-spec run
    (new subsystems are bitwise no-ops when unused)."""
    spec = two_pool_spec(bw=2e6, latency=20e-3)

    def run(**kw):
        job = StreamJob("p", dim=8, sla=LOOSE,
                        pipeline=pl.fanout_stream_graph(8), **kw)
        orch = Orchestrator(job)
        # a deterministic rate ramp drives real replan traffic
        return orch.run(_batches(10),
                        rate_fn=lambda s: 1e4 * (1.0 + 2.0 * (s >= 5)))

    a = run(cluster=spec)
    b = run(membership=MembershipDirectory(spec))
    assert a.plan_identities == b.plan_identities
    assert a.codecs == b.codecs
    assert a.cuts == b.cuts
    assert a.assignments == b.assignments
    assert a.migrations == b.migrations
    da = [ln for ln in a.decisions if "elastic" not in ln]
    db = [ln for ln in b.decisions if "elastic" not in ln]
    assert da == db


def test_join_mid_run_triggers_replan_onto_new_pool():
    d = MembershipDirectory(two_pool_spec(bw=2e6, latency=20e-3))
    job = StreamJob("dyn", dim=8, sla=LOOSE, membership=d,
                    pipeline=pl.fanout_stream_graph(8))
    orch = Orchestrator(job)
    batches = _batches(8)

    def stream():
        for i, b in enumerate(batches):
            if i == 3:   # a strictly better edge pool joins mid-ramp
                d.register(edge_b(), links=[cm.Link("edge_b", "cloud",
                                                    bw=8e6, latency=5e-3)],
                           now=i, monitored=False)
            yield b

    m = orch.run(stream(), rate_fn=lambda s: 1e4)
    assert any("topology pool_joined edge_b" in ln for ln in m.decisions)
    assert any(":pool_joined" in ln for ln in m.decisions)
    assert "edge_b" in set(orch._exec_assignment.values())
    assert m.migrations >= 1


def test_cluster_and_membership_are_mutually_exclusive():
    d = MembershipDirectory(two_pool_spec())
    with pytest.raises(ValueError, match="not both"):
        Orchestrator(StreamJob("x", cluster=two_pool_spec(), membership=d))


# ---------------------------------------------------------------------------
# fleet integration
# ---------------------------------------------------------------------------

def test_fleet_pool_loss_scrubs_ledger_and_forces_replans():
    """A fleet tenant planned onto the dying pool: its ledger bookings
    are scrubbed, it is forcibly replanned onto survivors (priority
    order), and the capacity invariants stay clean."""
    d = _seeded_directory()
    fleet = FleetOrchestrator(membership=d)
    res = fleet.add_tenant(
        TenantSpec("a", priority=0, demand_rate=1e4, sla=LOOSE),
        StreamJob("a", dim=8, pipeline=pl.fanout_stream_graph(8)), seed=0)
    assert res.admitted
    orch = fleet.orchestrators["a"]
    assert "edge_b" in set(orch._exec_assignment.values())
    booked = fleet.scheduler.ledger.reservations["a"]
    assert "edge_b" in booked.pool_frac

    gen = HyperplaneStream(dim=8, seed=0, horizon=6 * 32.0)
    d.heartbeat("edge_b", now=0)
    fleet.step_round({"a": gen.batch(0, 32)}, rates={"a": 1e4})
    # heartbeats stop; the lease expires inside a later round's drain
    for step in range(1, 6):
        fleet.step_round({"a": gen.batch(step, 32)}, rates={"a": 1e4})
    assert "edge_b" not in fleet.cluster.pools
    r = fleet.scheduler.ledger.reservations["a"]
    assert "edge_b" not in r.pool_frac and "edge_b" not in r.state_bytes
    assert all("edge_b" not in key for key in r.link_bytes)
    assert "edge_b" not in set(orch._exec_assignment.values())
    assert any("forced replan a" in ln for ln in fleet.scheduler.log)
    assert any("elastic-recover" in ln for ln in orch.metrics.decisions)
    assert fleet.scheduler.ledger.check() == []


def test_fleet_join_readmits_queued_tenant():
    """Capacity joining mid-run re-attempts admission for the queue
    within the same round's event drain."""
    d = MembershipDirectory(two_pool_spec(bw=2e6, latency=20e-3))
    fleet = FleetOrchestrator(membership=d)
    a = fleet.add_tenant(TenantSpec("a", demand_rate=1e4, sla=LOOSE),
                         StreamJob("a", dim=8), seed=0)
    assert a.admitted
    # a DAG tenant sized past the seed topology (linear jobs collapse
    # to the first edge pool and could never use a joiner): queues
    b = fleet.add_tenant(TenantSpec("b", demand_rate=1e6, sla=LOOSE),
                         StreamJob("b", dim=8,
                                   pipeline=pl.fanout_stream_graph(8)),
                         seed=1)
    assert not b.admitted and b.queued
    gens = {n: HyperplaneStream(dim=8, seed=i, horizon=4 * 32.0)
            for i, n in enumerate(["a", "b"])}
    fleet.step_round({"a": gens["a"].batch(0, 32)}, rates={"a": 1e4})
    assert fleet.scheduler.queued == ["b"]
    # a pool with a fat uplink joins; the next round's drain re-admits
    d.register(edge_b("edge_big", net_bw=10e9),
               links=[cm.Link("edge_big", "cloud", bw=1e9, latency=2e-3)],
               now=1, monitored=False)
    fleet.step_round({n: gens[n].batch(1, 32) for n in fleet.orchestrators},
                     rates={"a": 1e4, "b": 1e6})
    assert fleet.scheduler.queued == []
    assert "b" in fleet.orchestrators
    assert fleet.scheduler.ledger.check() == []
    # the re-admitted tenant runs in subsequent rounds
    fleet.step_round({n: gens[n].batch(2, 32) for n in fleet.orchestrators},
                     rates={"a": 1e4, "b": 1e6})
    assert fleet.orchestrators["b"].metrics.events > 0


def test_ledger_drop_pool_scrubs_only_touching_bookings():
    spec = cm.ClusterSpec(
        pools=[cm.EDGE_NODE, edge_b(), cm.CLOUD_POD],
        links=[cm.Link("edge", "cloud", bw=2e6, latency=20e-3),
               cm.Link("edge_b", "cloud", bw=8e6, latency=5e-3)])
    from repro_torch.core.fleet import FleetLedger, Reservation
    led = FleetLedger(spec)
    led.reservations["t0"] = Reservation(
        pool_frac={"edge_b": 0.5, "cloud": 0.1},
        link_bytes={("edge_b", "cloud"): 1e6},
        state_bytes={"edge_b": 1e6})
    led.reservations["t1"] = Reservation(
        pool_frac={"edge": 0.2}, link_bytes={("edge", "cloud"): 5e5})
    assert led.drop_pool("edge_b") == ["t0"]
    assert led.reservations["t0"].pool_frac == {"cloud": 0.1}
    assert led.reservations["t0"].link_bytes == {}
    assert led.reservations["t0"].state_bytes == {}
    # the untouched tenant keeps its booking bit-for-bit
    assert led.reservations["t1"].pool_frac == {"edge": 0.2}
    assert "edge_b" not in led.spec.pools
    assert led.check() == []
    # set_spec refuses to paper over a departure
    led.reservations["t2"] = Reservation(pool_frac={"edge": 0.1})
    with pytest.raises(ValueError, match="drop_pool"):
        led.set_spec(two_pool_spec().without_pool("edge"))


def test_bandwidth_probe_ewma_rewrites_spec_link():
    """``observe_bandwidth`` mirrors the latency probe: EWMA over
    samples, ``Link.bw`` rewritten in the versioned spec, LINK_UPDATE
    announced only beyond the shared dead band."""
    d = MembershipDirectory(two_pool_spec(bw=2e6, latency=20e-3),
                            ewma_alpha=0.5, latency_tol=0.2)
    sub = d.subscribe()
    # one big sample: EWMA moves halfway, beyond the 20% dead band
    ev = d.observe_bandwidth("edge", "cloud", 6e6, now=1)
    assert ev is not None and ev.kind == LINK_UPDATE
    assert ev.subject == "edge->cloud"
    assert "bw" in ev.detail
    assert d.spec.link("edge", "cloud").bw == pytest.approx(4e6)
    assert d.bandwidth_estimate("edge", "cloud") == pytest.approx(4e6)
    # the latency declared on the link is untouched by bandwidth probes
    assert d.spec.link("edge", "cloud").latency == pytest.approx(20e-3)
    # samples at the current estimate: spec stays fresh, no announcement
    v = d.version
    assert d.observe_bandwidth("edge", "cloud", 4e6, now=2) is None
    assert d.version > v            # the estimate still versions the spec
    assert [e.kind for e in sub.poll()] == [LINK_UPDATE]
    with pytest.raises(ValueError, match="unknown pool"):
        d.observe_bandwidth("edge", "nope", 1e6)
    with pytest.raises(ValueError, match="non-positive sample"):
        d.observe_bandwidth("edge", "cloud", 0.0)


def test_bandwidth_and_latency_probes_share_a_link_independently():
    d = MembershipDirectory(two_pool_spec(bw=2e6, latency=20e-3),
                            ewma_alpha=0.5, latency_tol=0.2)
    d.observe_bandwidth("edge", "cloud", 6e6, now=1)
    d.observe_latency("edge", "cloud", 60e-3, now=2)
    ln = d.spec.link("edge", "cloud")
    assert ln.bw == pytest.approx(4e6)
    assert ln.latency == pytest.approx(40e-3)
    # a dead-banded bandwidth wiggle never clobbers the latency estimate
    assert d.observe_bandwidth("edge", "cloud", 4.1e6, now=3) is None
    assert d.spec.link("edge", "cloud").latency == pytest.approx(40e-3)


# ---------------------------------------------------------------------------
# the two packages side by side
# ---------------------------------------------------------------------------

def _plain(x):
    """Events, resources and links as plain values, so the two packages'
    dataclasses compare field for field."""
    if x is None or isinstance(x, (str, int, float, bool)):
        return x
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return (type(x).__name__, _plain(list(vars(x).items())
                                     if hasattr(x, "__dict__") else
                                     [(f, getattr(x, f)) for f in
                                      x.__dataclass_fields__]))


def _snapshot(d):
    spec = d.spec
    pairs = [(a, b) for a in d.pool_names for b in d.pool_names if a != b]
    return {
        "version": d.version, "spec_version": spec.version,
        "clock": d.clock, "pools": d.pool_names,
        "resources": [_plain(spec[n]) for n in d.pool_names],
        "links": sorted((ln.src, ln.dst, _plain(ln)) for ln in spec.links),
        "derived": [_plain(spec.link(a, b)) for a, b in pairs],
        "monitored": [n for n in d.pool_names if d.monitored(n)],
        "latency": [d.probe_estimate(a, b) for a, b in pairs],
        "bandwidth": [d.bandwidth_estimate(a, b) for a, b in pairs],
        "events": _plain(d.events), "repr": repr(d),
    }


def _directory_script(cm_, ms_):
    """One script of every mutation and probe, through one package's
    costmodel and membership; the trace of each call's result and the
    directory after it."""
    d = ms_.MembershipDirectory(
        cm_.ClusterSpec(pools=[cm_.EDGE_NODE, cm_.CLOUD_POD],
                        links=[cm_.Link("edge", "cloud", bw=2e6,
                                        latency=20e-3)]),
        lease_ticks=3, ewma_alpha=0.3, latency_tol=0.2)
    sub = d.subscribe()
    trace = []

    def edge(name, flops=4e12):
        return cm_.Resource(name, "edge", chips=2, flops=flops,
                            mem_bw=100e9, mem_cap=8e9, net_bw=1e9,
                            net_latency=5e-3)

    calls = [
        lambda: d.register(edge("edge_rack"), links=[cm_.Link(
            "edge_rack", "cloud", bw=8e6, latency=5e-3)],
            locality=ms_.Locality(0.5, 0.0, region="metro"), now=0),
        lambda: d.register(edge("edge_far", 1e12), links=[cm_.Link(
            "edge_far", "cloud", bw=1e6, latency=60e-3)],
            locality=ms_.Locality(120.0, 90.0, region="rural"), now=0),
        lambda: d.register(edge("edge_near"), locality=ms_.Locality(3.0, 4.0),
                           now=1, monitored=False),
        *[(lambda t=t, s=s: d.observe_latency("edge_rack", "cloud", s,
                                               now=t))
          for t, s in enumerate([4e-3, 4e-3, 4.1e-3, 30e-3, 1e-3])],
        *[(lambda t=t, s=s: d.observe_bandwidth("edge_far", "cloud", s,
                                                 now=t))
          for t, s in enumerate([1.1e6, 3e6, 2.9e6, 0.5e6])],
        lambda: d.observe_latency("edge_near", "edge_rack", 2e-3, now=2),
        lambda: d.heartbeat("edge_rack", now=5),
        lambda: d.heartbeat("edge", now=5),
        lambda: d.heartbeat("edge_far", now=6),
        lambda: d.tick(7),
        lambda: d.tick(9),
        lambda: d.tick(9),
        lambda: d.deregister("edge_near", now=10),
        lambda: d.register(edge("edge_rack"), now=11),
        lambda: d.tick(12),
        lambda: d.tick(20),
    ]
    for call in calls:
        trace.append((_plain(call()), _snapshot(d)))
    trace.append(_plain(sub.poll()))
    return trace


def test_directory_script_matches_the_reference():
    """Registration with declared and derived links, EWMA latency and
    bandwidth probes inside and outside the dead band, heartbeats that
    enrol a seed pool, lease expiries (seed and registered), a
    deregistration and a re-registration: every call's result and the
    directory after it (events, versions, clock, pools, declared and
    derived links, leases, probe estimates) equal the reference's."""
    want = _directory_script(jcm, jms)
    got = _directory_script(cm, tms)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"call {i}"
    kinds = [e[1][0][1] for e in got[-1]]
    assert {POOL_JOINED, POOL_LEFT, POOL_FAILED, LINK_UPDATE} <= set(kinds)


_REF_RESCALE = """
    import tempfile
    from repro.core import orchestrator as jorch
    from repro.dist import elastic
    orch = jorch.Orchestrator(jorch.StreamJob(
        "e", dim=8, ckpt_dir=tempfile.mkdtemp()))
    for workers in (2, 4, 1):
        orch._apply_rescale(3, elastic.plan_reshard(1, workers, reason="t"))
    print("\\n".join(orch.metrics.decisions))
"""


def test_rescale_line_matches_the_reference_at_equal_device_counts(
        tmp_path):
    """Grow to 2 and 4 workers, shrink to 1: the reference in a process
    with one host device (as ``tests/test_system.py`` runs it) and the
    port in this one (a world of one rank) log the same lines, each
    naming the mesh its states came back on: ``mesh=(1, 1)``."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=1",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(_SRC),
                                           os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF_RESCALE)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = out.stdout.strip().splitlines()
    orch = Orchestrator(StreamJob("e", dim=8, ckpt_dir=str(tmp_path)))
    for workers in (2, 4, 1):
        orch._apply_rescale(3, elastic_mod.plan_reshard(1, workers,
                                                        reason="t"))
    assert orch.metrics.decisions == want
    assert all("mesh=(1, 1)" in ln for ln in want), want


def _pair_batches(n, dim=8, n_per=32, seed=0):
    jg = jgen.HyperplaneStream(dim=dim, seed=seed, horizon=n * n_per)
    tg = HyperplaneStream(dim=dim, seed=seed, horizon=n * n_per)
    jb = [jg.batch(i, n_per) for i in range(n)]
    tb = [tg.batch(i, n_per) for i in range(n)]
    for a, b in zip(jb, tb):
        for k in a.data:
            np.testing.assert_array_equal(a.data[k], b.data[k])
    return jb, tb


def _scenario(kind, cm_, ms_, orch_mod, pl_, sla_, batches, device=None):
    """One topology scenario through one package: the pool-loss test's,
    the join test's, or a directory nobody mutates. Every event is kept
    (sample_rate 1.0: the packages draw the thinning differently) and
    the worker count is pinned (max_workers 1), so no voluntary rescale
    reads the wall clock; the involuntary one still runs."""
    def edge_b(name="edge_b"):
        return cm_.Resource(name, "edge", chips=2, flops=4e12, mem_bw=100e9,
                            mem_cap=8e9, net_bw=1e9, net_latency=5e-3)

    d = ms_.MembershipDirectory(cm_.ClusterSpec(
        pools=[cm_.EDGE_NODE, cm_.CLOUD_POD],
        links=[cm_.Link("edge", "cloud", bw=2e6, latency=20e-3)]))
    if kind == "pool_loss":
        d.register(edge_b(), links=[cm_.Link("edge_b", "cloud", bw=8e6,
                                             latency=5e-3)], now=0)
    kw = {} if device is None else {"device": device}
    job = orch_mod.StreamJob(
        "dyn", dim=8, sla=sla_.SLA(max_latency_s=1e3, error_budget=11.0),
        membership=d, pipeline=pl_.fanout_stream_graph(8, sample_rate=1.0),
        sla_window=5, max_workers=1, **kw)
    orch = orch_mod.Orchestrator(job)

    def stream():
        for i, b in enumerate(batches):
            if kind == "pool_loss" and i < 6:
                d.heartbeat("edge_b", now=i)
            if kind == "join" and i == 3:
                d.register(edge_b(), links=[cm_.Link(
                    "edge_b", "cloud", bw=8e6, latency=5e-3)],
                    now=i, monitored=False)
            yield b

    return orch, orch.run(stream(), rate_fn=lambda s: 1e4), d


@pytest.mark.parametrize("kind", ["pool_loss", "join", "zero_event"])
def test_topology_scenarios_match_the_reference(kind, monkeypatch):
    """The reference's pool-loss, join and zero-event scenarios on the
    same numpy batches through both packages: ``JobMetrics`` equal
    (events, cuts, plan identities, codecs, drift alarms, preq within
    1e-4), migrations and rescales equal, and the decision logs equal
    line for line (``max_workers`` 1: the recovery's mesh is (1, 1) in
    both, whatever the reference's host device count). The reference's
    top-k codec
    runs its Pallas kernel in interpret mode, which keeps ties as the
    port does. Where the scenario rescales, the port's states come back
    bitwise and on the job's device."""
    n = {"pool_loss": 14, "join": 8, "zero_event": 10}[kind]
    jb, tb = _pair_batches(n)
    monkeypatch.setenv("JAX_PALLAS_INTERPRET", "1")
    jo, jm, jd = _scenario(kind, jcm, jms, jorch, jpl, jsla, jb)
    monkeypatch.delenv("JAX_PALLAS_INTERPRET", raising=False)

    rescales = []
    orig = torch_orch.Orchestrator._apply_rescale

    def spy(self, step, plan):
        before = self.states
        orig(self, step, plan)
        rescales.append((before, self.states))

    monkeypatch.setattr(torch_orch.Orchestrator, "_apply_rescale", spy)
    to, tm, td = _scenario(kind, cm, tms, torch_orch, pl, tsla, tb,
                           device="cpu")
    _compare_metrics(jm, tm)
    assert tm.migrations == jm.migrations and tm.rescales == jm.rescales
    assert tm.assignments == jm.assignments
    assert tm.decisions == jm.decisions
    assert _plain(td.events) == _plain(jd.events)
    assert td.version == jd.version
    assert to._exec_assignment == jo._exec_assignment
    assert sorted(to.controller.resources.pools) == \
        sorted(jo.controller.resources.pools)
    if kind == "pool_loss":
        assert any("[in plan]" in ln for ln in tm.decisions)
        assert any(":pool_lost" in ln for ln in tm.decisions)
        assert len(rescales) == tm.rescales >= 1
    if kind == "join":
        assert any(":pool_joined" in ln for ln in tm.decisions)
    if kind == "zero_event":
        assert td.events == [] and rescales == []
    for before, after in rescales:
        fa = tree_flatten_with_path(before)[0]
        fb = tree_flatten_with_path(after)[0]
        assert [p for p, _ in fa] == [p for p, _ in fb]
        for (p, u), (_, v) in zip(fa, fb):
            assert torch.equal(u, v), p
            assert v.device.type == "cpu", p
