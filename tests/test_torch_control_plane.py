"""Plan identity between the port's control plane and the JAX package's:
the same graphs, clusters, rates and SLA reports must give the same
placements, codec admissions and offload-controller trajectories. The
graphs are the random DAGs of ``tests/test_placement_dp.py`` and the
ladders of ``tests/test_adaptive_codec.py``, built in both packages."""

import numpy as np
import pytest

from repro.core import costmodel as jcm
from repro.core import pipeline as jpl
from repro.core import placement as jP
from repro.core import sla as jsla
from repro.core.offload import OffloadController as JController

from repro_torch.core import costmodel as tcm
from repro_torch.core import pipeline as tpl
from repro_torch.core import placement as tP
from repro_torch.core import sla as tsla
from repro_torch.core.offload import OffloadController as TController

SIDES = {"jax": (jcm, jpl, jP, jsla, JController),
         "torch": (tcm, tpl, tP, tsla, TController)}


def _noop(s, b):
    return s, {}


def random_graph(side, seed, n_ops):
    """test_placement_dp's random DAG, in the package ``side``."""
    cm, pl = SIDES[side][:2]
    rng = np.random.default_rng(seed)
    ops = []
    for j in range(n_ops):
        reads = ["src"] if j == 0 else None
        if j > 0:
            k = rng.integers(1, min(j, 3) + 1)
            parents = sorted(rng.choice(j, size=k, replace=False).tolist())
            reads = [f"k{i}" for i in parents]
            if rng.random() < 0.3:
                reads.append("src")
        cost = cm.OperatorCost(
            name=f"op{j}",
            flops_per_event=float(rng.integers(10, 10 ** 7)),
            bytes_per_event=float(rng.integers(8, 4096)),
            out_bytes_per_event=float(rng.integers(1, 2048)),
            edge_capable=bool(rng.random() < 0.8))
        ops.append(pl.Op(name=f"op{j}", fn=_noop, init=dict, reads=reads,
                         writes=[f"k{j}"], cost=cost))
    return pl.OpGraph(ops)


def multipool_spec(side, codec=None):
    cm = SIDES[side][0]
    pools = {
        "edge_a": cm.Resource("edge_a", "edge", chips=1, flops=2e12,
                              mem_bw=4e11, mem_cap=8e9, net_bw=1e9,
                              energy_w=30.0),
        "edge_b": cm.Resource("edge_b", "edge", chips=1, flops=1e12,
                              mem_bw=2e11, mem_cap=4e9, net_bw=5e8,
                              energy_w=15.0),
        "cloud": cm.Resource("cloud", "cloud", chips=4, flops=5e12,
                             mem_bw=8e11, mem_cap=32e9, net_bw=1e10,
                             energy_w=300.0),
        "cloud_b": cm.Resource("cloud_b", "cloud", chips=8, flops=5e12,
                               mem_bw=8e11, mem_cap=64e9, net_bw=1e10,
                               energy_w=500.0),
    }
    links = [cm.Link("edge_a", "cloud", bw=2e8, latency=0.03),
             cm.Link("edge_b", "cloud", bw=1e8, latency=0.05),
             cm.Link("edge_a", "edge_b", bw=5e8, latency=0.005)]
    spec = cm.ClusterSpec(pools, links=links)
    return spec.with_uplink_codec(codec) if codec else spec


def _plan_key(plan, frontier):
    return (tuple(sorted(plan.assignment.items())), tuple(sorted(frontier)),
            plan.uplink_codec, plan.feasible, plan.latency_s,
            plan.uplink_utilization, plan.energy_w)


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("codecs", [None, ("topk_int8_ef", "identity",
                                           "int8_ef")])
def test_place_frontier_plan_identical(seed, codecs):
    rate = float(np.random.default_rng(100 + seed).choice([1e3, 1e4, 1e5]))
    n_ops = 2 + seed % 4 if codecs is None else 3 + seed % 5
    kw = {} if codecs is None else {"codecs": list(codecs)}
    out = {}
    for side in SIDES:
        P = SIDES[side][2]
        obj = P.Objective()
        g = random_graph(side, seed, n_ops)
        spec = multipool_spec(side)
        en = P.place_frontier(g, spec, rate, obj, method="enumerate", **kw)
        dp = P.place_frontier_dp(g, spec, rate, obj, **kw)
        out[side] = (_plan_key(*en), _plan_key(*dp), obj.score(en[0]))
    assert out["torch"] == out["jax"]


def test_prefix_placement_of_the_standard_pipeline_identical():
    out = {}
    for side in SIDES:
        cm, pl, P = SIDES[side][:3]
        ops = pl.standard_stream_pipeline(16).costs()
        spec = cm.ClusterSpec.edge_cloud()
        out[side] = [(P.place(ops, spec, r, P.Objective())[1],
                      P.place(ops, spec, r, P.Objective())[0].latency_s)
                     for r in (1e2, 1e4, 1e6, 8e7)]
    assert out["torch"] == out["jax"]


REPORTS = [None,
           {"uplink_utilization": 0.95, "violation_rate": 0.0},
           {"uplink_utilization": 1.5, "violation_rate": 0.0},
           {"uplink_utilization": 0.1, "violation_rate": 0.0,
            "codec": "topk_int8_ef"},
           {"uplink_utilization": 0.7, "violation_rate": 0.2,
            "latency_violation_rate": 0.2, "codec": "int8_ef"},
           {"uplink_utilization": 0.7, "violation_rate": 0.2,
            "latency_violation_rate": 0.0, "codec": "topk_ef"},
           {"uplink_utilization": 0.7, "violation_rate": 0.0,
            "codec": "int8_ef"}]


@pytest.mark.parametrize("budget", [0.0, 0.02, 0.1, 10.0, 11.0])
def test_codec_admission_identical(budget):
    for report in REPORTS:
        names = {}
        for side in SIDES:
            sla = SIDES[side][3]
            spec = sla.SLA(error_budget=budget)
            names[side] = ([c.name for c in sla.codec_candidates(
                spec, report=report)],
                sla.pick_codec(spec, report=report).name)
        assert names["torch"] == names["jax"], report


def _history(ctl):
    return [(d.step, d.reason, d.codec, d.cut,
             tuple(sorted(d.assignment.items())), d.migration.bytes, d.migration.moves)
            for d in ctl.history]


@pytest.mark.parametrize("method", ["dp", "enumerate"])
def test_fanout_controller_trajectory_identical(method):
    rates = [5e6, 1e3, 5e6, 1e3, 5e6, 2e4, 5e6, 1e3, 8e7, 1e4]
    hist = {}
    for side in SIDES:
        cm, pl, P, sla, Ctl = SIDES[side]
        g = pl.fanout_stream_graph(dim=8)
        ctl = Ctl(g.costs(), multipool_spec(side), graph=g,
                  codec="topk_int8_ef",
                  sla_spec=sla.SLA(max_latency_s=1e3, error_budget=11.0),
                  cooldown=1, codec_cooldown=1, placement_method=method)
        ctl.initial_plan(5e6)
        for step, rate in enumerate(rates):
            ctl.observe(step, rate)
        hist[side] = (_history(ctl), ctl.migrations())
    assert hist["torch"] == hist["jax"]


@pytest.mark.parametrize("kw", [{}, {"cooldown": 1, "codec_cooldown": 100},
                                {"cooldown": 1, "codec_cooldown": 1}])
def test_codec_ramp_controller_trajectory_identical(kw):
    """test_adaptive_codec's ramp: escalate/de-escalate with hysteresis."""
    rates = [8e7] * 10 + [1e4] * 10 + [8e7] * 10 + [3e4] * 4
    hist = {}
    for side in SIDES:
        cm, pl, P, sla, Ctl = SIDES[side]
        g = pl.standard_stream_pipeline(dim=8, sample_rate=0.5)
        ctl = Ctl(g.costs(), cm.ClusterSpec.edge_cloud(), graph=g,
                  codec="topk_int8_ef",
                  sla_spec=sla.SLA(max_latency_s=1e3, error_budget=11.0),
                  **kw)
        ctl.initial_plan(rates[0])
        for step, r in enumerate(rates):
            ctl.observe(step, r)
        hist[side] = (_history(ctl), ctl.migrations())
    assert hist["torch"] == hist["jax"]
    assert len({h[2] for h in hist["torch"][0]}) > 1 or kw


def test_sla_tracker_reports_identical():
    reports = {}
    for side in SIDES:
        sla = SIDES[side][3]
        tr = sla.SLATracker(sla.SLA(max_latency_s=0.1, min_throughput=50.0),
                            window=5)
        out = []
        for lat, thr in [(0.05, 100), (0.2, 100), (0.05, 10), (0.3, 5),
                         (0.01, 500), (0.02, 400), (0.03, 300), (0.01, 90)]:
            tr.observe(lat, thr)
            out.append((tr.ok(), tr.report()))
        reports[side] = out
    assert reports["torch"] == reports["jax"]
