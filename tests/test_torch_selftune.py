"""The port's measured operator costs (``repro_torch.core.selftune``,
``launch/op_count.py``, ``StreamJob(measured_costs=True)``) against the
JAX package's: the counterparts of ``tests/test_placement_dp.py``'s
measured-cost tests; both orchestrators fed the reference's measured
table give identical plans and decisions; the measured output and state
bytes equal the reference's (every dtype matches on these graphs); the
tuner's candidates and verdicts equal the reference's for every config;
a kernel dispatcher counts its kernel's formula, not its plain body."""

from dataclasses import asdict, replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.core import costmodel as jcm
from repro.core import orchestrator as jorch
from repro.core import pipeline as jpl
from repro.core import selftune as jst
from repro.core import sla as jsla
from repro.streams import generators as jgen

from repro_torch import configs as tconfigs
from repro_torch.core import costmodel as tcm
from repro_torch.core import orchestrator as torch_orch
from repro_torch.core import pipeline as tpl
from repro_torch.core import selftune as tst
from repro_torch.core import sla as tsla
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.launch import op_count, roofline
from repro_torch.streams import drift as tdrift
from repro_torch.streams.generators import HyperplaneStream


def _multipool_spec(cm):
    """tests/test_placement_dp.py's multipool_spec, in either package: 2
    edge pools and 2 cloud pods with declared links."""
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
    return cm.ClusterSpec(pools, links=links)


def _batches(dim=8, n=32, seed=0):
    """The same first batch for both packages."""
    b = jgen.HyperplaneStream(dim=dim, seed=seed, horizon=n).batch(0, n)
    jb = {k: jnp.asarray(v) for k, v in b.data.items()}
    jb["rng"] = jax.random.PRNGKey(0)
    tb = {k: torch.as_tensor(v) for k, v in b.data.items()}
    tb["rng"] = torch.zeros((), dtype=torch.int64)
    return jb, tb


# ---------------------------------------------------------------------------
# the counterparts of tests/test_placement_dp.py:381-419
# ---------------------------------------------------------------------------

def test_measure_operator_costs_measures_and_preserves_flags():
    g = tpl.fanout_stream_graph(dim=8)
    measured, notes = tst.measure_operator_costs(g, _batches()[1])
    assert notes == [] and set(measured) == set(g.names)
    declared = {op.name: op.cost for op in g.ops}
    for name, c in measured.items():
        assert c.flops_per_event > 0, name
        assert c.bytes_per_event > 0, name
        assert c.edge_capable == declared[name].edge_capable
    assert measured["drift"].edge_capable is False
    # a fresh measurement: the graph's segment cache is untouched
    assert g.compiles == 0 and g.cache_hits == 0


def test_set_measured_costs_validates_and_clears():
    g = tpl.fanout_stream_graph(dim=8)
    declared = g.costs()
    with pytest.raises(ValueError, match="unknown ops"):
        g.set_measured_costs({"ghost": declared[0]})
    g.set_measured_costs({"normalize": replace(declared[0],
                                               flops_per_event=123.0,
                                               edge_capable=False)})
    assert g.cost_of("normalize").flops_per_event == 123.0
    assert g.cost_of("normalize").edge_capable is True
    g.set_measured_costs(None)
    assert g.cost_of("normalize").flops_per_event == \
        declared[0].flops_per_event


def test_orchestrator_measured_costs_end_to_end():
    gen = HyperplaneStream(dim=8, seed=1, horizon=96)
    batches = [gen.batch(i, 32) for i in range(3)]
    job = torch_orch.StreamJob("measured", dim=8, device="cpu",
                               cluster=_multipool_spec(tcm),
                               measured_costs=True)
    orch = torch_orch.Orchestrator(job)
    m = orch.run(batches)
    assert "0:measured-costs 5/5 ops" in m.decisions, m.decisions
    assert m.events == 96
    # placement priced the measured costs, not the declared guesses
    assert orch.ops == orch.pipeline.costs()
    assert orch.ops[0].flops_per_event != \
        orch.pipeline.ops[0].cost.flops_per_event


def test_a_failing_op_stops_the_measurement_with_a_note():
    def boom(state, batch):
        raise RuntimeError("no")
    g = tpl.Pipeline([tpl.normalize_op(8),
                      tpl.Op("bad", boom, tpl.normalize_op(8).cost),
                      tpl.sketch_op(8)])
    measured, notes = tst.measure_operator_costs(g, _batches()[1])
    assert set(measured) == {"normalize"}
    assert len(notes) == 1 and notes[0].startswith(
        "bad: execution failed, measurement aborted (RuntimeError: no)")


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graph", ["standard_stream_pipeline",
                                   "fanout_stream_graph"])
def test_measured_out_and_state_bytes_equal_the_references(graph):
    """Every channel and state leaf has the same dtype in both packages
    here (the reservoir's seed is an int64 where the reference keeps a
    uint32[2] key: 8 bytes either way), so the measured bytes a op writes
    and keeps are equal. flops and bytes per event are the port's own
    counts (unfused; the reference's come from XLA's analysis)."""
    jb, tb = _batches()
    jm, jn = jst.measure_operator_costs(getattr(jpl, graph)(8), jb)
    tm, tn = tst.measure_operator_costs(getattr(tpl, graph)(8), tb)
    assert jn == tn == [] and set(jm) == set(tm)
    for name in jm:
        assert tm[name].out_bytes_per_event == jm[name].out_bytes_per_event
        assert tm[name].state_bytes == jm[name].state_bytes
        assert tm[name].edge_capable == jm[name].edge_capable
        assert tm[name].flops_per_event > 0 and tm[name].bytes_per_event > 0


@pytest.mark.parametrize("graph", ["standard_stream_pipeline",
                                   "fanout_stream_graph"])
def test_the_references_measured_table_gives_identical_plans(graph,
                                                             monkeypatch):
    """Both orchestrators with ``measured_costs=True`` over the multipool
    cluster: the port's measurement replaced by the reference's measured
    table, every event kept (``sample_rate=1.0``: the draws differ), a
    latency limit no batch's wall time reaches, a rate that rises so
    the controller replans. The measured table moves the standard
    chain's plan off the declared one (cut 2 against 4)."""
    jb, _ = _batches(seed=1)
    table, _ = jst.measure_operator_costs(getattr(jpl, graph)(8), jb)
    ported = {k: tcm.OperatorCost(**asdict(v)) for k, v in table.items()}
    seen = []

    def fake(graph, batch, **kw):
        seen.append(sorted(batch))
        return dict(ported), []

    monkeypatch.setattr(tst, "measure_operator_costs", fake)
    gen = jgen.HyperplaneStream(dim=8, seed=1, horizon=8 * 32)
    batches = [gen.batch(i, 32) for i in range(8)]
    rates = [1e4, 1e4, 1e6, 1e6, 1e8, 1e8, 1e4, 1e4]

    def rate(s):
        return rates[min(s, len(rates) - 1)]

    def run(pkg, pl, sla, measured, **kw):
        return pkg.Orchestrator(pkg.StreamJob(
            "m", dim=8, pipeline=getattr(pl, graph)(8, sample_rate=1.0),
            cluster=_multipool_spec(tcm if pkg is torch_orch else jcm),
            measured_costs=measured, sla=sla.SLA(max_latency_s=1e3), **kw))

    jm = run(jorch, jpl, jsla, True).run(batches, rate_fn=rate)
    to = run(torch_orch, tpl, tsla, True, device="cpu")
    tm = to.run(batches, rate_fn=rate)
    assert seen == [["rng", "x", "y"]]
    assert [c.flops_per_event for c in to.ops] == \
        [ported[n].flops_per_event for n in to.pipeline.names]
    assert tm.plan_identities == jm.plan_identities
    assert tm.cuts == jm.cuts and tm.codecs == jm.codecs
    assert [d for d in tm.decisions if "elastic" not in d] == \
        [d for d in jm.decisions if "elastic" not in d]
    n_ops = len(to.pipeline.ops)
    assert tm.decisions[0] == f"0:measured-costs {n_ops}/{n_ops} ops"
    if graph == "standard_stream_pipeline":
        declared = run(torch_orch, tpl, tsla, False, device="cpu").run(
            batches, rate_fn=rate)
        assert (tm.cuts[0], declared.cuts[0]) == (2, 4)


@pytest.mark.parametrize("arch", list(jconfigs.ARCH_IDS))
def test_default_candidates_and_verdicts_equal_the_references(arch):
    assert list(tconfigs.ARCH_IDS) == list(jconfigs.ARCH_IDS)
    for smoke in (False, True):
        jc = jst.default_candidates(jconfigs.get_config(arch, smoke=smoke))
        tc = tst.default_candidates(tconfigs.get_config(arch, smoke=smoke))
        assert [(c.overrides, c.recipe, c.note) for c in tc] == \
            [(c.overrides, c.recipe, c.note) for c in jc]
    rng = np.random.default_rng(len(arch))
    for _ in range(40):
        kw = [dict(ok=bool(rng.random() < 0.8),
                   mem_gib=float(rng.choice([4.0, 16.0, 40.0])),
                   bound_s=float(rng.choice([0.5, 1.0, 2.0])))
              for _ in range(2)]
        cap = float(rng.choice([8.0, 16.0, 64.0]))
        j = [jst.TuneResult(jst.Candidate({}), **k) for k in kw]
        t = [tst.TuneResult(tst.Candidate({}), **k) for k in kw]
        assert t[0].better_than(t[1], cap) == j[0].better_than(j[1], cap)
        assert t[1].better_than(t[0], cap) == j[1].better_than(j[0], cap)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

def test_a_kernel_dispatcher_counts_its_formula_not_its_plain_body():
    n = 4096
    err = (torch.rand(n, generator=torch.Generator().manual_seed(0))
           < 0.2).float()
    with op_count.OpCount() as count:
        st, drifted = kops.detector_scan("ddm", tdrift.ddm_init(), err)
    assert count.flops == 20 * n and count.bytes == 4 * n + 48
    # the plain loop alone counts its many small ops, not the formula
    with op_count.OpCount() as plain:
        tdrift.run_detector(tdrift.ddm_step, tdrift.ddm_init(), err)
    assert plain.flops != count.flops and plain.bytes > 10 * count.bytes
    # and the dispatcher's result is the plain loop's
    pst, pdrift = _plain_ddm(err)
    assert bool(drifted) == bool(pdrift)
    assert all(torch.equal(a, b) for a, b in zip(st, pst))
    # the hash: 8 per feature, the output written once
    ids = torch.randint(-2 ** 31, 2 ** 31 - 1, (64, 8), dtype=torch.int64
                        ).to(torch.int32)
    vals = torch.randn(64, 8)
    with op_count.OpCount() as h:
        out = kops.hash_features(ids, vals, 32)
    assert (h.flops, h.bytes) == (8 * 64 * 8, 8 * 64 * 8 + 4 * 64 * 32)
    assert torch.equal(out, kref.hash_features_ref(ids, vals, 32))
    # nothing is counted when no count is active
    assert op_count.active() is None


def _plain_ddm(err):
    state, levels = tdrift.run_detector(tdrift.ddm_step, tdrift.ddm_init(),
                                        err)
    return state, torch.any(levels == tdrift.DRIFT)


def test_the_counter_counts_products_pointwise_reductions_and_bytes():
    x = torch.randn(32, 8)
    w = torch.randn(8)
    m = torch.randn(8, 5)
    with op_count.OpCount() as c:
        x @ w                      # mv: 2 * 32 * 8
    assert c.flops == 2 * 32 * 8
    assert c.bytes == 4 * (32 * 8 + 8 + 32)
    with op_count.OpCount() as c:
        x @ m                      # mm: 2 * 32 * 8 * 5
        x.sum(0)                   # a reduction: one per input element
        torch.exp(x)               # pointwise: one per output element
        x.T                        # a view: nothing
    assert c.flops == 2 * 32 * 8 * 5 + 32 * 8 + 32 * 8
    assert c.bytes == 4 * ((32 * 8 + 8 * 5 + 32 * 5) + (32 * 8 + 8)
                           + 2 * 32 * 8)
    assert roofline.op_event_costs(c, 32) == (c.flops / 32, c.bytes / 32)
