"""The port's pipeline and orchestrator (``repro_torch.core``): cut
invariance against its own unpartitioned run, ``JobMetrics`` against the
JAX package's on the same jobs and streams, state conversion, import
hygiene, and the device contract."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax
import torch

from repro.core import orchestrator as jorch
from repro.core import pipeline as jpl
from repro.core import sla as jsla
from repro.streams import generators as jgen
from repro.streams.events import StreamBatch as JBatch

from repro_torch import convert
from repro_torch._tree import tree_flatten_with_path, tree_leaves
from repro_torch.core import orchestrator as torch_orch
from repro_torch.core import pipeline as tpl
from repro_torch.core import sla as tsla
from repro_torch.dist import elastic
from repro_torch.streams import generators as tgen
from repro_torch.streams.events import StreamBatch as TBatch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(rng, n=64, dim=8, seed=0):
    x = torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32))
    y = torch.from_numpy((rng.random(n) < 0.5).astype(np.int32))
    return {"x": x, "y": y, "rng": torch.tensor(seed, dtype=torch.int64)}


def _assert_trees_equal(a, b):
    fa, fb = tree_flatten_with_path(a)[0], tree_flatten_with_path(b)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, u), (_, v) in zip(fa, fb):
        assert torch.equal(u, v), p


# ---------------------------------------------------------------------------
# cut invariance: every cut == the port's own unpartitioned run, bitwise
# ---------------------------------------------------------------------------

def _run_all(g, runner, n_batches=4):
    rng = np.random.default_rng(0)
    states = g.init_states("cpu")
    outs = []
    for i in range(n_batches):
        states, out = runner(states, _batch(rng, seed=100 + i))
        outs.append(out)
    return states, outs


def test_every_prefix_cut_is_bitwise_the_reference_run():
    g = tpl.standard_stream_pipeline(8, sample_rate=0.5)
    ref_states, ref_outs = _run_all(g, g.run_reference)
    for cut in range(g.n_cuts):
        states, outs = _run_all(g, lambda s, b: g.run(s, b, cut))
        _assert_trees_equal(states, ref_states)
        for o, r in zip(outs, ref_outs):
            _assert_trees_equal(o, r)
    # one cached segment per distinct op range, reused on every revisit
    n = len(g.ops)
    ranges = ({tuple(range(c)) for c in range(1, n + 1)}
              | {tuple(range(c, n)) for c in range(n)})
    assert g.compiles == len(ranges) and g.cache_hits > 0


def test_every_frontier_of_the_fanout_graph_is_bitwise_the_reference():
    g = tpl.fanout_stream_graph(8, sample_rate=0.5)
    ref_states, ref_outs = _run_all(g, g.run_reference)
    frontiers = list(g.frontiers())
    assert len(frontiers) > len(g.names) + 1     # more than the prefixes
    for f in frontiers:
        states, outs = _run_all(g, lambda s, b: g.run(s, b, f))
        _assert_trees_equal(states, ref_states)
        for o, r in zip(outs, ref_outs):
            _assert_trees_equal(o, r)


# ---------------------------------------------------------------------------
# JobMetrics against the JAX package's
# ---------------------------------------------------------------------------

def _dense_batches(n_batches=24, n=128, dim=16):
    kw = dict(dim=dim, seed=0, horizon=n_batches * float(n))
    jg = jgen.HyperplaneStream(drift=jgen.DriftSpec(kind="abrupt", at=0.5,
                                                    magnitude=2.0), **kw)
    tg = tgen.HyperplaneStream(drift=tgen.DriftSpec(kind="abrupt", at=0.5,
                                                    magnitude=2.0), **kw)
    jb = [jg.batch(i, n) for i in range(n_batches)]
    tb = [tg.batch(i, n) for i in range(n_batches)]
    for a, b in zip(jb, tb):          # the generators are the same numpy
        for k in a.data:
            np.testing.assert_array_equal(a.data[k], b.data[k])
    return jb, tb


def _compare_metrics(jm, tm, preq_tol=1e-4):
    assert tm.events == jm.events
    assert tm.cuts == jm.cuts
    assert tm.plan_identities == jm.plan_identities
    assert tm.codecs == jm.codecs
    assert tm.codec == jm.codec
    assert tm.drift_alarms == jm.drift_alarms
    if jm.preq is None:
        assert tm.preq is None
    else:
        assert tm.preq["n"] == jm.preq["n"]
        for k in ("accuracy", "logloss", "ewma_accuracy"):
            assert tm.preq[k] == pytest.approx(jm.preq[k], abs=preq_tol), k


@pytest.mark.parametrize("codec,budget", [
    ("identity", 0.0), ("int8_ef", 0.1), ("topk_int8_ef", 11.0)])
def test_job_metrics_match_jax_on_the_quickstart_job(codec, budget,
                                                     monkeypatch):
    """The quickstart job with every event kept (sample_rate=1.0, so the
    thinning draws do not enter), a pinned rate and a generous latency
    limit. The JAX package's CPU path keeps exactly k coordinates for
    topk_int8_ef, where the port (like the Pallas kernel) keeps every tie
    at the threshold; the JAX run of that codec therefore takes its
    Pallas kernel in interpret mode, as the JAX package's own tests do."""
    jb, tb = _dense_batches()
    ladder = None if codec == "identity" else [codec]
    kw = dict(dim=16, drift_detector="ddm", sample_rate=1.0,
              uplink_codecs=ladder)
    if codec == "topk_int8_ef":
        monkeypatch.setenv("JAX_PALLAS_INTERPRET", "1")
    jo = jorch.Orchestrator(jorch.StreamJob(
        "q", sla=jsla.SLA(max_latency_s=1e3, error_budget=budget), **kw))
    jm = jo.run(jb, rate_fn=lambda s: 1e4)
    monkeypatch.delenv("JAX_PALLAS_INTERPRET", raising=False)
    to = torch_orch.Orchestrator(torch_orch.StreamJob(
        "q", sla=tsla.SLA(max_latency_s=1e3, error_budget=budget),
        device="cpu", **kw))
    tm = to.run(tb, rate_fn=lambda s: 1e4)
    _compare_metrics(jm, tm)
    assert tm.drift_alarms >= 1, "the planted drift must raise an alarm"
    assert set(tm.codecs) == {codec}
    # the learner ends where the JAX package's does
    for a, b in zip(to.states["train"][0], jo.states["train"][0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)
    # lossy codecs keep their EF residuals on the job's device
    if codec != "identity":
        assert to._uplink_residuals
        assert all(r.device.type == "cpu"
                   for r in to._uplink_residuals.values())


def test_job_metrics_match_jax_on_the_hash_job():
    """hash -> pca -> sketch from the same initial states (the JAX
    package's random PCA start carried across by states_from_numpy)."""
    rng = np.random.default_rng(0)
    data = [{"ids": rng.integers(-2 ** 31, 2 ** 31, (64, 8),
                                 dtype=np.int64).astype(np.int32),
             "vals": rng.normal(size=(64, 8)).astype(np.float32)}
            for _ in range(12)]
    jp = jpl.Pipeline([jpl.hash_op(32), jpl.pca_op(32, 4), jpl.sketch_op(4)])
    tp = tpl.Pipeline([tpl.hash_op(32), tpl.pca_op(32, 4), tpl.sketch_op(4)])
    kw = dict(dim=32, uplink_codecs=["int8_ef"])
    jo = jorch.Orchestrator(jorch.StreamJob(
        "h", pipeline=jp, sla=jsla.SLA(max_latency_s=1e3, error_budget=0.1),
        **kw))
    to = torch_orch.Orchestrator(torch_orch.StreamJob(
        "h", pipeline=tp, sla=tsla.SLA(max_latency_s=1e3, error_budget=0.1),
        device="cpu", **kw))
    to.states = convert.states_from_numpy(tp, _np(jo.states), device="cpu")
    jm = jo.run([JBatch(data=dict(d)) for d in data], rate_fn=lambda s: 1e4)
    tm = to.run([TBatch(data=dict(d)) for d in data], rate_fn=lambda s: 1e4)
    _compare_metrics(jm, tm)
    for a, b in zip(to.states["sketch"], jo.states["sketch"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to.states["pca"].w.numpy(),
                               np.asarray(jo.states["pca"].w),
                               rtol=1e-4, atol=1e-5)


def test_codec_ramp_swaps_codecs_like_jax_and_flushes_residuals():
    """test_adaptive_codec's orchestrated ramp: a saturating rate drives a
    live codec de-escalation and re-escalation at the same steps as in
    the JAX package; each swap flushes the EF residuals."""
    rates = [8e7] * 10 + [1e4] * 10 + [8e7] * 10
    jb, tb = _dense_batches(n_batches=30, n=32, dim=8)
    loose = dict(max_latency_s=1e3, error_budget=11.0)
    jm = jorch.Orchestrator(jorch.StreamJob(
        "ramp", dim=8, sla=jsla.SLA(**loose))).run(
        jb, rate_fn=lambda s: rates[min(s, len(rates) - 1)])
    to = torch_orch.Orchestrator(torch_orch.StreamJob(
        "ramp", dim=8, sla=tsla.SLA(**loose), device="cpu"))
    swaps = []
    swap = to._swap_codec

    def spy(name, step):
        swaps.append((step, to.codec.name, name, len(to._uplink_residuals)))
        swap(name, step)
        assert to._uplink_residuals == {}

    to._swap_codec = spy
    tm = to.run(tb, rate_fn=lambda s: rates[min(s, len(rates) - 1)])
    assert tm.codecs == jm.codecs and tm.cuts == jm.cuts
    assert tm.plan_identities == jm.plan_identities
    assert [(a, b) for _, a, b, _ in swaps] == [
        ("topk_int8_ef", "identity"), ("identity", "topk_int8_ef")]
    assert swaps[0][3] > 0          # the lossy codec had live residuals
    assert to._uplink_residuals     # and the run ends lossy again


# ---------------------------------------------------------------------------
# states_from_numpy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("detector", ["ddm", "eddm", "ph", "adwin"])
def test_states_from_numpy_round_trips_the_jax_states(detector):
    jg = jpl.fanout_stream_graph(8, drift_detector=detector)
    tg = tpl.fanout_stream_graph(8, drift_detector=detector)
    js = jg.init_states()
    rng = np.random.default_rng(1)
    for _ in range(2):           # move every state off its initial value
        x = rng.normal(size=(32, 8)).astype(np.float32)
        y = (rng.random(32) < 0.5).astype(np.int32)
        js, _ = jg.run_reference(js, {"x": x, "y": y,
                                      "rng": jax.random.PRNGKey(3)})
    ts = convert.states_from_numpy(tg, _np(js), device="cpu")
    for name in tg.names:
        flat_t = tree_flatten_with_path(ts[name])[0]
        flat_j = tree_flatten_with_path(_np(js[name]))[0]
        assert [p for p, _ in flat_t] == [p for p, _ in flat_j], name
        for (p, t), (_, j) in zip(flat_t, flat_j):
            if p.endswith(".rng"):
                assert int(t) == convert.key_to_seed(j)
            else:
                np.testing.assert_array_equal(t.numpy(), j, err_msg=p)
    # the converted states drive the port's graph
    ts2, out = tg.run_reference(ts, _batch(rng, n=16))
    assert out["alert"].shape == ()
    with pytest.raises(ValueError):
        convert.states_from_numpy(tg, {"normalize": _np(js["normalize"])},
                                  device="cpu")


def test_elastic_rescale_keeps_states_bitwise(tmp_path):
    orch = torch_orch.Orchestrator(torch_orch.StreamJob(
        "e", dim=8, device="cpu", ckpt_dir=str(tmp_path)))
    jb, tb = _dense_batches(n_batches=3, dim=8)
    orch.run(tb, rate_fn=lambda s: 1e4)
    before = orch.states
    orch._apply_rescale(3, elastic.plan_reshard(1, 2, reason="test"))
    _assert_trees_equal(orch.states, before)
    assert orch.metrics.decisions[-1].startswith("3:elastic-grow workers=2")


# ---------------------------------------------------------------------------
# imports and devices
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "new = ('repro_torch.dist.api', 'repro_torch.dist.sharding', "
        "'repro_torch.dist.elastic', 'repro_torch.dist.compression', "
        "'repro_torch.launch.mesh', 'repro_torch.launch.serve', "
        "'repro_torch.launch.train')\n"
        "assert all(m in sys.modules for m in new), new\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 80       # every module was imported
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in smoke and "from repro." not in smoke


def test_orchestrator_runs_on_the_card_unless_asked_for_the_cpu():
    job = torch_orch.StreamJob("d", dim=8)
    assert job.device == "cuda"
    if torch.cuda.is_available():
        assert torch_orch.Orchestrator(job).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_orch.Orchestrator(job)
    orch = torch_orch.Orchestrator(torch_orch.StreamJob("d", dim=8,
                                                        device="cpu"))
    assert all(t.device.type == "cpu" for t in tree_leaves(orch.states))


def test_unported_options_raise():
    """A live topology (``membership=``) excludes a static ``cluster=``,
    as in the JAX package. ``measured_costs`` and ``fuse="xla"`` are
    ported (``tests/test_torch_selftune.py``,
    ``tests/test_torch_fuse_segments.py``), and so is the
    execution-config tuner's scoring: ``evaluate_candidate`` and
    ``tune`` run the dry run (``tests/test_torch_dryrun.py``). Here a
    candidate with an unknown recipe fails in the cell's rules, before
    any process group is touched, and comes back as a failed verdict."""
    from repro_torch.core import selftune
    from repro_torch.core.costmodel import ClusterSpec
    from repro_torch.core.membership import MembershipDirectory
    with pytest.raises(ValueError, match="not both"):
        torch_orch.Orchestrator(torch_orch.StreamJob(
            "m", device="cpu", cluster=ClusterSpec.edge_cloud(),
            membership=MembershipDirectory(ClusterSpec.edge_cloud())))
    bad = selftune.Candidate({}, recipe="bogus", note="bogus")
    r = selftune.evaluate_candidate("qwen2-1.5b", "train_4k", bad,
                                    device="cpu")
    assert not r.ok and r.error.startswith("ValueError: unknown recipe")
    assert r.record["recipe"] == "bogus" and not r.record["ok"]
    best, results = selftune.tune("qwen2-1.5b", "train_4k", [bad, bad],
                                  device="cpu")
    assert [x.ok for x in results] == [False, False] and best is results[0]
