"""``fuse="xla"`` in the port (``repro_torch.core.pipeline``): one
program per segment, a CUDA graph on the card and one callable on the
CPU. Held here, on the CPU, to ``fuse="op"`` within the reference's own
tolerance (rtol 1e-5, atol 1e-6, ``tests/test_graph.py``), to the
reference's refusal of host ops, and to the reference's compile-cache
counts over the same frontier walks. The capture itself runs on the card
(``chip_smoke.py`` phase 13); here :class:`_RecordedGraph` stands in
for it, so that ``GraphSegment`` itself runs on the CPU."""

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import pipeline as jpl
from repro.streams import generators as jgen

from repro_torch._tree import tree_leaves
from repro_torch.core import orchestrator as torch_orch
from repro_torch.core import pipeline as tpl
from repro_torch.core import sla as tsla
from repro_torch.streams.generators import DriftSpec, HyperplaneStream

# the phase-13 walk: cuts 0 -> 2 -> 5 -> 2 -> 0, one batch each
LINEAR_WALK = (0, 2, 5, 2, 0)
FANOUT_WALK = (frozenset({"normalize", "sketch", "anomaly", "sample",
                          "train"}),
               frozenset({"normalize", "anomaly"}),
               frozenset({"normalize", "sketch", "anomaly", "sample",
                          "train"}),
               frozenset({"normalize", "sketch", "anomaly", "sample",
                          "train"}))


def _data(n, dim=8, n_per=32):
    gen = jgen.HyperplaneStream(dim=dim, seed=0, horizon=n * n_per)
    return [gen.batch(i, n_per) for i in range(n)]


def _run_port(p, data, cuts, seed=11):
    """The port's ``p`` over ``data``, batch i at ``cuts[i]``, threading
    the rng channel as the reference's tests thread the key."""
    states = p.init_states("cpu")
    rng = torch.tensor(seed, dtype=torch.int64)
    outs = []
    for b, cut in zip(data, cuts):
        bd = {k: torch.as_tensor(v) for k, v in b.data.items()}
        bd["rng"] = rng
        states, out = p.run(states, bd, cut)
        rng = out["rng"]
        outs.append({k: v.numpy() for k, v in out.items() if k != "rng"})
    return states, outs


def _run_jax(p, data, cuts):
    states = p.init_states()
    rng = jax.random.PRNGKey(0)
    for b, cut in zip(data, cuts):
        bd = {k: jnp.asarray(v) for k, v in b.data.items()}
        bd["rng"] = rng
        states, out = p.run(states, bd, cut)
        rng = out["rng"]
    return states


@pytest.mark.parametrize("linear", [False, True])
def test_fuse_xla_segments_match_op_mode_allclose(linear):
    """tests/test_graph.py's parametrisations, in the port: every cut of
    the run under ``fuse="xla"`` against ``fuse="op"``, within rtol 1e-5
    and atol 1e-6 (the CPU runs the same composition, so it is bitwise
    here; the card's graph replays the same kernels)."""
    if linear:
        ref = tpl.standard_stream_pipeline(dim=8)
        xla = tpl.Pipeline(ref.ops, fuse="xla")
        cuts = (0, 2, len(ref.ops))
    else:
        ref = tpl.fanout_stream_graph(dim=8)
        xla = tpl.OpGraph(ref.ops, fuse="xla")
        cuts = (frozenset(), frozenset({"normalize", "anomaly"}))
    data = _data(2)
    for cut in cuts:
        (sa, oa), (sb, ob) = (_run_port(p, data, (cut,) * len(data))
                              for p in (ref, xla))
        la, lb = tree_leaves(sa), tree_leaves(sb)
        assert len(la) == len(lb)
        for a, b in zip(la, lb):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"cut={cut}")
        for a, b in zip(oa, ob):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6,
                                           err_msg=f"cut={cut} [{k}]")
    # the CPU has no graph: every cached segment is the composition
    assert xla.graph_segments == [] and xla.compiles > 0


def test_fuse_xla_refuses_host_ops_as_the_reference_does():
    def step(state, batch):
        return state, batch
    cost = tpl.normalize_op(8).cost
    ops = [tpl.normalize_op(8),
           tpl.Op("host", step, cost, reads=("x",), writes=(), jit=False)]
    jops = [jpl.normalize_op(8),
            jpl.Op("host", step, cost, reads=("x",), writes=(), jit=False)]
    with pytest.raises(ValueError) as te:
        tpl.OpGraph(ops, fuse="xla")
    with pytest.raises(ValueError) as je:
        jpl.OpGraph(jops, fuse="xla")
    assert str(te.value) == str(je.value)
    assert "cannot fuse host ops (jit=False): ['host']" in str(te.value)
    # host ops compose under fuse="op"; the serving ops are host ops
    tpl.OpGraph(ops, fuse="op")
    from repro_torch.serve import ops as serve_ops
    import inspect
    src = inspect.getsource(serve_ops)
    assert src.count("jit=False") >= 2
    with pytest.raises(ValueError, match="not in"):
        tpl.OpGraph(ops[:1], fuse="jit")


@pytest.mark.parametrize("fuse", ["op", "xla"])
def test_compile_cache_counts_equal_the_references_over_a_walk(fuse):
    """The same frontier walks in both packages: a capture per new
    (segment, signature), a hit per revisit; walking back to a cut
    already run compiles nothing (tests/test_graph.py:148)."""
    data = _data(max(len(LINEAR_WALK), len(FANOUT_WALK)))
    for make_t, make_j, walk, want in (
            (lambda: tpl.Pipeline(tpl.standard_stream_pipeline(8).ops,
                                  fuse=fuse),
             lambda: jpl.Pipeline(jpl.standard_stream_pipeline(8).ops,
                                  fuse=fuse), LINEAR_WALK, (3, 4)),
            (lambda: tpl.OpGraph(tpl.fanout_stream_graph(8).ops, fuse=fuse),
             lambda: jpl.OpGraph(jpl.fanout_stream_graph(8).ops, fuse=fuse),
             FANOUT_WALK, (4, 4))):
        tp, jp = make_t(), make_j()
        _run_port(tp, data, walk)
        _run_jax(jp, data, walk)
        # the linear walk's segments: ops 0-4 (cuts 0 and 5), 0-1 and 2-4
        assert (tp.compiles, tp.cache_hits) == \
            (jp.compiles, jp.cache_hits) == want
        _run_port(tp, data[:1], walk[:1])        # a revisit: no capture
        assert tp.compiles == want[0] and tp.cache_hits > want[1]


def test_orchestrator_job_under_fuse_xla_equals_fuse_op():
    """The standard job with the pipeline built under each mode, a rate
    that moves the cut: the same JobMetrics, the same learner."""
    gen = HyperplaneStream(dim=8, seed=0, horizon=12 * 64,
                           drift=DriftSpec(kind="abrupt", at=0.5,
                                           magnitude=2.0))
    batches = [gen.batch(i, 64) for i in range(12)]
    rates = [1e4] * 4 + [8e7] * 4 + [1e4] * 4
    runs = []
    for fuse in ("op", "xla"):
        orch = torch_orch.Orchestrator(torch_orch.StreamJob(
            "x", dim=8, device="cpu", uplink_codecs=["int8_ef"],
            sla=tsla.SLA(max_latency_s=1e3, error_budget=0.1),
            pipeline=tpl.standard_stream_pipeline(8, fuse=fuse)))
        m = orch.run(batches, rate_fn=lambda s: rates[s],
                     record_outputs=True)
        runs.append((orch, m))
    (oa, ma), (ob, mb) = runs
    assert len(set(ma.cuts)) > 1, "the rate must move the cut"
    for f in ("events", "cuts", "plan_identities", "codecs", "drift_alarms"):
        assert getattr(mb, f) == getattr(ma, f), f
    assert [d for d in mb.decisions if "elastic" not in d] == \
        [d for d in ma.decisions if "elastic" not in d]
    for a, b in zip(ma.outputs, mb.outputs):
        np.testing.assert_array_equal(a["mask"], b["mask"])
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6)
    for a, b in zip(tree_leaves(oa.states), tree_leaves(ob.states)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    assert ob.pipeline.fuse == "xla" and ob.pipeline.graph_segments == []


def test_a_graph_segment_takes_only_tensors_on_one_card():
    """A leaf on the CPU would be read during capture and frozen into the
    graph: the segment refuses it before touching CUDA."""
    g = tpl.standard_stream_pipeline(8, fuse="xla")
    seg = tpl.GraphSegment(g._fuse_ops((0, 1)), ("normalize", "sketch"))
    states = g.init_states("cpu")
    batch = {"x": torch.zeros(4, 8), "y": torch.zeros(4, dtype=torch.int32),
             "rng": torch.tensor(0)}
    with pytest.raises(ValueError, match="one CUDA device"):
        seg({n: states[n] for n in ("normalize", "sketch")}, batch)
    assert seg.graph is None and seg.replays == 0


# ---------------------------------------------------------------------------
# a CUDA graph's semantics on the CPU
# ---------------------------------------------------------------------------

# what a capture on the card refuses: a value read on the host, and a
# tensor built from host data (on the card, a copy from pageable memory)
_HOST_READS = (torch.ops.aten._local_scalar_dense.default,
               torch.ops.aten.is_nonzero.default,
               torch.ops.aten.equal.default)
_HOST_DATA = (torch.ops.aten.lift_fresh.default,
              torch.ops.aten.lift_fresh_copy.default)


class _RecordedGraph:
    """A CUDA graph's semantics on the CPU: the capture records every aten
    op the segment dispatches, its tensors by identity, and a replay runs
    them again on the same tensors, each result written into the tensor
    the capture made. Static addresses and in-place writes behave as they
    do on the card; a value read on the host and a tensor built from host
    data during capture are refused, as the card refuses them."""

    def __init__(self, keep_graph=False):
        self.ops, self.names = [], ()

    def replay(self):
        with torch.no_grad():
            for func, args, kwargs, out in self.ops:
                new = func(*args, **kwargs)
                for o, n in zip(pytree.tree_leaves(out),
                                pytree.tree_leaves(new)):
                    if isinstance(o, torch.Tensor) and not (
                            o.untyped_storage().data_ptr()
                            == n.untyped_storage().data_ptr()
                            and o.storage_offset() == n.storage_offset()
                            and o.stride() == n.stride()):
                        o.copy_(n)

    def raw_cuda_graph(self):
        return self.names


class _Record(TorchDispatchMode):
    def __init__(self, graph):
        super().__init__()
        self.graph = graph

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _HOST_READS:
            raise RuntimeError(f"{func} reads a tensor on the host during "
                               "capture")
        if func in _HOST_DATA:
            raise RuntimeError(f"{func} builds a tensor from host data "
                               "during capture")
        out = func(*args, **kwargs)
        self.graph.ops.append((func, args, kwargs, out))
        return out


class _Through(TorchDispatchMode):
    """Every op through a Python dispatch mode and nothing else: under any
    such mode some composite ops of the train step take another route,
    which rounds otherwise, so a reference for an emulated capture runs
    under one too."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


class _Stream:
    def wait_stream(self, other):
        pass


class _EmulatedSegment(tpl.GraphSegment):
    """``GraphSegment`` on CPU tensors, its graph a :class:`_RecordedGraph`
    that names the segment's ops (the node list chip_smoke.py's stub
    makes up from them)."""

    def _device(self, leaves):
        return leaves[0].device

    def _capture(self, leaves, treedef, dev, current):
        super()._capture(leaves, treedef, dev, current)
        self.graph.names = self.names


def _emulate_graphs(monkeypatch):
    """Every ``fuse="xla"`` segment of a CPU run becomes a
    :class:`_EmulatedSegment`, captured and replayed as on the card."""
    @contextlib.contextmanager
    def graph(g, capture_error_mode="global"):
        with _Record(g):
            yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _RecordedGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda dev=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    real = tpl.OpGraph._segment_fn

    def segment_fn(self, idxs, batch):
        made = self.compiles
        fn = real(self, idxs, batch)
        if self.fuse == "xla" and self.compiles > made:
            fn = self._segments[(idxs, self._sig(batch))] = _EmulatedSegment(
                fn, tuple(self.ops[i].name for i in idxs))
        return fn

    monkeypatch.setattr(tpl.OpGraph, "_segment_fn", segment_fn)


def test_emulated_graph_refuses_a_host_read():
    """The emulation refuses what a capture on the card refuses."""
    g = _RecordedGraph()
    x = torch.ones(3)
    with pytest.raises(RuntimeError, match="on the host"):
        with _Record(g):
            float((x * 2).sum())
    with pytest.raises(RuntimeError, match="from host data"):
        with _Record(g):
            x + torch.as_tensor(1.0)
    with _Record(g):
        y = x * 2
    x.fill_(3.0)
    g.replay()
    assert torch.equal(y, torch.full((3,), 6.0))


@pytest.mark.parametrize("linear", [False, True])
def test_graph_segments_replay_as_fuse_op_over_a_walk(monkeypatch, linear):
    """``GraphSegment`` itself over the phase-13 walk, states carried
    across cuts: the first call runs the batch, the capture follows, every
    later call replays; states and outputs equal ``fuse="op"`` within
    rtol 1e-5 and atol 1e-6, captures equal the distinct segments, and
    replays equal the cache hits."""
    _emulate_graphs(monkeypatch)
    if linear:
        ref = tpl.standard_stream_pipeline(dim=8)
        xla = tpl.Pipeline(ref.ops, fuse="xla")
        walk = LINEAR_WALK
    else:
        ref = tpl.fanout_stream_graph(dim=8)
        xla = tpl.OpGraph(ref.ops, fuse="xla")
        walk = FANOUT_WALK
    data = _data(len(walk) + 2)
    walk = walk + walk[:2]
    (sa, oa), (sb, ob) = (_run_port(p, data, walk) for p in (ref, xla))
    for a, b in zip(tree_leaves(sa), tree_leaves(sb), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    for a, b in zip(oa, ob, strict=True):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6)
    segs = xla.graph_segments
    assert len(segs) == xla.compiles == len(xla._segments)
    assert all(s.graph is not None for s in segs)
    assert sum(s.replays for s in segs) == xla.cache_hits > 0


def test_an_in_place_op_updates_the_callers_state_under_a_graph(monkeypatch):
    """``dl_train_op`` (its optimizer writes parameters and moments in
    place and hands the same tensors back) through ``GraphSegment``: three
    steps, the last two replays, bitwise ``fuse="op"`` (both under
    :class:`_Through`, so that the capture's ops round as the eager
    ones); the tensors the caller holds are the updated ones."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import OpGraph
    from repro_torch.train import optim as O
    from repro_torch.train.ops import dl_train_op

    _emulate_graphs(monkeypatch)
    cfg = get_config("qwen2-1.5b", smoke=True)
    rng = np.random.default_rng(3)
    tokens = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                               .astype(np.int32)) for _ in range(3)]
    runs = {}
    for fuse in ("op", "xla"):
        op = dl_train_op(cfg, O.adamw(1e-2), batch_size=2, seq_len=16,
                         device="cpu")
        g = OpGraph([op], fuse=fuse)
        states, losses = g.init_states("cpu"), []
        with _Through():
            for t in tokens:
                held = tree_leaves(states[op.name][:2])
                states, out = g.run(states, {"tokens": t}, frozenset())
                now = tree_leaves(states[op.name][:2])
                assert all(a is b for a, b in zip(held, now, strict=True))
                losses.append(out["loss"])
        runs[fuse] = (g, states[op.name], losses)
    (_, sa, la), (gx, sx, lx) = runs["op"], runs["xla"]
    (seg,) = gx.graph_segments
    assert seg.replays == 2 and gx.compiles == 1
    moved = [not torch.equal(a, b) for a, b in zip(
        tree_leaves(sx[0]), tree_leaves(dl_train_op(
            cfg, O.adamw(1e-2), batch_size=2, seq_len=16,
            device="cpu").init()[0]))]
    assert any(moved)
    for a, b in zip(la + tree_leaves(sa), lx + tree_leaves(sx), strict=True):
        assert torch.equal(a, b)
    assert int(sx[2]) == 3


class _Null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def test_chip_smoke_phase_13_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 13 end to end on the CPU at a small
    size: fuse="xla" segments stand in for CUDA graphs (their node lists
    made up: the DDM kernel in every drift segment), the card's calls are
    stubbed, and launch counts rise at every read (the CPU's plain
    versions count none). Every check of the phase passes."""
    import itertools
    import pathlib

    root = str(pathlib.Path(__file__).resolve().parents[1])
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs
    from repro_torch.kernels import ops

    monkeypatch.setattr(cs, "N_EVENTS", 256)
    monkeypatch.setattr(cs, "DIM", 16)
    monkeypatch.setattr(cs, "CONTROL_EVENTS", 128)
    monkeypatch.setattr(cs, "STRAT_K", 16)
    monkeypatch.setattr(cs, "MODES_PROFILED", 2)
    monkeypatch.setattr(cs, "log", lambda *a: None)
    monkeypatch.setattr(cs, "profiled_window", lambda profile: _Null())
    monkeypatch.setattr(cs, "device_busy", lambda prof, secs: {})
    monkeypatch.setattr(cs, "graph_node_names", lambda raw: (
        ["_ZN12_GLOBAL__N_116ddm_tiled_kernelEPKfxPfPiS3_Px", "memset"]
        if "drift" in raw else ["elementwise"]))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    _emulate_graphs(monkeypatch)
    import repro_torch.configs as tconfigs
    real_config = tconfigs.get_config
    monkeypatch.setattr(tconfigs, "get_config",
                        lambda name, smoke=False: real_config(name, smoke=True))
    monkeypatch.setattr(cs, "TRAIN_B", 2)
    monkeypatch.setattr(cs, "TRAIN_S", 16)
    real_train = cs.train_modes_check

    def train_modes_check(dev):
        with _Through():
            return real_train(dev)

    monkeypatch.setattr(cs, "train_modes_check", train_modes_check)
    tick = itertools.count(1)
    names = list(ops.launch_counts())
    monkeypatch.setattr(ops, "launch_counts",
                        lambda: dict.fromkeys(names, next(tick)))
    batches = cs.dense_batches(cs.N_BATCHES, cs.N_EVENTS, cs.DIM)
    counts = cs.modes_phase(torch.device("cpu"), batches)
    assert set(counts) == set(names) and counts["detector_scan"] > 0


def test_chip_smoke_phase_19_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 19 (the dense job with ADWIN) end to end
    on the CPU at a small size: one ADWIN scan a batch (the plain version
    counted as the kernel), the planted drift's alarm, card against CPU
    (both the CPU here), and fuse="xla" against "op" with the segments
    emulated (ADWIN's kernel the drift segment's made-up node)."""
    import pathlib

    root = str(pathlib.Path(__file__).resolve().parents[1])
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs
    from repro_torch.kernels import detector_scan as tds
    from repro_torch.kernels import ops

    monkeypatch.setattr(cs, "N_EVENTS", 256)
    monkeypatch.setattr(cs, "DIM", 16)
    monkeypatch.setattr(cs, "N_BATCHES", 6)
    monkeypatch.setattr(cs, "ADWIN_SMALL", (4, 128, 16))
    lines = []
    monkeypatch.setattr(cs, "log", lambda *a: lines.append(" ".join(
        str(x) for x in a)))
    monkeypatch.setattr(cs, "graph_node_names", lambda raw: (
        ["_ZN12_GLOBAL__N_117adwin_scan_kernelEPKfxPfPiS3_PxS3_PdS5_S3_i",
         "memset"]
        if "drift" in raw else ["elementwise"]))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    _emulate_graphs(monkeypatch)
    real = ops.detector_scan

    def counted(*a, **k):
        tds.LAUNCHES["detector_scan"] += 1
        return real(*a, **k)
    monkeypatch.setattr(ops, "detector_scan", counted)
    batches = cs.dense_batches(cs.N_BATCHES, cs.N_EVENTS, cs.DIM)
    counts = cs.adwin_phase(torch.device("cpu"), batches)
    assert counts["detector_scan"] >= 3 * len(batches)
    text = "\n".join(lines)
    assert "19b: small job, card vs CPU: events/cuts/codecs/drift_alarms " \
        "equal=True" in text
    assert "19c: fuse='xla' vs 'op': JobMetrics equal=True" in text


def test_chip_smoke_phase_20_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 20 (the dense job with EDDM, then with
    Page-Hinkley, after DDM's) end to end on the CPU at a small size: one
    scan a batch (the plain version counted as the kernel), card against
    CPU (both the CPU here), and fuse="xla" against "op" with the segments
    emulated (the detector's tiled kernel the drift segment's made-up
    node)."""
    import pathlib

    root = str(pathlib.Path(__file__).resolve().parents[1])
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs
    from repro_torch.kernels import detector_scan as tds
    from repro_torch.kernels import ops

    monkeypatch.setattr(cs, "N_EVENTS", 256)
    monkeypatch.setattr(cs, "DIM", 16)
    monkeypatch.setattr(cs, "N_BATCHES", 6)
    monkeypatch.setattr(cs, "ADWIN_SMALL", (4, 128, 16))
    lines = []
    monkeypatch.setattr(cs, "log", lambda *a: lines.append(" ".join(
        str(x) for x in a)))
    running = {}
    real_modes = cs.modes_run

    def modes_run(*a, detector="ddm", **k):
        running["kernel"] = f"{detector}_tiled_kernel"
        return real_modes(*a, detector=detector, **k)
    monkeypatch.setattr(cs, "modes_run", modes_run)
    monkeypatch.setattr(cs, "graph_node_names", lambda raw: (
        [f"_ZN12_GLOBAL__N_1{len(running['kernel'])}{running['kernel']}"
         "EPKfxPfPiS3_PxS3_", "memset"]
        if "drift" in raw else ["elementwise"]))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    _emulate_graphs(monkeypatch)
    real = ops.detector_scan

    def counted(*a, **k):
        tds.LAUNCHES["detector_scan"] += 1
        return real(*a, **k)
    monkeypatch.setattr(ops, "detector_scan", counted)
    batches = cs.dense_batches(cs.N_BATCHES, cs.N_EVENTS, cs.DIM)
    out = cs.detector_jobs_phase(torch.device("cpu"), batches)
    assert set(out) == set(cs.DETECTOR_JOBS) == {"eddm", "ph"}
    assert all(c["detector_scan"] >= 3 * len(batches) for c in out.values())
    text = "\n".join(lines)
    for det in cs.DETECTOR_JOBS:
        assert "20b: small job, card vs CPU: events/cuts/codecs/" \
            "drift_alarms equal=True" in text
        assert f"(xla) detector={det}" in text
    assert text.count("20c: fuse='xla' vs 'op': JobMetrics equal=True") == 2


def test_chip_smoke_counts_every_hand_kernel_in_a_graph():
    """A hand kernel (a ``__global__`` of the port's sources) in a captured
    graph counts its replays under its wrapper's counter; one without a
    counter fails the phase rather than go uncounted."""
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(root)
    known = cs.hand_kernel_names()
    assert {"ddm_tiled_kernel", "uq_add_global", "flash_fwd_mma",
            "normalize_persistent", "mamba_scan_lanes"} <= set(known)
    ddm = "_ZN12_GLOBAL__N_116ddm_tiled_kernelEPKfxPfPiS3_Px"
    got = cs.graph_launches({("a",): (3, [ddm, "memset", "elementwise"]),
                             ("b",): (2, [ddm])})
    assert got == {"detector_scan": 5}
    with pytest.raises(AssertionError, match="normalize_persistent"):
        cs.graph_launches({("a",): (1, [
            "_ZN12_GLOBAL__N_120normalize_persistentEPKfS1_"])})
