"""The port's multi-stream fusion (``repro_torch.streams.fusion``) against
the JAX package's on the same numpy arrays, bitwise: the four
``WindowJoin`` cases and the delayed-label aligner of
``tests/test_streams.py``, and a longer randomized join. Then the
fusion-fed job of ``tests/test_pipeline.py`` through both orchestrators:
events, cuts and plans equal, prequential metrics within 1e-4."""

import numpy as np
import pytest

from repro.core import orchestrator as jorch
from repro.core import pipeline as jpl
from repro.core import sla as jsla
from repro.streams import fusion as jfu
from repro.streams import generators as jgen
from repro.streams.events import StreamBatch as JBatch

from repro_torch.core import orchestrator as torch_orch
from repro_torch.core import pipeline as tpl
from repro_torch.core import sla as tsla
from repro_torch.streams import fusion as tfu
from repro_torch.streams.events import StreamBatch as TBatch


def _pair(data, ts):
    """The same arrays as a batch of each package."""
    return (JBatch(data={k: v.copy() for k, v in data.items()},
                   ts=np.array(ts)),
            TBatch(data={k: v.copy() for k, v in data.items()},
                   ts=np.array(ts)))


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _same_batch(jb, tb):
    assert sorted(jb.data) == sorted(tb.data)
    for k in jb.data:
        _same(jb.data[k], tb.data[k])
    _same(np.asarray(jb.ts), np.asarray(tb.ts))
    assert (jb.watermark, jb.seq_no, jb.source_id) == \
        (tb.watermark, tb.seq_no, tb.source_id)


def _same_ring(jj, tj):
    assert (jj._head, jj._tail) == (tj._head, tj._tail)
    _same(jj._rt, tj._rt)
    if jj._rv is None:
        assert tj._rv is None
    else:
        _same(jj._rv, tj._rv)


def _joins(jj, tj, left):
    jl, tl = _pair(*left)
    (jo, jm), (to, tm) = jj.join_left(jl), tj.join_left(tl)
    _same_batch(jo, to)
    _same(jm, tm)
    _same_ring(jj, tj)
    return to, tm


def test_window_join_matches_within_tolerance():
    jj, tj = jfu.WindowJoin(tolerance=0.5), tfu.WindowJoin(tolerance=0.5)
    for j, b in zip((jj, tj), _pair(
            {"x": np.arange(10, dtype=np.float32)[:, None]},
            np.arange(10, dtype=np.float64))):
        j.push_right(b)
    out, matched = _joins(jj, tj, ({"x": np.zeros((3, 1), np.float32)},
                                   np.asarray([2.05, 5.4, 30.0])))
    assert matched.tolist() == [True, True, False]
    assert out.data["joined"][:2, 0].tolist() == [2.0, 5.0]
    # before any push the column is width 0
    e_j, e_t = jfu.WindowJoin(), tfu.WindowJoin()
    _joins(e_j, e_t, ({"x": np.zeros((2, 1), np.float32)},
                      np.asarray([1.0, 2.0])))


def test_window_join_circular_buffer_reuses_storage():
    jj = jfu.WindowJoin(tolerance=0.5, max_buffer=100)
    tj = tfu.WindowJoin(tolerance=0.5, max_buffer=100)

    def push(lo):
        for j, b in zip((jj, tj), _pair(
                {"x": np.full((40, 2), float(lo), np.float32)},
                np.arange(lo, lo + 40, dtype=np.float64))):
            j.push_right(b)

    push(0)
    buf_t, buf_v = tj._buf_t, tj._buf_v
    assert len(buf_t) >= 2 * tj.max_buffer
    for lo in range(40, 40 * 5, 40):
        push(lo)
        assert tj._buf_t is buf_t and tj._buf_v is buf_v
        _same_ring(jj, tj)
    for lo in range(200, 1200, 40):
        push(lo)
        _same_ring(jj, tj)
    assert tj._buf_t is buf_t
    out, matched = _joins(jj, tj, ({"x": np.zeros((3, 1), np.float32)},
                                   np.asarray([1100.2, 1150.0, 10.0])))
    assert matched.tolist() == [True, True, False]
    assert out.data["joined"][:2, 0].tolist() == [1080.0, 1120.0]


def test_window_join_promotes_value_dtype_mid_stream():
    jj = jfu.WindowJoin(tolerance=0.5, max_buffer=16)
    tj = tfu.WindowJoin(tolerance=0.5, max_buffer=16)
    for data, ts in (({"x": np.arange(4)[:, None]},
                      np.arange(4, dtype=np.float64)),
                     ({"x": np.full((4, 1), 7.5, np.float64)},
                      np.arange(4, 8, dtype=np.float64))):
        for j, b in zip((jj, tj), _pair(data, ts)):
            j.push_right(b)
    out, matched = _joins(jj, tj, ({"x": np.zeros((1, 1), np.float32)},
                                   np.asarray([5.0])))
    assert matched.all() and out.data["joined"][0, 0] == 7.5
    assert out.data["joined"].dtype == np.float64


def test_window_join_oversized_push_keeps_newest():
    jj = jfu.WindowJoin(tolerance=0.5, max_buffer=10)
    tj = tfu.WindowJoin(tolerance=0.5, max_buffer=10)
    for j, b in zip((jj, tj), _pair(
            {"x": np.arange(25, dtype=np.float32)[:, None]},
            np.arange(25, dtype=np.float64))):
        j.push_right(b)
    _same_ring(jj, tj)
    np.testing.assert_array_equal(tj._rt, np.arange(15, 25, dtype=np.float64))


def test_window_join_randomized_stream_is_bitwise_the_reference():
    """Jittered timestamps, ties between neighbours, pushes of varying
    size through several wraps of a small ring."""
    rng = np.random.default_rng(3)
    jj = jfu.WindowJoin(tolerance=0.3, max_buffer=64)
    tj = tfu.WindowJoin(tolerance=0.3, max_buffer=64)
    t = 0.0
    for _ in range(30):
        n = int(rng.integers(1, 50))
        ts = t + np.sort(rng.uniform(0, 10, n).round(1))
        t = float(ts[-1])
        vals = rng.normal(size=(n, 3)).astype(np.float32)
        for j, b in zip((jj, tj), _pair({"x": vals}, ts)):
            j.push_right(b)
        left_ts = t - rng.uniform(0, 12, 20)
        _joins(jj, tj, ({"x": np.zeros((20, 2), np.float32)}, left_ts))


def test_delayed_label_aligner():
    ja, ta = jfu.DelayedLabelAligner(), tfu.DelayedLabelAligner()
    feats = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    for a in (ja, ta):
        a.push_features(np.arange(5), np.arange(5, dtype=np.float64), feats)
    assert ja.backlog == ta.backlog == 5
    jo = ja.push_labels(np.asarray([1, 3]), np.asarray([0, 1], np.int32))
    to = ta.push_labels(np.asarray([1, 3]), np.asarray([0, 1], np.int32))
    assert isinstance(to, TBatch) and to.n == 2
    _same_batch(jo, to)
    assert ta.backlog == ja.backlog == 3
    assert to.data["y"].tolist() == [0, 1]
    # labels for ids not pending
    assert ja.push_labels(np.asarray([9]), np.asarray([1])) is None
    assert ta.push_labels(np.asarray([9]), np.asarray([1])) is None


def _fused_batches(n_batches=15, n=32, dim=8, side=3):
    """tests/test_pipeline.py's fusion-fed stream: a side channel on the
    same timestamps joined through WindowJoin(tolerance=5.0)."""
    gen = jgen.HyperplaneStream(dim=dim, seed=2, horizon=n_batches * n)
    base = [gen.batch(i, n) for i in range(n_batches)]
    rng = np.random.default_rng(1)
    jj, tj = jfu.WindowJoin(tolerance=5.0), tfu.WindowJoin(tolerance=5.0)
    jout, tout = [], []
    for b in base:
        right = rng.normal(size=(n, side)).astype(np.float32)
        for j, rb in zip((jj, tj), _pair({"x": right}, np.asarray(b.ts))):
            j.push_right(rb)
        jl, tl = _pair(b.data, np.asarray(b.ts))
        (jo, jm), (to, tm) = jj.join_left(jl), tj.join_left(tl)
        assert jm.all() and tm.all()
        _same_batch(jo, to)
        jout.append(jo)
        tout.append(to)
    return jout, tout


@pytest.mark.parametrize("rate", [1e4, 1e7])
def test_fusion_fed_job_matches_the_reference(rate):
    dim, side = 8, 3
    jb, tb = _fused_batches(dim=dim, side=side)
    # a latency limit no batch's wall time reaches (the JAX run's first
    # batch compiles)
    jm = jorch.Orchestrator(jorch.StreamJob(
        "fusion-fed", dim=dim + side, sla=jsla.SLA(max_latency_s=1e3),
        pipeline=jpl.Pipeline([
            jpl.concat_op("joined", dim + side),
            jpl.normalize_op(dim + side),
            jpl.logreg_train_op(dim + side)]))).run(
        jb, rate_fn=lambda s: rate)
    tm = torch_orch.Orchestrator(torch_orch.StreamJob(
        "fusion-fed", dim=dim + side, sla=tsla.SLA(max_latency_s=1e3),
        device="cpu", pipeline=tpl.Pipeline([
            tpl.concat_op("joined", dim + side),
            tpl.normalize_op(dim + side),
            tpl.logreg_train_op(dim + side)]))).run(
        tb, rate_fn=lambda s: rate)
    assert tm.events == jm.events == 15 * 32
    assert tm.cuts == jm.cuts
    assert tm.plan_identities == jm.plan_identities
    # elastic lines read the measured rate (the wall clock): left out
    assert tm.codecs == jm.codecs
    assert [d for d in tm.decisions if "elastic" not in d] == \
        [d for d in jm.decisions if "elastic" not in d]
    assert tm.preq["n"] == jm.preq["n"] == 15 * 32
    for k in ("accuracy", "logloss", "ewma_accuracy"):
        assert tm.preq[k] == pytest.approx(jm.preq[k], abs=1e-4), k
    assert tm.preq["accuracy"] > 0.6
