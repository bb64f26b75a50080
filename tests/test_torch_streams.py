"""The port's stream and learner modules against the JAX package's:
``streams/preprocess``, ``streams/sketches`` (moments), ``streams/sampling``,
``streams/drift``, ``ml/online`` and ``ml/metrics``, on the same inputs
(made from a seed with numpy), with random initial states carried across
by ``repro_torch.convert``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.ml import metrics as jmetrics
from repro.ml import online as jonline
from repro.streams import drift as jdrift
from repro.streams import preprocess as jprep
from repro.streams import sampling as jsamp
from repro.streams import sketches as jsk

from repro_torch import convert
from repro_torch.ml import metrics as tmetrics
from repro_torch.ml import online as tonline
from repro_torch.streams import drift as tdrift
from repro_torch.streams import preprocess as tprep
from repro_torch.streams import sampling as tsamp
from repro_torch.streams import sketches as tsk


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(port, ref, rtol=1e-5, atol=1e-5):
    for a, b in zip(port, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=rtol, atol=atol)


def _batches(seed, n_batches=10, n=64, d=8, shift=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        off = 2.0 if (shift and i >= n_batches // 2) else 0.0
        out.append((rng.normal(size=(n, d)) * 1.5 + off).astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# preprocess + moments (tolerance: the reductions sum in another order)
# ---------------------------------------------------------------------------

def test_norm_update_apply_tracks_jax():
    js, ts = jprep.norm_init(8), tprep.norm_init(8)
    for x in _batches(0):
        js, jy = jprep.norm_update_apply(js, jnp.asarray(x))
        ts, ty = tprep.norm_update_apply(ts, _t(x))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                   rtol=1e-4, atol=1e-5)
        _close(ts, js, rtol=1e-5, atol=1e-4)


def test_moments_update_tracks_jax():
    js, ts = jsk.moments_init(8), tsk.moments_init(8)
    for x in _batches(1):
        js = jsk.moments_update(js, jnp.asarray(x))
        ts = tsk.moments_update(ts, _t(x))
        _close(ts, js, rtol=1e-5, atol=1e-4)
    # min and max are exact
    np.testing.assert_array_equal(ts.min.numpy(), np.asarray(js.min))
    np.testing.assert_array_equal(ts.max.numpy(), np.asarray(js.max))


def test_oja_from_the_same_start_tracks_jax():
    js = jprep.oja_init(16, 4, seed=3)
    ts = convert.state_from_numpy(tprep.oja_init(16, 4), _np(js))
    for x in _batches(2, d=16):
        js, jz = jprep.oja_update_project(js, jnp.asarray(x))
        ts, tz = tprep.oja_update_project(ts, _t(x))
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(ts.w.numpy(), np.asarray(js.w),
                                   rtol=1e-4, atol=1e-5)


def test_hash_features_bitwise_with_jax_streams_path():
    rng = np.random.default_rng(4)
    ids = rng.integers(-2 ** 31, 2 ** 31, (50, 6), dtype=np.int64
                       ).astype(np.int32)
    vals = rng.normal(size=(50, 6)).astype(np.float32)
    want = jprep.hash_features(jnp.asarray(ids), jnp.asarray(vals), 64,
                               use_kernel=False)
    got = tprep.hash_features(_t(ids), _t(vals), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# learners and prequential metrics
# ---------------------------------------------------------------------------

def _labels(x, seed):
    w = np.random.default_rng(seed).normal(size=x.shape[1])
    return (x @ w > 0).astype(np.int32)


def test_logreg_and_prequential_track_jax():
    jm, tm = jonline.logreg_init(8), tonline.logreg_init(8)
    jp, tp = jmetrics.preq_init(), tmetrics.preq_init()
    rng = np.random.default_rng(5)
    for x in _batches(5, shift=False):
        y = _labels(x, 0)
        mask = rng.random(len(x)) < 0.5
        jpred = jonline.logreg_predict(jm, jnp.asarray(x))
        tpred = tonline.logreg_predict(tm, _t(x))
        np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred),
                                   rtol=1e-5, atol=1e-6)
        jp = jmetrics.preq_update(jp, jpred, jnp.asarray(y))
        tp = tmetrics.preq_update(tp, tpred, _t(y))
        w = mask.astype(np.float32)[:, None]
        jm = jonline.logreg_update(jm, jnp.asarray(x * w),
                                   jnp.asarray(y * mask))
        tm = tonline.logreg_update(tm, _t(x * w), _t(y * mask))
        _close(tm, jm, rtol=1e-5, atol=1e-6)
    tmet, jmet = tmetrics.preq_metrics(tp), jmetrics.preq_metrics(jp)
    assert tmet["n"] == jmet["n"]
    for k in ("accuracy", "logloss", "ewma_accuracy"):
        assert tmet[k] == pytest.approx(jmet[k], rel=1e-5, abs=1e-6)
    _close(tonline.logreg_reset_soft(tm), jonline.logreg_reset_soft(jm),
           rtol=1e-5, atol=1e-6)


def test_anomaly_scorer_from_the_same_start_tracks_jax():
    js = jonline.anomaly_init(8, m=4, seed=2)
    ts = convert.state_from_numpy(tonline.anomaly_init(8, m=4), _np(js))
    for x in _batches(6):
        js = jonline.anomaly_update(js, jnp.asarray(x))
        ts = tonline.anomaly_update(ts, _t(x))
        np.testing.assert_array_equal(ts.counts.numpy(),
                                      np.asarray(js.counts))
        np.testing.assert_allclose(
            tonline.anomaly_score(ts, _t(x)).numpy(),
            np.asarray(jonline.anomaly_score(js, jnp.asarray(x))),
            rtol=1e-5, atol=1e-5)


def test_kmeans_from_the_same_start_tracks_jax():
    js = jonline.kmeans_init(3, 8, seed=1)
    ts = convert.state_from_numpy(tonline.kmeans_init(3, 8), _np(js))
    for x in _batches(7):
        js = jonline.kmeans_update(js, jnp.asarray(x))
        ts = tonline.kmeans_update(ts, _t(x))
        _close(ts, js, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# drift detectors: level for level
# ---------------------------------------------------------------------------

_DETECTORS = {
    "ddm": (jdrift.ddm_init, jdrift.ddm_step, tdrift.ddm_init,
            tdrift.ddm_step),
    "eddm": (jdrift.eddm_init, jdrift.eddm_step, tdrift.eddm_init,
             tdrift.eddm_step),
    "ph": (jdrift.ph_init, jdrift.ph_step, tdrift.ph_init, tdrift.ph_step),
    "adwin": (jdrift.adwin_init, jdrift.adwin_step, tdrift.adwin_init,
              tdrift.adwin_step),
}


@pytest.mark.parametrize("detector", sorted(_DETECTORS))
def test_detectors_equal_level_for_level(detector):
    jinit, jstep, tinit, tstep = _DETECTORS[detector]
    rng = np.random.default_rng(8)
    n = 600
    p = np.where(np.arange(n) < n // 2, 0.1, 0.7)
    err = (rng.random(n) < p).astype(np.float32)
    jstate, jlevels = jdrift.run_detector(jstep, jinit(), jnp.asarray(err))
    tstate, tlevels = tdrift.run_detector(tstep, tinit(), _t(err))
    np.testing.assert_array_equal(tlevels.numpy(), np.asarray(jlevels))
    assert (np.asarray(jlevels) == 2).any(), "the planted drift must fire"
    # the state floats agree to an ulp (XLA may contract a*b+c on the CPU)
    _close(tstate, jstate, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _jax_reservoir_draws(state, n):
    """The j draws the JAX package's reservoir_update makes for n items
    from ``state`` (the same split/randint sequence, replayed)."""
    def step(carry, _):
        rng, seen = carry
        rng, r1 = jax.random.split(rng)
        seen = seen + 1
        return (rng, seen), jax.random.randint(r1, (), 0, seen)

    _, js = jax.lax.scan(step, (state.rng, state.seen), None, length=n)
    return np.asarray(js)


def test_reservoir_update_bitwise_with_injected_draws():
    k, d = 16, 4
    js = jsamp.reservoir_init(k, d, seed=3)
    ts = convert.state_from_numpy(tsamp.reservoir_init(k, d), _np(js))
    rng = np.random.default_rng(9)
    for _ in range(6):              # fills, then replaces
        x = rng.normal(size=(40, d)).astype(np.float32)
        y = rng.integers(0, 5, 40).astype(np.int32)
        draws = _jax_reservoir_draws(js, 40)
        js = jsamp.reservoir_update(js, jnp.asarray(x), jnp.asarray(y))
        ts = tsamp.reservoir_update(ts, _t(x), _t(y), j=_t(draws))
        np.testing.assert_array_equal(ts.buf.numpy(), np.asarray(js.buf))
        np.testing.assert_array_equal(ts.extra.numpy(), np.asarray(js.extra))
        assert int(ts.seen) == int(js.seen)


def test_reservoir_update_own_draws_is_uniform_and_advances():
    """With its own generator, every item of the history is equally
    likely to sit in the reservoir, and the seed advances per batch."""
    k, n_items, trials = 8, 64, 400
    counts = np.zeros(n_items)
    for t in range(trials):
        st = tsamp.reservoir_init(k, 1, seed=t)
        for b in range(4):
            x = torch.arange(b * 16, (b + 1) * 16, dtype=torch.float32)[:, None]
            st2 = tsamp.reservoir_update(st, x, torch.zeros(16))
            assert int(st2.rng) != int(st.rng)
            st = st2
        counts[st.buf[:, 0].long().numpy()] += 1
    # each item is kept w.p. k/n_items: binomial(trials, 1/8), mean 50
    p = k / n_items
    sd = np.sqrt(trials * p * (1 - p))
    assert np.abs(counts - trials * p).max() < 5 * sd


def test_bernoulli_keep_rate_within_binomial_bounds():
    n, rate = 20000, 0.3
    mask, seed2 = tsamp.bernoulli_thin(123, torch.zeros(n, 2), rate)
    sd = np.sqrt(rate * (1 - rate) / n)
    assert abs(float(mask.float().mean()) - rate) < 5 * sd
    assert seed2 != 123
    again, _ = tsamp.bernoulli_thin(123, torch.zeros(n, 2), rate)
    assert torch.equal(mask, again)        # explicit seed -> same draw
    full, _ = tsamp.bernoulli_thin(7, torch.zeros(n, 2), 1.0)
    assert bool(full.all())
