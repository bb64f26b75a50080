"""ADWIN's drift-scan decomposition (``kernels/ref.py``: ``adwin_layout``,
``adwin_scan_restart_ref``), the algorithm of the card's
``adwin_scan_kernel`` (``csrc/detector_scan.cu``), held on the CPU to the
insert loop, the port's plain loop (``run_detector`` of ``adwin_step``)
and the JAX package's ``lax.scan`` of ``adwin_step``, on the same errors
made from a seed with numpy.

Tolerances: on 0/1 errors every sum the cut tests use is a whole number
below 2^24, so the levels and the state are bitwise. On float errors the
cut tests' sums round once from fp64 where the loop accumulates in fp32:
the levels must be equal on these streams, and the state (rebuilt in the
merges' order) within rtol 1e-6 of the reference's (XLA on the CPU may
contract a multiply-add the port rounds twice).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.streams import drift as jdrift

from repro_torch.kernels import ref as tref
from repro_torch.streams import drift as tdrift

L, M = tdrift.ADWIN_LEVELS, tdrift.ADWIN_M
EMPTY = [0] * L
FULL = [5] * L                     # level 11 full: the next cascade overflows
DROPPED = [4, 5, 4, 5, 5, 4] + [0] * 6   # just after a drop


def _simulate(nb, k):
    """n_buckets after each of k inserts, by the insert loop's cascade:
    (k + 1, 12) with row 0 the start."""
    nb = list(nb)
    out = [list(nb)]
    for _ in range(k):
        for level in range(L):
            if nb[level] < M:
                nb[level] += 1
                break
            nb[level] = M - 1      # merge two, take the pending one
        out.append(list(nb))
    return np.array(out)


@pytest.mark.parametrize("start", [EMPTY, FULL, DROPPED],
                         ids=["empty", "level11_full", "after_drop"])
def test_closed_form_layout_matches_the_insert_loop(start):
    """``adwin_layout(nb, k)`` is the insert loop's n_buckets after k
    inserts, for every k up to 70,000 (level 11 overflows many times)."""
    k = 70_000
    want = _simulate(start, k)
    got = tref.adwin_layout(torch.tensor(start), torch.arange(k + 1))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("start", [EMPTY, FULL, DROPPED],
                         ids=["empty", "level11_full", "after_drop"])
def test_the_simulated_cascade_is_the_steps_insert(start):
    """The counter above is the port's ``_insert`` (the plain step's, a
    masked select a branch) on n_buckets, 400 inserts from each start."""
    counts = torch.zeros(L, M)
    for level, nb in enumerate(start):
        counts[level, :nb] = 2.0 ** level
    sums = counts.clone()
    nbt = torch.tensor(start, dtype=torch.int32)
    want = _simulate(start, 400)
    one = torch.ones(())
    for i in range(1, 401):
        counts, sums, nbt = tdrift._insert(counts, sums, nbt, one, one)
        np.testing.assert_array_equal(nbt.numpy(), want[i])


def _errors(n: int, kind: str, seed: int) -> np.ndarray:
    """0/1 errors with the rate jumping 0.1 -> 0.6 halfway ("planted"),
    or alternating 0.05 / 0.6 every 500 events ("many"); "float": the
    planted rates as floats in [0, 1]."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    if kind == "many":
        p = np.where((i // 500) % 2 == 0, 0.05, 0.6)
    else:
        p = np.where(i < n // 2, 0.1, 0.6)
    if kind == "float":
        return np.clip(p + rng.normal(0.0, 0.15, n), 0.0, 1.0
                       ).astype(np.float32)
    return (rng.random(n) < p).astype(np.float32)


def _jax_scan(state, err):
    st, lv = jax.jit(lambda s, e: jdrift.run_detector(jdrift.adwin_step,
                                                      s, e))(
        state, jnp.asarray(err))
    return st, np.asarray(lv)


def _to_torch(jstate):
    return tdrift.AdwinState(*(torch.from_numpy(np.array(a)) for a in jstate))


def _to_jax(tstate):
    return jdrift.AdwinState(*(jnp.asarray(t.numpy()) for t in tstate))


def _same(t, j, bitwise=True):
    for a, b in zip(t, j):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        if bitwise:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ["planted", "many"])
@pytest.mark.parametrize("window", [1, 7, 4096])
def test_restart_ref_is_the_lax_scan_bitwise(kind, window):
    """From ``adwin_init`` over 6,000 0/1 events: every level and the
    final state bitwise the JAX package's ``lax.scan`` of ``adwin_step``,
    at any window; many drifts (the many-drift stream's drift lasts
    hundreds of events) but few rebases."""
    err = _errors(6000, kind, seed=3)
    stats = [0, 0, 0]
    st, lv = tref.adwin_scan_restart_ref(tdrift.adwin_init(),
                                         torch.from_numpy(err), window,
                                         stats)
    jst, jlv = _jax_scan(jdrift.adwin_init(), err)
    np.testing.assert_array_equal(lv.numpy(), jlv)
    _same(st, jst)
    drifts = int((jlv == jdrift.DRIFT).sum())
    assert drifts >= 1 and stats[1] == drifts
    assert 1 <= stats[2] < drifts
    assert stats[0] >= -(-6000 // window)


@pytest.mark.parametrize("kind", ["planted", "many"])
def test_restart_ref_is_the_plain_loop_bitwise(kind):
    """Against the port's own plain loop (the CPU route of the drift op),
    level for level and the state bitwise, at the kernel's window on the
    card and at 7."""
    err = torch.from_numpy(_errors(1200, kind, seed=5))
    pst, plv = tdrift.run_detector(tdrift.adwin_step, tdrift.adwin_init(),
                                   err)
    for window in (7, 2112):
        st, lv = tref.adwin_scan_restart_ref(tdrift.adwin_init(), err,
                                             window)
        assert torch.equal(lv, plv)
        assert all(torch.equal(a, b) for a, b in zip(st, pst))


@pytest.mark.parametrize("window", [1, 7, 4096])
def test_restart_ref_from_carried_states(window):
    """From states the reference built (after a drift-free prefix, after
    a drift, and mid-burst), a state whose level 11 is full, and a zero
    batch: bitwise ``lax.scan`` from the same state."""
    pre = _errors(9000, "many", seed=9)
    starts = []
    jst, jlv = _jax_scan(jdrift.adwin_init(), pre[:400])
    starts.append(jst)                           # no drift yet
    jst, jlv = _jax_scan(jdrift.adwin_init(), pre)
    starts.append(jst)                           # ends mid-stream
    drift_at = int(np.nonzero(jlv == jdrift.DRIFT)[0][0])
    starts.append(_jax_scan(jdrift.adwin_init(), pre[:drift_at + 1])[0])
    full = jdrift.AdwinState(
        counts=jnp.asarray(np.repeat(2.0 ** np.arange(L), M).reshape(L, M),
                           jnp.float32),
        sums=jnp.asarray(np.repeat(0.3 * 2.0 ** np.arange(L), M).reshape(
            L, M).round(), jnp.float32),
        n_buckets=jnp.full((L,), M, jnp.int32),
        level=jnp.zeros((), jnp.int32))
    starts.append(full)
    err = _errors(3000, "planted", seed=13)
    for start in starts:
        st, lv = tref.adwin_scan_restart_ref(_to_torch(start),
                                             torch.from_numpy(err), window)
        jst, jlv = _jax_scan(start, err)
        np.testing.assert_array_equal(lv.numpy(), jlv)
        _same(st, jst)
        st0, lv0 = tref.adwin_scan_restart_ref(
            _to_torch(start), torch.zeros(0), window)
        assert lv0.shape == (0,)
        _same(st0, start)


@pytest.mark.parametrize("chunk", [37, 200])
def test_restart_ref_carried_from_call_to_call(chunk):
    """The state carried over many short calls, as the drift op carries
    it (the final buckets then hold carried ones, whose sums are leaves
    of the rebuilt ones): bitwise one ``lax.scan`` over the whole
    stream, level for level."""
    err = _errors(3000, "many", seed=17)
    st, lvs = tdrift.adwin_init(), []
    for part in torch.from_numpy(err).split(chunk):
        st, lv = tref.adwin_scan_restart_ref(st, part, 64)
        lvs.append(lv)
    jst, jlv = _jax_scan(jdrift.adwin_init(), err)
    np.testing.assert_array_equal(torch.cat(lvs).numpy(), jlv)
    _same(st, jst)


@pytest.mark.parametrize("window", [7, 4096])
def test_restart_ref_on_float_errors(window):
    """Errors that are not 0/1: levels equal to the reference's, the
    state within rtol 1e-6 (its sums rebuilt in the merges' order)."""
    err = _errors(4000, "float", seed=21)
    st, lv = tref.adwin_scan_restart_ref(tdrift.adwin_init(),
                                         torch.from_numpy(err), window)
    jst, jlv = _jax_scan(jdrift.adwin_init(), err)
    np.testing.assert_array_equal(lv.numpy(), jlv)
    assert (jlv == jdrift.DRIFT).sum() >= 1
    _same(st, jst, bitwise=False)
    np.testing.assert_array_equal(st.n_buckets.numpy(),
                                  np.asarray(jst.n_buckets))


def test_tree_sum_is_the_merges_order():
    """A bucket's sum from leaves of weights 4, 2, 1, 1 is
    ``a + (b + (c + d))``, the order its merges formed it."""
    x = torch.tensor([1e8, 3.0, 1.0, 1.0], dtype=torch.float32)
    w = torch.tensor([4, 2, 1, 1])
    got = tref._adwin_tree_sum(x, w)
    want = x[0] + (x[1] + (x[2] + x[3]))
    assert torch.equal(got, want)
    ev = torch.from_numpy(np.random.default_rng(1).normal(size=16).astype(
        np.float32))
    pair = ev
    while pair.shape[0] > 1:
        pair = pair[0::2] + pair[1::2]
    assert torch.equal(tref._adwin_tree_sum(ev, torch.ones(16,
                                                           dtype=torch.int64)),
                       pair[0])
