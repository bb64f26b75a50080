"""The two chained scans' decompositions, held bitwise on the CPU.

The Misra-Gries kernel (``csrc/mg_scan.cu``) takes the ids of safe slots
off its chain; the DDM drift-scan kernel (``csrc/detector_scan.cu``)
keeps only ``n`` and ``p`` on its chain and restarts after a drift. A CUDA
kernel cannot run here, so their algorithms are spelled out in torch
(``kernels/ref.py::mg_update_chunked_ref`` and ``ddm_scan_restart_ref``)
and held here, bitwise, to the plain loops and to the JAX package's
``lax.scan`` on the same inputs, made from a seed with numpy. The kernels
themselves are held to the plain loops and to their serial witnesses on
the card by ``chip_smoke.py``.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.streams import drift as jdrift
from repro.streams import sketches as jsk

from repro_torch.kernels import detector_scan as ds
from repro_torch.kernels import mg_scan as mgk
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref
from repro_torch.streams import drift as tdrift


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Misra-Gries: safe slots off the chain, +hits - decrements
# ---------------------------------------------------------------------------

MG_CHUNKS = (1, 7, 64)


@functools.lru_cache(maxsize=None)
def _mg_case(kind: str, k: int):
    """``(keys0, counts0, ids)`` of a case that does not depend on the
    chunk (the threshold cases do: :func:`_mg_threshold_case`)."""
    rng = np.random.default_rng(900 + k)
    if kind == "zipf":
        # a Zipf stream from a summary carried over an earlier stretch
        ids = (rng.zipf(1.3, 1800) % 4000).astype(np.int32)
        k0, c0 = tref.mg_update_ref(torch.full((k,), -1, dtype=torch.int32),
                                    torch.zeros(k, dtype=torch.int32),
                                    _t(ids[:600]))
        return k0.numpy(), c0.numpy(), ids[600:]
    if kind == "neg_ones":
        # -1 sits in several slots, stale (count 0) and counted: an id of
        # -1 hits only the first of them, so no later one is safe
        keys = rng.integers(100, 200, k).astype(np.int32)
        counts = rng.integers(1, 5, k).astype(np.int32)
        for s, c in ((0, 0), (2, 900), (3, 900), (k - 1, 900)):
            if s < k:
                keys[s], counts[s] = -1, c
        ids = np.where(rng.random(1200) < 0.25, -1,
                       rng.integers(95, 160, 1200)).astype(np.int32)
        return keys, counts, ids
    if kind == "leave_reenter":
        # key 7 is heavy (safe), is decremented out by a run of fresh ids,
        # is replaced, and then comes back
        keys = np.arange(k, dtype=np.int32) * 3 + 1000
        counts = np.full(k, 2, np.int32)
        keys[0], counts[0] = 7, 150
        fresh = np.arange(5000, 5400, dtype=np.int32)
        back = np.where(rng.random(500) < 0.6, 7,
                        rng.integers(6000, 6050, 500)).astype(np.int32)
        ids = np.concatenate([np.full(60, 7, np.int32), fresh, back])
        return keys, counts, ids
    raise KeyError(kind)


def _mg_threshold_case(k: int, chunk: int, delta: int):
    """Slot 0 at the first chunk's threshold (its length) plus ``delta``,
    slot 1 at the look-ahead threshold (two chunks) plus ``delta``, the
    rest far above; then two chunks of fresh ids, each a decrement of
    every slot, so at ``delta = 0`` slot 0 reaches 0 on the first chunk's
    last id and slot 1 on the second's, and at ``delta = 1`` each ends at
    1; then a mixed tail."""
    rng = np.random.default_rng(950 + k + chunk)
    keys = np.arange(k, dtype=np.int32) * 7 + 3
    counts = np.full(k, 3 * chunk + 5, np.int32)
    counts[0] = chunk + delta
    if k > 1:
        counts[1] = 2 * chunk + delta
    fresh = np.arange(10_000, 10_000 + 2 * chunk, dtype=np.int32)
    tail = np.where(rng.random(300) < 0.5, rng.choice(keys[:2], 300),
                    rng.integers(20_000, 20_100, 300)).astype(np.int32)
    return keys, counts, np.concatenate([fresh, tail])


@functools.lru_cache(maxsize=None)
def _mg_jax(keys: bytes, counts: bytes, ids: bytes):
    mg = jax.jit(jsk.mg_update)(
        jsk.MisraGries(jnp.asarray(np.frombuffer(keys, np.int32)),
                       jnp.asarray(np.frombuffer(counts, np.int32))),
        jnp.asarray(np.frombuffer(ids, np.int32)))
    return np.array(mg.keys), np.array(mg.counts)


def _mg_check(keys, counts, ids, chunk):
    want = _mg_jax(keys.tobytes(), counts.tobytes(), ids.tobytes())
    plain = tref.mg_update_ref(_t(keys), _t(counts), _t(ids))
    stats = {}
    got = tref.mg_update_chunked_ref(_t(keys), _t(counts), _t(ids), chunk,
                                     stats=stats)
    for a, b, w in zip(got, plain, want):
        assert a.dtype == torch.int32
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), w)
    assert 0 <= stats["chained"] <= len(ids)
    return stats["chained"]


@pytest.mark.parametrize("chunk", MG_CHUNKS)
@pytest.mark.parametrize("k", [1, 33, 64])
@pytest.mark.parametrize("kind", ["zipf", "neg_ones", "leave_reenter"])
def test_mg_chunked_ref_bitwise_with_plain_loop_and_lax_scan(kind, k,
                                                             chunk):
    keys, counts, ids = _mg_case(kind, k)
    chained = _mg_check(keys, counts, ids, chunk)
    if kind == "zipf" and k > 1:
        # the heavy keys' ids left the chain
        assert chained < len(ids)


@pytest.mark.parametrize("chunk", MG_CHUNKS)
@pytest.mark.parametrize("k", [1, 33, 64])
@pytest.mark.parametrize("delta", [0, 1], ids=["at", "above"])
def test_mg_chunked_ref_bitwise_at_the_safe_threshold(delta, k, chunk):
    keys, counts, ids = _mg_threshold_case(k, chunk, delta)
    _mg_check(keys, counts, ids, chunk)
    # the edge itself: after the first chunk slot 0 stands at delta
    first = tref.mg_update_ref(_t(keys), _t(counts), _t(ids[:chunk]))
    assert int(first[1][0]) == delta and int(first[0][0]) == keys[0]


def test_mg_chunked_ref_at_the_kernels_chunk_takes_heavy_ids_off_the_chain():
    """At the kernel's chunk (``mg_scan.CHUNK``), on a Zipf(1.3) stream
    from an empty summary, k = 64: bitwise, and the heavy keys' ids off
    the chain once their counts exceed two chunks (31% of these 65,536
    ids)."""
    rng = np.random.default_rng(7)
    ids = (rng.zipf(1.3, 65536) % (1 << 20)).astype(np.int32)
    keys = np.full(64, -1, np.int32)
    counts = np.zeros(64, np.int32)
    chained = _mg_check(keys, counts, ids, mgk.CHUNK)
    assert chained < 0.75 * len(ids)


# ---------------------------------------------------------------------------
# DDM: the chain of n and p, a prefix pair minimum, restart at a drift
# ---------------------------------------------------------------------------

DDM_TILES = (1, 7, 64, 2048)


def _alternating(seed=0, n=3000, per=300):
    """Error rates alternating between 0.05 and 0.7 every ``per`` events:
    many drifts, some a few events after the warm-up that follows a
    reset."""
    rng = np.random.default_rng(seed)
    p = np.where((np.arange(n) // per) % 2 == 0, 0.05, 0.7)
    return (rng.random(n) < p).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ddm_case(kind: str):
    """``(initial state as floats (n, p, s_min, p_min), errors)``."""
    fresh = (0.0, 0.0, 1e9, 1e9)
    if kind == "alternating":
        return fresh, _alternating(2)
    if kind == "int8_ef":
        # the errors after the port's int8 uplink codec: not 0 or 1
        err = _alternating(3, n=2000)
        res = np.random.default_rng(4).normal(0, 0.02, err.shape)
        dec, _ = tref.ef_int8_roundtrip_ref(_t(res.astype(np.float32)),
                                            _t(err))
        dec = dec.numpy()
        assert not np.isin(dec, [0.0, 1.0]).all()
        return fresh, dec
    if kind == "near_2_24":
        # n crosses 2^24, where n + 1 rounds back to n in fp32
        err = (np.random.default_rng(5).random(600) < 0.3).astype(np.float32)
        return (float(2 ** 24 - 100), 0.3, 1e9, 1e9), err
    if kind == "ties":
        # a carried pair whose p_min + s_min equals, as a float, the q of
        # the first event that can set the minimum (the 30th): the strict
        # rule keeps the carried pair, whose p_min (0) is not that
        # event's p
        err = _alternating(6, 800)
        _, _, q, new_min = _ddm_trace(err)
        j = int(np.nonzero(new_min)[0][0])
        return (0.0, 0.0, float(q[j]), 0.0), err
    raise KeyError(kind)


def _ddm_trace(err):
    """The step loop from a fresh state, with each step's q and whether it
    set a new minimum."""
    st = tdrift.ddm_init()
    qs, new_min, levels = [], [], []
    for e in _t(err):
        n = st.n + 1.0
        p = st.p + (e - st.p) / n
        s = torch.sqrt(p * (1 - p) / torch.clamp(n, min=1.0))
        new_min.append(bool((n >= 30) & ((p + s) < (st.p_min + st.s_min))))
        qs.append(float(p + s))
        st, lv = tdrift.ddm_step(st, e)
        levels.append(int(lv))
    return st, np.array(levels), np.array(qs, np.float32), np.array(new_min)


def _state(floats, mod):
    f = [mod.float32(v) if mod is jnp else torch.tensor(v, dtype=torch.float32)
         for v in floats]
    lv = jnp.int32(0) if mod is jnp else torch.tensor(0, dtype=torch.int32)
    return (jdrift.DDMState if mod is jnp else tdrift.DDMState)(*f, lv)


@functools.lru_cache(maxsize=None)
def _ddm_want(kind: str):
    floats, err = _ddm_case(kind)
    js, jl = jax.jit(lambda s, e: jax.lax.scan(jdrift.ddm_step, s, e))(
        _state(floats, jnp), jnp.asarray(err))
    ts, tl = tdrift.run_detector(tdrift.ddm_step, _state(floats, torch),
                                 _t(err))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for a, b in zip(ts, js):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    return ts, tl


def _ddm_check(kind, tile):
    floats, err = _ddm_case(kind)
    want_state, want_levels = _ddm_want(kind)
    st, levels = tref.ddm_scan_restart_ref(_state(floats, torch), _t(err),
                                           tile)
    assert torch.equal(levels, want_levels)
    for a, b in zip(st, want_state):
        assert a.dtype == b.dtype and a.reshape(()).numpy().tobytes() == \
            b.reshape(()).numpy().tobytes()
    # the wrapper's CPU path (the plain loop) gives the same drift flag
    _, flag = kops.detector_scan("ddm", _state(floats, torch), _t(err))
    assert bool(flag) == bool((want_levels == 2).any())
    return want_levels


@pytest.mark.parametrize("tile", DDM_TILES)
@pytest.mark.parametrize("kind", ["alternating", "ties", "int8_ef",
                                  "near_2_24"])
def test_ddm_restart_ref_bitwise_with_step_loop_and_lax_scan(kind, tile):
    levels = _ddm_check(kind, tile)
    if kind == "alternating":
        drifts = np.nonzero(levels.numpy() == 2)[0]
        assert len(drifts) >= 5
        # a drift a few events after the warm-up that followed a reset
        assert np.diff(drifts).min() <= 45
    if kind == "near_2_24":
        st, _ = _ddm_want(kind)
        assert float(st.n) == 2.0 ** 24


@pytest.mark.parametrize("where", ["last_of_a_tile", "first_of_a_tile"])
def test_ddm_restart_ref_with_a_drift_on_a_tile_boundary(where):
    _, want_levels = _ddm_want("alternating")
    r = int(np.nonzero(want_levels.numpy() == 2)[0][0])
    tile = r + 1 if where == "last_of_a_tile" else r
    assert (r + 1) % tile == 0 if where == "last_of_a_tile" else r % tile == 0
    _ddm_check("alternating", tile)


def test_ddm_ties_case_keeps_the_carried_pair():
    """In the ties case the 30th event's q equals the carried pair's sum:
    the carried pair survives it, where a fresh state takes the event's
    (p, s)."""
    floats, err = _ddm_case("ties")
    _, _, q, new_min = _ddm_trace(err)
    j = int(np.nonzero(new_min)[0][0])
    assert j == 29 and q[j] == np.float32(floats[2])
    for tile in DDM_TILES:
        st, _ = tref.ddm_scan_restart_ref(_state(floats, torch),
                                          _t(err[:j + 1]), tile)
        assert float(st.p_min) == 0.0 and float(st.s_min) == floats[2]
    fresh, _ = tref.ddm_scan_restart_ref(_state((0.0, 0.0, 1e9, 1e9), torch),
                                         _t(err[:j + 1]), 64)
    assert float(fresh.p_min) != 0.0
    assert float(fresh.p_min) + float(fresh.s_min) == q[j]


# ---------------------------------------------------------------------------
# the wrappers: plain on the CPU, a kernel or an error elsewhere
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("detector", ["eddm", "ph"])
def test_detector_scan_runs_eddm_and_ph_plain_on_cpu_and_raises_elsewhere(
        detector, monkeypatch):
    init = {"eddm": tdrift.eddm_init, "ph": tdrift.ph_init}[detector]
    kops.reset_launch_counts()
    err = _t(_alternating(1, n=400))
    st, flag = kops.detector_scan(detector, init(), err)
    want, levels = tdrift.run_detector(ds.STEPS[detector], init(), err)
    assert all(torch.equal(a, b) for a, b in zip(st, want))
    assert bool(flag) == bool((levels == 2).any())
    assert kops.launch_counts()["detector_scan"] == 0
    with pytest.raises(ValueError, match="no kernel for device"):
        kops.detector_scan(detector, init("meta"),
                           torch.empty(8, device="meta"))
    # the kernel's wrapper passes levels=True on for every tiled kind
    # (their kernels write each event's level), DDM's too
    seen = []
    monkeypatch.setattr(ds, "_launch", lambda *a: seen.append(a) or "ran")
    assert ds.detector_scan_cuda(detector, init(), err, levels=True) == "ran"
    assert ds.detector_scan_cuda("ddm", tdrift.ddm_init(), err,
                                 levels=True) == "ran"
    assert [(a[0],) + a[3:] for a in seen] == [
        (detector, "path", True), ("ddm", "path", True)]


@pytest.mark.parametrize("k,kc", [(0, 0), (1025, 1025), (4, 5)],
                         ids=["k0", "k1025", "counts_of_another_k"])
def test_mg_kernel_refuses_a_summary_it_cannot_take(k, kc):
    with pytest.raises(ValueError, match="1 <= k <= 1024"):
        mgk.mg_scan_cuda(torch.full((k,), -1, dtype=torch.int32),
                         torch.zeros(kc, dtype=torch.int32),
                         torch.arange(8, dtype=torch.int32))


def test_chain_stats_keep_one_counter_per_device_and_kernel():
    a = mgk.chain_stats("cpu")
    assert a is mgk.chain_stats(torch.device("cpu"))
    assert a.dtype == torch.int64 and a.shape == (2,)
    assert ds.chain_stats("cpu") is not a
