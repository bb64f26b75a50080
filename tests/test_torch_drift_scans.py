"""EDDM's and Page-Hinkley's drift-scan decompositions
(``kernels/ref.py``: ``eddm_scan_restart_ref``, ``ph_scan_restart_ref``),
the algorithms of the card's ``eddm_tiled_kernel`` and
``ph_tiled_kernel`` (``csrc/detector_scan.cu``), held on the CPU to the
port's plain loop (``run_detector`` of ``eddm_step`` / ``ph_step``) and
to the JAX package's ``lax.scan`` of the same steps, on errors made from
a seed with numpy. A CUDA kernel cannot run here; ``chip_smoke.py``
holds the kernels to their one-thread witness on the card.

Tolerances: against the plain loop, every level equal and the state
bitwise, at every tile. Against ``lax.scan``: every level equal, PH's
state bitwise; EDDM's ``var_d``, and ``best`` that rests on it, within
rtol 1e-6 (XLA on the CPU contracts ``var_d``'s multiply-add into an
FMA, ROADMAP fault 3), its other fields bitwise.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.streams import drift as jdrift

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref
from repro_torch.streams import drift as tdrift

TILES = (16, 64, 2048)
DETECTORS = ("eddm", "ph")
STEPS = {"eddm": (tdrift.eddm_step, jdrift.eddm_step),
         "ph": (tdrift.ph_step, jdrift.ph_step)}
STATES = {"eddm": (tdrift.EDDMState, jdrift.EDDMState),
          "ph": (tdrift.PHState, jdrift.PHState)}
INITS = {"eddm": tdrift.eddm_init, "ph": tdrift.ph_init}
RESTART_REFS = {"eddm": tref.eddm_scan_restart_ref,
                "ph": tref.ph_scan_restart_ref}
BIG = float(2 ** 24)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rates(seed: int, p) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.random(len(p)) < p).astype(np.float32)


def _planted(seed=1, n=4096):
    """0/1 errors whose rate jumps 0.1 -> 0.5 halfway."""
    return _rates(seed, np.where(np.arange(n) < n // 2, 0.1, 0.5))


def _alternating(seed=2, n=3000, per=200):
    """0/1 errors whose rate alternates 0.05 / 0.6 every ``per`` events."""
    return _rates(seed, np.where((np.arange(n) // per) % 2 == 0, 0.05, 0.6))


@functools.lru_cache(maxsize=None)
def _case(det: str, kind: str):
    """``(initial state as a tuple of floats and the level, errors)``."""
    fresh = tuple(float(v) for v in INITS[det]()[:-1]) + (0,)
    if kind == "planted":
        return fresh, _planted()
    if kind == "alternating":
        return fresh, _alternating()
    if kind == "int8_ef":
        # the errors after the port's int8 uplink codec: not 0 or 1
        err = _alternating(3, n=2000)
        res = np.random.default_rng(4).normal(0, 0.02, err.shape)
        dec, _ = tref.ef_int8_roundtrip_ref(_t(res.astype(np.float32)),
                                            _t(err))
        dec = dec.numpy()
        assert not np.isin(dec, [0.0, 1.0]).all()
        return fresh, dec
    if kind == "quiet_and_busy":
        # runs of 300 events without an error and of only errors: tiles of
        # 16 and 64 with none and with all
        err = np.concatenate([_planted(5, 600)[:400], np.zeros(300, np.float32),
                              np.ones(300, np.float32), _alternating(6, 800)])
        return fresh, err
    if kind == "near_2_24":
        # counters a little under 2^24, where c + 1 rounds back to c: a
        # quiet start walks since_last past it, the errors n
        err = np.concatenate([np.zeros(300, np.float32), _planted(7, 1500)])
        if det == "eddm":
            n0 = BIG - 100.0
            return (n0, BIG - 200.0, 9.0, 90.0 * n0, 28.0, 0), err
        return (BIG - 100.0, 0.25, 3.0, -2.0, 0), err
    if kind == "warm_up":
        # the plain loop's state after 150 low-rate events: EDDM in its 50
        # errors' warm-up (a few errors), PH's sums under way
        pre = _alternating(8, n=150)
        st, lv = tdrift.run_detector(STEPS[det][0], INITS[det](), _t(pre))
        assert not (lv == tdrift.DRIFT).any()
        if det == "eddm":
            assert 0 < float(st.n_err) < 50
        return tuple(float(v) for v in st[:-1]) + (int(st.level),), \
            _alternating(9)
    if kind == "fractional":
        # counters that are not whole numbers: the closed form does not
        # hold, so they step one by one
        floats = (7.5, 3.5, 9.0, 80.0, 20.0) if det == "eddm" else \
            (7.5, 0.3, 1.0, -0.5)
        return floats + (0,), _alternating(10, n=1500)
    raise KeyError(kind)


def _state(det, values, mod):
    *floats, level = values
    if mod is jnp:
        return STATES[det][1](*(jnp.float32(v) for v in floats),
                              jnp.int32(level))
    return STATES[det][0](*(torch.tensor(v, dtype=torch.float32)
                            for v in floats),
                          torch.tensor(level, dtype=torch.int32))


def _bitwise(a, b) -> bool:
    return all(x.dtype == y.dtype and x.reshape(()).numpy().tobytes()
               == y.reshape(()).numpy().tobytes() for x, y in zip(a, b))


def _jax_agrees(det, tstate, jstate):
    """The plain loop's state against ``lax.scan``'s, as the module
    docstring states."""
    for field, a, b in zip(tstate._fields, tstate, jstate):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        if det == "eddm" and field in ("var_d", "best"):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=field)
        else:
            assert a.tobytes() == b.tobytes(), field


@functools.lru_cache(maxsize=None)
def _jax_scan(det, values, err_bytes, n):
    err = np.frombuffer(err_bytes, np.float32, count=n)
    js, jl = jax.jit(lambda s, e: jax.lax.scan(STEPS[det][1], s, e))(
        _state(det, values, jnp), jnp.asarray(err))
    return js, np.asarray(jl)


@functools.lru_cache(maxsize=None)
def _want(det: str, kind: str):
    """The plain loop's ``(state, levels)``, held to ``lax.scan``'s."""
    values, err = _case(det, kind)
    ts, tl = tdrift.run_detector(STEPS[det][0], _state(det, values, torch),
                                 _t(err))
    js, jl = _jax_scan(det, values, err.tobytes(), len(err))
    np.testing.assert_array_equal(tl.numpy(), jl)
    _jax_agrees(det, ts, js)
    return ts, tl


def _check(det, kind, tile):
    values, err = _case(det, kind)
    want_state, want_levels = _want(det, kind)
    st, levels = RESTART_REFS[det](_state(det, values, torch), _t(err), tile)
    assert torch.equal(levels, want_levels)
    assert _bitwise(st, want_state)
    return want_state, want_levels


CASES = ("planted", "alternating", "int8_ef", "quiet_and_busy", "near_2_24",
         "warm_up", "fractional")


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("kind", CASES)
@pytest.mark.parametrize("det", DETECTORS)
def test_restart_ref_bitwise_with_step_loop_and_lax_scan(det, kind, tile):
    """Level for level, the state bitwise the plain loop's (itself held
    to ``lax.scan``), at tiles of 16, 64 and the kernel's 2,048."""
    _, levels = _check(det, kind, tile)
    drifts = int((levels == tdrift.DRIFT).sum())
    if kind == "alternating":
        assert drifts >= 5
    if kind == "planted":
        assert drifts >= 1


@pytest.mark.parametrize("det", DETECTORS)
def test_near_2_24_the_counters_stop_at_2_24(det):
    """The case's counters do cross 2^24 in the plain loop, so the
    restart ref's one-by-one route is what holds it there."""
    values, err = _case(det, "near_2_24")
    st = _state(det, values, torch)
    for e in _t(err[:400]):
        st, _ = STEPS[det][0](st, e)
    if det == "eddm":
        first = int(np.nonzero(err > 0.5)[0][0])
        assert first >= 300
        # from 2^24 - 200, 300 quiet events and more reach 2^24
        st0 = _state(det, values, torch)
        for e in _t(err[:first]):
            st0, _ = STEPS[det][0](st0, e)
        assert float(st0.since_last) == BIG
    else:
        assert float(st.n) == BIG


def test_eddm_tiles_without_errors_and_of_only_errors():
    """The quiet-and-busy stream holds whole tiles of 16 and 64 events with
    no error and with only errors, wherever the restarts put the tiles."""
    _, err = _case("eddm", "quiet_and_busy")
    for tile in (16, 64):
        runs = [err[s:s + 2 * tile] for s in range(0, len(err) - 2 * tile)]
        assert any((r == 0).all() for r in runs)
        assert any((r == 1).all() for r in runs)
    _, levels = _want("eddm", "quiet_and_busy")
    # the run of only errors shrinks the distance: EDDM drifts inside it
    assert (levels.numpy()[700:1000] == tdrift.DRIFT).any()


@pytest.mark.parametrize("where", ["last_of_a_tile", "first_of_a_tile"])
@pytest.mark.parametrize("det", DETECTORS)
def test_restart_ref_with_a_drift_on_a_tile_boundary(det, where):
    _, want_levels = _want(det, "alternating")
    r = int(np.nonzero(want_levels.numpy() == tdrift.DRIFT)[0][0])
    tile = r + 1 if where == "last_of_a_tile" else r
    assert (r + 1) % tile == 0 if where == "last_of_a_tile" else \
        r % tile == 0
    _check(det, "alternating", tile)


@pytest.mark.parametrize("chunk", [37, 200])
@pytest.mark.parametrize("det", DETECTORS)
def test_restart_ref_carried_from_call_to_call(det, chunk):
    """The state carried over short calls, as the drift op carries it:
    bitwise one plain loop over the whole stream, level for level."""
    want_state, want_levels = _want(det, "alternating")
    _, err = _case(det, "alternating")
    st, lvs = INITS[det](), []
    for part in _t(err).split(chunk):
        st, lv = RESTART_REFS[det](st, part, 64)
        lvs.append(lv)
    assert torch.equal(torch.cat(lvs), want_levels)
    assert _bitwise(st, want_state)


@pytest.mark.parametrize("det", DETECTORS)
def test_restart_ref_on_no_events_keeps_the_state(det):
    values, _ = _case(det, "warm_up")
    start = _state(det, values, torch)
    st, levels = RESTART_REFS[det](start, torch.zeros(0), 64)
    assert levels.shape == (0,)
    assert _bitwise(st, start)


@pytest.mark.parametrize("det", DETECTORS)
def test_the_drift_ops_cpu_route_is_the_plain_loop(det):
    """The dispatcher's CPU route (the plain loop): the state and the flag
    the levels imply."""
    values, err = _case(det, "alternating")
    want_state, want_levels = _want(det, "alternating")
    st, flag = kops.detector_scan(det, _state(det, values, torch), _t(err))
    assert _bitwise(st, want_state)
    assert bool(flag) == bool((want_levels == tdrift.DRIFT).any())
