"""ADWIN, the drift op's fourth detector, through the port's detector
scan (``kernels/detector_scan.py``, kind 3 of ``csrc/detector_scan.cu``)
against the JAX package's ``drift_op("adwin")`` (a ``lax.scan`` of
``adwin_step``), on the same batches made from a seed with numpy.

On the CPU the dispatcher runs its plain loop (``run_detector`` of
``adwin_step``) and launches no kernel; the kernel itself is held to that
loop and to its serial witness on the card (``chip_smoke.py`` phase 2).
Tolerances: on 0/1 errors the bucket counts and sums are whole numbers,
so the state is bitwise; on float errors the levels are equal and the
state within rtol 1e-6 (XLA on the CPU may contract a multiply-add the
port rounds twice).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import pipeline as jpl
from repro.streams import drift as jdrift

from repro_torch.core import pipeline as tpl
from repro_torch.kernels import detector_scan as tds
from repro_torch.kernels import ops as kops
from repro_torch.launch import op_count
from repro_torch.streams import drift as tdrift

N = 600               # events a batch; the error rate jumps at batch 2
BATCHES = 2


def _errors(kind: str, seed: int) -> np.ndarray:
    """(BATCHES * N,) errors: rate 0.1, then 0.6 from the second batch,
    as 0/1 draws or as floats in [0, 1] around the rate."""
    rng = np.random.default_rng(seed)
    p = np.where(np.arange(BATCHES * N) < N, 0.1, 0.6)
    if kind == "binary":
        return (rng.random(p.shape) < p).astype(np.float32)
    return np.clip(p + rng.normal(0.0, 0.15, p.shape), 0.0, 1.0
                   ).astype(np.float32)


def _state_close(t, j, bitwise: bool):
    for a, b in zip(t, j):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        if bitwise:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ["binary", "float"])
def test_drift_op_adwin_matches_the_reference(kind, monkeypatch):
    """The port's ``drift_op("adwin")`` dispatches each batch through
    ``kops.detector_scan`` (one call, no kernel on the CPU) and agrees with
    the reference's over two batches with the state carried: the drifted
    flags, the state, and every event's level (the plain step the kernel
    repeats, against ``lax.scan`` of ``adwin_step``)."""
    err = _errors(kind, seed=11)
    calls = []
    real = kops.detector_scan

    def spy(detector, state, e):
        calls.append(detector)
        return real(detector, state, e)
    monkeypatch.setattr(kops, "detector_scan", spy)
    kops.reset_launch_counts()
    jop, top = jpl.drift_op("adwin"), tpl.drift_op("adwin")
    js, ts = jop.init(), top.init()
    flags = []
    for b in range(BATCHES):
        e = err[b * N:(b + 1) * N]
        js, jout = jop.fn(js, {"err": jnp.asarray(e)})
        ts, tout = top.fn(ts, {"err": torch.from_numpy(e)})
        assert bool(tout["drifted"]) == bool(jout["drifted"])
        flags.append(bool(jout["drifted"]))
        _state_close(ts, js, bitwise=kind == "binary")
    assert calls == ["adwin"] * BATCHES
    assert set(kops.launch_counts().values()) == {0}
    assert flags[-1], "the planted drift must fire"
    # level for level over the whole stream
    jst, jlv = jdrift.run_detector(jdrift.adwin_step, jdrift.adwin_init(),
                                   jnp.asarray(err))
    tst, tlv = tdrift.run_detector(tds.STEPS["adwin"], tdrift.adwin_init(),
                                   torch.from_numpy(err))
    np.testing.assert_array_equal(tlv.numpy(), np.asarray(jlv))
    assert (np.asarray(jlv) == tdrift.DRIFT).sum() >= 1
    _state_close(tst, jst, bitwise=kind == "binary")


def test_adwin_state_packs_into_the_kernels_buffers_and_back():
    """The kernel's buffers (120 floats: counts then sums, row major; 13
    ints: n_buckets then the level) hold every field, and unpack to the
    same state, views of the buffers."""
    rng = np.random.default_rng(3)
    st = tdrift.AdwinState(
        torch.from_numpy(rng.integers(0, 9, (12, 5)).astype(np.float32)),
        torch.from_numpy(rng.normal(size=(12, 5)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, 6, 12).astype(np.int32)),
        torch.tensor(2, dtype=torch.int32))
    floats, ints = tds._pack("adwin", st, torch.device("cpu"))
    assert floats.shape == (120,) and floats.dtype == torch.float32
    assert ints.shape == (13,) and ints.dtype == torch.int32
    assert torch.equal(floats[:60].view(12, 5), st.counts)
    assert torch.equal(floats[60:].view(12, 5), st.sums)
    assert torch.equal(ints[:12], st.n_buckets) and int(ints[12]) == 2
    back = tds._unpack("adwin", st, floats, ints)
    assert all(torch.equal(a, b) for a, b in zip(back, st))
    assert back.level.shape == () and back.n_buckets.shape == (12,)


def test_adwin_counts_its_own_formula():
    """Under ``OpCount`` the drift op's ADWIN scan counts ADWIN's formula
    (its 60-bucket step), on the CPU as on the card, not the plain loop's
    many small ops nor DDM's 20 an event."""
    n = 64
    err = torch.from_numpy(_errors("binary", seed=5)[:n])
    init = tdrift.adwin_init()
    with op_count.OpCount() as count:
        kops.detector_scan("adwin", init, err)
    assert count.flops == kops.ADWIN_OPS_PER_EVENT * n
    assert count.bytes == 4 * n + 2 * kops.ADWIN_STATE_BYTES
    init = tdrift.ddm_init()
    with op_count.OpCount() as ddm:
        kops.detector_scan("ddm", init, err)
    assert ddm.flops == 20 * n and count.flops > 50 * ddm.flops
