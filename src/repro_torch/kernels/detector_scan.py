"""The drift op's detector scan: the CUDA kernels of
``csrc/detector_scan.cu`` beside their plain version, a loop of the
``streams/drift.py`` step functions.

The JAX package scans DDM, EDDM, Page-Hinkley and ADWIN over a batch's
error stream with ``jax.lax.scan`` (``core/pipeline.py`` drift_op); it
has no Pallas kernel for it. A loop of torch steps on the card would
launch some 25 kernels per event (ADWIN's some 300), so the scan is one
kernel launch a call. DDM's and ADWIN's kernels take off the chain all
the work that does not feed the next step. For DDM the kernel keeps only
``p`` on the chain (one thread per tile, with ``n`` and half of each
divide computed ahead for the tile), computes ``s``, the running
``(p_min, s_min)`` pair and the levels for the whole tile in parallel,
and restarts the chain after the first event at DRIFT
(``kernels/ref.py::ddm_scan_restart_ref`` spells it out). Page-Hinkley
and EDDM run on the same skeleton (one template, a kind each):
Page-Hinkley with two chains on the thread (the running mean, DDM's
``p`` chain, and ``cum``'s three adds), ``cum_min`` a prefix minimum
across the tile; EDDM's chain walks only the errors (an event
with ``e <= 0.5`` only advances ``since_last``): the block compacts them,
takes each one's distance since the previous error and ``n_err``, one
thread walks ``mean_d`` and ``var_d``, and ``best`` is a prefix maximum
across them (``kernels/ref.py::ph_scan_restart_ref`` and
``eddm_scan_restart_ref``). For ADWIN the
bucket layout is a counter in closed form and every bucket a run of one
stream, so each event's 60 cut tests are differences of one fp64 prefix
sum and run across the grid, a warp an event; only a drift whose drop
removes a bucket rebases the events after it (one cooperative launch,
rounds of a window of events and a grid minimum;
``kernels/ref.py::adwin_scan_restart_ref`` spells it out, and
:func:`adwin_stats` counts its rounds, events at DRIFT and rebases).
The kernels and the plain loop agree bitwise, level for level: every
step is repeated in fp32 without contracted multiply-adds (ADWIN on 0/1
errors, whose bucket sums are whole numbers; on other errors its cut
tests' sums round once from fp64 where the loop accumulates in fp32, and
its final sums are rebuilt in the loop's order). ``detector_scan_serial_cuda`` walks every kind on one
thread, the tiled and ADWIN kernels' witness; ``adwin_warp_witness_cuda``
runs ADWIN's previous kernel (one warp); both are off every main path
and not counted.

:func:`detector_scan` launches the kernel for a CUDA tensor, runs the
plain loop for a CPU tensor, and raises for any other device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.streams import drift as drift_mod

LAUNCHES = {"detector_scan": 0}

KINDS = {"ddm": 0, "eddm": 1, "ph": 2, "adwin": 3}
STEPS = {"ddm": drift_mod.ddm_step, "eddm": drift_mod.eddm_step,
         "ph": drift_mod.ph_step, "adwin": drift_mod.adwin_step}

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_STATS = {}    # device -> int64 (2,): events the tiled chains walked, restarts
_ADWIN_STATS = {}   # device -> int64 (3,): rounds, events at DRIFT, rebases


def _lib():
    lib = _build.library("detector_scan")
    if not getattr(lib, "_typed", False):
        lib.detector_scan.argtypes = [_P, _L, ctypes.c_int] + [_P] * 7
        lib.detector_scan.restype = ctypes.c_int
        lib.detector_scan_serial.argtypes = [_P, _L, ctypes.c_int] + [_P] * 5
        lib.detector_scan_serial.restype = ctypes.c_int
        lib.adwin_warp_witness.argtypes = [_P, _L] + [_P] * 4
        lib.adwin_warp_witness.restype = ctypes.c_int
        lib.adwin_scratch_bytes.argtypes = [_L]
        lib.adwin_scratch_bytes.restype = _L
        lib.detector_divide_check.argtypes = [_P, _P, _L, _P, _P]
        lib.detector_divide_check.restype = ctypes.c_int
        lib._typed = True
    return lib


def chain_stats(device) -> torch.Tensor:
    """The card's running ``[events the chains walked, restarts]``
    (int64), summed over the tiled kernels' launches on ``device`` (DDM,
    EDDM, whose chain walks its errors, and Page-Hinkley)."""
    return _build.device_stats(_STATS, device)


def adwin_stats(device) -> torch.Tensor:
    """The card's running ``[rounds, events at DRIFT, rebases]`` (int64),
    summed over the ADWIN kernel's launches on ``device``."""
    return _build.device_stats(_ADWIN_STATS, device, 3)


def detector_scan_plain(detector: str, state, err: torch.Tensor):
    """Step the detector over every event of ``err`` in order:
    ``(final state, any event at DRIFT)``."""
    state, levels = drift_mod.run_detector(STEPS[detector], state, err)
    return state, torch.any(levels == drift_mod.DRIFT)


def _pack(detector: str, state, dev):
    """The kernel's state buffers: ``(floats, ints)``. DDM, EDDM and PH:
    their fields in five floats (zero-padded) and the level; ADWIN: its
    counts and sums (120 floats, row major) and its ``n_buckets`` and
    level (13 ints)."""
    if detector == "adwin":
        st = torch.cat([state.counts.reshape(-1), state.sums.reshape(-1)])
        ints = torch.cat([state.n_buckets.reshape(-1),
                          state.level.reshape(1)])
        return (st.to(device=dev, dtype=torch.float32),
                ints.to(device=dev, dtype=torch.int32))
    floats = [t.to(device=dev, dtype=torch.float32).reshape(1)
              for t in state[:-1]]
    pad = [torch.zeros(1, device=dev)] * (5 - len(floats))
    level = state.level.to(device=dev, dtype=torch.int32).reshape(1).clone()
    return torch.cat(floats + pad), level


def _unpack(detector: str, state, st: torch.Tensor, ints: torch.Tensor):
    """The state after the scan from the kernel's buffers."""
    if detector == "adwin":
        shape = state.counts.shape
        n = st.numel() // 2
        return type(state)(st[:n].view(shape), st[n:].view(shape),
                           ints[:-1], ints[-1])
    return type(state)(*[st[i] for i in range(len(state) - 1)], ints[0])


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(detector: str, state, err: torch.Tensor, route: str,
            levels: bool = False):
    """Launch ``route`` ("path", "serial" or "warp", ADWIN's one-warp
    witness) on ``err``'s device: ``(state, drifted)``, and each event's
    level (int32) with ``levels`` (every kind's path kernel and the serial
    witness)."""
    kind = KINDS[detector]
    dev = err.device
    st, level = _pack(detector, state, dev)
    drifted = torch.empty(1, dtype=torch.int32, device=dev)
    e = err.float().contiguous()
    n = e.numel()
    lib = _lib()
    lv = scratch = None
    if levels or (route == "path" and detector == "adwin"):
        lv = torch.empty(n, dtype=torch.int32, device=dev)
    if route == "path" and detector == "adwin":
        scratch = torch.empty(lib.adwin_scratch_bytes(n), dtype=torch.uint8,
                              device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "serial":
            rc = lib.detector_scan_serial(e.data_ptr(), n, kind,
                                          st.data_ptr(), level.data_ptr(),
                                          drifted.data_ptr(), _ptr(lv),
                                          stream)
        elif route == "warp":
            rc = lib.adwin_warp_witness(e.data_ptr(), n, st.data_ptr(),
                                        level.data_ptr(), drifted.data_ptr(),
                                        stream)
        else:
            stats = adwin_stats(dev) if detector == "adwin" else \
                chain_stats(dev)
            rc = lib.detector_scan(e.data_ptr(), n, kind, st.data_ptr(),
                                   level.data_ptr(), drifted.data_ptr(),
                                   stats.data_ptr(), _ptr(scratch),
                                   _ptr(lv), stream)
    _build.check(rc, {"path": "detector_scan", "serial":
                      "detector_scan_serial", "warp": "adwin_warp_witness"}
                 [route])
    out = (_unpack(detector, state, st, level), drifted[0] != 0)
    return out + (lv,) if levels else out


def detector_scan_cuda(detector: str, state, err: torch.Tensor, *,
                       levels: bool = False):
    """The detector-scan kernel: ``(final state, any event at DRIFT)``,
    and each event's level with ``levels`` (the drift op asks for none;
    ADWIN's kernel writes them anyway)."""
    _build.refuse_autograd("detector_scan", state, err)
    out = _launch(detector, state, err, "path", levels)
    LAUNCHES["detector_scan"] += 1
    return out


def detector_scan_serial_cuda(detector: str, state, err: torch.Tensor, *,
                              levels: bool = False):
    """The serial witness kernel (every event on one thread's chain): the
    same ``(final state, any event at DRIFT)``, and each event's level
    with ``levels``. Off the main path; not counted."""
    return _launch(detector, state, err, "serial", levels)


def adwin_warp_witness_cuda(state, err: torch.Tensor):
    """ADWIN's previous kernel (one warp: lane 0 inserts, the warp tests
    the 60 cut points by shuffles): the same ``(final state, any event at
    DRIFT)``. Off the main path; not counted."""
    return _launch("adwin", state, err, "warp")


def divide_check_cuda(a: torch.Tensor, b: torch.Tensor):
    """The DDM chain's split divide against IEEE ``/`` on the card, over
    the pairs ``(a[i], b[i])`` (fp32, one device) that lie in its fast
    range: ``(pairs in the range, pairs whose quotients differ)``."""
    a = a.float().contiguous()
    b = b.to(device=a.device, dtype=torch.float32).contiguous()
    out = torch.zeros(2, dtype=torch.int64, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _lib().detector_divide_check(a.data_ptr(), b.data_ptr(),
                                          a.numel(), out.data_ptr(), stream)
    _build.check(rc, "detector_divide_check")
    tried, differ = out.tolist()
    return tried, differ


def detector_scan(detector: str, state, err: torch.Tensor):
    """Scan a DDM/EDDM/PH/ADWIN detector over ``err`` on its device:
    kernel on CUDA, plain loop on the CPU."""
    if detector not in KINDS:
        raise KeyError(f"no detector scan for {detector!r}; "
                       f"known: {sorted(KINDS)}")
    if err.device.type == "cuda":
        return detector_scan_cuda(detector, state, err)
    if err.device.type == "cpu":
        return detector_scan_plain(detector, state, err)
    raise ValueError(f"detector_scan: no kernel for device {err.device}")
