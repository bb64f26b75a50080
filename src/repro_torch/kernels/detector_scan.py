"""The drift op's detector scan: the CUDA kernel of
``csrc/detector_scan.cu`` beside its plain version, a loop of the
``streams/drift.py`` step functions.

The JAX package scans DDM, EDDM and Page-Hinkley over a batch's error
stream with ``jax.lax.scan`` (``core/pipeline.py`` drift_op); it has no
Pallas kernel for it. A loop of torch steps on the card would launch
some 25 kernels per event, so the scan is one kernel: one thread walks
the events in order. It is bound by the latency of the dependent step
chain, not by bytes or operations. The kernel and the plain loop agree
level for level: the kernel repeats every step in fp32 without
contracted multiply-adds.

:func:`detector_scan` launches the kernel for a CUDA tensor, runs the
plain loop for a CPU tensor, and raises for any other device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.streams import drift as drift_mod

LAUNCHES = {"detector_scan": 0}

KINDS = {"ddm": 0, "eddm": 1, "ph": 2}
STEPS = {"ddm": drift_mod.ddm_step, "eddm": drift_mod.eddm_step,
         "ph": drift_mod.ph_step}

_P = ctypes.c_void_p


def _lib():
    lib = _build.library("detector_scan")
    if not getattr(lib, "_typed", False):
        lib.detector_scan.argtypes = [_P, ctypes.c_longlong, ctypes.c_int,
                                      _P, _P, _P, _P]
        lib.detector_scan.restype = ctypes.c_int
        lib._typed = True
    return lib


def detector_scan_plain(detector: str, state, err: torch.Tensor):
    """Step the detector over every event of ``err`` in order:
    ``(final state, any event at DRIFT)``."""
    state, levels = drift_mod.run_detector(STEPS[detector], state, err)
    return state, torch.any(levels == drift_mod.DRIFT)


def detector_scan_cuda(detector: str, state, err: torch.Tensor):
    """The detector-scan kernel: ``(final state, any event at DRIFT)``."""
    kind = KINDS[detector]
    dev = err.device
    floats = [t.to(device=dev, dtype=torch.float32).reshape(1)
              for t in state[:-1]]
    pad = [torch.zeros(1, device=dev)] * (5 - len(floats))
    st = torch.cat(floats + pad)
    level = state.level.to(device=dev, dtype=torch.int32).reshape(1).clone()
    drifted = torch.empty(1, dtype=torch.int32, device=dev)
    e = err.float().contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().detector_scan(e.data_ptr(), e.numel(), kind,
                                  st.data_ptr(), level.data_ptr(),
                                  drifted.data_ptr(), stream)
    _build.check(rc, "detector_scan")
    LAUNCHES["detector_scan"] += 1
    new = type(state)(*[st[i] for i in range(len(floats))], level[0])
    return new, drifted[0] != 0


def detector_scan(detector: str, state, err: torch.Tensor):
    """Scan a DDM/EDDM/PH detector over ``err`` on its device: kernel on
    CUDA, plain loop on the CPU."""
    if detector not in KINDS:
        raise KeyError(f"no detector scan for {detector!r}; "
                       f"known: {sorted(KINDS)}")
    if err.device.type == "cuda":
        return detector_scan_cuda(detector, state, err)
    if err.device.type == "cpu":
        return detector_scan_plain(detector, state, err)
    raise ValueError(f"detector_scan: no kernel for device {err.device}")
