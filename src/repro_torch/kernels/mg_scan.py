"""The Misra-Gries scan: the CUDA kernel of ``csrc/mg_scan.cu`` beside
its plain version, ``kernels/ref.py::mg_update_ref`` (a per-item loop).

The JAX package steps Misra-Gries with ``jax.lax.scan``
(``streams/sketches.py::mg_update``); it has no Pallas kernel. The scan
is sequential, so it is one kernel in which one warp owns the k slots
and walks the ids in order; it is bound by the latency of that chain.
Integer state only: the kernel is bitwise equal to the plain loop.

:func:`mg_scan` launches the kernel for a CUDA tensor, runs the plain
loop for a CPU tensor, and raises for any other device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mg_update_ref

LAUNCHES = {"mg_scan": 0}

MAX_K = 1024
_P = ctypes.c_void_p


def _lib():
    lib = _build.library("mg_scan")
    if not getattr(lib, "_typed", False):
        lib.mg_scan.argtypes = [_P, ctypes.c_longlong, ctypes.c_int, _P, _P,
                                _P]
        lib.mg_scan.restype = ctypes.c_int
        lib._typed = True
    return lib


def mg_scan_cuda(keys, counts, ids):
    """The Misra-Gries kernel: ``(keys, counts)`` after ``ids``."""
    k = keys.shape[0]
    if keys.shape != (k,) or counts.shape != (k,) or not 1 <= k <= MAX_K:
        raise ValueError(f"mg_scan: keys {tuple(keys.shape)} and counts "
                         f"{tuple(counts.shape)} must be (k,), 1 <= k <= "
                         f"{MAX_K}")
    dev = keys.device
    kk = keys.to(torch.int32).clone(memory_format=torch.contiguous_format)
    cc = counts.to(device=dev, dtype=torch.int32).clone(
        memory_format=torch.contiguous_format)
    idt = ids.to(device=dev, dtype=torch.int32).reshape(-1).contiguous()
    if not idt.numel():
        return kk, cc
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().mg_scan(idt.data_ptr(), idt.numel(), k, kk.data_ptr(),
                            cc.data_ptr(), stream)
    _build.check(rc, "mg_scan")
    LAUNCHES["mg_scan"] += 1
    return kk, cc


def mg_scan(keys, counts, ids):
    """Step a Misra-Gries summary over ``ids`` on its device: kernel on
    CUDA, plain loop on the CPU. Returns ``(keys, counts)`` int32."""
    if keys.device.type == "cuda":
        return mg_scan_cuda(keys, counts, ids)
    if keys.device.type == "cpu":
        return mg_update_ref(keys, counts, ids.reshape(-1))
    raise ValueError(f"mg_scan: no kernel for device {keys.device}")
