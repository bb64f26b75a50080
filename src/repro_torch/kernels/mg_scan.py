"""The Misra-Gries scan: the CUDA kernel of ``csrc/mg_scan.cu`` beside
its plain version, ``kernels/ref.py::mg_update_ref`` (a per-item loop).

The JAX package steps Misra-Gries with ``jax.lax.scan``
(``streams/sketches.py::mg_update``); it has no Pallas kernel. The scan
is sequential and bound by the latency of its chain, so the kernel takes
off the chain every id that cannot change it: per chunk of ids, the
block's other warps count the ids of the safe slots (the first slot of
their key, with a count above the ids left to the chunk's end) and
compact the rest in order, while one warp walks the rest with the safe
slots frozen and then adds ``hits - decrements`` to them. One launch a
call. Integer state only: the kernel is bitwise equal to the plain loop
(``kernels/ref.py::mg_update_chunked_ref`` spells its algorithm out).
``mg_scan_serial_cuda`` is the kernel it replaced, every id on one
warp's chain: an exact witness off every main path, not counted.

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
CHUNK = 1024          # ids a chunk: kChunk in csrc/mg_scan.cu
_P = ctypes.c_void_p
_STATS = {}           # device -> int64 (2,): ids the chain walked, ids seen


def _lib():
    lib = _build.library("mg_scan")
    if not getattr(lib, "_typed", False):
        lib.mg_scan.argtypes = [_P, ctypes.c_longlong, ctypes.c_int, _P, _P,
                                _P, _P]
        lib.mg_scan.restype = ctypes.c_int
        lib.mg_scan_serial.argtypes = [_P, ctypes.c_longlong, ctypes.c_int,
                                       _P, _P, _P]
        lib.mg_scan_serial.restype = ctypes.c_int
        lib._typed = True
    return lib


def chain_stats(device) -> torch.Tensor:
    """The card's running ``[ids the chain walked, ids seen]`` (int64),
    summed over the kernel's launches on ``device``; read it without a
    sync by cloning it after a call."""
    return _build.device_stats(_STATS, device)


def _args(keys, counts, ids):
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
    return k, kk, cc, idt


def mg_scan_cuda(keys, counts, ids):
    """The Misra-Gries kernel: ``(keys, counts)`` after ``ids``."""
    _build.refuse_autograd("mg_scan", keys, counts, ids)
    k, kk, cc, idt = _args(keys, counts, ids)
    if not idt.numel():
        return kk, cc
    dev = kk.device
    stats = chain_stats(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().mg_scan(idt.data_ptr(), idt.numel(), k, kk.data_ptr(),
                            cc.data_ptr(), stats.data_ptr(), stream)
    _build.check(rc, "mg_scan")
    LAUNCHES["mg_scan"] += 1
    return kk, cc


def mg_scan_serial_cuda(keys, counts, ids):
    """The serial witness kernel: the same ``(keys, counts)``, every id
    on the chain. Off the main path; not counted."""
    k, kk, cc, idt = _args(keys, counts, ids)
    if not idt.numel():
        return kk, cc
    dev = kk.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().mg_scan_serial(idt.data_ptr(), idt.numel(), k,
                                   kk.data_ptr(), cc.data_ptr(), stream)
    _build.check(rc, "mg_scan_serial")
    return kk, cc


def mg_scan(keys, counts, ids):
    """Step a Misra-Gries summary over ``ids`` on its device: kernel on
    CUDA, plain loop on the CPU. Returns ``(keys, counts)`` int32."""
    if keys.device.type == "cuda":
        return mg_scan_cuda(keys, counts, ids)
    if keys.device.type == "cpu":
        return mg_update_ref(keys, counts, ids.reshape(-1))
    raise ValueError(f"mg_scan: no kernel for device {keys.device}")
