"""Error-feedback codec round-trips: the CUDA kernels of
``csrc/ef_codec.cu`` beside their plain versions in ``kernels/ref.py``.

Replaces the JAX package's ``kernels/ef_codec.py::ef_int8_roundtrip``
(``_int8_kernel``) and ``::ef_topk_int8_roundtrip``
(``_topk_int8_kernel``). Each wrapper launches the kernel for a CUDA
tensor, runs the plain version for a CPU tensor, and raises for any
other device. Both kernels are bound by bytes: 16 per element (x and the
residual read, the decoded value and the new residual written).

The top-k threshold is the k-th largest ``|x + residual|``. The JAX
package takes it outside its Pallas kernel with ``lax.top_k``; here an
exact radix select over the bits of ``|x + residual|`` finds it on the
card, inside the same C call as the round-trip, with no host sync
(``csrc/ef_codec.cu``; its plain version is
``ref.topk_threshold_radix``), and every coordinate at or above it is
kept, ties included. :func:`ef_topk_threshold_cuda` runs the select
alone. :func:`ef_topk_int8_roundtrip_witness_cuda` is the path it
replaced (``torch.topk``'s threshold, then the int8 kernels with a
threshold): a witness off every main path, not counted.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (ef_int8_roundtrip_ref,
                                     ef_topk_int8_roundtrip_ref,
                                     topk_threshold)

LAUNCHES = {"ef_int8_roundtrip": 0, "ef_topk_int8_roundtrip": 0}

_P = ctypes.c_void_p


def _lib():
    lib = _build.library("ef_codec")
    if not getattr(lib, "_typed", False):
        lib.ef_roundtrip.argtypes = [_P, _P, _P, _P, _P, _P,
                                     ctypes.c_longlong, _P]
        lib.ef_roundtrip.restype = ctypes.c_int
        lib.ef_topk_roundtrip.argtypes = [_P, _P, ctypes.c_longlong,
                                          ctypes.c_longlong, _P, _P, _P, _P]
        lib.ef_topk_roundtrip.restype = ctypes.c_int
        lib.ef_topk_select.argtypes = [_P, _P, ctypes.c_longlong,
                                       ctypes.c_longlong, _P, _P]
        lib.ef_topk_select.restype = ctypes.c_int
        lib.ef_topk_scratch_words.argtypes = [ctypes.c_longlong]
        lib.ef_topk_scratch_words.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def _check_pair(residual: torch.Tensor, x: torch.Tensor) -> None:
    if residual.device != x.device:
        raise ValueError(f"residual on {residual.device}, x on {x.device}")
    if residual.dtype != torch.float32:
        raise TypeError(f"residual must be float32, got {residual.dtype}")
    if residual.numel() != x.numel():
        raise ValueError(f"residual has {residual.numel()} elements, "
                         f"x has {x.numel()}")


def _launch(residual, x, thresh, counter):
    _check_pair(residual, x)
    xf = x.float().contiguous()
    r = residual.contiguous()
    dec = torch.empty_like(xf)
    rout = torch.empty_like(xf)
    scratch = torch.empty(1, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().ef_roundtrip(
            xf.data_ptr(), r.data_ptr(),
            None if thresh is None else thresh.data_ptr(),
            dec.data_ptr(), rout.data_ptr(), scratch.data_ptr(),
            xf.numel(), stream)
    _build.check(rc, counter or "ef_roundtrip")
    if counter:
        LAUNCHES[counter] += 1
    return dec.reshape(x.shape).to(x.dtype), rout.reshape(x.shape)


def ef_int8_roundtrip_cuda(residual: torch.Tensor, x: torch.Tensor):
    """The int8 EF round-trip kernel: ``(decoded, new_residual)``."""
    _build.refuse_autograd("ef_int8_roundtrip", residual, x)
    return _launch(residual, x, None, "ef_int8_roundtrip")


def _topk_operands(residual, x, k: int):
    """x and the residual flat, fp32 and contiguous; k clamped to
    [1, n]; the select's device scratch."""
    _check_pair(residual, x)
    if x.numel() == 0:
        raise ValueError("top-k of an empty tensor")
    xf = x.reshape(-1).float().contiguous()
    r = residual.reshape(-1).contiguous()
    k = max(1, min(int(k), xf.numel()))
    scratch = torch.empty(_lib().ef_topk_scratch_words(xf.numel()),
                          dtype=torch.int32, device=x.device)
    return xf, r, k, scratch


def ef_topk_int8_roundtrip_cuda(residual: torch.Tensor, x: torch.Tensor,
                                k: int):
    """The top-k + int8 EF round-trip kernels, the radix select included:
    ``(decoded, new_residual)``."""
    _build.refuse_autograd("ef_topk_int8_roundtrip", residual, x)
    xf, r, k, scratch = _topk_operands(residual, x, k)
    dec = torch.empty_like(xf)
    rout = torch.empty_like(xf)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().ef_topk_roundtrip(xf.data_ptr(), r.data_ptr(), xf.numel(),
                                      k, dec.data_ptr(), rout.data_ptr(),
                                      scratch.data_ptr(), stream)
    _build.check(rc, "ef_topk_int8_roundtrip")
    LAUNCHES["ef_topk_int8_roundtrip"] += 1
    return dec.reshape(x.shape).to(x.dtype), rout.reshape(x.shape)


def ef_topk_threshold_cuda(residual: torch.Tensor, x: torch.Tensor, k: int,
                           *, state: bool = False):
    """The radix select alone: the k-th largest ``|x + residual|`` (0-dim
    fp32 on the card), as the round-trip finds it. Not counted. With
    ``state`` also (after a sync) the select's own record: pass 1's digit
    bin, the sample's window of bins, the keys pass 1 kept and whether
    pass 2 took them (else it read x and r again)."""
    xf, r, k, scratch = _topk_operands(residual, x, k)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().ef_topk_select(xf.data_ptr(), r.data_ptr(), xf.numel(), k,
                                   scratch.data_ptr(), stream)
    _build.check(rc, "ef_topk_select")
    t = scratch[2].view(torch.float32)
    if not state:
        return t
    # the header of csrc/ef_codec.cu's scratch
    h = scratch[:12].tolist()
    return t, {"digit1": h[3], "window": (h[8], h[9]), "kept": h[10],
               "from_kept": bool(h[11])}


def ef_topk_int8_roundtrip_witness_cuda(residual: torch.Tensor,
                                        x: torch.Tensor, k: int):
    """The path the radix select replaced: ``torch.topk``'s threshold
    (``ref.topk_threshold``), then the int8 kernels keeping what reaches
    it. The same ``(decoded, new_residual)``; not counted."""
    _check_pair(residual, x)
    xc = x.reshape(-1).float() + residual.reshape(-1)
    k = max(1, min(int(k), xc.shape[0]))
    t = topk_threshold(torch.abs(xc), k).reshape(1).contiguous()
    return _launch(residual, x, t, None)


def ef_int8_roundtrip(residual: torch.Tensor, x: torch.Tensor):
    """Int8 EF wire round-trip on x's device: kernel on CUDA, plain
    version on the CPU."""
    if x.device.type == "cuda":
        return ef_int8_roundtrip_cuda(residual, x)
    if x.device.type == "cpu":
        return ef_int8_roundtrip_ref(residual, x)
    raise ValueError(f"ef_int8_roundtrip: no kernel for device {x.device}")


def ef_topk_int8_roundtrip(residual: torch.Tensor, x: torch.Tensor, k: int):
    """Top-k + int8 EF wire round-trip on x's device: kernel on CUDA,
    plain version on the CPU."""
    if x.device.type == "cuda":
        return ef_topk_int8_roundtrip_cuda(residual, x, k)
    if x.device.type == "cpu":
        return ef_topk_int8_roundtrip_ref(residual, x, k)
    raise ValueError(
        f"ef_topk_int8_roundtrip: no kernel for device {x.device}")
