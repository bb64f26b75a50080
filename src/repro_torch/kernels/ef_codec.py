"""Error-feedback codec round-trips: the CUDA kernels of
``csrc/ef_codec.cu`` beside their plain versions in ``kernels/ref.py``.

Replaces the JAX package's ``kernels/ef_codec.py::ef_int8_roundtrip``
(``_int8_kernel``) and ``::ef_topk_int8_roundtrip``
(``_topk_int8_kernel``). Each wrapper launches the kernel for a CUDA
tensor, runs the plain version for a CPU tensor, and raises for any
other device. Both kernels are bound by bytes: 16 per element (x and the
residual read, the decoded value and the new residual written).

The top-k threshold is the k-th largest ``|x + residual|``. The JAX
package takes it outside its Pallas kernel with ``lax.top_k``; here the
wrapper takes it with ``torch.topk`` and the kernel keeps every
coordinate at or above it, ties included.
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


def _launch(residual, x, thresh, counter: str):
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
    _build.check(rc, counter)
    LAUNCHES[counter] += 1
    return dec.reshape(x.shape).to(x.dtype), rout.reshape(x.shape)


def ef_int8_roundtrip_cuda(residual: torch.Tensor, x: torch.Tensor):
    """The int8 EF round-trip kernel: ``(decoded, new_residual)``."""
    return _launch(residual, x, None, "ef_int8_roundtrip")


def ef_topk_int8_roundtrip_cuda(residual: torch.Tensor, x: torch.Tensor,
                                k: int):
    """The top-k + int8 EF round-trip kernel: ``(decoded, new_residual)``."""
    _check_pair(residual, x)
    xc = x.reshape(-1).float() + residual.reshape(-1)
    k = max(1, min(int(k), xc.shape[0]))
    t = topk_threshold(torch.abs(xc), k).reshape(1).contiguous()
    return _launch(residual, x, t, "ef_topk_int8_roundtrip")


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
