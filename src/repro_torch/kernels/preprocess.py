"""Streaming-preprocess kernels: the CUDA kernels of
``csrc/preprocess.cu`` beside their plain versions in ``kernels/ref.py``.

* :func:`fused_normalize` replaces the JAX package's
  ``kernels/preprocess.py::fused_normalize`` (``_normalize_kernel``):
  NaN -> prior-mean impute, batch moments, Welford merge and normalize.
  Bound by bytes (x read once, y written once). The kernel sums raw
  moments in a fixed order (no float atomics), so it is deterministic
  and tolerance-equal, not bitwise, to the plain version, which centres
  first.
* :func:`fused_hash_features` replaces ``::fused_hash_features``
  (``_hash_kernel``): signed feature hashing into a dense (n, dim) array.
  Bound by the bytes of the output. Bitwise equal to the plain version.

Each wrapper launches the kernel for a CUDA tensor, runs the plain
version for a CPU tensor, and raises for any other device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_normalize_ref, hash_features_ref

LAUNCHES = {"fused_normalize": 0, "fused_hash_features": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.library("preprocess")
    if not getattr(lib, "_typed", False):
        lib.hash_features.argtypes = [_P, _P, _P, _I, _I, _I, ctypes.c_uint,
                                      _P]
        lib.hash_features.restype = _I
        lib.normalize_chunks.argtypes = [_I]
        lib.normalize_chunks.restype = _I
        lib.fused_normalize.argtypes = [_P] * 9 + [_I, _I, _I, _P]
        lib.fused_normalize.restype = _I
        lib._typed = True
    return lib


def fused_normalize_cuda(x, n0, mean0, m20, *, impute: bool = True):
    """The fused normalize kernel: ``(y, n1, mean1, m21)``."""
    if x.dim() != 2:
        raise ValueError(f"x must be (n, d), got {tuple(x.shape)}")
    n, d = x.shape
    dev = x.device
    xf = x.float().contiguous()
    n0t = torch.as_tensor(n0, dtype=torch.float32, device=dev).reshape(1)
    mean0t = torch.as_tensor(mean0, dtype=torch.float32,
                             device=dev).reshape(d).contiguous()
    m20t = torch.as_tensor(m20, dtype=torch.float32,
                           device=dev).reshape(d).contiguous()
    lib = _lib()
    chunks = lib.normalize_chunks(n)
    y = torch.empty_like(xf)
    n1 = torch.empty(1, dtype=torch.float32, device=dev)
    mean1 = torch.empty(d, dtype=torch.float32, device=dev)
    m21 = torch.empty(d, dtype=torch.float32, device=dev)
    scratch = torch.empty(2 * chunks * d + d, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_normalize(
            xf.data_ptr(), n0t.data_ptr(), mean0t.data_ptr(), m20t.data_ptr(),
            y.data_ptr(), n1.data_ptr(), mean1.data_ptr(), m21.data_ptr(),
            scratch.data_ptr(), n, d, int(bool(impute)), stream)
    _build.check(rc, "fused_normalize")
    LAUNCHES["fused_normalize"] += 1
    return y, n1.reshape(()), mean1, m21


def fused_hash_features_cuda(ids, vals, dim: int, *, seed: int = 17):
    """The feature-hashing kernel: ids/vals (n, f) -> dense (n, dim)."""
    if ids.shape != vals.shape or ids.dim() != 2:
        raise ValueError(f"ids {tuple(ids.shape)} and vals "
                         f"{tuple(vals.shape)} must both be (n, f)")
    if ids.device != vals.device:
        raise ValueError(f"ids on {ids.device}, vals on {vals.device}")
    n, f = ids.shape
    idt = ids.to(torch.int32).contiguous()
    vf = vals.float().contiguous()
    out = torch.empty((n, dim), dtype=torch.float32, device=ids.device)
    a = (2 * int(seed) + 1) & 0xFFFFFFFF
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        rc = _lib().hash_features(idt.data_ptr(), vf.data_ptr(),
                                  out.data_ptr(), n, f, int(dim), a, stream)
    _build.check(rc, "fused_hash_features")
    LAUNCHES["fused_hash_features"] += 1
    return out


def fused_normalize(x, n0, mean0, m20, *, impute: bool = True):
    """Impute + Welford update + normalize on x's device: kernel on CUDA,
    plain version on the CPU. Returns ``(y, n1, mean1, m21)``."""
    if x.device.type == "cuda":
        return fused_normalize_cuda(x, n0, mean0, m20, impute=impute)
    if x.device.type == "cpu":
        return fused_normalize_ref(x, n0, mean0, m20, impute=impute)
    raise ValueError(f"fused_normalize: no kernel for device {x.device}")


def fused_hash_features(ids, vals, dim: int, *, seed: int = 17):
    """Signed feature hashing on the ids' device: kernel on CUDA, plain
    version on the CPU."""
    if ids.device.type == "cuda":
        return fused_hash_features_cuda(ids, vals, dim, seed=seed)
    if ids.device.type == "cpu":
        return hash_features_ref(ids, vals, dim, seed=seed)
    raise ValueError(f"fused_hash_features: no kernel for device {ids.device}")
