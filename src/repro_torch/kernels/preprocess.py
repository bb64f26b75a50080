"""Streaming-preprocess kernels: the CUDA kernels of
``csrc/preprocess.cu`` beside their plain versions in ``kernels/ref.py``.

* :func:`fused_normalize` replaces the JAX package's
  ``kernels/preprocess.py::fused_normalize`` (``_normalize_kernel``):
  NaN -> prior-mean impute, batch moments, Welford merge and normalize.
  Bound by bytes (x read once, y written once). One call is one
  persistent kernel (``normalize_persistent``, a cooperative launch of
  one CTA an SM): each CTA reads its slice of rows once and keeps it in
  shared memory and the L2 for the normalize after a grid barrier. The
  partials are added in a fixed order (no float atomics), so it is
  deterministic and tolerance-equal, not bitwise, to the plain version,
  which centres first; ``ref.fused_normalize_slices_ref`` spells out its
  order. :func:`fused_normalize_witness_cuda` runs the
  first kernels (three launches, x read twice): the witness on the
  card, not counted in :data:`LAUNCHES`.
* :func:`fused_hash_features` replaces ``::fused_hash_features``
  (``_hash_kernel``): signed feature hashing into a dense (n, dim) array.
  Bound by the bytes of the output, which it writes once: each row is
  staged in shared memory, a warp adds its features there (equal slots
  summed in feature order by the lowest of their lanes) and writes the
  row out whole (``hash_staged``; dim <= 16,384, beyond that the
  row-thread kernel). Bitwise equal to the plain version.
  :func:`hash_features_rowthread_cuda` runs the first kernel (a thread
  a row, adding in device memory) at any dim: the witness on the card,
  not counted in :data:`LAUNCHES`.

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
        for fn in (lib.hash_features, lib.hash_features_rowthread):
            fn.argtypes = [_P, _P, _P, _I, _I, _I, ctypes.c_uint, _P]
            fn.restype = _I
        lib.normalize_chunks.argtypes = [_I]
        lib.normalize_chunks.restype = _I
        lib.normalize_grid.argtypes = []
        lib.normalize_grid.restype = _I
        for fn in (lib.fused_normalize, lib.fused_normalize_witness):
            fn.argtypes = [_P] * 9 + [_I, _I, _I, _P]
            fn.restype = _I
        lib._typed = True
    return lib


def _normalize(entry: str, scratch, x, n0, mean0, m20, impute: bool):
    """Run C entry ``entry`` with ``scratch(lib, n, d)`` floats of scratch."""
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
    y = torch.empty_like(xf)
    n1 = torch.empty(1, dtype=torch.float32, device=dev)
    mean1 = torch.empty(d, dtype=torch.float32, device=dev)
    m21 = torch.empty(d, dtype=torch.float32, device=dev)
    work = torch.empty(scratch(lib, n, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(
            xf.data_ptr(), n0t.data_ptr(), mean0t.data_ptr(), m20t.data_ptr(),
            y.data_ptr(), n1.data_ptr(), mean1.data_ptr(), m21.data_ptr(),
            work.data_ptr(), n, d, int(bool(impute)), stream)
    _build.check(rc, entry)
    return y, n1.reshape(()), mean1, m21


def fused_normalize_cuda(x, n0, mean0, m20, *, impute: bool = True):
    """The persistent normalize kernel: ``(y, n1, mean1, m21)``."""
    _build.refuse_autograd("fused_normalize", x, n0, mean0, m20)
    out = _normalize("fused_normalize",
                     lambda lib, n, d: 2 * lib.normalize_grid() * d + 2 * d,
                     x, n0, mean0, m20, impute)
    LAUNCHES["fused_normalize"] += 1
    return out


def fused_normalize_witness_cuda(x, n0, mean0, m20, *, impute: bool = True):
    """The first normalize kernels, the persistent kernel's witness
    (uncounted)."""
    return _normalize(
        "fused_normalize_witness",
        lambda lib, n, d: 2 * lib.normalize_chunks(n) * d + d,
        x, n0, mean0, m20, impute)


def _hash(entry: str, ids, vals, dim: int, seed: int):
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
        rc = getattr(_lib(), entry)(idt.data_ptr(), vf.data_ptr(),
                                    out.data_ptr(), n, f, int(dim), a,
                                    stream)
    _build.check(rc, entry)
    return out


def fused_hash_features_cuda(ids, vals, dim: int, *, seed: int = 17):
    """The feature-hashing kernel: ids/vals (n, f) -> dense (n, dim)."""
    _build.refuse_autograd("fused_hash_features", ids, vals)
    out = _hash("hash_features", ids, vals, dim, seed)
    if ids.shape[0]:
        LAUNCHES["fused_hash_features"] += 1
    return out


def hash_features_rowthread_cuda(ids, vals, dim: int, *, seed: int = 17):
    """The first hashing kernel, the staged kernel's witness (uncounted)."""
    return _hash("hash_features_rowthread", ids, vals, dim, seed)


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
