"""RWKV6 WKV recurrence: the CUDA kernel of ``csrc/rwkv6_wkv.cu`` beside
its plain version, ``kernels/ref.py::rwkv6_wkv_ref`` (the per-timestep
recurrence).

Replaces the JAX package's ``kernels/rwkv6_wkv.py::rwkv6_wkv_bh``
(``_wkv_kernel``). :func:`rwkv6_wkv_bh` takes r, k, v (BH, S, hs) in fp32
or bf16, lw (BH, S, hs), u (BH, hs) and h0 (BH, hs, hs) in fp32, and
returns ``(o, h_last)``: o in r's dtype, h_last in fp32. The kernel
walks the sequence in chunks of ``chunk`` steps (``min(chunk, S)``), the
last one padded; S = 1 is a decode step. :func:`rwkv6_wkv` is the model
layout wrapper.

Each wrapper launches the kernel for a CUDA tensor, runs the plain
version for a CPU tensor, and raises for any other device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rwkv6_wkv_ref

LAUNCHES = {"rwkv6_wkv": 0}

MAX_CHUNK = 64
MAX_HS = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.library("rwkv6_wkv")
    if not getattr(lib, "_typed", False):
        lib.rwkv6_wkv_fwd.argtypes = [_P] * 8 + [_I] * 5 + [_P]
        lib.rwkv6_wkv_fwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def rwkv6_wkv_bh_cuda(r, k, v, lw, u, h0, *, chunk: int = 32):
    """The WKV kernel: ``(o (BH,S,hs), h_last (BH,hs,hs))``."""
    BH, S, hs = r.shape
    chunk = min(int(chunk), S)
    if k.shape != r.shape or v.shape != r.shape or lw.shape != r.shape:
        raise ValueError(f"rwkv6_wkv: r {tuple(r.shape)}, k {tuple(k.shape)}"
                         f", v {tuple(v.shape)}, lw {tuple(lw.shape)}")
    if u.shape != (BH, hs) or h0.shape != (BH, hs, hs):
        raise ValueError(f"rwkv6_wkv: u {tuple(u.shape)}, h0 "
                         f"{tuple(h0.shape)} for r {tuple(r.shape)}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6_wkv: r, k, v must be one of fp32/bf16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if not (0 < chunk <= MAX_CHUNK and hs <= MAX_HS):
        raise ValueError(f"rwkv6_wkv: chunk {chunk} (max {MAX_CHUNK}) or "
                         f"head size {hs} (max {MAX_HS}) out of range")
    dev = r.device
    r, k, v = r.contiguous(), k.contiguous(), v.contiguous()
    lwf = lw.to(device=dev, dtype=torch.float32).contiguous()
    uf = u.to(device=dev, dtype=torch.float32).contiguous()
    h0f = h0.to(device=dev, dtype=torch.float32).contiguous()
    o = torch.empty_like(r)
    h_last = torch.empty((BH, hs, hs), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().rwkv6_wkv_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), lwf.data_ptr(),
            uf.data_ptr(), h0f.data_ptr(), o.data_ptr(), h_last.data_ptr(),
            BH, S, hs, chunk, _DTYPES[r.dtype], stream)
    _build.check(rc, "rwkv6_wkv")
    LAUNCHES["rwkv6_wkv"] += 1
    return o, h_last


def rwkv6_wkv_bh_plain(r, k, v, lw, u, h0, *, chunk: int = 32):
    """The plain version in the kernel's layout: the (B,S,H,hs) oracle
    with the B*H rows as the heads of one batch (``chunk`` only sets the
    kernel's schedule). o in r's dtype, h_last in fp32."""
    def unfold(t):
        return t.transpose(0, 1)[None]          # (1, S, BH, hs)
    o, h = rwkv6_wkv_ref(unfold(r), unfold(k), unfold(v), unfold(lw), u,
                         h0[None])
    return o[0].transpose(0, 1).to(r.dtype), h[0]


def rwkv6_wkv_bh(r, k, v, lw, u, h0, *, chunk: int = 32):
    """WKV in the kernel's layout on r's device: kernel on CUDA, plain
    version on the CPU."""
    if r.device.type == "cuda":
        return rwkv6_wkv_bh_cuda(r, k, v, lw, u, h0, chunk=chunk)
    if r.device.type == "cpu":
        return rwkv6_wkv_bh_plain(r, k, v, lw, u, h0, chunk=chunk)
    raise ValueError(f"rwkv6_wkv: no kernel for device {r.device}")


def rwkv6_wkv(r, k, v, lw, u, h0, *, chunk: int = 32):
    """Model layout. r,k,v,lw: (B,S,H,hs); u: (H,hs); h0: (B,H,hs,hs).
    Returns (o (B,S,H,hs) in r's dtype, h_last (B,H,hs,hs) fp32)."""
    B, S, H, hs = r.shape

    def fold(t):
        return t.transpose(1, 2).reshape(B * H, S, hs)
    uf = u[None].expand(B, H, hs).reshape(B * H, hs)
    o, h_last = rwkv6_wkv_bh(fold(r), fold(k), fold(v), fold(lw), uf,
                             h0.reshape(B * H, hs, hs), chunk=chunk)
    return (o.reshape(B, H, S, hs).transpose(1, 2),
            h_last.reshape(B, H, hs, hs))
