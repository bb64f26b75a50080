"""Flash attention (forward): the CUDA kernel of ``csrc/flash_attention.cu``
beside its plain version, ``kernels/ref.py::attention_ref``.

Replaces the JAX package's ``kernels/flash_attention.py::
flash_attention_bhsd`` (``_flash_fwd_kernel``). :func:`flash_attention_bhsd`
takes q (BH, S, D) against k, v (BH, T, D), fp32 or bf16, D = 64, causal
(start-aligned, as the TPU kernel) or not; S = 1 (a decode step) and
S != T (cross-attention) included. :func:`flash_attention` is the
model-layout wrapper: it expands GQA by repeating KV heads, as the
reference's wrapper does, and folds heads into the batch.

Each wrapper launches the kernel for a CUDA tensor, runs the plain
version for a CPU tensor, and raises for any other device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

LAUNCHES = {"flash_attention": 0}

# the kernel is built for the one head size on a path that reaches it
# (seamless-m4t's cross-attention)
HEAD_DIMS = (64,)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.library("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_fwd.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                            _I, _I, _P]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def flash_attention_bhsd_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True
                              ) -> torch.Tensor:
    """The flash-attention kernel: q (BH,S,D), k,v (BH,T,D) -> (BH,S,D)."""
    BH, S, D = q.shape
    T = k.shape[1]
    if k.shape != (BH, T, D) or v.shape != (BH, T, D):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes fp32 or bf16 alike, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    # contiguous, and 16-byte aligned: the kernel reads 16 bytes at a time
    q, k, v = (t.contiguous() for t in (q, k, v))
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), BH, S, T,
            D, _DTYPES[q.dtype], int(bool(causal)), stream)
    _build.check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o


def flash_attention_bhsd_plain(q, k, v, *, causal: bool = True):
    """The plain version in the kernel's layout."""
    return attention_ref(q[:, :, None], k[:, :, None], v[:, :, None],
                         causal=causal)[:, :, 0]


def flash_attention_bhsd(q, k, v, *, causal: bool = True):
    """q (BH,S,D) against k,v (BH,T,D) on q's device: kernel on CUDA,
    plain version on the CPU."""
    if q.device.type == "cuda":
        return flash_attention_bhsd_cuda(q, k, v, causal=causal)
    if q.device.type == "cpu":
        return flash_attention_bhsd_plain(q, k, v, causal=causal)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


def flash_attention(q, k, v, *, causal: bool = True):
    """Model layout. q: (B,S,H,D); k,v: (B,T,KV,D) (GQA expanded here).
    Returns (B,S,H,D)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if KV != H:
        k = torch.repeat_interleave(k, H // KV, dim=2)
        v = torch.repeat_interleave(v, H // KV, dim=2)
    qr = q.transpose(1, 2).reshape(B * H, S, D)
    kr = k.transpose(1, 2).reshape(B * H, T, D)
    vr = v.transpose(1, 2).reshape(B * H, T, D)
    o = flash_attention_bhsd(qr, kr, vr, causal=causal)
    return o.reshape(B, H, S, D).transpose(1, 2)
