"""Flash attention (forward): the CUDA kernels of ``csrc/flash_attention.cu``
beside their plain version, ``kernels/ref.py::attention_ref``.

Replaces the JAX package's ``kernels/flash_attention.py``
(``flash_attention_bhsd``, ``_flash_fwd_kernel``, and its model-layout
wrapper ``flash_attention``). :func:`flash_attention` takes the model
layout, q (B, S, H, D) against k, v (B, T, KV, D), and reads it in place:
the kernel takes each tensor's strides, and query head h reads KV head
``h // (H // KV)``, so GQA is an index and one call is one launch with no
copy (a tensor whose last axis is not contiguous, or whose rows are not
16-byte aligned, is copied first). :func:`flash_attention_bhsd` is the
reference's (BH, S, D) API, a view of the same entry point with
H = KV = 1. fp32 or bf16, head dims :data:`HEAD_DIMS`, causal
(start-aligned, as the TPU kernel) or not. The dispatching wrappers take
any head dim: q, k and v of an unbuilt dim are zero-padded up to the
next built dim (:func:`padded_head_dim`), the kernel scales the scores
by the original dim's 1/sqrt (so they do not change), and the padded
columns of the output are sliced off (:func:`padded_call`). Above the
largest built dim (256) the scores need the whole head dim, so no split
outside a kernel can serve it: ``flash_fwd_wide`` takes any multiple of
8 there (a dim that is not is padded up to one, for the rows' 16-byte
alignment), fp32 or bf16, on the CUDA cores, walking the head dim in
chunks of 32 for Q K^T and for P V with its output accumulator in shared
memory (in scratch where 16 rows of it do not fit), with the same
semantics as the other kernels.

Up to 256, bf16 runs on the tensor cores: the 64-row kernel, or for a step of at most
:data:`DECODE_ROWS` query rows a (batch, KV head) the grouped decode
kernel, with T split across blocks where the batch's KV heads cannot fill
the card (:func:`kv_splits`). fp32 runs on the CUDA cores.

Each wrapper launches the kernel for a CUDA tensor, runs the plain
version for a CPU tensor, and raises for any other device. The kernel
has no backward: its wrapper raises where an input requires grad in
grad mode.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

LAUNCHES = {"flash_attention": 0}

# the head dims the kernels are built for: 64 (seamless-m4t-medium), 128
# (llama-3.2-vision-90b), 16 (both smoke configurations) and 256 (the
# attention head of Gemma's published configurations); every dim up to
# 256 reaches a kernel
HEAD_DIMS = (16, 64, 128, 256)
WIDE_ALIGN = 8         # the wide kernel's head dims: multiples of 8 above 256
WIDE_ROWS = 16         # query rows a block of the wide kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_K = 64           # keys per KV tile
DECODE_ROWS = 16       # query rows (H / KV heads x S) of the decode kernel
# fewer (batch, KV head) blocks than this leave SMs of the H100's 132 idle
# at a decode step: T is then split so that about twice as many run
FILL_BLOCKS = 128
MAX_SPLITS = 128       # the decode kernel's merge keeps 16 (m, l) a split
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# per device, the decode kernel's split counters (zeros; each call leaves
# them at zero). Calls share them, so they run on one stream at a time.
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _lib():
    lib = _build.library("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_fwd.argtypes = (
            [_P] * 4 + [_I] * 6 + [_L] * 9 + [_I] * 3 + [ctypes.c_float]
            + [_P] * 3)
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_wide_in_smem.argtypes = [_I]
        lib.flash_wide_in_smem.restype = _I
        lib._typed = True
    return lib


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """What the kernels take: q (B, S, H, D) and k, v (B, T, KV, D) alike,
    H a multiple of KV, fp32 or bf16 alike (else ``TypeError``), D in
    :data:`HEAD_DIMS` or a multiple of :data:`WIDE_ALIGN` above them, one
    device, a contiguous last axis, and rows that
    start 16 bytes aligned (else ``ValueError``). Returns each tensor's
    (batch, position, head) element strides for the kernel."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, H, D = q.shape
    kB, T, KV, kD = k.shape
    if kB != B or kD != D or not (B and S and T and KV) or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} against k, v "
                         f"{tuple(k.shape)}")
    dt = q.dtype
    if dt not in _DTYPES or k.dtype != dt or v.dtype != dt:
        raise TypeError(f"flash_attention takes fp32 or bf16 alike, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS and not (D > max(HEAD_DIMS)
                                   and D % WIDE_ALIGN == 0):
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS} "
                         f"nor a multiple of {WIDE_ALIGN} above them")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    out = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        rs = _row_strides(t)
        if rs is None:
            raise ValueError(
                f"flash_attention: {name}'s last axis has stride "
                f"{t.stride(-1)}, not 1" if t.stride(-1) != 1 else
                f"flash_attention: {name}'s rows are not 16-byte aligned")
        out.append(rs)
    return out


def _row_strides(t: torch.Tensor):
    """The (batch, position, head) element strides of a 4-D tensor (0 on
    a size-1 axis, which is never stepped along), or None where the
    kernels cannot read it in place: a last axis that is not contiguous,
    or a row that does not start 16 bytes aligned."""
    st, sh = t.stride(), t.shape
    if st[3] != 1:
        return None
    rs = (st[0] if sh[0] > 1 else 0, st[1] if sh[1] > 1 else 0,
          st[2] if sh[2] > 1 else 0)
    es = t.element_size()
    if (t.data_ptr() | rs[0] * es | rs[1] * es | rs[2] * es) % 16:
        return None
    return rs


def kv_splits(B: int, S: int, T: int, H: int, KV: int, dtype,
              causal: bool) -> int:
    """The launch shape: 0 for the 64-row kernel (fp32, or more than
    :data:`DECODE_ROWS` query rows a KV head); n >= 1 for the decode
    kernel, with T split over n blocks a (batch, KV head)."""
    if dtype != torch.bfloat16 or (H // KV) * S > DECODE_ROWS:
        return 0
    n_tiles = -(-T // BLOCK_K)
    if causal:      # start-aligned: no query position reaches past S - 1
        n_tiles = min(n_tiles, (S - 1) // BLOCK_K + 1)
    if B * KV >= FILL_BLOCKS:
        return 1
    want = min(n_tiles, MAX_SPLITS, -(-2 * FILL_BLOCKS // (B * KV)))
    per = -(-n_tiles // want)
    return -(-n_tiles // per)


def _counters(device: torch.device, n: int) -> torch.Tensor:
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = c
    return c


def padded_head_dim(D: int) -> int:
    """The head dim a call at ``D`` runs at: ``D`` where it is built, else
    the smallest built dim above it; above the largest, the next multiple
    of :data:`WIDE_ALIGN` (the wide kernel's). ``ValueError`` below 1."""
    if D < 1:
        raise ValueError(f"flash_attention: head dim {D} is not positive")
    if D > max(HEAD_DIMS):
        return -(-D // WIDE_ALIGN) * WIDE_ALIGN
    return min(d for d in HEAD_DIMS if d >= D)


def _scale(D: int) -> float:
    """1/sqrt(D) as the kernel computes it, in fp32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(D)))


def padded_call(fn, q, k, v, *, causal: bool = True):
    """``fn(q, k, v, causal=..., scale_dim=...)`` at the built head dim
    :func:`padded_head_dim` gives: q, k and v zero-padded on the head dim
    (the scores and the output's first D columns do not change when the
    scores keep the original dim's scale), the output sliced back."""
    D = q.shape[-1]
    Dp = padded_head_dim(D)
    if Dp == D:
        return fn(q, k, v, causal=causal)
    q, k, v = (F.pad(t, (0, Dp - D)) for t in (q, k, v))
    return fn(q, k, v, causal=causal, scale_dim=D)[..., :D]


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         scale_dim=None) -> torch.Tensor:
    """The kernel, model layout: q (B,S,H,D), k,v (B,T,KV,D) -> (B,S,H,D),
    read in place (see :func:`check_args` for what it takes). The scores
    are scaled by 1/sqrt(``scale_dim``), D by default."""
    _build.refuse_autograd("flash_attention", q, k, v)
    strides = check_args(q, k, v)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda: {dev} is not a CUDA "
                         "device")
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    wide = D > max(HEAD_DIMS)
    splits = 0 if wide else kv_splits(B, S, T, H, KV, q.dtype, causal)
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    part = counters = None
    if wide and not _lib().flash_wide_in_smem(D):
        part = torch.empty(-(-S // WIDE_ROWS) * WIDE_ROWS * B * H * D,
                           dtype=torch.float32, device=dev)
    if splits > 1:
        part = torch.empty(B * KV * splits * DECODE_ROWS * (D + 2),
                           dtype=torch.float32, device=dev)
        counters = _counters(dev, B * KV)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, S, T, H, KV, D, *strides[0], *strides[1], *strides[2],
            _DTYPES[q.dtype], int(bool(causal)), splits,
            0.0 if scale_dim is None else _scale(scale_dim),
            None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr())
    if dev.index == torch.cuda.current_device():
        rc = _lib().flash_attention_fwd(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = _lib().flash_attention_fwd(
                *args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale_dim=None):
    """The plain version, model layout, any head dim."""
    return attention_ref(q, k, v, causal=causal, scale_dim=scale_dim)


def flash_attention(q, k, v, *, causal: bool = True):
    """Model layout. q: (B,S,H,D); k,v: (B,T,KV,D), H a multiple of KV.
    Returns (B,S,H,D) on q's device: the kernel on CUDA (one launch; a
    tensor is copied only if its last axis is not contiguous or its rows
    are not 16-byte aligned, or zero-padded where D is not built), the
    plain version on the CPU."""
    if q.device.type == "cuda":
        q, k, v = (t if _row_strides(t) is not None
                   else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
        return padded_call(flash_attention_cuda, q, k, v, causal=causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


def flash_attention_bhsd_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True
                              ) -> torch.Tensor:
    """The kernel in the reference's layout: q (BH,S,D), k,v (BH,T,D) ->
    (BH,S,D), as one head of a model-layout call (zero-padded where D is
    not built)."""
    return padded_call(flash_attention_cuda, q[:, :, None], k[:, :, None],
                       v[:, :, None], causal=causal)[:, :, 0]


def flash_attention_bhsd_plain(q, k, v, *, causal: bool = True):
    """The plain version in the reference's layout."""
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

