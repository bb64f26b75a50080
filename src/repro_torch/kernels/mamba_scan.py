"""Mamba selective scan: the CUDA kernel of ``csrc/mamba_scan.cu`` beside
its plain version, ``kernels/ref.py::mamba_scan_ref`` (the per-timestep
recurrence).

Replaces the JAX package's ``kernels/mamba_scan.py::mamba_scan_bd``
(``_mamba_kernel``). :func:`mamba_scan` takes dt, x (B, S, dI), Bm, Cm
(B, S, N), A (dI, N) and h0 (B, dI, N) and returns ``(y (B, S, dI),
h_last (B, dI, N))``, both fp32 (inputs of another float type are cast).
S = 1 is a decode step.

On the card the kernel is ``mamba_scan_lanes``: four lanes a channel,
each holding N / 4 states (a thread is a lane of two channels),
exponentials as ``ex2`` of a pre-scaled A, dt and x staged a tile of
steps ahead (``ref.mamba_scan_lanes_ref``
spells out its arithmetic). ``chunk`` and ``bd`` only set its schedule,
within what it builds: it stages ``min(chunk, 32)`` steps at a time and
takes ``bd`` channels a block, rounded up to a multiple of 16, at most
64. :func:`mamba_scan_witness_cuda` runs the first kernel (a thread a
channel, ``chunk`` steps of B and C staged, ``bd`` threads a block): the
witness on the card, not counted in :data:`LAUNCHES`.

A state size that is not built, up to the largest built one, runs
zero-padded up to the next built size (:func:`padded_state_size`,
:func:`padded_call`): B, C, A and h0 are padded on the state axis (a zero
B and a zero h0 keep the padded states at 0, whatever exp(dt A) is), and
h_last is sliced back. The states of the recurrence are independent, and
y is a sum over them: a state size above the largest built one runs as
groups of at most 64 states (:func:`state_groups`), each padded so, one
launch a group, their y summed in fp32 and their h_last concatenated.
Every size of 1 or more reaches a kernel.

It launches the kernel for a CUDA tensor, runs the plain version for a
CPU tensor, and raises for any other device. The kernel has no
backward: its wrapper raises where an input requires grad in grad mode.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mamba_scan_ref

LAUNCHES = {"mamba_scan": 0}

# the configs' d_state (4, 16), and 32 and 64 so that every state size
# up to 64 reaches a kernel; the .cu builds these
STATE_SIZES = (4, 16, 32, 64)
MAX_TILE = 32           # steps the lane kernel stages at a time
MAX_CHANNELS = 64       # channels a block of the lane kernel
MAX_CHUNK = 1024
WITNESS_SMEM = 200 * 1024   # the witness's staged B and C, at most
_P = ctypes.c_void_p
_I = ctypes.c_int


def state_groups(N: int):
    """The groups a call at ``N`` states runs as: ``(first state, states,
    built size)`` a group, 64 states a group from the first and what
    remains last, each at the smallest built size at or above it.
    ``ValueError`` below 1."""
    if N < 1:
        raise ValueError(f"mamba_scan: state size {N} is not positive")
    top = max(STATE_SIZES)
    return [(s, min(top, N - s),
             min(n for n in STATE_SIZES if n >= min(top, N - s)))
            for s in range(0, N, top)]


def padded_state_size(N: int) -> int:
    """The states a call at ``N`` runs at, over its groups: ``N`` where it
    is built, else the smallest built size above it; above the largest,
    the groups' built sizes summed. ``ValueError`` below 1."""
    return sum(p for _, _, p in state_groups(N))


def padded_call(fn, dt, x, Bm, Cm, A, h0, **kw):
    """``fn`` (a selective scan) at the built state sizes
    :func:`state_groups` gives: each group's B, C, A and h0 zero-padded on
    the state axis, one call a group, y summed over the groups in fp32
    (no term of y is outside the states), h_last sliced back and
    concatenated."""
    N = Bm.shape[-1]
    ys, hs = None, []
    for s, n, p in state_groups(N):
        part = (t[..., s:s + n] if n < N else t for t in (Bm, Cm, A, h0))
        y, h = fn(dt, x, *(F.pad(t, (0, p - n)) if p > n else t
                           for t in part), **kw)
        ys = y if ys is None else ys + y
        hs.append(h[..., :n] if p > n else h)
    return ys, hs[0] if len(hs) == 1 else torch.cat(hs, dim=-1)


def _lib():
    lib = _build.library("mamba_scan")
    if not getattr(lib, "_typed", False):
        for fn in (lib.mamba_scan, lib.mamba_scan_witness):
            fn.argtypes = [_P] * 8 + [_I] * 6 + [_P]
            fn.restype = _I
        lib._typed = True
    return lib


def _scan(entry: str, dt, x, Bm, Cm, A, h0, steps: int, width: int):
    B, S, dI = dt.shape
    N = Bm.shape[-1]
    if (x.shape != dt.shape or Bm.shape != (B, S, N) or Cm.shape != Bm.shape
            or A.shape != (dI, N) or h0.shape != (B, dI, N)):
        raise ValueError(f"mamba_scan: dt {tuple(dt.shape)}, x "
                         f"{tuple(x.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)}, A {tuple(A.shape)}, h0 "
                         f"{tuple(h0.shape)}")
    if N not in STATE_SIZES:
        raise ValueError(f"mamba_scan: state size {N} (built for "
                         f"{STATE_SIZES})")
    dev = dt.device
    ins = [t.to(device=dev, dtype=torch.float32).contiguous()
           for t in (dt, x, Bm, Cm, A, h0)]
    y = torch.empty((B, S, dI), dtype=torch.float32, device=dev)
    h_last = torch.empty((B, dI, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(_lib(), entry)(*[t.data_ptr() for t in ins],
                                    y.data_ptr(), h_last.data_ptr(), B, S,
                                    dI, N, steps, width, stream)
    _build.check(rc, entry)
    return y, h_last


def mamba_scan_cuda(dt, x, Bm, Cm, A, h0, *, chunk: int = 128,
                    bd: int = 256):
    """The lane-split selective-scan kernel: ``(y, h_last)`` in fp32."""
    _build.refuse_autograd("mamba_scan", dt, x, Bm, Cm, A, h0)
    S, dI = dt.shape[1], dt.shape[2]
    steps = max(1, min(int(chunk), S, MAX_TILE))
    chans = min(MAX_CHANNELS, 16 * -(-max(1, min(int(bd), dI)) // 16))
    out = _scan("mamba_scan", dt, x, Bm, Cm, A, h0, steps, chans)
    LAUNCHES["mamba_scan"] += 1
    return out


def mamba_scan_witness_cuda(dt, x, Bm, Cm, A, h0, *, chunk: int = 128,
                            bd: int = 256):
    """The first selective-scan kernel, the lane kernel's witness
    (uncounted)."""
    S, dI, N = dt.shape[1], dt.shape[2], Bm.shape[-1]
    steps = max(1, min(int(chunk), S, MAX_CHUNK, WITNESS_SMEM // (8 * N)))
    threads = min(1024 if N <= 16 else 256,
                  32 * -(-max(1, min(int(bd), dI)) // 32))
    return _scan("mamba_scan_witness", dt, x, Bm, Cm, A, h0, steps, threads)


def mamba_scan(dt, x, Bm, Cm, A, h0, *, chunk: int = 128, bd: int = 256):
    """The selective scan on dt's device: kernel on CUDA (zero-padded
    where N is not built, in groups of 64 states above 64), plain version
    on the CPU."""
    if dt.device.type == "cuda":
        return padded_call(mamba_scan_cuda, dt, x, Bm, Cm, A, h0,
                           chunk=chunk, bd=bd)
    if dt.device.type == "cpu":
        return mamba_scan_ref(dt, x, Bm, Cm, A, h0)
    raise ValueError(f"mamba_scan: no kernel for device {dt.device}")
