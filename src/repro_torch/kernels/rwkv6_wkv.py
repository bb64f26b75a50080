"""RWKV6 WKV recurrence: the CUDA kernels of ``csrc/rwkv6_wkv.cu`` beside
their plain version, ``kernels/ref.py::rwkv6_wkv_ref`` (the per-timestep
recurrence).

Replaces the JAX package's ``kernels/rwkv6_wkv.py`` (``rwkv6_wkv_bh``,
``_wkv_kernel``, and its model-layout wrapper ``rwkv6_wkv``).
:func:`rwkv6_wkv` takes the model layout and reads it in place: r, k, v
(B, S, H, hs) in bf16 or fp32 and lw (B, S, H, hs) fp32, each with its
own strides (a contiguous last axis, 16-byte aligned rows; anything else
is copied first), u (H, hs) in fp32 or bf16, h0 (B, H, hs, hs) fp32. It
returns ``(o, h_last)``: o (B, S, H, hs) contiguous in r's dtype, h_last
(B, H, hs, hs) fp32. One call is one launch: the decode kernel at S = 1,
the tensor-core chunk kernel for bf16 (at head size 128 the CUDA-core
kernel), the CUDA-core kernel for fp32.
:func:`rwkv6_wkv_bh` is the reference's (BH, S, hs) API, a view of the
same entry point with B = 1 and BH heads. The kernels take head sizes
:data:`HEAD_SIZES` and chunks :data:`CHUNKS` (the sequence is padded to
a multiple of the chunk, so h_last is exact at any S); the kernel's
wrapper :func:`rwkv6_wkv_cuda` and the C entry refuse anything else with
``ValueError``. The chunk is internal to the kernel: any chunk computes
the same recurrence, only the schedule and the order of sums differ. So
the dispatching wrappers :func:`rwkv6_wkv` and :func:`rwkv6_wkv_bh` take
every positive chunk the reference's kernel takes and run one that was
not built at the built chunk :func:`kernel_chunk` names (the largest
built chunk that divides it, else the largest built chunk): rwkv6's
default ``RWKVConfig.chunk`` of 64 runs the chunk-32 kernel, one launch.
A head size that is not built, up to the largest built one, runs
zero-padded up to the next built size (:func:`padded_head_size`,
:func:`padded_call`): r, k, v, lw, u and h0 are padded on the head axis
(a zero key and a zero state keep the padded rows of the state at 0, a
zero value the padded columns of o), and o and h_last are sliced back.
Above the largest built one (:data:`HEAD_SIZES`' 128) hs is padded to a
multiple of 128 and split in blocks of 128 (:func:`blocked_call`): the
state ``S[k, v]`` decays by key row and its value columns are
independent, ``o[v] = sum_k r[k] (S[k, v] + u[k] k[k] v[v])``, so each
(key block i, value block j) is a head of its own at size 128 (r, k, lw
and u of block i, v of block j, h0 block [i, j]), all of them one launch
of the kernel in fp32; o sums its key blocks in fp32 and rounds once to
r's dtype, and block [i, j] of h_last is that head's. Every size of 1
or more reaches a kernel. The plain version takes any shape. :func:`rwkv6_wkv_witness_cuda` runs the CUDA-core
kernel on either dtype: the witness the tensor-core kernel is held
against on the card (not counted in :data:`LAUNCHES`).

Each wrapper launches its kernel for a CUDA tensor, runs the plain
version for a CPU tensor, and raises for any other device. The kernels
have no backward: the path's wrapper raises where an input requires grad
in grad mode.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rwkv6_wkv_ref

LAUNCHES = {"rwkv6_wkv": 0}

# every head size and chunk a configuration reaches: rwkv6-1.6b (64, 32)
# and its smoke configuration (16, 16); and head size 128, so that every
# size up to 128 reaches a kernel
HEAD_SIZES = (16, 64, 128)
CHUNKS = (16, 32)
BAD_ARGS = -1          # the C entry's answer to arguments it does not take
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def kernel_chunk(chunk: int) -> int:
    """The built chunk a call at ``chunk`` runs at on the card: ``chunk``
    where it is built, else the largest built chunk that divides it, else
    the largest built chunk. ``ValueError`` for a chunk below 1."""
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f"rwkv6_wkv: chunk {chunk} is not positive")
    if chunk in CHUNKS:
        return chunk
    return max([c for c in CHUNKS if chunk % c == 0] or CHUNKS)


def padded_head_size(hs: int) -> int:
    """The head size a call at ``hs`` runs at: ``hs`` where it is built,
    else the smallest built size above it; above the largest, the next
    multiple of it (:func:`blocked_call`'s blocks). ``ValueError`` below
    1."""
    if hs < 1:
        raise ValueError(f"rwkv6_wkv: head size {hs} is not positive")
    top = max(HEAD_SIZES)
    if hs > top:
        return -(-hs // top) * top
    return min(h for h in HEAD_SIZES if h >= hs)


def blocked_call(fn, r, k, v, lw, u, h0, *, chunk: int):
    """``fn`` (a model-layout WKV) at a head size above the largest built
    one, as blocks of that size: hs zero-padded to
    :func:`padded_head_size`, each (key block i, value block j) a head of
    one fp32 call (heads ordered (h, i, j)), o summed over i in fp32 and
    cast to r's dtype, h_last's blocks put back; both sliced to hs."""
    B, S, H, hs = r.shape
    top = max(HEAD_SIZES)
    hp = padded_head_size(hs)
    nb, p = hp // top, hp - hs
    dtype = r.dtype
    r, k, v, lw, u = (F.pad(t.float(), (0, p)) for t in (r, k, v, lw, u))
    h0 = F.pad(h0.float(), (0, p, 0, p))

    def by_key(t):       # (..., H, hp) -> (..., H * nb * nb, top), block i
        lead = t.shape[:-2]
        return t.reshape(*lead, H, nb, 1, top).expand(
            *lead, H, nb, nb, top).reshape(*lead, H * nb * nb, top)

    def by_value(t):     # block j
        lead = t.shape[:-2]
        return t.reshape(*lead, H, 1, nb, top).expand(
            *lead, H, nb, nb, top).reshape(*lead, H * nb * nb, top)

    hb = h0.reshape(B, H, nb, top, nb, top).permute(0, 1, 2, 4, 3, 5)
    o, h = fn(by_key(r), by_key(k), by_value(v), by_key(lw), by_key(u),
              hb.reshape(B, H * nb * nb, top, top), chunk=chunk)
    o = o.float().reshape(B, S, H, nb, nb, top).sum(dim=3)
    h = h.reshape(B, H, nb, nb, top, top).permute(0, 1, 2, 4, 3, 5)
    return (o.reshape(B, S, H, hp)[..., :hs].to(dtype),
            h.reshape(B, H, hp, hp)[..., :hs, :hs])


def padded_call(fn, r, k, v, lw, u, h0, *, chunk: int):
    """``fn`` (a model-layout WKV) at the head size
    :func:`padded_head_size` gives: up to the largest built size, every
    input zero-padded on the head axis (both axes of h0), o and h_last
    sliced back; above it, :func:`blocked_call`."""
    hs = r.shape[-1]
    if hs > max(HEAD_SIZES):
        return blocked_call(fn, r, k, v, lw, u, h0, chunk=chunk)
    p = padded_head_size(hs) - hs
    if not p:
        return fn(r, k, v, lw, u, h0, chunk=chunk)
    r, k, v, lw, u = (F.pad(t, (0, p)) for t in (r, k, v, lw, u))
    o, h = fn(r, k, v, lw, u, F.pad(h0, (0, p, 0, p)), chunk=chunk)
    return o[..., :hs], h[..., :hs, :hs]


def _lib():
    lib = _build.library("rwkv6_wkv")
    if not getattr(lib, "_typed", False):
        lib.rwkv6_wkv_fwd.argtypes = (
            [_P] * 8 + [_I] * 5 + [_L] * 12 + [_I] * 3 + [_P])
        lib.rwkv6_wkv_fwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def check_args(r, k, v, lw, u, h0, chunk: int):
    """What the kernels take (``ValueError`` or ``TypeError`` otherwise):
    r, k, v, lw (B, S, H, hs) alike, u (H, hs), h0 (B, H, hs, hs); r, k, v
    one of fp32/bf16 alike, lw and h0 fp32, u fp32 or bf16; hs in
    :data:`HEAD_SIZES`, ``chunk`` in :data:`CHUNKS`; one device."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, lw)):
        raise ValueError(f"rwkv6_wkv: r {tuple(r.shape)}, k {tuple(k.shape)}"
                         f", v {tuple(v.shape)}, lw {tuple(lw.shape)}")
    B, S, H, hs = r.shape
    if hs not in HEAD_SIZES:
        raise ValueError(f"rwkv6_wkv: head size {hs} not in {HEAD_SIZES}")
    if chunk not in CHUNKS:
        raise ValueError(f"rwkv6_wkv: chunk {chunk} not in {CHUNKS}")
    if not (B and S and H):
        raise ValueError(f"rwkv6_wkv: empty input {tuple(r.shape)}")
    if u.shape != (H, hs) or h0.shape != (B, H, hs, hs):
        raise ValueError(f"rwkv6_wkv: u {tuple(u.shape)}, h0 "
                         f"{tuple(h0.shape)} for r {tuple(r.shape)}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6_wkv: r, k, v must be one of fp32/bf16 alike, "
                        f"got {r.dtype}, {k.dtype}, {v.dtype}")
    if lw.dtype != torch.float32 or h0.dtype != torch.float32 or \
            u.dtype not in _DTYPES:
        raise TypeError(f"rwkv6_wkv: lw {lw.dtype}, h0 {h0.dtype} must be "
                        f"fp32 and u {u.dtype} fp32 or bf16")
    if any(t.device != r.device for t in (k, v, lw, u, h0)):
        raise ValueError("rwkv6_wkv: inputs on different devices")


def _row_strides(t: torch.Tensor):
    """The (batch, position, head) element strides of a 4-D tensor (0 on
    a size-1 axis), or None where the kernels cannot read it in place: a
    last axis that is not contiguous, or a row not 16 bytes aligned."""
    st, sh = t.stride(), t.shape
    if st[3] != 1:
        return None
    rs = tuple(st[d] if sh[d] > 1 else 0 for d in range(3))
    es = t.element_size()
    if (t.data_ptr() | rs[0] * es | rs[1] * es | rs[2] * es) % 16:
        return None
    return rs


def _in_place(t: torch.Tensor) -> torch.Tensor:
    return t if _row_strides(t) is not None else \
        t.clone(memory_format=torch.contiguous_format)


def _launch(r, k, v, lw, u, h0, chunk: int, route: int):
    check_args(r, k, v, lw, u, h0, chunk)
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"rwkv6_wkv: {dev} is not a CUDA device")
    strides = [_row_strides(t) for t in (r, k, v, lw)]
    if any(s is None for s in strides) or not u.is_contiguous() or \
            not h0.is_contiguous() or h0.data_ptr() % 16:
        raise ValueError("rwkv6_wkv: an input the kernels cannot read in "
                         "place (last axis, row alignment, or u / h0 not "
                         "contiguous)")
    B, S, H, hs = r.shape
    o = torch.empty((B, S, H, hs), dtype=r.dtype, device=dev)
    h_last = torch.empty((B, H, hs, hs), dtype=torch.float32, device=dev)
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), h0.data_ptr(), o.data_ptr(), h_last.data_ptr(),
            B, S, H, hs, chunk, *strides[0], *strides[1], *strides[2],
            *strides[3], _DTYPES[r.dtype], int(u.dtype == torch.bfloat16),
            route)
    if dev.index == torch.cuda.current_device():
        rc = _lib().rwkv6_wkv_fwd(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = _lib().rwkv6_wkv_fwd(
                *args, torch.cuda.current_stream(dev).cuda_stream)
    if rc == BAD_ARGS:
        raise ValueError(f"rwkv6_wkv: the kernel refused hs {hs}, chunk "
                         f"{chunk}")
    _build.check(rc, "rwkv6_wkv")
    return o, h_last


def rwkv6_wkv_cuda(r, k, v, lw, u, h0, *, chunk: int = 32):
    """The path's kernel, model layout, read in place (see
    :func:`check_args`): one launch."""
    _build.refuse_autograd("rwkv6_wkv", r, k, v, lw, u, h0)
    out = _launch(r, k, v, lw, u, h0, chunk, 0)
    LAUNCHES["rwkv6_wkv"] += 1
    return out


def rwkv6_wkv_witness_cuda(r, k, v, lw, u, h0, *, chunk: int = 32):
    """The CUDA-core kernel on either dtype and any S, model layout: the
    witness the tensor-core kernel is held against on the card."""
    return _launch(r, k, v, lw, u, h0, chunk, 1)


def rwkv6_wkv_plain(r, k, v, lw, u, h0, *, chunk: int = 32):
    """The plain version, model layout, any shape (``chunk`` only sets
    the kernel's schedule): o in r's dtype, h_last fp32."""
    o, h = rwkv6_wkv_ref(r, k, v, lw, u, h0)
    return o.to(r.dtype), h


def rwkv6_wkv(r, k, v, lw, u, h0, *, chunk: int = 32):
    """Model layout. r,k,v,lw: (B,S,H,hs); u: (H,hs); h0: (B,H,hs,hs).
    Returns (o (B,S,H,hs) in r's dtype, h_last (B,H,hs,hs) fp32) on r's
    device: the kernel on CUDA (one launch; an input is copied only where
    the kernels cannot read it in place or its type is not theirs, or
    zero-padded where hs is not built), the plain version on the CPU.
    ``chunk`` is any positive chunk: the kernel runs it at
    :func:`kernel_chunk`'s built chunk."""
    chunk = kernel_chunk(chunk)
    if r.device.type == "cuda":
        r, k, v = (_in_place(t) for t in (r, k, v))
        lw = _in_place(lw.float())
        h0 = h0.float().contiguous()
        if u.dtype not in _DTYPES:
            u = u.float()
        return padded_call(rwkv6_wkv_cuda, r, k, v, lw, u.contiguous(), h0,
                           chunk=chunk)
    if r.device.type == "cpu":
        return rwkv6_wkv_plain(r, k, v, lw, u, h0, chunk=chunk)
    raise ValueError(f"rwkv6_wkv: no kernel for device {r.device}")


def _heads(t):
    """(BH, S, hs) as (1, S, BH, hs), a view: BH heads of one batch."""
    return t.transpose(0, 1)[None]


def rwkv6_wkv_bh_cuda(r, k, v, lw, u, h0, *, chunk: int = 32):
    """The kernel in the reference's layout: r,k,v,lw (BH,S,hs), u
    (BH,hs), h0 (BH,hs,hs) -> (o (BH,S,hs), h_last (BH,hs,hs)), as the BH
    heads of one batch of a model-layout call."""
    o, h = rwkv6_wkv_cuda(*map(_heads, (r, k, v, lw)), u, h0[None],
                          chunk=chunk)
    return o[0].transpose(0, 1), h[0]


def rwkv6_wkv_bh_plain(r, k, v, lw, u, h0, *, chunk: int = 32):
    """The plain version in the reference's layout."""
    o, h = rwkv6_wkv_plain(*map(_heads, (r, k, v, lw)), u, h0[None],
                           chunk=chunk)
    return o[0].transpose(0, 1), h[0]


def rwkv6_wkv_bh(r, k, v, lw, u, h0, *, chunk: int = 32):
    """WKV in the reference's (BH, S, hs) layout on r's device: kernel on
    CUDA (at :func:`kernel_chunk`'s built chunk, zero-padded where hs is
    not built), plain version on the CPU."""
    chunk = kernel_chunk(chunk)
    if r.device.type == "cuda":
        o, h = rwkv6_wkv(*map(_heads, (r, k, v, lw)), u, h0[None],
                         chunk=chunk)
        return o[0].transpose(0, 1), h[0]
    if r.device.type == "cpu":
        return rwkv6_wkv_bh_plain(r, k, v, lw, u, h0, chunk=chunk)
    raise ValueError(f"rwkv6_wkv: no kernel for device {r.device}")
