"""Public entry points of the port's kernels, and their launch counts.

Every wrapper launches its CUDA kernel for a CUDA tensor, runs its plain
version for a CPU tensor, and raises for any other device: there is no
fallback from a kernel to its plain version. Each wrapper counts its
kernel launches (and nothing else) in a plain integer;
:func:`launch_counts` reads them and :func:`reset_launch_counts` sets
them to 0, so a run can show that its path went through the kernels.
While a ``launch/op_count.py`` count is active, each dispatcher here
adds its kernel's work to it (:func:`_counted`).
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import countmin as _cms
from repro_torch.kernels import detector_scan as _ds
from repro_torch.kernels import ef_codec as _ef
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import mg_scan as _mg
from repro_torch.kernels import preprocess as _pp
from repro_torch.kernels import rwkv6_wkv as _wkv
from repro_torch.launch import op_count


def _counted(fn, work):
    """``fn`` that, while a ``launch/op_count.py`` count is active, adds
    its kernel's work (``work(*args) -> (operations, bytes)``) to the
    count and runs with counting suspended: the kernel is a ``ctypes``
    launch no dispatch mode sees, and on the CPU its plain version must
    count as the kernel does."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        if op_count.active() is None:
            return fn(*args, **kwargs)
        with op_count.kernel(*work(*args, **kwargs)):
            return fn(*args, **kwargs)
    return call


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# Each kernel's (operations, bytes): the formulas of chip_smoke.py's
# bound column (each input read once, each output written once).

def _normalize_work(x, n0, mean0, m20, *, impute=True):
    return 8 * x.numel(), 8 * x.numel() + 24 * x.shape[-1]


def _hash_work(ids, vals, dim, *, seed=17):
    n, f = ids.shape
    return 8 * n * f, 8 * n * f + 4 * n * dim


def _int8_work(residual, x):
    return 8 * x.numel(), 16 * x.numel()


def _topk_work(residual, x, k):
    return 10 * x.numel(), 16 * x.numel() + 4


# ADWIN's step over its 60-bucket state: some 25 operations a cut point
# (the prefix's adds, both means, the harmonic size, the bound, the
# test) and 15 for the insert and the bound's logarithms; the state's
# 120 floats and 13 ints read and written once
ADWIN_OPS_PER_EVENT = 25 * 60 + 15
ADWIN_STATE_BYTES = 4 * (120 + 13)


def _adwin_work(err):
    return (ADWIN_OPS_PER_EVENT * err.numel(),
            4 * err.numel() + 2 * ADWIN_STATE_BYTES)


def _scan_work(detector, state, err):
    if detector == "adwin":
        return _adwin_work(err)
    return 20 * err.numel(), 4 * err.numel() + 48


def _flash_work(q, k, v, *, causal=True):
    B, S, H, D = q.shape
    T = k.shape[1]
    pairs = (sum(min(s + 1, T) for s in range(S)) if causal else S * T)
    return (B * H * pairs * (4 * D + 5),
            2 * _nbytes(q) + _nbytes(k, v))


def _wkv_work(r, k, v, lw, u, h0, *, chunk=32):
    # operations: the recurrence's 6 hs^2 a step and head (the decode
    # formula; the chunked design's own count is chip_smoke.wkv_work's)
    B, S, H, hs = r.shape
    return (6 * B * S * H * hs * hs,
            _nbytes(r, k, v, lw, u) + _nbytes(r) + 2 * B * H * hs * hs * 4)


def _cms_update_work(ids, depth, width, seeds):
    return 5 * ids.numel() * depth, 4 * ids.numel() + 4 * depth * width


def _cms_add_work(ids, table, seeds):
    n, d = ids.numel(), table.shape[0]
    return 5 * n * d, 4 * n + 8 * table.numel()


def _cms_query_work(ids, table, seeds):
    n, d = ids.numel(), table.shape[0]
    return 10 * n * d, 8 * n + 8 * table.numel()


def _mg_work(keys, counts, ids):
    return ids.numel() * keys.numel(), 4 * ids.numel() + 16 * keys.numel()


def _mamba_work(dt, x, Bm, Cm, A, h0, *, chunk=128, bd=256):
    B, S, dI = dt.shape
    return (B * S * dI * (7 * A.shape[-1] + 1),
            _nbytes(dt, x, Bm, Cm, A, h0) + _nbytes(x) + _nbytes(h0))


fused_normalize = _counted(_pp.fused_normalize, _normalize_work)
hash_features = _counted(_pp.fused_hash_features, _hash_work)
ef_int8_roundtrip = _counted(_ef.ef_int8_roundtrip, _int8_work)
ef_topk_int8_roundtrip = _counted(_ef.ef_topk_int8_roundtrip, _topk_work)
detector_scan = _counted(_ds.detector_scan, _scan_work)
flash_attention = _counted(_fa.flash_attention, _flash_work)
rwkv6_wkv = _counted(_wkv.rwkv6_wkv, _wkv_work)
countmin_update = _counted(_cms.countmin_update, _cms_update_work)
countmin_add = _counted(_cms.countmin_add, _cms_add_work)
countmin_update_query = _counted(_cms.countmin_update_query,
                                 _cms_query_work)
mg_scan = _counted(_mg.mg_scan, _mg_work)
mamba_scan = _counted(_ms.mamba_scan, _mamba_work)

_COUNTERS = (_pp.LAUNCHES, _ef.LAUNCHES, _ds.LAUNCHES, _fa.LAUNCHES,
             _wkv.LAUNCHES, _cms.LAUNCHES, _mg.LAUNCHES, _ms.LAUNCHES)


def flash_supported(q, k, v, causal, q_offset, kv_len) -> bool:
    """When ``attention(impl="kernel")`` takes the flash kernel: plain
    causal or full attention with no query offset and no KV length, and
    one head dim for q, k and v. A tensor offset, even a zero one,
    refuses it: ``self_attention`` always passes one, so only
    cross-attention reaches the kernel. The JAX package's rule
    (``kernels/ops.py::flash_supported``) compares q's dim with k's only
    and then crashes on MLA's uncached forward (keys nope + rope wide,
    values ``v_head_dim``) inside its kernel; here v's dim is checked
    too, so MLA takes the chunked path, the function the reference
    means. The reference's other condition, that Pallas is available,
    is the caller's choice of ``impl="kernel"`` here."""
    if kv_len is not None:
        return False
    if isinstance(q_offset, torch.Tensor) or q_offset:
        return False
    return q.shape[-1] == k.shape[-1] == v.shape[-1]


def launch_counts() -> Dict[str, int]:
    """``{kernel name: launches}`` since the last reset."""
    out: Dict[str, int] = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0


def restore_launch_counts(counts: Dict[str, int]) -> None:
    """Set the counts to ``counts`` (from :func:`launch_counts`): after a
    CUDA-graph capture, whose wrapper calls launch nothing."""
    for c in _COUNTERS:
        for k in c:
            c[k] = counts[k]


def build_all() -> None:
    """Compile every kernel source now (one ``nvcc`` per source, in
    parallel) instead of at each kernel's first launch."""
    _build.build()
