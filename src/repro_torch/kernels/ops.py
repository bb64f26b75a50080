"""Public entry points of the port's kernels, and their launch counts.

Every wrapper launches its CUDA kernel for a CUDA tensor, runs its plain
version for a CPU tensor, and raises for any other device: there is no
fallback from a kernel to its plain version. Each wrapper counts its
kernel launches (and nothing else) in a plain integer;
:func:`launch_counts` reads them and :func:`reset_launch_counts` sets
them to 0, so a run can show that its path went through the kernels.
"""

from __future__ import annotations

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

fused_normalize = _pp.fused_normalize
hash_features = _pp.fused_hash_features
ef_int8_roundtrip = _ef.ef_int8_roundtrip
ef_topk_int8_roundtrip = _ef.ef_topk_int8_roundtrip
detector_scan = _ds.detector_scan
flash_attention = _fa.flash_attention
rwkv6_wkv = _wkv.rwkv6_wkv
countmin_update = _cms.countmin_update
countmin_add = _cms.countmin_add
countmin_update_query = _cms.countmin_update_query
mg_scan = _mg.mg_scan
mamba_scan = _ms.mamba_scan

_COUNTERS = (_pp.LAUNCHES, _ef.LAUNCHES, _ds.LAUNCHES, _fa.LAUNCHES,
             _wkv.LAUNCHES, _cms.LAUNCHES, _mg.LAUNCHES, _ms.LAUNCHES)


def flash_supported(q, k, v, causal, q_offset, kv_len) -> bool:
    """The JAX package's rule (``kernels/ops.py::flash_supported``) for
    when ``attention(impl=...)`` takes the flash kernel: plain causal or
    full attention with no query offset and no KV length. A tensor
    offset, even a zero one, refuses it: ``self_attention`` always passes
    one, so only cross-attention reaches the kernel. The reference's
    other condition, that Pallas is available, is the caller's choice of
    ``impl="kernel"`` here."""
    if kv_len is not None:
        return False
    if isinstance(q_offset, torch.Tensor) or q_offset:
        return False
    return q.shape[-1] == k.shape[-1]


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


def build_all() -> None:
    """Compile every kernel source now (one ``nvcc`` per source, in
    parallel) instead of at each kernel's first launch."""
    _build.build()
