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

from repro_torch.kernels import _build
from repro_torch.kernels import detector_scan as _ds
from repro_torch.kernels import ef_codec as _ef
from repro_torch.kernels import preprocess as _pp

fused_normalize = _pp.fused_normalize
hash_features = _pp.fused_hash_features
ef_int8_roundtrip = _ef.ef_int8_roundtrip
ef_topk_int8_roundtrip = _ef.ef_topk_int8_roundtrip
detector_scan = _ds.detector_scan

_COUNTERS = (_pp.LAUNCHES, _ef.LAUNCHES, _ds.LAUNCHES)


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
