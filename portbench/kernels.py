"""The port's hand kernels by name, as the device trace shows them: which
operations of a trace belong to which layer."""

from __future__ import annotations

import re

# core/codecs.py -> kernels/ef_codec.py (csrc/ef_codec.cu): the int8
# round-trip's two kernels
CODEC = re.compile(r"(^|::)(amax_kernel|apply_kernel)\b")
# streams/drift.py -> kernels/detector_scan.py (csrc/detector_scan.cu)
DRIFT = re.compile(r"(^|::)(ddm_tiled_kernel|eddm_tiled_kernel|"
                   r"ph_tiled_kernel|adwin_scan_kernel)\b")


def is_codec(name: str, kind: str) -> bool:
    return kind == "kernel" and CODEC.search(name) is not None


def is_drift(name: str, kind: str) -> bool:
    return kind == "kernel" and DRIFT.search(name) is not None
