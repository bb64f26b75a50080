"""drift_scan_ms.stream: device ms a batch of the drift detector's scan
kernel (DDM's tiled chain on this configuration)."""

from portbench import kernels


def read(run):
    t, n = run.trace, run.work.get("batches", 0)
    if t is None or not n:
        return None
    ms = t.seconds(kernels.is_drift) * 1e3
    return ms / n if ms > 0 else None
