"""batch_ms_p95.stream: the 95th percentile of the host-clock time between
successive batch handovers of the window (``Orchestrator.run`` asks for a
batch when ``execute_batch`` and the control step of the one before are
done), over all of the window's batches, in ms."""

import statistics


def read(run):
    s = run.stamps
    if len(s) < 21:
        return None
    gaps = [(b - a) * 1e3 for a, b in zip(s, s[1:])]
    return statistics.quantiles(gaps, n=20, method="inclusive")[18]
