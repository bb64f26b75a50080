"""h2d_copy_ms.stream: device ms a batch of the host-to-card copies in the
trace (the ``.to(device)`` of ``execute_batch``)."""


def read(run):
    t, n = run.trace, run.work.get("batches", 0)
    if t is None or not n:
        return None
    ms = t.seconds(lambda name, kind: kind == "memcpy"
                   and "HtoD" in name) * 1e3
    return ms / n if ms > 0 else None
