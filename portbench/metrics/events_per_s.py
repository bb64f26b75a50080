"""events_per_s: all events of the batches completed in the window over
the window (host clock)."""


def read(run):
    if "events" not in run.work:
        return None
    return run.work["events"] / run.window_s
