"""pipeline_ops_ms.stream: device ms a batch of every kernel other than
the uplink codec's and the drift scan's: the pipeline ops (normalize,
sketch, sample, the learner) and their glue."""

from portbench import kernels


def read(run):
    t, n = run.trace, run.work.get("batches", 0)
    if t is None or not n:
        return None
    ms = t.seconds(lambda name, kind: kind == "kernel"
                   and not kernels.is_codec(name, kind)
                   and not kernels.is_drift(name, kind)) * 1e3
    return ms / n if ms > 0 else None
