"""The stream job: ``Orchestrator.run`` of the port on the configuration's
``StreamJob``, fed from a ring of batches in host memory.

Set-up draws the ring (the traffic's generator, from the seed), builds
the job, and lets ``run`` take the first ``warmup_batches`` batches:
they build the kernels, take the plan and warm every shape. The batch
iterator handed to ``run`` is the window's clock: it stamps each
handover (the previous batch has ended: ``execute_batch`` reads the
drift flag on the host) and stops at the first handover past
``--seconds``. Around the batches that the check samples it copies the
job's state (on the card; the copies are the only work it adds).

The check (:func:`check`) runs the plain reference after the window: from
the initial state through the warm-up batches, and from the program's own
state before each sampled batch of the window through that batch. It
holds each layer's state after the batch, the uplink's residuals (the
decoded values are the input plus the old residual less the new), DDM's
state and drift flags, and the job's metrics.
"""

from __future__ import annotations

import contextlib
import random
import time

import torch

from portbench import bench, compare, trace

# each check's tensors, by the prefix of the reference's state names
GROUPS = {"normalize": ("norm",), "sketch": ("sketch",),
          "sample": ("sample",), "learner": ("learner",),
          "preq": ("preq",), "codec": ("ef",), "ddm": ("ddm",)}
# the window's sampled batches: one offset drawn from the seed in each
# range after the window's first batch (as many as the window reaches)
SAMPLE_RANGES = ((0, 4), (4, 16), (16, 64), (64, 256), (256, 1024),
                 (1024, 4096), (4096, 16384))


def program_state(orch) -> dict:
    """The job's state as the reference names it, copied (on the card)."""
    st = orch.states
    norm, sk, res = st["normalize"], st["sketch"], st["sample"]
    lr, preq = st["train"]
    dd = st["drift"]
    flat = {
        "norm.n": norm.n, "norm.mean": norm.mean, "norm.m2": norm.m2,
        "sketch.n": sk.n, "sketch.mean": sk.mean, "sketch.m2": sk.m2,
        "sketch.min": sk.min, "sketch.max": sk.max,
        "sample.buf": res.buf, "sample.labels": res.extra,
        "sample.seen": res.seen, "sample.seed": res.rng,
        "learner.w": lr.w, "learner.b": lr.b, "learner.g2": lr.g2,
        "learner.n": lr.n,
        "preq.n": preq.n, "preq.correct": preq.correct,
        "preq.loss_sum": preq.loss_sum, "preq.ewma": preq.ewma_acc,
        "ddm.n": dd.n, "ddm.p": dd.p, "ddm.s_min": dd.s_min,
        "ddm.p_min": dd.p_min, "ddm.level": dd.level}
    for (channel, _leaf), r in orch._uplink_residuals.items():
        flat[f"ef.{channel}"] = r
    return {k: v.detach().clone() for k, v in flat.items()}


def sampled_offsets(seed: int) -> list:
    rng = random.Random(seed)
    return [rng.randrange(a, b) for a, b in SAMPLE_RANGES]


class Program:
    """The stream job of ``run.cell``, set up and ready for its window."""

    def __init__(self, run: bench.Run):
        from repro_torch.core.orchestrator import Orchestrator, StreamJob
        from repro_torch.core.pipeline import standard_stream_pipeline
        from repro_torch.core.sla import SLA
        self.run = run
        cfg, mix = run.cell.config, run.cell.traffic
        self.cfg = cfg
        self.ring = run.cell.generator().ring(mix, cfg, run.seed, run.device)
        pc = cfg["pipeline"]
        self.orch = Orchestrator(StreamJob(
            cfg["name"], dim=cfg["num_features"],
            n_classes=cfg["num_classes"],
            sla=SLA(error_budget=cfg["sla"]["error_budget"],
                    max_latency_s=cfg["sla"]["max_latency_s"]),
            pipeline=standard_stream_pipeline(
                cfg["num_features"], sample_rate=pc["sample_rate"],
                drift_detector=pc["detector"],
                reservoir_k=pc["reservoir_k"], fuse=pc["fuse"]),
            uplink_codecs=[cfg["codec"]["name"]], device=run.device))
        self.warmup = int(cfg["warmup_batches"])
        self.checked = {self.warmup + o for o in sampled_offsets(run.seed)}
        self.snaps = {}          # batch -> (state before, state after)
        self.alarms = []         # the job's drift alarms after each batch
        self.metrics = None

    def batches(self, seconds: float, tracing: bool):
        """The batch iterator ``Orchestrator.run`` draws from: the warm-up
        batches, then the window's, stamped at each handover."""
        run, orch = self.run, self.orch
        stack = contextlib.ExitStack()
        self.prof = None
        k = 0
        try:
            while True:
                now = time.perf_counter()
                if k > 0:
                    self.alarms.append(orch.metrics.drift_alarms)
                if k - 1 in self.snaps:
                    self.snaps[k - 1] = (self.snaps[k - 1][0],
                                         program_state(orch))
                if k == self.warmup:
                    self.start = program_state(orch)
                    bench.sync(run.device)
                    self.prof = stack.enter_context(trace.traced(tracing))
                    now = time.perf_counter()
                    run.t_window, self.window_ns = now, [time.time_ns()]
                    host = bench.host_counters()
                if k >= self.warmup:
                    run.stamps.append(now)
                    if now - run.t_window >= seconds:
                        run.t_close = now
                        self.window_ns.append(time.time_ns())
                        run.notes["host"] = bench.counters_since(host)
                        return
                if k in self.checked:
                    self.snaps[k] = (program_state(orch), None)
                yield self.ring[k % len(self.ring)]
                k += 1
        finally:
            stack.close()

    def window(self, seconds: float, tracing: bool) -> None:
        self.metrics = self.orch.run(
            self.batches(seconds, tracing),
            rate_fn=lambda s: float(self.cfg["offered_rate"]),
            seed=self.run.seed)
        run = self.run
        n_win = len(run.stamps) - 1
        n_total = self.warmup + n_win
        ev = self.ring[0].n
        run.work.update(attempted=n_win, failed=0, batches=n_win,
                        events=n_win * ev, batch_events=ev,
                        total_batches=n_total,
                        codec_elements=n_win * ev * sum(
                            self.cfg["num_features"] if c == "x" else 1
                            for c in self.cfg["plan"]["crossing"]))
        run.notes["drift_alarms"] = self.metrics.drift_alarms
        gaps = sorted(b - a for a, b in zip(run.stamps, run.stamps[1:]))
        if gaps:
            run.notes["batch_ms_median"] = 1e3 * gaps[len(gaps) // 2]
        half = len(run.stamps) // 2
        if half >= 2:
            run.notes["half_rates"] = [
                ev * (b - a) / (run.stamps[b] - run.stamps[a])
                for a, b in ((0, half), (half, len(run.stamps) - 1))]
        if self.prof is not None:
            run.trace = trace.read(self.prof, self.window_ns)

    def close(self) -> dict:
        """What the check needs; the job itself is freed."""
        ev = {"start": self.start, "snaps": self.snaps,
              "alarms": self.alarms, "metrics": self.metrics,
              "ring": self.ring, "warmup": self.warmup}
        del self.orch
        return ev


def expected_job(cfg: dict, n_batches: int, events: int) -> dict:
    return {"events": n_batches * events, "cuts": [cfg["plan"]["cut"]]
            * n_batches, "codecs": [cfg["codec"]["name"]] * n_batches,
            "migrations": 0, "rescales": 0}


def job_mismatches(m, want: dict) -> int:
    got = {"events": m.events, "cuts": list(m.cuts), "codecs": list(m.codecs),
           "migrations": m.migrations, "rescales": m.rescales}
    return sum(1 for k in want if got[k] != want[k])


def follow(ref, cfg, state, ring, first, last, root, precision="fp32"):
    """The reference from ``state`` through batches ``first..last``:
    ``(state after, drift flag of each batch)``."""
    flags = []
    for k in range(first, last + 1):
        b = ring[k % len(ring)]
        dev = state["norm.mean"].device
        x = b.data["x"].to(dev)
        y = b.data["y"].to(dev)
        state, drifted = ref.batch_step(state, x, y, ref.step_seed(root, k),
                                        cfg, precision)
        flags.append(drifted)
    return state, flags


def readings(run: bench.Run, ev: dict, candidate: str = None) -> dict:
    """Every compared number of one run: the program (its states and
    flags as copied in the window) against the reference, both from the
    same starts. With ``candidate`` (a precision) the reference computed
    in it stands in the program's place: the control."""
    cfg = run.cell.config
    ref = run.cell.reference()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = run.device
    w = ev["warmup"]
    alarms = [0] + ev["alarms"]
    prog_flag = lambda k: alarms[k + 1] > alarms[k]  # noqa: E731
    pairs, flag_misses = [], 0
    # the start: from the initial state through the warm-up batches; each
    # sampled batch of the window from the program's state before it
    runs = [(ref.init_state(cfg, dev), 0, w - 1, ev["start"])]
    runs += [(before, k, k, after) for k, (before, after)
             in sorted(ev["snaps"].items()) if after is not None]
    for state, first, last, got in runs:
        want, flags = follow(ref, cfg, state, ev["ring"], first, last,
                             run.seed)
        if candidate is None:
            got_flags = [prog_flag(k) for k in range(first, last + 1)]
        else:
            got, got_flags = follow(ref, cfg, state, ev["ring"], first, last,
                                    run.seed, candidate)
        pairs.append((got, want))
        flag_misses += sum(a != b for a, b in zip(got_flags, flags))
    gaps = {name: 0.0 for name in GROUPS}
    for got, want in pairs:
        for name, g in compare.grouped_gaps(got, want, GROUPS).items():
            gaps[name] = max(gaps[name], g)
    run.notes["checked_batches"] = [k for _, k, _, _ in runs[1:]]
    gaps["alarms"] = float(flag_misses)
    gaps["job"] = float(job_mismatches(ev["metrics"], expected_job(
        cfg, run.work["total_batches"], run.work["batch_events"])))
    return gaps


def check(run: bench.Run, ev: dict) -> dict:
    return compare.held(readings(run, ev), run.cell.config["limits"])


# the control's precision: the step below the one the configuration states
CONTROL = {"float32": "tf32"}


def control(cell: bench.Cell, seed: int, seconds: float,
            device: str) -> dict:
    """The control's readings on ``seed``: a short run of the program for
    its states, then the reference one precision below the configuration's
    in the program's place."""
    run = bench.Run(cell, int(seed), device, time.perf_counter())
    program = Program(run)
    program.window(seconds, False)
    ev = program.close()
    return readings(run, ev, candidate=CONTROL[cell.config["precision"]])
