"""Where the time of the stream orchestrator's main path goes, on the card.

    python -m repro_torch.launch.profile_stream [--batches 6] \\
        [--events 65536] [--dim 256] [--codec int8_ef] [--trace PATH]

Runs the dense job of ``chip_smoke.py`` phase 3 (the standard pipeline
on a drifting ``HyperplaneStream``, one uplink codec pinned) on the
card: two warm-up batches, then ``--batches`` batches under
``torch.profiler`` with CPU and CUDA activities. It prints the wall time
per batch (host clock around work that ends in a synchronize), the
device time per batch of kernels and of copies (the profiler's CUDA
events, less its own buffer requests), the device's idle share with and
without the copies, and the kernels and copies by device time. Then it runs the same number of batches op by op, synchronizing
after each, for the host-clock time of the batch's copy to the card, of
each op and of the uplink codec. ``--trace`` writes the Chrome trace.
It needs a card and refuses to run without one.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core.orchestrator import Orchestrator, StreamJob
from repro_torch.core.pipeline import standard_stream_pipeline
from repro_torch.core.sla import SLA
from repro_torch.kernels import ops
from repro_torch.streams.generators import DriftSpec, HyperplaneStream

BUDGETS = {"int8_ef": 0.1, "topk_int8_ef": 11.0}


_PROFILER_OWN = ("Activity Buffer Request",)


def _device_events(prof):
    """``(ms, count, name)`` of every kernel and copy the profiler traced
    on the card. The host ops that launched them (``aten::*``) also carry
    device time and are left out, so nothing is counted twice."""
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or evt.key in _PROFILER_OWN:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            rows.append((float(us) / 1e3, evt.count, evt.key))
    return sorted(rows, reverse=True)


def op_breakdown(orch, batches, first_step: int) -> dict:
    """Host-clock ms per batch of the copy to the card, each op and the
    uplink round-trip, with a synchronize after each (so the times add
    up to the batch, but no two parts overlap)."""
    dev = orch.device
    pipe, cut, uplink = orch.pipeline, orch.cut, orch._uplink
    parts = {"copy_to_card": 0.0, "uplink": 0.0,
             **{op.name: 0.0 for op in pipe.ops}}

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        parts[key] += (time.perf_counter() - t0) * 1e3
        return out

    for step, b in enumerate(batches, start=first_step):
        env = timed("copy_to_card", lambda: {
            k: torch.as_tensor(v).to(dev) for k, v in b.data.items()})
        env["rng"] = torch.tensor(step, dtype=torch.int64)
        for i, op in enumerate(pipe.ops):
            if i == cut and uplink is not None:
                env = timed("uplink", lambda: uplink(env))
            st, env = timed(op.name, lambda: op.fn(orch.states[op.name], env))
            orch.states[op.name] = st
    return {k: v / len(batches) for k, v in parts.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--events", type=int, default=65536)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--codec", default="int8_ef", choices=sorted(BUDGETS))
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_stream: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False

    n_all = args.batches + 2
    gen = HyperplaneStream(dim=args.dim, seed=0,
                           drift=DriftSpec(kind="abrupt", at=0.5),
                           horizon=n_all * float(args.events))
    batches = [gen.batch(i, args.events) for i in range(n_all)]
    job = StreamJob(f"profile-{args.codec}", dim=args.dim,
                    sla=SLA(error_budget=BUDGETS[args.codec],
                            max_latency_s=1e3),
                    pipeline=standard_stream_pipeline(args.dim),
                    uplink_codecs=[args.codec])
    orch = Orchestrator(job)
    orch.begin(1e4)
    for step in range(2):                       # warm-up, not profiled
        orch.execute_batch(step, batches[step])
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for step in range(2, n_all):
            orch.execute_batch(step, batches[step])
            d = orch.controller.observe(step, 1e4, orch.sla)
            orch.apply_decision(step, d)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    nb = args.batches
    rows = _device_events(prof)
    copy_ms = sum(r[0] for r in rows if r[2].startswith(("Memcpy", "Memset")))
    kernel_ms = sum(r[0] for r in rows) - copy_ms
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"job: {nb} batches x {args.events} events, dim {args.dim}, "
          f"codec {args.codec}, cut {orch.cut}")
    print(f"wall_ms_per_batch={wall_ms / nb!r} "
          f"kernel_ms_per_batch={kernel_ms / nb!r} "
          f"copy_ms_per_batch={copy_ms / nb!r} "
          f"idle_share_of_kernels={1.0 - kernel_ms / wall_ms!r} "
          f"idle_share_with_copies={1.0 - (kernel_ms + copy_ms) / wall_ms!r} "
          f"events_per_s={nb * args.events / (wall_ms / 1e3)!r}")
    print("device time by kernel or copy (ms per batch, calls per batch):")
    for ms, count, key in rows[:15]:
        print(f"  {ms / nb:10.4f}  {count / nb:6.1f}  {key[:90]}")
    print(json.dumps({"launch_counts": ops.launch_counts()}))
    parts = op_breakdown(orch, batches[2:], n_all)
    print(f"host-clock ms per batch, synchronized after each part "
          f"(sum {sum(parts.values())!r}):")
    for key, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:10.4f}  {key}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
