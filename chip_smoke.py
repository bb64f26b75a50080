#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds every kernel against its plain PyTorch version on the card at the
shapes the main path gives it, drives the stream orchestrator's main
path on the card, and checks what comes out. Phases:

1. device (``nvidia-smi`` name and power limit) and the kernel build;
2. each kernel vs its plain version: max error against the stated
   tolerance, the kernel's median time, the plain version's time, and
   the least time the card could take (``bound_ms``);
3. the orchestrator on a dense 256-wide drifting stream, 12 batches of
   65,536 events, once with the ``int8_ef`` uplink codec and once with
   ``topk_int8_ef``, plus a small run compared with the same job on the
   CPU (the kernels' plain versions);
4. the orchestrator on a hashed sparse stream (hash -> pca -> sketch);
5. edge preprocessing (``preprocess_batch``) over the dense batches with
   NaNs injected.

The launch counts are set to 0 just before phase 3 and read after phase
5; every kernel must have launched there. A line ``{"kernels": [...]}``
reports each kernel, the line before the last gives the card's name and
power limit, and the last line is ``{"ok": true, "device": {...}}``. Any
failure raises and the script exits non-zero without that line. It also
exits non-zero, printing no result, where CUDA is unavailable or the
port's sources are not beside it.
"""

from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# HBM bytes/s and fp32 (non-tensor) flop/s by H100/H200 variant, from
# NVIDIA's data sheets; matched on the name nvidia-smi reports.
CARD_PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H200", 4.8e12, 67e12),
    ("H100", 3.35e12, 67e12),          # SXM, "H100 80GB HBM3"
)

N_EVENTS = 65_536      # events per batch on the main path
DIM = 256              # dense stream width
HASH_F = 32            # sparse features per event
HASH_DIM = 1024        # hashed width
N_BATCHES = 12


def log(*a):
    print(*a, flush=True)


def card_peaks(name: str):
    for key, bw, flops in CARD_PEAKS:
        if key in name:
            return bw, flops
    raise RuntimeError(f"no memory/flop peaks known for card {name!r}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version on the card
# ---------------------------------------------------------------------------

def kernel_checks(dev, bw: float, flops: float) -> dict:
    import torch
    from repro_torch.kernels import (detector_scan as ds, ef_codec,
                                     preprocess, ref)
    from repro_torch.streams import drift

    g = torch.Generator(device=dev).manual_seed(1234)
    n_el = N_EVENTS * DIM
    rows = {}

    def bound(nbytes, nops):
        t_b, t_o = nbytes / bw * 1e3, nops / flops * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    def record(name, source, replaces, err, tol, ms, plain_ms, nbytes, nops):
        b_ms, b_by = bound(nbytes, nops)
        log(f"  {name}: max_abs_err={err!r} tol={tol!r} kernel_ms={ms!r} "
            f"plain_ms={plain_ms!r} bound_ms={b_ms!r} ({b_by})")
        if not err <= tol:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version: {err!r} > {tol!r}")
        rows[name] = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": None}

    # -- EF codecs: (65536 x 256) f32 with a non-zero residual, k = 10% ----
    x = torch.randn((N_EVENTS, DIM), generator=g, device=dev)
    r = torch.randn((N_EVENTS, DIM), generator=g, device=dev) * 0.01
    dec, rout = ef_codec.ef_int8_roundtrip_cuda(r, x)
    pdec, prout = ref.ef_int8_roundtrip_ref(r, x)
    torch.cuda.synchronize()
    ident = float(((dec + rout) - (x + r)).abs().max())
    if ident != 0.0:
        raise AssertionError(f"int8 EF identity broken by {ident!r}")
    err = max(float((dec - pdec).abs().max()), float((rout - prout).abs().max()))
    # one ulp of the largest decoded value; a flipped quantum is a scale
    tol = float(torch.finfo(torch.float32).eps) * float(pdec.abs().max())
    record("ef_int8_roundtrip", "src/repro_torch/kernels/csrc/ef_codec.cu",
           "src/repro/kernels/ef_codec.py:81", err, tol,
           median_ms(lambda: ef_codec.ef_int8_roundtrip_cuda(r, x), 20),
           median_ms(lambda: ref.ef_int8_roundtrip_ref(r, x), 5),
           16 * n_el, 8 * n_el)

    k = int(round(0.1 * n_el))
    dec, rout = ef_codec.ef_topk_int8_roundtrip_cuda(r, x, k)
    pdec, prout = ref.ef_topk_int8_roundtrip_ref(r, x, k)
    torch.cuda.synchronize()
    ident = float(((dec + rout) - (x + r)).abs().max())
    if ident != 0.0:
        raise AssertionError(f"top-k EF identity broken by {ident!r}")
    kept = int((dec != 0).sum())
    if kept < k:      # ties at the threshold are all kept
        raise AssertionError(f"top-k kept {kept} coordinates, fewer than {k}")
    err = max(float((dec - pdec).abs().max()), float((rout - prout).abs().max()))
    tol = float(torch.finfo(torch.float32).eps) * float(pdec.abs().max())
    record("ef_topk_int8_roundtrip", "src/repro_torch/kernels/csrc/ef_codec.cu",
           "src/repro/kernels/ef_codec.py:145", err, tol,
           median_ms(lambda: ef_codec.ef_topk_int8_roundtrip_cuda(r, x, k), 20),
           median_ms(lambda: ref.ef_topk_int8_roundtrip_ref(r, x, k), 5),
           16 * n_el + 4, 10 * n_el)
    thr_ms = median_ms(lambda: ref.topk_threshold(
        torch.abs(x.reshape(-1) + r.reshape(-1)), k), 10)
    log(f"  (of which the wrapper's torch.topk threshold: {thr_ms!r} ms)")
    del x, r, dec, rout, pdec, prout

    # -- hashing: ids over the full int32 range, negatives included --------
    ids = torch.randint(-2 ** 31, 2 ** 31 - 1, (N_EVENTS, HASH_F),
                        generator=g, device=dev, dtype=torch.int64
                        ).to(torch.int32)
    vals = torch.randn((N_EVENTS, HASH_F), generator=g, device=dev)
    if int((ids < 0).sum()) == 0:
        raise AssertionError("hash check drew no negative ids")
    out = preprocess.fused_hash_features_cuda(ids, vals, HASH_DIM)
    pout = ref.hash_features_ref(ids, vals, HASH_DIM)
    torch.cuda.synchronize()
    if not torch.equal(out, pout):
        raise AssertionError("hash kernel is not bitwise equal to plain")
    record("fused_hash_features", "src/repro_torch/kernels/csrc/preprocess.cu",
           "src/repro/kernels/preprocess.py:159",
           float((out - pout).abs().max()), 0.0,
           median_ms(lambda: preprocess.fused_hash_features_cuda(
               ids, vals, HASH_DIM), 20),
           median_ms(lambda: ref.hash_features_ref(ids, vals, HASH_DIM), 5),
           N_EVENTS * HASH_F * 8 + N_EVENTS * HASH_DIM * 4,
           N_EVENTS * HASH_F * 8)
    del ids, vals, out, pout

    # -- fused normalize: (65536 x 256) with 15% NaN -----------------------
    x = torch.randn((N_EVENTS, DIM), generator=g, device=dev) * 2.0 + 0.5
    x[torch.rand((N_EVENTS, DIM), generator=g, device=dev) < 0.15] = math.nan
    n0 = 1000.0
    mean0 = torch.randn((DIM,), generator=g, device=dev)
    m20 = (torch.rand((DIM,), generator=g, device=dev) + 0.1) * n0
    got = preprocess.fused_normalize_cuda(x, n0, mean0, m20)
    want = ref.fused_normalize_ref(x, n0, mean0, m20)
    torch.cuda.synchronize()
    # raw moments (kernel) vs centred moments (plain): rtol 1e-4, atol 1e-4
    worst = 0.0
    for a, b in zip(got, want):
        excess = float(((a - b).abs() - (1e-4 + 1e-4 * b.abs())).max())
        worst = max(worst, excess)
        if not torch.isfinite(a).all():
            raise AssertionError("fused_normalize returned a non-finite value")
    if worst > 0.0:
        raise AssertionError(f"fused_normalize outside rtol/atol 1e-4 by {worst!r}")
    yerr = float((got[0] - want[0]).abs().max())
    ytol = 1e-4 + 1e-4 * float(want[0].abs().max())
    record("fused_normalize", "src/repro_torch/kernels/csrc/preprocess.cu",
           "src/repro/kernels/preprocess.py:92", yerr, ytol,
           median_ms(lambda: preprocess.fused_normalize_cuda(
               x, n0, mean0, m20), 20),
           median_ms(lambda: ref.fused_normalize_ref(x, n0, mean0, m20), 5),
           2 * n_el * 4 + 3 * DIM * 4 * 2, 8 * n_el)
    del x, got, want

    # -- detector scan: a 0/1 error stream with a planted drift ------------
    p = torch.where(torch.arange(N_EVENTS, device=dev) < N_EVENTS // 2,
                    0.1, 0.5)
    err = (torch.rand((N_EVENTS,), generator=g, device=dev) < p).float()
    init = drift.ddm_init(dev)
    st, flag = ds.detector_scan_cuda("ddm", init, err)
    t0 = time.perf_counter()
    pst, pflag = ds.detector_scan_plain("ddm", init, err)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    diffs = [abs(float(a) - float(b)) for a, b in zip(st, pst)]
    diffs.append(float(bool(flag) != bool(pflag)))
    if not bool(flag):
        raise AssertionError("detector scan missed the planted drift")
    record("detector_scan", "src/repro_torch/kernels/csrc/detector_scan.cu",
           "src/repro/core/pipeline.py:687", max(diffs), 0.0,
           median_ms(lambda: ds.detector_scan_cuda("ddm", init, err), 20),
           plain_ms, N_EVENTS * 4 + 48, N_EVENTS * 20)
    return rows


# ---------------------------------------------------------------------------
# phases 3-5: the main path
# ---------------------------------------------------------------------------

def dense_batches(n_batches: int, n: int, dim: int):
    from repro_torch.streams.generators import DriftSpec, HyperplaneStream
    gen = HyperplaneStream(dim=dim, seed=0,
                           drift=DriftSpec(kind="abrupt", at=0.5,
                                           magnitude=2.0),
                           horizon=n_batches * float(n))
    return [gen.batch(i, n) for i in range(n_batches)]


def run_dense(batches, codec: str, budget: float, device: str,
              sample_rate: float = 0.5):
    from repro_torch.core.orchestrator import Orchestrator, StreamJob
    from repro_torch.core.pipeline import standard_stream_pipeline
    from repro_torch.core.sla import SLA
    import torch
    dim = batches[0].data["x"].shape[1]
    job = StreamJob(f"smoke-{codec}", dim=dim,
                    sla=SLA(error_budget=budget, max_latency_s=1e3),
                    pipeline=standard_stream_pipeline(
                        dim, sample_rate=sample_rate, drift_detector="ddm"),
                    uplink_codecs=[codec], device=device)
    orch = Orchestrator(job)
    t0 = time.perf_counter()
    m = orch.run(batches, rate_fn=lambda s: 1e4)
    if device == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return orch, m, secs


def check_no_nan(states, what: str):
    import torch
    from repro_torch._tree import tree_leaves
    for leaf in tree_leaves(states):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            if torch.isnan(leaf).any():
                raise AssertionError(f"{what}: a NaN in the op states")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core.orchestrator import Orchestrator, StreamJob
    from repro_torch.core.pipeline import Pipeline, hash_op, pca_op, sketch_op
    from repro_torch.core.sla import SLA
    from repro_torch.kernels import ops
    from repro_torch.streams import preprocess as prep
    from repro_torch.streams.events import StreamBatch

    t_all = time.perf_counter()
    # -- phase 1 ------------------------------------------------------------
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    bw, flops = card_peaks(name)
    log(f"phase 1: card {name!r}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    ops.build_all()
    log(f"  kernels built in {time.perf_counter() - t0:.2f} s")
    dev = torch.device("cuda")

    # -- phase 2 ------------------------------------------------------------
    log("phase 2: kernels vs plain versions at the main path's shapes")
    rows = kernel_checks(dev, bw, flops)

    # -- phases 3-5 drive the main path with the counts from 0 ----------------
    batches = dense_batches(N_BATCHES, N_EVENTS, DIM)
    # one short run first, so phase 3's rates do not carry the first
    # use of the card's libraries and allocator
    run_dense(batches[:2], "int8_ef", 0.1, "cuda")
    ops.reset_launch_counts()
    phase_counts = {}

    log("phase 3: orchestrator, dense job "
        f"({N_BATCHES} x {N_EVENTS} events, dim {DIM})")
    for codec, budget in (("int8_ef", 0.1), ("topk_int8_ef", 11.0)):
        before = ops.launch_counts()
        orch, m, secs = run_dense(batches, codec, budget, "cuda")
        delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
        phase_counts[f"dense/{codec}"] = delta
        log(f"  {codec}: events={m.events} events_per_s={m.events / secs!r} "
            f"drift_alarms={m.drift_alarms} cuts={sorted(set(m.cuts))} "
            f"codecs={sorted(set(m.codecs))} preq={m.preq} launches={delta}")
        if m.events != N_BATCHES * N_EVENTS or set(m.codecs) != {codec}:
            raise AssertionError(f"{codec}: wrong events or codec trajectory")
        if m.drift_alarms < 1:
            raise AssertionError(f"{codec}: the planted drift raised no alarm")
        if not (0.6 < m.preq["ewma_accuracy"] <= 1.0):
            raise AssertionError(f"{codec}: the learner did not recover: "
                                 f"{m.preq}")
        check_no_nan(orch.states, codec)

    log("phase 4: orchestrator, hashed job (hash -> pca -> sketch)")
    before = ops.launch_counts()
    rng = torch.Generator().manual_seed(7)
    sparse = [StreamBatch(data={
        "ids": torch.randint(-2 ** 31, 2 ** 31 - 1, (N_EVENTS, HASH_F),
                             generator=rng, dtype=torch.int64
                             ).to(torch.int32),
        "vals": torch.randn((N_EVENTS, HASH_F), generator=rng)})
        for _ in range(8)]
    hp = Pipeline([hash_op(HASH_DIM), pca_op(HASH_DIM, 16), sketch_op(16)])
    orch = Orchestrator(StreamJob(
        "smoke-hash", dim=HASH_DIM, pipeline=hp,
        sla=SLA(error_budget=0.1, max_latency_s=1e3),
        uplink_codecs=["int8_ef"]))
    t0 = time.perf_counter()
    m = orch.run(sparse, rate_fn=lambda s: 1e4)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
    phase_counts["hashed"] = delta
    sk = orch.states["sketch"]
    log(f"  events={m.events} events_per_s={m.events / secs!r} "
        f"cuts={sorted(set(m.cuts))} codecs={sorted(set(m.codecs))} "
        f"sketch_n={int(sk.n)} launches={delta}")
    if int(sk.n) != 8 * N_EVENTS or not torch.isfinite(sk.mean).all():
        raise AssertionError("hashed job: wrong or non-finite sketch state")

    log("phase 5: edge preprocessing (preprocess_batch) with NaNs")
    before = ops.launch_counts()
    state = prep.norm_init(DIM, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    t0 = time.perf_counter()
    for b in batches:
        x = torch.as_tensor(b.data["x"]).to(dev)
        x[torch.rand(x.shape, generator=g, device=dev) < 0.15] = math.nan
        state, out = prep.preprocess_batch(state, b.with_data(x=x))
        y = out.data["x"]
        if y.shape != x.shape or not torch.isfinite(y).all():
            raise AssertionError("preprocess_batch: non-finite or misshapen")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
    phase_counts["preprocess"] = delta
    log(f"  batches={len(batches)} events_per_s="
        f"{len(batches) * N_EVENTS / secs!r} n={float(state.n)!r} "
        f"launches={delta}")
    if float(state.n) != len(batches) * N_EVENTS:
        raise AssertionError("preprocess_batch: wrong running count")

    counts = ops.launch_counts()
    missing = sorted(k for k, v in counts.items() if v <= 0)
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # -- small input: the card's path against the CPU's plain path -----------
    # sample_rate=1.0 keeps every event, so the two generators' draws
    # (which differ between devices) do not enter the comparison
    log("check: small dense job on the card vs the same job on the CPU")
    small = dense_batches(10, 512, 16)
    for codec, budget in (("int8_ef", 0.1), ("topk_int8_ef", 11.0)):
        _, mg, _ = run_dense(small, codec, budget, "cuda", sample_rate=1.0)
        _, mc, _ = run_dense(small, codec, budget, "cpu", sample_rate=1.0)
        same = (mg.events == mc.events and mg.cuts == mc.cuts
                and mg.codecs == mc.codecs
                and mg.drift_alarms == mc.drift_alarms)
        gap = max(abs(mg.preq[k] - mc.preq[k]) for k in
                  ("accuracy", "logloss", "ewma_accuracy"))
        log(f"  {codec}: events/cuts/codecs/drift_alarms equal={same} "
            f"max preq gap={gap!r} (tol 1e-3)")
        if not same or gap > 1e-3:
            raise AssertionError(f"{codec}: card and CPU runs disagree")

    kernels = []
    for k, row in rows.items():
        kernels.append({"name": row["name"], "route": row["route"],
                        "source": row["source"], "replaces": row["replaces"],
                        "launches": counts[k],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    log(f"launches by phase: {json.dumps(phase_counts, sort_keys=True)}")
    log(f"total seconds: {time.perf_counter() - t_all:.1f}")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
