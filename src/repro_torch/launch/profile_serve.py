"""Where the time of one served wave goes, on the card.

    python -m repro_torch.launch.profile_serve --arch rwkv6-1.6b

Serves one wave as ``chip_smoke.py`` phase 6 does (full width, random
weights from seed 0, 8 prompts of 512 tokens drawn with numpy, 32
greedy new tokens, ``max_len=1024``, ``impl="kernel"``) through the
engine's own prefill and decode steps,
after one unprofiled warm-up wave. The prefill and the decode loop are
each run under ``torch.profiler`` (CPU and CUDA activities). For each it
prints the wall ms (host clock around work that ends in a synchronize),
the device ms of kernels and copies, the device's idle share, the
kernels by device time and the port's kernel launches. It needs a card
and refuses to run without one.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.profile_stream import _device_events
from repro_torch.models import model_zoo as zoo
from repro_torch.serve.engine import (Request, ServeEngine, sample_with_seed,
                                      split_seed, wave_inputs)

BATCH = 8              # chip_smoke.py's traffic: SERVE_BATCH, PROMPT,
PROMPT = 512           # NEW_TOKENS and MAX_LEN
NEW_TOKENS = 32
MAX_LEN = 1024


def _profiled(fn):
    """``(result, wall ms, device rows, launch counts)`` of ``fn()``."""
    ops.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return out, wall_ms, _device_events(prof), ops.launch_counts()


def _report(phase: str, wall_ms: float, rows, launches, per: int):
    """Print one phase; ``per`` divides every number (decode steps)."""
    unit = "step" if per > 1 else "wave"
    copies = [r for r in rows if r[2].startswith(("Memcpy", "Memset"))]
    kernels = [r for r in rows if r not in copies]
    copy_ms = sum(r[0] for r in copies)
    kernel_ms = sum(r[0] for r in kernels)
    print(f"{phase}, per {unit}: wall_ms={wall_ms / per!r} "
          f"kernel_ms={kernel_ms / per!r} copy_ms={copy_ms / per!r} "
          f"idle_share={1.0 - (kernel_ms + copy_ms) / wall_ms!r} "
          f"kernel_calls={sum(r[1] for r in kernels) / per!r}")
    print(f"  device time by kernel (ms and calls per {unit}):")
    for ms, count, key in rows[:12]:
        print(f"  {ms / per:10.4f}  {count / per:7.1f}  {key[:90]}")
    print(json.dumps({"phase": phase, "launch_counts": {
        k: v for k, v in launches.items() if v}}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6-1.6b")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = get_config(args.arch)
    params = zoo.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=PROMPT
                            ).astype(np.int32) for _ in range(BATCH)]
    eng = ServeEngine(cfg, params, batch_size=BATCH, max_len=MAX_LEN,
                      impl="kernel", seed=0)
    eng.run([Request(i, p, max_new_tokens=2)
             for i, p in enumerate(prompts)])            # warm-up wave
    torch.cuda.synchronize()

    batch = wave_inputs(cfg, prompts, eng.device)

    def prefill():
        logits, caches = eng._prefill(params, batch)
        _, sub = split_seed(eng.rng)
        tok = sample_with_seed(logits[:, 0, :cfg.vocab_size], sub,
                               eng.sampling)
        return tok, caches

    (tok, caches), wall, rows, launches = _profiled(prefill)
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"model: {args.arch} ({cfg.param_dtype}), batch {BATCH}, "
          f"prompt {PROMPT}, impl kernel")
    _report("prefill", wall, rows, launches, 1)
    steps = NEW_TOKENS - 1

    def decode():
        nonlocal tok, caches
        r = eng.rng
        for _ in range(steps):
            tok, caches, r = eng._decode(params, caches, tok[:, None], r)
            tok.tolist()                  # the engine reads every step
        return None

    _, wall, rows, launches = _profiled(decode)
    _report("decode", wall, rows, launches, steps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
