"""Serving launcher: batched prefill+decode over any assigned architecture.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --smoke --requests 4 --new-tokens 16 [--device cpu]

The JAX package's ``launch/serve.py`` on the port: weights drawn from
seed 0 on ``--device`` (the card by default), the port's
:class:`~repro_torch.serve.engine.ServeEngine` (its ``impl="kernel"``:
the hand kernels where the model reaches them), the same
``default_rng(0)`` prompts and the same lines printed. :func:`run` takes
the parameters, so a caller may serve converted ones.
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--greedy", action="store_true", default=True)
    ap.add_argument("--device", default="cuda",
                    help="where the weights live and the model runs")
    return ap.parse_args(argv)


def run(cfg, params, args):
    """Serve ``args.requests`` prompts of ``args.prompt_len`` tokens drawn
    by ``default_rng(0)`` with ``params``; prints the reference's lines.
    Returns ``(finished requests, engine)``."""
    import numpy as np

    from repro_torch.models import model_zoo as zoo
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.sampling import SamplingParams

    print(f"arch={cfg.name} params={zoo.param_count(cfg)/1e6:.1f}M")
    eng = ServeEngine(cfg, params, batch_size=args.batch_size,
                      max_len=args.max_len,
                      sampling=SamplingParams(greedy=args.greedy))
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, args.prompt_len)
                    .astype(np.int32), max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = eng.run(reqs)
    dt = time.perf_counter() - t0
    for r in done[:3]:
        print(f"req {r.rid}: out={r.out_tokens[:8]}...")
    print(f"throughput: {eng.throughput()} wall={dt:.1f}s")
    return done, eng


def main(argv=None):
    args = parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as zoo

    cfg = get_config(args.arch, smoke=args.smoke)
    params = zoo.init_params(cfg, 0, args.device)
    return run(cfg, params, args)


if __name__ == "__main__":
    main()
