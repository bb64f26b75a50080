"""The readings that a cell's limits are set from, on the card: the
program's compared numbers on many seeds (each a whole run of the cell
with a short window, at the cell's own sizes and load), then the
control's on a few more (the reference one precision below the
configuration's in the program's place), each held to the cell's limits
as a run holds them (``correct``: the control's has to be false). One
JSON line a reading on standard output; the benchmark's own runs never
run this.

    python3 portbench/controls/readings.py --workload <cell> \\
        --seeds 11,12,... --control-seeds 91,92,93 --seconds 3
"""

import argparse
import json
import pathlib
import sys
import time

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent.parent


def main(argv=None) -> int:
    sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]
    from portbench import bench, compare
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = bench.Cell.resolve(bench.load_bench(), args.workload)
    system = cell.system()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds:
        t0 = time.perf_counter()
        r = bench.run_cell(cell, seed, args.seconds, False, args.device, t0)
        print(json.dumps({"kind": "program", "seed": seed,
                          "correct": r["correct"],
                          "readings": {k: v["value"]
                                       for k, v in r["checks"].items()},
                          "metrics": {k: v["value"]
                                      for k, v in r["metrics"].items()},
                          "notes": r["notes"],
                          "wall_s": time.perf_counter() - t0}), flush=True)
        if args.device == "cuda":
            import torch
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    for seed in ctl:
        t0 = time.perf_counter()
        got = system.control(cell, seed, args.seconds, args.device)
        held = compare.held(got, cell.config["limits"])
        print(json.dumps({"kind": "control", "seed": seed,
                          "correct": compare.correct(held),
                          "readings": got,
                          "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
