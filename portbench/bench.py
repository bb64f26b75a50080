"""The harness: resolve a cell of ``BENCHMARK.json`` by name, build and
drive its system for a window of wall-clock time, check what the timed
path produced against the plain reference, read the metrics and print
the result line.

A cell is found only through names. ``BENCHMARK.json`` gives the cell's
configuration and traffic mix; ``configs/<config>.json`` names the
system (``systems/<system>.py``) and ``traffic/<mix>.json`` the
generator (``generators/<generator>.py``) that reads it; the reference
is ``reference/<config>.py`` and each metric's reader
``metrics/<metric>.py``. A new cell, configuration, traffic mix or
metric is new files and entries, with no edit to a file that is here.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import pathlib
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from portbench import compare

HERE = pathlib.Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# top-level module names that must not be loaded where the result is
# printed: JAX and the JAX package (compared whole: ``repro_torch`` is
# the port, ``repro`` the JAX package)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

_MODULES: Dict[pathlib.Path, Any] = {}


def load_file(path: pathlib.Path):
    """The module in ``path`` (a file named after a cell, configuration,
    mix or metric, which may hold ``-`` and ``.``), loaded once."""
    path = pathlib.Path(path).resolve()
    mod = _MODULES.get(path)
    if mod is None:
        if not path.is_file():
            raise FileNotFoundError(f"no such benchmark file: {path}")
        name = "portbench_file_" + "".join(
            c if c.isalnum() else "_" for c in str(path.relative_to(HERE)))
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return mod


def read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_bench(path: Optional[pathlib.Path] = None) -> dict:
    return read_json(path or CHECKOUT / "BENCHMARK.json")


def _reports(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, resolved."""
    name: str
    chips: int
    config: dict              # configs/<config>.json
    traffic: dict             # traffic/<mix>.json
    end_to_end: List[dict]    # the end-to-end metrics this cell reports
    per_layer: List[dict]     # the per-layer metrics this cell reports

    @classmethod
    def resolve(cls, bench: dict, workload: str,
                data: pathlib.Path = HERE) -> "Cell":
        """``workload``'s entry of ``bench``; its traffic mix is read from
        ``data/traffic`` and its configuration from the entry's ``file``
        (relative to the checkout, or absolute)."""
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                           f"known: {sorted(cells)}")
        w = cells[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        cfg_entry = configs[w["config"]]
        config = read_json(CHECKOUT / cfg_entry["file"])
        traffic = read_json(data / "traffic" / f"{w['traffic']}.json")
        return cls(name=workload, chips=int(w["chips"]), config=config,
                   traffic=traffic,
                   end_to_end=[m for m in bench["end_to_end"]
                               if _reports(m, workload)],
                   per_layer=[m for m in bench["per_layer"]
                              if _reports(m, workload)])

    def system(self):
        return load_file(HERE / "systems" / f"{self.config['system']}.py")

    def generator(self):
        return load_file(HERE / "generators"
                         / f"{self.traffic['generator']}.py")

    def reference(self):
        """The plain reference: ``reference/<config>.py``, or the file the
        configuration names (one reference serves a family of sizes)."""
        name = self.config.get("reference", self.config["name"])
        return load_file(HERE / "reference" / f"{name}.py")

    def reader(self, metric: str):
        return load_file(HERE / "metrics" / f"{metric}.py")


@dataclass
class Run:
    """What one run measured: filled by the system while it drives the
    program, read by the metric readers and the check."""
    cell: Cell
    seed: int
    device: str
    t_start: float                      # process start (perf_counter)
    t_window: Optional[float] = None    # the first timed batch or step
    t_close: Optional[float] = None     # the end of the window's last one
    work: Dict[str, float] = field(default_factory=dict)
    stamps: List[float] = field(default_factory=list)
    memory_peak_bytes: int = 0
    trace: Any = None                   # trace.Trace of a --trace 1 run
    notes: Dict[str, Any] = field(default_factory=dict)

    @property
    def setup_s(self) -> float:
        return self.t_window - self.t_start

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_window


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def host_counters() -> Dict[str, float]:
    """This process's host counters: CPU seconds, page faults (minor and
    major) and context switches (voluntary and forced). Their change over
    the window goes into the result's notes: CPU seconds near the wall
    say the host thread was busy all through the window."""
    import resource
    r = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": r.ru_utime + r.ru_stime, "minflt": r.ru_minflt,
            "majflt": r.ru_majflt, "nvcsw": r.ru_nvcsw,
            "nivcsw": r.ru_nivcsw}


def counters_since(start: Dict[str, float]) -> Dict[str, float]:
    now = host_counters()
    return {k: now[k] - start[k] for k in start}


def sync(device: str) -> None:
    if str(device).startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def read_metrics(run: Run, specs: List[dict]) -> Dict[str, dict]:
    """Each metric's reader on ``run``: ``{name: {"value", "unit"}}``. A
    per-layer reader that finds nothing returns None and its metric is
    left out; an end-to-end metric must be there."""
    out = {}
    for spec in specs:
        value = run.cell.reader(spec["name"]).read(run)
        if value is None:
            if spec in run.cell.end_to_end:
                raise RuntimeError(f"end-to-end metric {spec['name']!r} "
                                   f"read nothing in {run.cell.name}")
            continue
        value = float(value)
        if not math.isfinite(value):
            raise RuntimeError(f"metric {spec['name']!r} read {value!r}")
        out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out


def device_record(run: Run) -> dict:
    import torch
    if str(run.device).startswith("cuda"):
        platform, kind = "gpu", torch.cuda.get_device_name(0)
    else:
        platform, kind = "cpu", "cpu"
    dev = {"platform": platform, "kind": kind, "count": run.cell.chips,
           "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    return dev


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             program_hook: Optional[Callable] = None) -> dict:
    """Build, drive and check ``cell`` once; the result line as a dict
    (``checks`` last). ``program_hook(program)``, for the tests, breaks
    the timed path underneath before the window."""
    import torch
    if t_start is None:
        t_start = time.perf_counter()
    run = Run(cell, int(seed), device, t_start)
    system = cell.system()
    program = system.Program(run)
    if program_hook is not None:
        program_hook(program)
    program.window(float(seconds), bool(trace))
    if str(device).startswith("cuda"):
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    evidence = program.close()
    del program
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    checks = system.check(run, evidence)
    correct = compare.correct(checks)
    metrics = read_metrics(run, cell.per_layer if trace else cell.end_to_end)
    result = {"correct": bool(correct),
              "attempted": int(run.work.get("attempted", 0)),
              "failed": int(run.work.get("failed", 0)),
              "metrics": metrics, "device": device_record(run)}
    if trace and run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["notes"] = run.notes
    result["checks"] = checks
    return result


def check_lines(checks: dict) -> List[str]:
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
            for name, c in checks.items()]


def main(argv=None, t_start: Optional[float] = None) -> int:
    if t_start is None:
        t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell.resolve(load_bench(), args.workload)
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      t_start)
    # the window has closed: nothing of JAX or the JAX package may be
    # loaded in the process that prints the result
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    for line in check_lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
