"""Aggregate the port's dry-run cell records (``launch/dryrun.py``)
into roofline tables, as the JAX package's ``launch/report.py`` does
with its own.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.report            # print tables
  PYTHONPATH=src python -m repro_torch.launch.report --pick3    # hillclimb picks
  PYTHONPATH=src python -m repro_torch.launch.report --traced   # traced columns only

The modelled seconds, the fraction and the ``fits`` verdict divide by
the modelled cluster's chip (``launch/roofline.py``'s constants and
``HBM_CAP_GIB``), not by the card's numbers. ``--traced`` prints only
what the trace itself counted: GiB a rank, product flops and link bytes
a rank, the dominant term and the useful ratio.
"""

from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List

ROOT = pathlib.Path(__file__).resolve().parents[3]
DRYRUN = ROOT / "experiments" / "dryrun_torch"

HBM_CAP_GIB = 16.0      # the modelled chip's memory, the JAX package's cap


def load_cells(mesh_dir: str = "pod_16x16") -> List[dict]:
    cells = []
    base = DRYRUN / mesh_dir
    if not base.exists():
        return cells
    for arch_dir in sorted(base.iterdir()):
        for f in sorted(arch_dir.glob("*.json")):
            cells.append(json.loads(f.read_text()))
    return cells


def _row(c: dict) -> dict:
    rf = c.get("roofline", {})
    mem = c.get("memory", {}).get("total_per_device", 0) / 2**30
    return {
        "arch": c["arch"], "shape": c["shape"], "ok": c.get("ok", False),
        "recipe": c.get("recipe", "?"),
        "mem_gib": mem, "fits": mem <= HBM_CAP_GIB,
        "t_comp": rf.get("t_compute_s", 0.0),
        "t_mem": rf.get("t_memory_s", 0.0),
        "t_coll": rf.get("t_collective_s", 0.0),
        "dom": rf.get("dominant", "?"),
        "useful": rf.get("useful_flops_ratio", 0.0),
        "frac": rf.get("roofline_fraction", 0.0),
        "params_total": c.get("params_total", 0),
        "flops": rf.get("flops_per_dev", 0.0),
        "link_bytes": rf.get("link_bytes_per_dev", 0.0),
        "err": c.get("error", "")[:60],
    }


def table(mesh_dir: str = "pod_16x16") -> List[dict]:
    return [_row(c) for c in load_cells(mesh_dir)]


def render_markdown(rows: List[dict]) -> str:
    hdr = ("| arch | shape | recipe | mem GiB | fits | t_comp s | t_mem s | "
           "t_coll s | dominant | useful | roofline frac |")
    sep = "|" + "---|" * 11
    lines = [hdr, sep]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['recipe']} | "
            f"{r['mem_gib']:.2f} | {'Y' if r['fits'] else 'N'} | "
            f"{r['t_comp']:.3f} | {r['t_mem']:.3f} | {r['t_coll']:.3f} | "
            f"{r['dom']} | {r['useful']:.2f} | {r['frac']:.4f} |")
    return "\n".join(lines)


def render_traced(rows: List[dict]) -> str:
    """The traced columns of each cell (no modelled seconds, no ``fits``);
    a failed cell shows its error."""
    hdr = ("| arch | shape | recipe | GiB a rank | product flops a rank | "
           "link bytes a rank | dominant | useful |")
    lines = [hdr, "|" + "---|" * 8]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if not r["ok"]:
            lines.append(f"| {r['arch']} | {r['shape']} | {r['recipe']} | "
                         f"failed: {r['err']} | | | | |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['recipe']} | "
            f"{r['mem_gib']:.2f} | {r['flops']:.4g} | {r['link_bytes']:.4g} | "
            f"{r['dom']} | {r['useful']:.3f} |")
    return "\n".join(lines)


def pick3(rows: List[dict]) -> Dict[str, dict]:
    """worst roofline fraction (train), most collective-bound, and the
    serving cell most representative of the S2CE pipeline."""
    ok = [r for r in rows if r["ok"] and r["frac"] > 0]
    train = [r for r in ok if r["shape"] == "train_4k"]
    worst = min(train, key=lambda r: r["frac"])
    coll = max(ok, key=lambda r: (r["t_coll"] /
                                  max(r["t_comp"], r["t_mem"], 1e-12)))
    serve = [r for r in ok if r["shape"] in ("decode_32k", "prefill_32k")]
    rep = max(serve, key=lambda r: r["mem_gib"])
    return {"worst_fraction": worst, "most_collective": coll,
            "serving_representative": rep}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod_16x16")
    ap.add_argument("--pick3", action="store_true")
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--traced", action="store_true")
    args = ap.parse_args()
    rows = table(args.mesh)
    if args.markdown:
        print(render_markdown(rows))
        return
    if args.traced:
        print(render_traced(rows))
        return
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        status = "ok " if r["ok"] else "ERR"
        print(f"{status} {r['arch']:>24s} {r['shape']:>12s} {r['recipe']:>10s} "
              f"mem={r['mem_gib']:7.2f}GiB fits={'Y' if r['fits'] else 'N'} "
              f"tc={r['t_comp']:8.3f} tm={r['t_mem']:8.3f} "
              f"tl={r['t_coll']:8.3f} dom={r['dom']:10s} "
              f"useful={r['useful']:5.2f} frac={r['frac']:.4f}")
    if args.pick3:
        print("\n== hillclimb picks ==")
        for k, r in pick3(rows).items():
            print(f"{k}: {r['arch']} x {r['shape']} (dom={r['dom']}, "
                  f"frac={r['frac']:.4f}, mem={r['mem_gib']:.1f}GiB)")


if __name__ == "__main__":
    main()
