"""Self-tuning (S2CE O1: "Optimization & Self-Tuning of Cloud
Applications"), the port of the JAX package's ``core/selftune.py``.

:func:`measure_operator_costs` closes the placement loop: the pipeline's
ops are priced by what a counted run of them does
(``launch/op_count.py``), not by their hand-written guesses. The
execution-config tuner (:class:`Candidate`, :class:`TuneResult`,
:func:`default_candidates`, :func:`evaluate_candidate`, :func:`tune`)
scores each candidate by the dry run's traced step
(``launch/dryrun.py``) against the modelled cluster's roofline.
"""

from __future__ import annotations

import json
import pathlib
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch._tree import tree_leaves


def _n_events(batch: Dict[str, Any]) -> int:
    """Events in a batch dict: the largest leading dimension over its
    tensor values (the ``rng`` key is control, not payload)."""
    n = 0
    for k, v in batch.items():
        if k == "rng":
            continue
        shape = tuple(getattr(v, "shape", ()))
        if shape and shape[0] > n:
            n = int(shape[0])
    return max(n, 1)


def _pytree_nbytes(tree: Any) -> float:
    return float(sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                     if isinstance(t, torch.Tensor)))


def _device_of(batch: Dict[str, Any]) -> torch.device:
    for t in tree_leaves(batch):
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def measure_operator_costs(graph, batch: Dict[str, Any], *,
                           events: Optional[int] = None
                           ) -> Tuple[Dict[str, Any], List[str]]:
    """Measured per-op :class:`~repro_torch.core.costmodel.OperatorCost`s
    from one counted run of ``graph`` over ``batch``: instead of
    optimizing the hand-written per-op guesses, the placement search
    prices what the ops do.

    Per op, in graph order (so each op sees the channel env its real
    parents produced), from fresh states on the batch's device:

      * ``flops_per_event`` / ``bytes_per_event`` — the op's step run
        under an :class:`~repro_torch.launch.op_count.OpCount`, divided
        by the event count (:func:`repro_torch.launch.roofline.
        op_event_costs`). The counts are unfused, so the bytes are an
        upper bound next to the JAX package's XLA ``bytes accessed``;
      * ``out_bytes_per_event`` — the bytes the op writes to its output
        channels;
      * ``state_bytes`` — the bytes of its post-step state;
      * ``edge_capable`` — NOT measured; the declared semantic flag is
        preserved by :meth:`OpGraph.set_measured_costs`.

    Returns ``(measured, notes)``: every op whose measurement succeeded,
    and notes for the ops that kept their declared numbers. An op that
    fails stops the measurement there (downstream ops would see a wrong
    env), as in the reference.

    The states are fresh (``graph.init_states``) and the ops run through
    ``graph._apply``, not the graph's segments, so a running pipeline's
    segment cache and states are untouched.
    """
    from repro_torch.launch import op_count, roofline

    states = graph.init_states(_device_of(batch))
    env = dict(batch)
    n_ev = int(events) if events else _n_events(batch)
    measured: Dict[str, Any] = {}
    notes: List[str] = []
    for i, op in enumerate(graph.ops):
        try:
            with op_count.OpCount() as count:
                states, env = graph._apply(i, states, env)
        except Exception as e:
            notes.append(f"{op.name}: execution failed, measurement "
                         f"aborted ({type(e).__name__}: {e})")
            break
        flops_ev, bytes_ev = roofline.op_event_costs(count, n_ev)
        if op.writes is None:
            # linear chain: the op forwards the whole batch downstream
            out_nbytes = _pytree_nbytes(
                {k: v for k, v in env.items() if k != "rng"})
        else:
            out_nbytes = sum(_pytree_nbytes(env[k]) for k in op.writes
                             if k in env)
        measured[op.name] = replace(
            op.cost,
            flops_per_event=flops_ev,
            bytes_per_event=bytes_ev,
            out_bytes_per_event=out_nbytes / n_ev,
            state_bytes=_pytree_nbytes(states[op.name]),
        )
    return measured, notes


@dataclass
class Candidate:
    overrides: Dict
    recipe: Optional[str] = None
    note: str = ""


@dataclass
class TuneResult:
    candidate: Candidate
    ok: bool
    mem_gib: float = float("inf")
    bound_s: float = float("inf")
    dominant: str = ""
    roofline_fraction: float = 0.0
    useful_ratio: float = 0.0
    error: str = ""
    record: Optional[dict] = None

    def better_than(self, other: "TuneResult", mem_cap_gib: float) -> bool:
        if not self.ok:
            return False
        if not other.ok:
            return True
        a_fits = self.mem_gib <= mem_cap_gib
        b_fits = other.mem_gib <= mem_cap_gib
        if a_fits != b_fits:
            return a_fits
        if a_fits:
            return self.bound_s < other.bound_s
        return self.mem_gib < other.mem_gib


def default_candidates(cfg) -> List[Candidate]:
    """A modest, napkin-math-ordered candidate set (biggest predicted win
    first)."""
    cands = [Candidate({}, note="baseline")]
    for mb in (1, 2, 4, 8, 16):
        if mb != cfg.microbatches:
            cands.append(Candidate({"microbatches": mb},
                                   note=f"microbatches={mb}"))
    for chunk in (256, 512, 2048):
        if chunk != cfg.attn_chunk:
            cands.append(Candidate({"attn_chunk": chunk},
                                   note=f"attn_chunk={chunk}"))
    for remat in ("dots",):
        if remat != cfg.remat:
            cands.append(Candidate({"remat": remat}, note=f"remat={remat}"))
    return cands


def evaluate_candidate(arch: str, shape_name: str, cand: Candidate, *,
                       multi_pod: bool = False, tag: str = "tune",
                       save: bool = False, device="cuda") -> TuneResult:
    """Dry-run one candidate and extract the roofline verdict.

    Runs in a process with no process group, or with the dry run's fake
    world already up (``launch/mesh.py::fake_world``)."""
    from repro_torch.launch.dryrun import run_cell
    rec = run_cell(arch, shape_name, multi_pod, recipe=cand.recipe,
                   overrides=cand.overrides or None, tag=tag, save=save,
                   force=True, device=device)
    if not rec.get("ok"):
        return TuneResult(cand, False, error=rec.get("error", "?"),
                          record=rec)
    rf = rec["roofline"]
    return TuneResult(
        cand, True,
        mem_gib=rec["memory"]["total_per_device"] / 2**30,
        bound_s=max(rf["t_compute_s"], rf["t_memory_s"], rf["t_collective_s"]),
        dominant=rf["dominant"],
        roofline_fraction=rf["roofline_fraction"],
        useful_ratio=rf["useful_flops_ratio"],
        record=rec,
    )


def tune(arch: str, shape_name: str, candidates: List[Candidate], *,
         mem_cap_gib: float = 16.0, log_path: Optional[str] = None,
         stop_after_no_improve: int = 3, device="cuda"
         ) -> Tuple[TuneResult, List[TuneResult]]:
    """Greedy sweep with early stop (3 consecutive <5% improvements).
    ``mem_cap_gib`` is the modelled chip's cap, as in the JAX package."""
    results: List[TuneResult] = []
    best: Optional[TuneResult] = None
    stale = 0
    for cand in candidates:
        r = evaluate_candidate(arch, shape_name, cand, device=device)
        results.append(r)
        if best is None or r.better_than(best, mem_cap_gib):
            improved = best is None or (
                best.bound_s - r.bound_s) > 0.05 * best.bound_s or (
                best.mem_gib > mem_cap_gib >= r.mem_gib)
            best = r
            stale = 0 if improved else stale + 1
        else:
            stale += 1
        if log_path:
            p = pathlib.Path(log_path)
            p.parent.mkdir(parents=True, exist_ok=True)
            with p.open("a") as f:
                f.write(json.dumps({
                    "arch": arch, "shape": shape_name, "note": cand.note,
                    "ok": r.ok, "mem_gib": round(r.mem_gib, 2),
                    "bound_s": r.bound_s, "dominant": r.dominant,
                    "roofline_fraction": r.roofline_fraction,
                    "error": r.error[:200],
                }) + "\n")
        if stale >= stop_after_no_improve:
            break
    return best, results
