"""The S2CE orchestrator: one object that wires the paper's Fig. 2 together.

A :class:`StreamJob` declares sources, the transformation pipeline (a
linear :class:`~repro_torch.core.pipeline.Pipeline` or a fan-out/rejoin
:class:`~repro_torch.core.pipeline.OpGraph` — the default is the classic
normalize -> sketch -> sample -> train -> drift chain), the ML payload,
and an SLA. The orchestrator:

  1. costs the pipeline's op graph and *places* it over the job's
     :class:`~repro_torch.core.costmodel.ClusterSpec` (any number of edge
     pools / cloud pods with codec-carrying links; core/placement) —
     the same op list the executor runs. The SLA error budget picks the
     cheapest admissible uplink codec (core/sla.pick_codec), attached
     to every edge->cloud link,
  2. executes the planned partition: the frontier (ops resident on any
     edge pool; a prefix for linear pipelines) as the edge segment, the
     rest as the cloud segment (core/pipeline), applying the chosen
     codec's wire round-trip to batches crossing the uplink,
  3. monitors rate + SLA, *re-plans* via the offload controller, and
     re-partitions the graph when the assignment migrates — including
     **codec migrations**: the controller re-runs codec admission
     against the windowed SLA report on every replan, and when the
     winning plan carries a different uplink codec the orchestrator
     swaps the wire round-trip fn and flushes the error-feedback
     residuals (a stale carry from the old codec's quantization
     geometry must not leak into the new one),
  4. reacts to drift alarms through each op's declared drift response,
  5. drives elastic grow/shrink plans through the state-carrying
     ``elastic.rescale_cycle`` (checkpoint.save -> restore -> back on the
     job's device — the same path failure recovery takes),
  6. exposes metrics for the Output Interface.

Because segments are composed from shared per-op steps (see
core/pipeline), a migration changes *where* ops run without perturbing
*what* they compute: results are bitwise-identical to any fixed-cut run.

The job runs on ``StreamJob.device`` (the card by default; a machine
without CUDA raises rather than running on the CPU). Batches are moved
there as they arrive, and the EF residuals of the uplink codec stay
there between batches.
"""

from __future__ import annotations

import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, Iterable, List, Optional

import torch

from repro_torch._tree import tree_flatten, tree_unflatten
from repro_torch.core.costmodel import (CLOUD_POD, EDGE_NODE, ClusterSpec,
                                        Resource)
from repro_torch.core.offload import OffloadController
from repro_torch.core.pipeline import (OpGraph, Pipeline,
                                       standard_stream_pipeline)
from repro_torch.core.placement import Objective
from repro_torch.core.sla import SLA, SLATracker, codec_candidates, pick_codec
from repro_torch.dist import elastic
from repro_torch.streams.sampling import SEED_MASK


def step_seed(seed: int, step: int) -> int:
    """The batch ``rng`` seed of ``step``: a fresh 63-bit value per step
    (a splitmix64 finalizer over the root seed and the step), so
    randomness advances every batch whatever ops the pipeline holds."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(step) + 1) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & SEED_MASK


@dataclass
class StreamJob:
    name: str
    dim: int = 16
    n_classes: int = 2
    sla: SLA = field(default_factory=SLA)
    # SLA telemetry window: every tracker statistic (violation rate,
    # p99) covers the last `sla_window` batches, so violations age out
    # and replanning reacts to current state, not lifetime history
    sla_window: int = 100
    sample_rate: float = 0.5
    drift_detector: str = "ddm"          # ddm|eddm|ph|adwin
    # full cluster topology (any number of edge pools / cloud pods with
    # explicit links); None -> the classic two-pool spec built from
    # edge_resource/cloud_resource below (kept for back-compat)
    cluster: Optional[ClusterSpec] = None
    # live topology (a membership directory): not ported yet, raises
    membership: Optional[object] = None
    edge_resource: Resource = EDGE_NODE
    cloud_resource: Resource = CLOUD_POD
    objective: Objective = field(default_factory=Objective)
    # user-supplied operator graph (linear Pipeline or fan-out OpGraph);
    # None -> the standard S2CE chain
    pipeline: Optional[OpGraph] = None
    # measured per-op costs for placement: not ported yet, raises
    measured_costs: bool = False
    # elastic cloud-pool sizing (dist/elastic): starting worker count and cap
    workers: int = 1
    max_workers: int = 16
    # where elastic rescale cycles publish checkpoints; None -> a tempdir
    ckpt_dir: Optional[str] = None
    # explicit codec ladder for SLA admission and rate-adaptive replans
    # (names resolvable by core/codecs.get_codec). None -> the default
    # gradient ladder (DEFAULT_CODECS). A serving job passes the KV
    # ladder (identity / kv_int8 / kv_latent) here so the controller's
    # escalate/de-escalate loop governs KV-cache compression
    uplink_codecs: Optional[List[str]] = None
    # where the job's states, batches and EF residuals live: the card
    # unless the caller asks for the CPU
    device: str = "cuda"


@dataclass
class JobMetrics:
    events: int = 0
    drift_alarms: int = 0
    migrations: int = 0
    rescales: int = 0
    workers: int = 1
    preq: Optional[dict] = None
    sla: Optional[dict] = None
    decisions: List[str] = field(default_factory=list)
    cuts: List[int] = field(default_factory=list)        # |frontier| per batch
    # assignment record per batch: the frozenset of edge-resident op names
    # (the frontier VIEW — kept for back-compat; migrations count on the
    # full plan identity below)
    assignments: List[FrozenSet[str]] = field(default_factory=list)
    # full executed plan identity per batch: (sorted (op, pool) pairs,
    # uplink codec) — the identity contract of core/offload, so a
    # multi-pool rebalance that keeps the frontier but moves ops between
    # pods, or a codec-only migration, is still counted
    plan_identities: List[tuple] = field(default_factory=list)
    codecs: List[str] = field(default_factory=list)      # codec per batch
    outputs: List[dict] = field(default_factory=list)    # when recording
    # the initially admitted uplink codec (pick_codec at job start); the
    # per-batch trajectory under rate-adaptive control is `codecs`
    codec: str = "identity"


class Orchestrator:
    """Runs a StreamJob over a stream of feature batches."""

    def __init__(self, job: StreamJob):
        self.job = job
        self.device = torch.device(job.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"StreamJob {job.name!r} asks for device {job.device!r} but "
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if job.membership is not None:
            raise NotImplementedError(
                "StreamJob(membership=...) is not ported yet: see "
                "ROADMAP.md, 'Modules to port', core/membership.py")
        if job.measured_costs:
            raise NotImplementedError(
                "StreamJob(measured_costs=True) is not ported yet: see "
                "ROADMAP.md, 'Modules to port', core/selftune.py")
        # the cluster topology placement runs over: the job's ClusterSpec,
        # or the classic two-pool spec from edge/cloud resources. The SLA
        # error budget picks the cheapest admissible uplink codec, which
        # fills every uplink that doesn't declare its own (pricing) AND
        # is applied to batches crossing segments at runtime (execution).
        # A user-declared per-link codec wins over the blanket pick but
        # must itself fit the budget — a lossy topology under a lossless
        # SLA is a configuration conflict, not something to paper over.
        spec = (ClusterSpec.of(job.cluster) if job.cluster is not None
                else ClusterSpec.edge_cloud(job.edge_resource,
                                            job.cloud_resource))
        # the user-declared topology, BEFORE the blanket codec attach:
        # rate-adaptive replans re-derive per-candidate specs from it
        # (user-declared per-link codecs always win over the blanket)
        self._base_cluster = spec
        from repro_torch.core.codecs import get_codec
        self._codec_ladder = (
            [get_codec(n) for n in job.uplink_codecs]
            if job.uplink_codecs is not None else None)
        self.codec = pick_codec(job.sla, candidates=self._codec_ladder)
        self.cluster = spec.with_uplink_codec(self.codec.name)
        for e in self.cluster.edge_pools:
            for c in self.cluster.cloud_pools:
                ln = self.cluster.link(e.name, c.name)
                bound = get_codec(ln.codec).error_bound
                if bound > job.sla.error_budget + 1e-12:
                    raise ValueError(
                        f"link {ln.src}->{ln.dst} declares codec "
                        f"{ln.codec!r} (error bound {bound:.4g}) but the "
                        f"SLA error budget is {job.sla.error_budget:.4g}; "
                        f"raise the budget or drop the link codec")
        self.resources = dict(self.cluster.pools)
        self.pipeline = job.pipeline or standard_stream_pipeline(
            job.dim, sample_rate=job.sample_rate,
            drift_detector=job.drift_detector)
        # a Pipeline partitions at prefix cuts (plans identical to the
        # linear IR); any other OpGraph partitions at frontier cuts
        self.is_graph = not isinstance(self.pipeline, Pipeline)
        # the cost model prices the SAME op list the executor runs
        self.ops = self.pipeline.costs()
        # every budget-admissible codec is a replan-time candidate: the
        # controller re-runs admission against windowed SLA telemetry on
        # each replan event and may migrate the codec (a zero budget
        # leaves exactly [identity] — the codec is then pinned)
        self.codec_candidates = [
            c.name for c in codec_candidates(
                job.sla, candidates=self._codec_ladder)]
        self.controller = OffloadController(
            self.ops, self._base_cluster, job.objective,
            graph=self.pipeline if self.is_graph else None,
            codec=self.codec.name, sla_spec=job.sla,
            codec_candidates=self.codec_candidates)
        self.sla = SLATracker(job.sla, window=job.sla_window)
        # error-feedback residuals for the lossy uplink codec, keyed by
        # (batch channel, pytree leaf index) — carried across steps so
        # accumulated error stays within the codec's admitted bound. They
        # stay on the job's device between batches
        self._uplink_residuals: Dict[tuple, torch.Tensor] = {}
        self.elastic = elastic.ElasticController(workers=job.workers,
                                                 max_workers=job.max_workers)
        self.states = self.pipeline.init_states(self.device)
        self.cut = 0
        self.frontier: FrozenSet[str] = frozenset()
        self.metrics = JobMetrics()
        self._ckpt_dir = job.ckpt_dir

    # -- uplink codec: the wire transform between segments ------------------
    def _uplink_fn(self):
        """The batch transform applied where data crosses the edge->cloud
        uplink (or the cloud->edge downlink of a ``downlink_ok`` split),
        or None for a lossless (identity) codec. Channels are arbitrary
        pytrees — a flat feature array or a whole KV-cache tree — and
        every float leaf round-trips the codec with its own error-
        feedback residual (keyed by ``(channel, leaf index)``); integer/
        bool/PRNG leaves cross uncompressed."""
        if self.codec.lossless:
            return None

        def uplink(env):
            out = dict(env)
            for k, v in env.items():
                if k == "rng":
                    continue
                leaves, treedef = tree_flatten(v)
                changed = False
                for i, leaf in enumerate(leaves):
                    if not (isinstance(leaf, torch.Tensor)
                            and leaf.is_floating_point()):
                        continue
                    r = self._uplink_residuals.get((k, i))
                    if (r is None or r.shape != leaf.shape
                            or r.device != leaf.device):
                        r = self.codec.init_residual(leaf)
                    dec, r = self.codec.roundtrip(r, leaf)
                    self._uplink_residuals[(k, i)] = r
                    leaves[i] = dec
                    changed = True
                if changed:
                    out[k] = tree_unflatten(treedef, leaves)
            return out

        return uplink

    # -- codec migration: swap the wire round-trip at a replan boundary -----
    def _swap_codec(self, name: str, step: int) -> None:
        """Runtime codec migration: swap the wire round-trip fn and FLUSH
        the error-feedback residuals — a stale carry is expressed in the
        old codec's quantization geometry and would corrupt (leak stale
        mass into) the first round-trips of the new codec. The next lossy
        crossing reseeds zero residuals via ``init_residual``."""
        from repro_torch.core.codecs import get_codec
        old = self.codec.name
        self.codec = get_codec(name)
        self._uplink_residuals.clear()
        self.cluster = self._base_cluster.with_uplink_codec(name)
        self._uplink = self._uplink_fn()
        self.metrics.decisions.append(f"{step}:codec {old}->{name}")

    # -- drift response: each op declares its own -------------------------
    def _apply_drift_response(self):
        for op in self.pipeline.ops:
            if op.on_drift is not None:
                self.states[op.name] = op.on_drift(self.states[op.name])

    def _collect_op_metrics(self) -> Optional[dict]:
        out: Dict[str, float] = {}
        for op in self.pipeline.ops:
            if op.metrics is not None:
                out.update(op.metrics(self.states[op.name]))
        return out or None

    # -- elastic rescale: the ROADMAP save->rebuild->reshard->resume cycle --
    def _apply_rescale(self, step: int, plan) -> None:
        """Drive an elastic grow/shrink through ``elastic.rescale_cycle``:
        the op states round-trip a published checkpoint and come back on
        the job's device — the same machinery a failure recovery takes,
        so values are preserved bitwise. The job's device does not
        change, so the EF residuals stay where they are."""
        if self._ckpt_dir is None:
            self._ckpt_dir = tempfile.mkdtemp(
                prefix=f"s2ce-{self.job.name}-elastic-")
        self.states, devices = elastic.rescale_cycle(
            self._ckpt_dir, step, self.states, plan.workers, self.device,
            meta={"reason": plan.reason, "job": self.job.name}, keep=2)
        self.metrics.decisions.append(
            f"{step}:elastic-{plan.action} workers={plan.workers} "
            f"devices={len(devices)} ({plan.reason})")

    # -- step primitives ----------------------------------------------------
    # run() composes these; the fleet orchestrator (core/fleet) drives
    # them directly so N tenant jobs can interleave batch execution with
    # fleet-arbitrated (instead of per-job immediate) replanning.

    def begin(self, rate0: float, seed: int = 0,
              fixed_cut: Optional[int] = None,
              fixed_frontier: Optional[Iterable[str]] = None,
              decision=None):
        """Take (or adopt) the initial plan and arm the run state.
        ``decision`` lets a fleet admission pass hand over the
        OffloadDecision it already took through this job's controller —
        ``begin`` then must not call ``initial_plan`` a second time."""
        self._root_seed = int(seed)
        dec = decision if decision is not None else \
            self.controller.initial_plan(rate0)
        if fixed_frontier is not None:
            self.frontier = self.pipeline.check_frontier(fixed_frontier)
        elif fixed_cut is not None:
            self.frontier = frozenset(self.pipeline.names[:fixed_cut])
        else:
            self.frontier = dec.frontier
        self._pinned = fixed_cut is not None or fixed_frontier is not None
        self.cut = len(self.frontier)
        # the executed plan identity (assignment + codec) in force; a
        # pinned reference run keeps it constant -> 0 executed migrations
        if self._pinned:
            e = self.cluster.edge_pools[0].name
            c = self.cluster.cloud_pools[0].name
            self._exec_assignment = {
                n: (e if n in self.frontier else c)
                for n in self.pipeline.names}
        else:
            self._exec_assignment = dict(dec.assignment)
        self.metrics.codec = self.codec.name
        self.metrics.decisions.append(
            f"0:init cut={self.cut} codec={self.codec.name}")
        self._uplink = self._uplink_fn()
        return dec

    def execute_batch(self, step: int, batch,
                      record_outputs: bool = False) -> float:
        """Execute one batch under the plan in force; record metrics and
        feed the SLA tracker. Returns the measured event rate."""
        t0 = time.perf_counter()
        bd = {k: torch.as_tensor(v).to(self.device)
              for k, v in batch.data.items()}
        # a fresh per-step seed, so randomness advances every batch
        bd["rng"] = torch.tensor(step_seed(self._root_seed, step),
                                 dtype=torch.int64)
        if self.is_graph:
            self.states, out = self.pipeline.run(self.states, bd,
                                                 self.frontier,
                                                 uplink=self._uplink)
        else:
            self.states, out = self.pipeline.run(self.states, bd,
                                                 self.cut,
                                                 uplink=self._uplink)
        self.metrics.cuts.append(self.cut)
        self.metrics.assignments.append(self.frontier)
        self.metrics.codecs.append(self.codec.name)
        self.metrics.plan_identities.append(
            (tuple(sorted(self._exec_assignment.items())),
             self.codec.name))
        if record_outputs:
            self.metrics.outputs.append(
                {k: v.detach().cpu().numpy() for k, v in out.items()
                 if k != "rng"})
        if "drifted" in out and bool(out["drifted"]):
            self.metrics.drift_alarms += 1
            self._apply_drift_response()
        dt = time.perf_counter() - t0
        rate = batch.n / max(dt, 1e-9)
        self.sla.observe(dt, rate)
        self.metrics.events += batch.n
        return rate

    def apply_decision(self, step: int, d) -> None:
        """Apply an OffloadDecision to the executing partition: codec
        migration and/or re-partition. Hold decisions are no-ops beyond
        the decision log."""
        if d.reason != "hold":
            self.metrics.decisions.append(
                f"{step}:{d.reason} cut={d.cut}")
        if self._pinned:
            return
        if d.codec != self.codec.name:
            # codec migration: new wire round-trip, flushed EF
            # residuals (frontier may or may not move with it)
            self._swap_codec(d.codec, step)
        if d.frontier != self.frontier:
            # migration: re-partition — the next pipeline.run
            # re-fuses segments for the new cut (compile cache
            # makes revisits free)
            self.metrics.decisions.append(
                f"{step}:repartition {self.cut}->{d.cut} "
                f"edge={sorted(d.frontier)}")
            self.frontier = d.frontier
            self.cut = len(d.frontier)
        self._exec_assignment = dict(d.assignment)

    def elastic_step(self, step: int, offered: float, rate: float) -> None:
        """Elastic cloud-pool sizing: grow/shrink the worker count when
        the offered rate persistently over/under-runs the pool; a
        changed plan is DRIVEN through the checkpoint rescale cycle."""
        plan = self.elastic.observe(step, offered, rate)
        if plan.changed:
            self._apply_rescale(step, plan)

    def finish(self) -> JobMetrics:
        """Derive the executed-migration count and final telemetry."""
        # migrations = plan-identity changes that actually EXECUTED (the
        # full (assignment, codec) identity per core/offload's contract:
        # a pod rebalance that keeps the frontier, or a codec-only swap,
        # still counts; a pinned reference run reports 0 even when the
        # controller's virtual plan moved)
        self.metrics.migrations = sum(
            1 for a, b in zip(self.metrics.plan_identities,
                              self.metrics.plan_identities[1:])
            if a != b)
        self.metrics.rescales = self.elastic.rescales
        self.metrics.workers = self.elastic.workers
        self.metrics.preq = self._collect_op_metrics()
        self.metrics.sla = self.sla.report()
        return self.metrics

    # -- main loop ----------------------------------------------------------
    def run(self, batches, rate_fn: Optional[Callable[[int], float]] = None,
            seed: int = 0, fixed_cut: Optional[int] = None,
            fixed_frontier: Optional[Iterable[str]] = None,
            record_outputs: bool = False) -> JobMetrics:
        """Run the job. ``fixed_cut`` (linear) or ``fixed_frontier`` (DAG)
        pins the partition (reference runs / ablations); otherwise the
        offload controller's plan drives which segment each op executes
        in, re-partitioning on migration."""
        self.begin(rate_fn(0) if rate_fn else 1e4, seed=seed,
                   fixed_cut=fixed_cut, fixed_frontier=fixed_frontier)
        for step, batch in enumerate(batches):
            rate = self.execute_batch(step, batch, record_outputs)
            offered = rate_fn(step) if rate_fn else rate
            d = self.controller.observe(step, offered, self.sla)
            self.apply_decision(step, d)
            self.elastic_step(step, offered, rate)
        return self.finish()
