"""Operator-DAG pipeline IR (S2CE O2): one dataflow graph that the cost
model, placement search, offload controller, and executor all consume, so
a placement decision *is* an execution plan.

An :class:`Op` declares a ``(state, batch) -> (state, batch)`` step
function (``batch`` is a dict of tensors — a pytree), an initial-state
factory, the :class:`~repro_torch.core.costmodel.OperatorCost` profile the
placement optimizer prices it with, and — for DAG composition — its named
I/O channels: the batch keys it ``reads``, ``writes``, and ``deletes``.

An :class:`OpGraph` is a dataflow graph over such ops. Dependency edges
are inferred from the channel declarations (producer -> consumer for each
read key, plus write-after-read/write hazards), so fused sources can fan
out to parallel sketches, samplers, and learners whose outputs rejoin —
the Fig. 2 workflow shapes a linear chain cannot express. The graph is
partitioned at any *downward-closed cut set* ("frontier"): a set of ops
that contains all of its own ancestors runs on the edge, its upward-closed
complement on the cloud, and the cost model prices the uplink per crossing
edge (``out_bytes_per_event`` of each edge-side producer feeding a cloud
consumer) instead of at one cut point.

:class:`Pipeline` is retained as the linear special case: an ordered op
list whose frontiers are exactly the prefix cuts ``ops[:k]``, with the
same ``run(states, batch, cut)`` API, prefix-cut placement, and plan
costs as before — every existing call site keeps working unchanged.

Cut-invariance: in the ``fuse="op"`` mode each op runs its own step
function eagerly and segments compose the *shared* per-op callables, so
an op computes bitwise-identically no matter which segment it lands in —
migrating the frontier never perturbs learner state, and every
downward-closed cut reproduces the unpartitioned reference exactly
(``tests/test_torch_orchestrator.py`` checks every cut). ``OpGraph``
additionally restricts each op's input dict to its declared ``reads``,
so the per-op callable sees the same input signature under every
frontier.

``fuse="xla"`` instead runs each segment as one program, the port's
counterpart of the JAX package's one fused XLA program per segment: on
the card, each ``(segment, batch signature)`` is captured once into a
``torch.cuda.CUDAGraph`` and replayed for every later batch (the same
``compiles``/``cache_hits`` bookkeeping as the reference: a capture is a
compile, a replay of a cached segment a hit). Op boundaries keep op
semantics: the graph replays each op's own kernels, nothing is fused
into a neighbour's arithmetic. The CPU has no graph: there the segment
is the same composition as one callable. A capture that fails raises,
naming the op; there is no fallback to per-op dispatch. Host ops
(``Op.jit=False``) only compose under ``fuse="op"``.

On the card, the drift op's detector scan (every detector) and the hash op
run the port's CUDA kernels (``kernels/ops.py``); the batch ``rng``
channel is a per-step seed, a 0-dim int64 tensor on the batch's device,
which the sample op mixes with each item's index
(``streams/sampling.py``) without a read on the host.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import (Any, Callable, Dict, FrozenSet, Iterable, Iterator, List,
                    Optional, Sequence, Tuple)

import torch

from repro_torch import resolve_device
from repro_torch._tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.core.costmodel import OperatorCost
from repro_torch.kernels import ops as kops
from repro_torch.ml import metrics as mmetrics
from repro_torch.ml import online
from repro_torch.streams import drift as drift_mod
from repro_torch.streams import preprocess as prep
from repro_torch.streams import sampling as samp
from repro_torch.streams import sketches as sk

Batch = Dict[str, torch.Tensor]
StepFn = Callable[[Any, Batch], Tuple[Any, Batch]]


def _no_state():
    return ()


@dataclass(frozen=True)
class Op:
    """One pipeline stage: a ``(state, batch) -> (state, batch)`` fn
    plus the cost profile placement prices it with.

    ``reads``/``writes``/``deletes`` declare the op's named channels —
    the batch keys it consumes, produces, and removes. :class:`OpGraph`
    requires them (they define the dataflow edges); :class:`Pipeline`
    treats an undeclared op conservatively as reading and writing
    everything, which is exactly the linear-chain dependency structure.

    ``on_drift`` (optional) maps state -> state when the orchestrator's
    drift response fires; ``metrics`` (optional) maps state -> dict for
    the Output Interface at end of run.

    ``init`` builds the state on the CPU; :meth:`OpGraph.init_states`
    places it on the job's device.

    ``jit=False`` marks a *host op*, as in the JAX package: an op that
    manages its own device programs and host control flow (the serving
    ops loop over an engine's steps and read their seeds on the host).
    Host ops are only valid under ``fuse="op"``.
    """
    name: str
    fn: StepFn
    cost: OperatorCost
    init: Callable[[], Any] = _no_state
    on_drift: Optional[Callable[[Any], Any]] = None
    metrics: Optional[Callable[[Any], dict]] = None
    reads: Optional[Tuple[str, ...]] = None
    writes: Optional[Tuple[str, ...]] = None
    deletes: Tuple[str, ...] = ()
    jit: bool = True

    def __post_init__(self):
        for f in ("reads", "writes", "deletes"):
            v = getattr(self, f)
            if v is not None and not isinstance(v, tuple):
                object.__setattr__(self, f, tuple(v))


class OpGraph:
    """A dataflow graph of :class:`Op`, executable under any frontier cut.

    Ops are given in a topological list order (the reference execution
    order); every op must declare its channels. Dependencies are inferred
    per key with full hazard analysis over that order:

      * true dependency — the last writer of a key feeds each reader
        (these are the *flow edges* the cost model prices bytes on),
      * anti dependency — a reader must precede the key's next writer,
      * output dependency — writers of the same key stay ordered.

    A *frontier* is a downward-closed op set (every member's dependencies
    are members): the edge-resident part of a partition. Executing the
    edge segment then the cloud segment is then a valid topological
    linearization, so any frontier reproduces the reference bitwise under
    ``fuse="op"``.
    """

    def __init__(self, ops: Sequence[Op], fuse: str = "op"):
        ops = tuple(ops)
        if not ops:
            raise ValueError("graph needs at least one op")
        names = [op.name for op in ops]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate op names: {names}")
        if fuse not in ("op", "xla"):
            raise ValueError(f"fuse mode {fuse!r} not in ('op', 'xla')")
        if fuse == "xla":
            host = [op.name for op in ops if not op.jit]
            if host:
                raise ValueError(
                    f"fuse='xla' cannot fuse host ops (jit=False): {host}; "
                    "host ops manage their own executables and only "
                    "compose under fuse='op'")
        self.ops = ops
        self.fuse = fuse
        self._segments: Dict[tuple, Callable] = {}   # (idxs, sig) -> fn
        # cache misses (a segment composed, or under fuse="xla" on the
        # card captured) and hits (a cached segment run or replayed)
        self.compiles = 0
        self.cache_hits = 0
        # measured per-op costs overriding the declared OperatorCost
        # guesses in costs()
        self._cost_overrides: Dict[str, OperatorCost] = {}
        self._build_deps()

    # -- dependency inference ----------------------------------------------
    def _build_deps(self):
        undeclared = [op.name for op in self.ops
                      if op.reads is None or op.writes is None]
        if undeclared:
            raise ValueError(
                f"OpGraph ops must declare reads/writes channels; missing "
                f"on: {undeclared} (use Pipeline for undeclared linear "
                f"chains)")
        parents: List[set] = [set() for _ in self.ops]
        flow_parents: List[set] = [set() for _ in self.ops]
        flow: set = set()
        last_writer: Dict[str, int] = {}
        readers: Dict[str, set] = {}
        source_reads: List[str] = []
        source_consumers: List[str] = []
        all_writers: Dict[str, int] = {}
        for j, op in enumerate(self.ops):
            for k in op.writes + op.deletes:
                all_writers.setdefault(k, j)
        for j, op in enumerate(self.ops):
            for k in op.reads:
                i = last_writer.get(k)
                if i is None:
                    w = all_writers.get(k)
                    if w is not None and w != j:
                        raise ValueError(
                            f"op {op.name!r} reads channel {k!r} which is "
                            f"only written by the later op "
                            f"{self.ops[w].name!r}; order ops topologically")
                    if k not in source_reads:
                        source_reads.append(k)
                    if op.name not in source_consumers:
                        source_consumers.append(op.name)
                else:
                    parents[j].add(i)
                    flow_parents[j].add(i)
                    flow.add((i, j))
                readers.setdefault(k, set()).add(j)
            for k in op.writes + op.deletes:
                i = last_writer.get(k)
                if i is not None and i != j:
                    parents[j].add(i)              # write-after-write
                for r in readers.get(k, ()):
                    if r != j:
                        parents[j].add(r)          # write-after-read
                last_writer[k] = j
                readers[k] = set()
        self._parents: Tuple[FrozenSet[int], ...] = tuple(
            frozenset(p) for p in parents)
        # the *closure* relation frontier enumeration (and the placement
        # DP) is downward-closed under: identical to the full hazard
        # relation, except that a downlink-ok op drops its flow parents
        # (its inputs may legitimately arrive over a cloud->edge
        # downlink — the evaluator prices that crossing instead of
        # forbidding it). Pure WAR/WAW hazard parents are kept. Graphs
        # without downlink ops have closure == hazard parents, so every
        # existing frontier family is unchanged.
        self._closure: Tuple[FrozenSet[int], ...] = tuple(
            frozenset(p - flow_parents[j])
            if self.ops[j].cost.downlink_ok else frozenset(p)
            for j, p in enumerate(parents))
        self._flow_pairs: Tuple[Tuple[int, int], ...] = tuple(sorted(flow))
        self.flow_edges: Tuple[Tuple[str, str], ...] = tuple(sorted(
            (self.ops[i].name, self.ops[j].name) for i, j in flow))
        self.source_reads = tuple(source_reads)
        self.source_consumers = tuple(source_consumers)

    @property
    def source_bytes_per_event(self) -> float:
        """Raw-event size the source crossing is priced at: the first
        source-consuming op's input traffic (for a chain this is
        ``ops[0].bytes_per_event`` — the linear model's charge)."""
        if not self.source_consumers:
            return 0.0
        return self.cost_of(self.source_consumers[0]).bytes_per_event

    # -- IR views ----------------------------------------------------------
    @property
    def names(self) -> List[str]:
        return [op.name for op in self.ops]

    @property
    def hazard_parent_indices(self) -> Tuple[FrozenSet[int], ...]:
        """Per-op index sets of ALL dependency parents (true flow deps
        plus write-after-read/write hazards) — the full ordering
        relation. For frontier enumeration and the placement DP, use
        :attr:`closure_parent_indices` (equal to this unless an op
        declares ``downlink_ok``)."""
        return self._parents

    @property
    def closure_parent_indices(self) -> Tuple[FrozenSet[int], ...]:
        """The relation :meth:`frontiers` enumerates downward-closed
        sets under and the placement DP enforces: hazard parents, minus
        the flow parents of ``downlink_ok`` ops (those inputs may ride
        the cloud->edge downlink, so the parent need not be
        edge-resident). Every frontier it admits is executable —
        :meth:`run` interleaves sides in list order when a frontier is
        not closed under the full hazard relation."""
        return self._closure

    @property
    def flow_pairs(self) -> Tuple[Tuple[int, int], ...]:
        """The true-dependency edges as (producer idx, consumer idx)
        pairs — the index view of :attr:`flow_edges` (the edges the cost
        model prices bytes on)."""
        return self._flow_pairs

    def count_frontiers(self, limit: Optional[int] = None) -> int:
        """Number of downward-closed frontiers, enumerated lazily and
        capped at ``limit`` (the dispatch heuristic in
        ``placement.place_frontier`` needs "more than N?", never the
        exact — potentially exponential — count)."""
        n = 0
        for _ in self.frontiers():
            n += 1
            if limit is not None and n >= limit:
                break
        return n

    def costs(self) -> List[OperatorCost]:
        """The cost-model view — what placement/offload optimize over.
        Measured overrides (:meth:`set_measured_costs`) win over the
        declared per-op guesses."""
        return [self._cost_overrides.get(op.name, op.cost)
                for op in self.ops]

    def cost_of(self, name: str) -> OperatorCost:
        return self._cost_overrides.get(name) or self.op(name).cost

    def set_measured_costs(
            self, costs: Optional[Dict[str, OperatorCost]]) -> None:
        """Install measured per-op costs so placement optimizes against
        measurement instead of the hand-written declarations. ``None``
        clears back to the declared costs.

        Edge-capability and downlink tolerance are *semantic*
        declarations (model management must stay in the cloud; only a
        decode op designed for it may consume over the downlink), not
        something a dry-run can measure, so the declared flags always
        survive the override."""
        if costs is None:
            self._cost_overrides = {}
            return
        unknown = sorted(set(costs) - set(self.names))
        if unknown:
            raise ValueError(f"measured costs name unknown ops: {unknown}")
        self._cost_overrides = {
            name: replace(c, name=name,
                          edge_capable=self.op(name).cost.edge_capable,
                          downlink_ok=self.op(name).cost.downlink_ok)
            for name, c in costs.items()}

    def init_states(self, device="cuda") -> Dict[str, Any]:
        """Every op's initial state, placed on ``device`` (raises where
        CUDA is not available; pass ``"cpu"`` to run on the CPU)."""
        device = resolve_device(device)
        return {op.name: tree_map(lambda t: _to(t, device), op.init())
                for op in self.ops}

    def op(self, name: str) -> Op:
        for o in self.ops:
            if o.name == name:
                return o
        raise KeyError(name)

    def parents_of(self, name: str) -> FrozenSet[str]:
        i = self.names.index(name)
        return frozenset(self.ops[p].name for p in self._parents[i])

    # -- frontier cuts ------------------------------------------------------
    def check_frontier(self, frontier: Iterable[str]) -> FrozenSet[str]:
        """Validate ``frontier`` is a known, downward-closed op set."""
        f = frozenset(frontier)
        unknown = f - set(self.names)
        if unknown:
            raise ValueError(f"unknown ops in frontier: {sorted(unknown)}")
        idx = {op.name: i for i, op in enumerate(self.ops)}
        for name in f:
            for p in self._closure[idx[name]]:
                if self.ops[p].name not in f:
                    raise ValueError(
                        f"frontier not downward-closed: {name!r} depends on "
                        f"{self.ops[p].name!r} which is not in the frontier")
        return f

    def frontiers(self) -> Iterator[FrozenSet[str]]:
        """Enumerate every downward-closed cut set (edge-side op set)
        under :attr:`closure_parent_indices`. For a chain these are
        exactly the ``n+1`` prefixes; a graph with downlink-ok ops
        additionally admits frontiers whose members receive inputs over
        the cloud->edge downlink (e.g. ``{decode}`` with prefill in the
        cloud)."""
        n = len(self.ops)
        names = self.names
        parents = self._closure

        def rec(i: int, cur: set) -> Iterator[FrozenSet[str]]:
            if i == n:
                yield frozenset(names[j] for j in cur)
                return
            yield from rec(i + 1, cur)          # op i on the cloud side
            if parents[i] <= cur:               # edge only if deps on edge
                cur.add(i)
                yield from rec(i + 1, cur)
                cur.remove(i)

        yield from rec(0, set())

    # -- partitioned execution ---------------------------------------------
    @staticmethod
    def _sig(batch: Batch) -> tuple:
        # channels may carry whole pytrees (a KV cache, a param tree),
        # not just arrays — the signature is treedef + per-leaf
        # shape/dtype, which degenerates to the old (shape, dtype) key
        # for plain array channels.
        out = []
        for k in sorted(batch):
            leaves, treedef = tree_flatten(batch[k])
            out.append((k, str(treedef),
                        tuple((tuple(l.shape), str(l.dtype)) for l in leaves)))
        return tuple(out)

    def _apply(self, i: int, states: Dict[str, Any], env: Batch
               ) -> Tuple[Dict[str, Any], Batch]:
        """Run op ``i`` with channel semantics: feed only its declared
        ``reads`` (the per-op input signature is therefore identical under
        every frontier), merge back only its declared ``writes``, and drop
        its ``deletes``. Every segment holding op ``i`` calls the same
        step, which is what makes frontier migration bitwise-safe."""
        op = self.ops[i]
        inb = {k: env[k] for k in op.reads if k in env}
        st, out = op.fn(states[op.name], inb)
        states[op.name] = st
        if op.deletes:
            env = {k: v for k, v in env.items() if k not in op.deletes}
        else:
            env = dict(env)
        env.update({k: out[k] for k in op.writes if k in out})
        return states, env

    def _fuse_ops(self, idxs: Tuple[int, ...]) -> Callable:
        """The segment as a composition of the shared per-op steps (the
        cut-invariant segment form, and under ``fuse="xla"`` the function
        a CUDA graph captures). ``current``, a one-item list, names the
        op running (None once the segment is done), so a failure can say
        which op it came from."""
        def segment(states: Dict[str, Any], env: Batch, current=None):
            states = dict(states)
            for i in idxs:
                if current is not None:
                    current[0] = self.ops[i].name
                states, env = self._apply(i, states, env)
            if current is not None:
                current[0] = None
            return states, env

        return segment

    def _segment_fn(self, idxs: Tuple[int, ...], batch: Batch) -> Callable:
        """Compose (or fetch) the segment for the op subset ``idxs`` at
        this batch signature — the segment cache, with the same
        ``compiles``/``cache_hits`` bookkeeping as the JAX package. Under
        ``fuse="xla"`` a batch on the card gets a :class:`GraphSegment`
        (captured at its first call, replayed after); on the CPU the
        composition itself runs."""
        key = (idxs, self._sig(batch))
        fn = self._segments.get(key)
        if fn is None:
            fn = self._fuse_ops(idxs)
            if self.fuse == "xla" and any(
                    isinstance(t, torch.Tensor) and t.is_cuda
                    for t in tree_flatten(batch)[0]):
                fn = GraphSegment(fn, tuple(self.ops[i].name for i in idxs))
            self._segments[key] = fn
            self.compiles += 1
        else:
            self.cache_hits += 1
        return fn

    @property
    def graph_segments(self) -> List["GraphSegment"]:
        """The CUDA-graph segments of the cache (``fuse="xla"`` on the
        card), in the order they were first run."""
        return [fn for fn in self._segments.values()
                if isinstance(fn, GraphSegment)]

    def _run_segments(self, states: Dict[str, Any], batch: Batch,
                      segments: Sequence[Tuple[int, ...]],
                      uplink: Optional[Callable[[Batch], Batch]] = None,
                      sides: Optional[Sequence[str]] = None
                      ) -> Tuple[Dict[str, Any], Batch]:
        """Execute ``segments`` in order, applying ``uplink`` (the wire
        codec round-trip) on every *side change*. ``sides`` labels each
        segment "edge"/"cloud"; without it the historical two-segment
        rule applies (first segment edge, the rest cloud). The stream
        source sits on the edge side, so an empty edge segment still
        crosses the wire entering the cloud — the all-cloud plan's
        priced raw-event crossing."""
        if sides is None:
            sides = ["edge"] + ["cloud"] * (len(segments) - 1)
        prev_side = "edge"    # where the stream originates
        for idxs, side in zip(segments, sides):
            if not idxs:
                continue
            if side != prev_side and uplink is not None:
                # the batch crosses the edge<->cloud wire (uplink, or —
                # for downlink-ok consumers — the cloud->edge downlink):
                # apply the link codec's round-trip.
                batch = uplink(batch)
            prev_side = side
            sub = {self.ops[i].name: states[self.ops[i].name] for i in idxs}
            fn = self._segment_fn(tuple(idxs), batch)
            sub, batch = fn(sub, batch)
            states = {**states, **sub}
        return states, batch

    def run(self, states: Dict[str, Any], batch: Batch,
            frontier: Iterable[str] = (),
            uplink: Optional[Callable[[Batch], Batch]] = None
            ) -> Tuple[Dict[str, Any], Batch]:
        """Execute under the downward-closed cut ``frontier``: member ops
        form the edge segment, the rest the cloud segment (either may be
        empty); within each segment ops run in graph list order.
        ``uplink`` (optional) transforms the batch dict where it crosses
        between the sides — the orchestrator passes the SLA-chosen
        uplink codec's wire round-trip here.

        A frontier that is downward-closed under the *full* hazard
        relation runs as the historical two segments (edge then cloud —
        one wire crossing). A frontier admitted only by the relaxed
        closure (downlink-ok ops with cloud-resident flow parents, e.g.
        edge-decode under cloud-prefill) cannot be grouped that way
        without reordering a flow edge, so it executes as maximal
        same-side runs in graph list order — always a valid topological
        linearization — and the wire codec applies on every side
        change, pricing the downlink crossing too."""
        f = self.check_frontier(frontier)
        edge = tuple(i for i, op in enumerate(self.ops) if op.name in f)
        eset = frozenset(edge)
        if all(self._parents[i] <= eset for i in edge):
            cloud = tuple(i for i in range(len(self.ops)) if i not in eset)
            return self._run_segments(states, batch, (edge, cloud), uplink)
        segments: List[List[int]] = []
        sides: List[str] = []
        for i in range(len(self.ops)):
            side = "edge" if i in eset else "cloud"
            if sides and sides[-1] == side:
                segments[-1].append(i)
            else:
                segments.append([i])
                sides.append(side)
        return self._run_segments(
            states, batch, [tuple(s) for s in segments], uplink, sides)

    def run_reference(self, states: Dict[str, Any], batch: Batch
                      ) -> Tuple[Dict[str, Any], Batch]:
        """Unpartitioned execution: every op in one (cloud) segment, in
        graph list order — the composition of the shared per-op steps.
        Any downward-closed cut must reproduce this bitwise."""
        return self.run(states, batch, frontier=())


class GraphSegment:
    """A segment under ``fuse="xla"`` on the card: captured into one
    ``torch.cuda.CUDAGraph`` after its first call and replayed at every
    later call.

    Every leaf of ``(states, batch)`` must be a tensor on one CUDA device
    (a CPU tensor read during capture would be frozen into the graph).
    The first call runs the batch's own work on a side stream, as
    ``fuse="op"`` would (the warm-up ``torch.cuda.graph`` asks for), and
    returns its outputs; the segment is then captured on static copies of
    the leaves. The capture launches nothing, so the kernels' launch
    counts are put back after it; a replay launches every kernel of the
    graph without passing through the wrappers (``replays`` times the
    graph's kernel nodes counts them).

    A later call copies the leaves into the static inputs and replays.
    The replay writes into the same tensors every time, so every output
    that is not a static input comes back as a clone: no state kept
    between batches, handed to another segment or recorded aliases a
    buffer the next replay overwrites. A static input that the segment
    wrote in place (the optimizers update parameters in place) is copied
    back into the caller's leaf, and an output that is a static input
    comes back as the caller's leaf, as under ``fuse="op"``. In-place
    writes are found by the tensors' version counters during capture: the
    port's hand kernels write only into tensors their wrappers make.
    A failing op raises ``RuntimeError`` naming it; nothing falls back to
    per-op dispatch."""

    def __init__(self, segment: Callable, names: Tuple[str, ...]):
        self.segment = segment
        self.names = names
        self.graph = None            # the CUDAGraph, kept to list its nodes
        self.replays = 0
        self.capture_ms = 0.0        # capture, host clock

    @staticmethod
    def _aliases(leaves) -> Tuple[int, ...]:
        """For each leaf, the first position of the same tensor."""
        first: Dict[int, int] = {}
        return tuple(first.setdefault(id(t), i) for i, t in enumerate(leaves))

    def __call__(self, states: Dict[str, Any], env: Batch):
        leaves, treedef = tree_flatten((states, env))
        if self.graph is None:
            return self._first_call(leaves, treedef)
        if treedef != self._in_def or self._aliases(leaves) != self._slots \
                or any((t.shape, t.dtype, t.device)
                       != (s.shape, s.dtype, s.device)
                       for s, t in zip(self._ins, leaves)):
            raise ValueError(f"fuse='xla' segment {list(self.names)}: the "
                             "states' structure, shapes or devices changed "
                             "since the segment was captured")
        for i, (s, t) in enumerate(zip(self._ins, leaves)):
            if self._slots[i] == i:
                s.copy_(t)
        self.graph.replay()
        self.replays += 1
        for i in self._written:
            leaves[i].copy_(self._ins[i])
        return tree_unflatten(self._out_def, [
            o.clone() if j is None else leaves[j]
            for o, j in zip(self._outs, self._out_src)])

    def _fail(self, what: str, current, e: Exception):
        where = (f"op {current[0]!r}" if current[0] is not None
                 else "the end of the segment")
        return RuntimeError(
            f"fuse='xla' segment {list(self.names)}: {what} failed at "
            f"{where} ({type(e).__name__}: {e})")

    def _device(self, leaves) -> torch.device:
        where = {str(t.device) if isinstance(t, torch.Tensor)
                 else type(t).__name__ for t in leaves}
        if len(where) != 1 or not next(iter(where)).startswith("cuda"):
            raise ValueError(
                f"fuse='xla' segment {list(self.names)}: every state and "
                f"batch leaf must be a tensor on one CUDA device; got "
                f"{sorted(where)}")
        return leaves[0].device

    def _first_call(self, leaves, treedef):
        dev = self._device(leaves)
        current = [None]
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        try:
            with torch.cuda.stream(side):
                out = self.segment(*tree_unflatten(treedef, leaves),
                                   current=current)
        except Exception as e:
            raise self._fail("the first run (the warm-up before capture)",
                             current, e) from e
        main.wait_stream(side)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(main)
        t0 = time.perf_counter()
        self._capture(leaves, treedef, dev, current)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        return out

    def _capture(self, leaves, treedef, dev, current) -> None:
        slots = self._aliases(leaves)
        ins = [t.clone() if slots[i] == i else None
               for i, t in enumerate(leaves)]
        ins = [ins[j] for j in slots]
        versions = [s._version for s in ins]
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        counts = kops.launch_counts()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = self.segment(*tree_unflatten(treedef, ins),
                                   current=current)
        except Exception as e:
            raise self._fail("the CUDA-graph capture", current, e) from e
        finally:
            kops.restore_launch_counts(counts)
        outs, out_def = tree_flatten(out)
        host = [i for i, o in enumerate(outs)
                if not (isinstance(o, torch.Tensor) and o.device == dev)]
        if host:
            raise RuntimeError(
                f"fuse='xla' segment {list(self.names)}: {len(host)} output "
                "leaves are not tensors on the card; computed on the host "
                "during capture, they would be frozen into the graph")
        src: Dict[int, int] = {}
        for i, s in enumerate(ins):
            src.setdefault(id(s), i)
        self._in_def, self._slots, self._ins = treedef, slots, ins
        self._written = [i for i, s in enumerate(ins)
                         if slots[i] == i and s._version != versions[i]]
        self._outs, self._out_def = outs, out_def
        self._out_src = [src.get(id(o)) for o in outs]
        self.graph = graph


class Pipeline(OpGraph):
    """An ordered list of :class:`Op`, executable under any prefix cut —
    the linear special case of :class:`OpGraph`.

    The dependency structure is the chain itself (op ``i`` precedes op
    ``i+1``), so frontiers are exactly the prefixes and placement reduces
    to the prefix-cut search; channel declarations are not required, and
    each op receives the full batch dict exactly as before."""

    def __init__(self, ops: Sequence[Op], fuse: str = "op"):
        ops = tuple(ops)
        if not ops:
            raise ValueError("pipeline needs at least one op")
        super().__init__(ops, fuse=fuse)

    def _build_deps(self):
        # a chain: each op depends on its predecessor; bytes flow along
        # consecutive edges and the raw stream enters at ops[0].
        n = len(self.ops)
        self._parents = tuple(frozenset(() if i == 0 else (i - 1,))
                              for i in range(n))
        # prefix cuts only: the linear chain keeps the strict relation
        # even for downlink-ok ops (a non-prefix edge set has no `cut`).
        self._closure = self._parents
        self._flow_pairs = tuple((i, i + 1) for i in range(n - 1))
        self.flow_edges = tuple((self.ops[i].name, self.ops[i + 1].name)
                                for i in range(n - 1))
        self.source_reads = ()
        self.source_consumers = (self.ops[0].name,)

    @property
    def source_bytes_per_event(self) -> float:
        return self.cost_of(self.ops[0].name).bytes_per_event

    @property
    def n_cuts(self) -> int:
        """Valid cuts are 0..len(ops): ops[:k] edge, ops[k:] cloud."""
        return len(self.ops) + 1

    def _apply(self, i: int, states: Dict[str, Any], env: Batch
               ) -> Tuple[Dict[str, Any], Batch]:
        # linear threading: the op sees (and returns) the full batch dict,
        # no channel restriction — byte-compatible with undeclared ops.
        op = self.ops[i]
        st, env = op.fn(states[op.name], env)
        states[op.name] = st
        return states, env

    def run(self, states: Dict[str, Any], batch: Batch, cut: int,
            uplink: Optional[Callable[[Batch], Batch]] = None
            ) -> Tuple[Dict[str, Any], Batch]:
        """Execute under prefix cut ``cut``: ops[:cut] as the edge segment,
        ops[cut:] as the cloud segment (either may be empty). ``uplink``
        (optional) transforms the batch where it crosses the segments —
        the orchestrator's codec hook."""
        if not 0 <= cut <= len(self.ops):
            raise ValueError(f"cut {cut} outside [0, {len(self.ops)}]")
        return self._run_segments(
            states, batch, (tuple(range(0, cut)),
                            tuple(range(cut, len(self.ops)))), uplink)

    def run_reference(self, states: Dict[str, Any], batch: Batch
                      ) -> Tuple[Dict[str, Any], Batch]:
        """Unpartitioned execution: the whole chain as one (cloud) segment
        — the per-op composition at cut 0. Any cut must reproduce this
        bitwise."""
        return self.run(states, batch, cut=0)


# ---------------------------------------------------------------------------
# Standard op wrappers around streams/ and ml/ — the same functions the
# hard-coded orchestrator stages used to call, now declared as IR nodes
# with named channels so they compose into DAGs as well as chains.
# ---------------------------------------------------------------------------

def _ev(dim: int) -> float:
    return 4.0 * dim        # fp32 bytes per event at width `dim`


def _to(t, device):
    return t.to(device) if isinstance(t, torch.Tensor) else t


def normalize_op(dim: int) -> Op:
    """Welford running normalization (edge preprocessing)."""
    def fn(state, batch):
        state, xn = prep.norm_update_apply(state, batch["x"])
        return state, {**batch, "x": xn}
    cost = OperatorCost("normalize", flops_per_event=50 * dim,
                        bytes_per_event=4 * _ev(dim),
                        out_bytes_per_event=_ev(dim))
    return Op("normalize", fn, cost, init=lambda: prep.norm_init(dim),
              reads=("x",), writes=("x",))


def sketch_op(dim: int) -> Op:
    """Streaming moments sketch (edge-side summary; state-only sink)."""
    def fn(state, batch):
        return sk.moments_update(state, batch["x"]), batch
    cost = OperatorCost("sketch", flops_per_event=20 * dim,
                        bytes_per_event=2 * _ev(dim),
                        out_bytes_per_event=_ev(dim))
    return Op("sketch", fn, cost, init=lambda: sk.moments_init(dim),
              reads=("x",), writes=())


def sample_op(dim: int, rate: float, reservoir_k: int = 256) -> Op:
    """Reservoir update + Bernoulli thinning; emits the keep `mask` and
    threads the stream `rng` (a device seed: no host read)."""
    def fn(state, batch):
        state = samp.reservoir_update(state, batch["x"], batch["y"])
        mask, rng = samp.bernoulli_thin(batch["rng"], batch["x"], rate)
        return state, {**batch, "mask": mask, "rng": rng}
    cost = OperatorCost("sample", flops_per_event=20,
                        bytes_per_event=2 * _ev(dim),
                        out_bytes_per_event=_ev(dim) * rate)
    return Op("sample", fn, cost,
              init=lambda: samp.reservoir_init(reservoir_k, dim),
              reads=("x", "y", "rng"), writes=("mask", "rng"))


def logreg_train_op(dim: int, lr: float = 0.5,
                    flops_per_event: float = 2e6) -> Op:
    """Prequential test-then-train online logistic regression. Predicts on
    the full batch, updates on the sampled (masked) rows, and writes the
    per-event error stream for a downstream drift op."""
    def fn(state, batch):
        model, preq = state
        x, y = batch["x"], batch["y"]
        p = online.logreg_predict(model, x)
        err = ((p > 0.5).to(y.dtype) != y).float()
        preq = mmetrics.preq_update(preq, p, y)
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(x.shape[:1], dtype=torch.bool, device=x.device)
        w = mask.float()
        model = online.logreg_update(model, x * w[:, None], y * mask, lr=lr)
        return (model, preq), {**batch, "p": p, "err": err}
    # emits model/metric deltas, not events: the uplink-compressing stage.
    # Cheap rates place it on the edge (a paper-style pre-model); its
    # 2e6 flops/event saturate the edge pool near 1e6 ev/s, which is what
    # pushes the cut down (training offloads to cloud) under rate spikes.
    cost = OperatorCost("train", flops_per_event=flops_per_event,
                        bytes_per_event=20 * _ev(dim),
                        out_bytes_per_event=8.0)
    return Op("train", fn, cost,
              init=lambda: (online.logreg_init(dim), mmetrics.preq_init()),
              on_drift=lambda s: (online.logreg_reset_soft(s[0]), s[1]),
              metrics=lambda s: mmetrics.preq_metrics(s[1]),
              reads=("x", "y", "mask"), writes=("p", "err"))


def drift_op(detector: str = "ddm") -> Op:
    """Concept-drift detection over the op-emitted error stream. Model
    management is a cloud concern, so this op is not edge-capable (it
    also anchors at least one stage on the cloud pool). Every detector
    (DDM, EDDM, Page-Hinkley, ADWIN) scans the batch with the
    ``detector_scan`` kernel on the card, one launch a batch."""
    init_fn = {
        "ddm": drift_mod.ddm_init,
        "eddm": drift_mod.eddm_init,
        "ph": drift_mod.ph_init,
        "adwin": drift_mod.adwin_init,
    }[detector]

    def fn(state, batch):
        state, drifted = kops.detector_scan(detector, state, batch["err"])
        return state, {**batch, "drifted": drifted}
    cost = OperatorCost("drift", flops_per_event=50, bytes_per_event=64,
                        out_bytes_per_event=8, edge_capable=False)
    return Op("drift", fn, cost, init=init_fn,
              reads=("err",), writes=("drifted",))


# -- scenario-diversity ops -------------------------------------------------

def hash_op(dim: int, seed: int = 17) -> Op:
    """Signed feature hashing: sparse (ids, vals) -> dense x."""
    def fn(state, batch):
        x = prep.hash_features(batch["ids"], batch["vals"], dim, seed=seed)
        out = {k: v for k, v in batch.items() if k not in ("ids", "vals")}
        return state, {**out, "x": x}
    cost = OperatorCost("hash", flops_per_event=10 * dim,
                        bytes_per_event=2 * _ev(dim),
                        out_bytes_per_event=_ev(dim))
    return Op("hash", fn, cost,
              reads=("ids", "vals"), writes=("x",), deletes=("ids", "vals"))


def pca_op(dim: int, k: int, lr: float = 1e-2, seed: int = 0) -> Op:
    """Streaming PCA (Oja's rule): project x from `dim` to `k` dims."""
    def fn(state, batch):
        state, z = prep.oja_update_project(state, batch["x"], lr=lr)
        return state, {**batch, "x": z}
    cost = OperatorCost("pca", flops_per_event=4 * dim * k,
                        bytes_per_event=6 * _ev(dim),
                        out_bytes_per_event=4.0 * k)
    return Op("pca", fn, cost, init=lambda: prep.oja_init(dim, k, seed),
              reads=("x",), writes=("x",))


def concat_op(key: str, out_dim: int) -> Op:
    """Concatenate a fused column (e.g. a WindowJoin output) onto x —
    the fusion-fed pipeline entry point."""
    def fn(state, batch):
        x = torch.cat([batch["x"], batch[key]], dim=-1)
        out = {k: v for k, v in batch.items() if k != key}
        return state, {**out, "x": x}
    cost = OperatorCost("concat", flops_per_event=2 * out_dim,
                        bytes_per_event=2 * _ev(out_dim),
                        out_bytes_per_event=_ev(out_dim))
    return Op("concat", fn, cost,
              reads=("x", key), writes=("x",), deletes=(key,))


def anomaly_op(dim: int, m: int = 8, seed: int = 0) -> Op:
    """Random-projection histogram anomaly scorer; writes `score`."""
    def fn(state, batch):
        state = online.anomaly_update(state, batch["x"])
        score = online.anomaly_score(state, batch["x"])
        return state, {**batch, "score": score}
    cost = OperatorCost("anomaly", flops_per_event=2 * dim * m,
                        bytes_per_event=4 * _ev(dim),
                        out_bytes_per_event=4.0)
    return Op("anomaly", fn, cost,
              init=lambda: online.anomaly_init(dim, m=m, seed=seed),
              reads=("x",), writes=("score",))


def alert_op(threshold: float = 3.0) -> Op:
    """Rejoin head: fuses the anomaly branch's `score` with the learner
    branch's `drifted` flag into a per-batch `alert` — the downstream
    consumer a fan-out graph re-converges on."""
    def fn(state, batch):
        hot = (batch["score"] > threshold).float().mean()
        alert = torch.logical_or(hot > 0.5, batch["drifted"])
        return state, {**batch, "alert": alert}
    cost = OperatorCost("alert", flops_per_event=4, bytes_per_event=16,
                        out_bytes_per_event=1.0)
    return Op("alert", fn, cost, reads=("score", "drifted"),
              writes=("alert",))


def standard_stream_pipeline(dim: int, sample_rate: float = 0.5,
                             drift_detector: str = "ddm",
                             reservoir_k: int = 256,
                             fuse: str = "op") -> Pipeline:
    """The default S2CE job: normalize -> sketch -> sample -> train -> drift
    (the op-graph form of the orchestrator's stages).

    ``fuse="op"`` keeps every cut bitwise-identical to the reference —
    required when the placement migrates live state. ``fuse="xla"`` runs
    each segment as one CUDA graph on the card (one callable on the
    CPU): allclose to ``fuse="op"``, as the reference's fused segments
    are."""
    return Pipeline([
        normalize_op(dim),
        sketch_op(dim),
        sample_op(dim, sample_rate, reservoir_k),
        logreg_train_op(dim),
        drift_op(drift_detector),
    ], fuse=fuse)


def fanout_stream_graph(dim: int, sample_rate: float = 0.5,
                        drift_detector: str = "ddm",
                        reservoir_k: int = 256,
                        anomaly_threshold: float = 3.0,
                        fuse: str = "op") -> OpGraph:


    """The Fig. 2 fan-out/rejoin workflow a linear pipeline cannot express:

    ::

        normalize ──> sketch                      (summary branch)
              ├─────> anomaly ──────────┐         (scoring branch)
              └─────> sample -> train -> drift    (learner branch)
                                 score │  │ drifted
                                       └──┴─> alert

    The normalized stream fans out to a moments sketch, an anomaly
    scorer, and a sample->train->drift learner chain; the anomaly and
    learner branches rejoin at the alert head. Because the branches are
    dependency-independent, a frontier cut can keep e.g. `anomaly` on
    the edge while `train` offloads to the cloud — an assignment no
    prefix cut of any op ordering can produce.

    ``fuse`` as in :func:`standard_stream_pipeline`."""
    return OpGraph([
        normalize_op(dim),
        sketch_op(dim),
        anomaly_op(dim),
        sample_op(dim, sample_rate, reservoir_k),
        logreg_train_op(dim),
        drift_op(drift_detector),
        alert_op(anomaly_threshold),
    ], fuse=fuse)
