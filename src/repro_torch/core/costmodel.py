"""Analytic cost model + cluster topology API shared by the placement
optimizer, the offload controller, and the self-tuner (S2CE O1/O2 "smart
resource management"). Its chip constants (``launch/roofline.py``) are
the modelled cluster's, kept identical to the JAX package's so that both
packages place the same pipeline the same way.

Resources are heterogeneous pools (cloud pods, edge nodes); a
:class:`ClusterSpec` names any number of them and the directed
:class:`Link` objects between them (bandwidth, latency, and the uplink
codec compressing bytes on that link); operators are stream-pipeline
stages with per-event flops/bytes/output-bytes costs.

DAG plan latency is the **critical path** over the op DAG: each op
contributes its compute latency, each crossing flow edge the latency of
the link it rides. For a linear chain the critical path is the whole
chain (one path), so chain plans price identically to the historical
per-op sum — the parity the tests pin down.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

from repro_torch.launch.roofline import HBM_BW, LINK_BW, PEAK_FLOPS


@dataclass(frozen=True)
class Resource:
    name: str
    kind: str                  # "cloud" | "edge"
    chips: int = 1
    flops: float = PEAK_FLOPS  # per chip
    mem_bw: float = HBM_BW
    mem_cap: float = 16e9
    net_bw: float = LINK_BW    # to the next hop (edge->cloud uplink for edge)
    net_latency: float = 1e-3  # seconds per hop
    energy_w: float = 200.0    # watts per chip (coarse; drives O2 decisions)

    @property
    def total_flops(self) -> float:
        return self.chips * self.flops


# The cost model's modelled-cluster presets: an edge node and a cloud pod
# as the placement search prices them. Numerically identical to the JAX
# package's presets so plans match; they are not measurements of any chip.
EDGE_NODE = Resource("edge", "edge", chips=1, flops=2e12, mem_bw=50e9,
                     mem_cap=4e9, net_bw=1e9, net_latency=20e-3, energy_w=15.0)
CLOUD_POD = Resource("cloud", "cloud", chips=256, flops=PEAK_FLOPS,
                     mem_bw=HBM_BW, mem_cap=16e9, net_bw=LINK_BW,
                     net_latency=0.2e-3, energy_w=250.0)


@dataclass(frozen=True)
class Link:
    """A directed network link between two named pools.

    ``codec`` names the :class:`~repro_torch.core.codecs.UplinkCodec` that
    compresses every byte shipped over this link — plans price crossings
    at ``codec.wire_bytes(payload)`` and the orchestrator applies the
    same codec to tensors that actually cross at runtime.

    ``energy_per_byte`` (joules per *wire* byte; radio/NIC transmit
    energy) is priced into the plan's energy aggregate: every crossing
    adds ``wire_bytes * rate * energy_per_byte`` watts, so placement can
    trade latency against uplink energy. The default 0.0 is bitwise
    neutral — links that don't declare it price exactly as before.
    """
    src: str
    dst: str
    bw: float                  # bytes/s
    latency: float             # seconds per message
    codec: str = "identity"
    energy_per_byte: float = 0.0   # J per wire byte (0.0 = unpriced)

    def wire_bytes(self, raw_bytes: float) -> float:
        from repro_torch.core.codecs import get_codec
        return get_codec(self.codec).wire_bytes(raw_bytes)


class ClusterSpec(Mapping):
    """First-class cluster topology: named :class:`Resource` pools (any
    number of edge pools and cloud pods) plus explicit directed
    :class:`Link` objects between them.

    The spec is a ``Mapping[str, Resource]`` over its pools, so legacy
    call sites that iterate a flat resource dict keep working unchanged;
    every cost/placement entry point coerces through :meth:`of`, which
    wraps a plain dict in a spec with *derived default links*: for any
    ``(src, dst)`` pair without a declared link, bandwidth is the slower
    side's ``net_bw`` and latency the slower side's ``net_latency`` —
    exactly the historical "charge the slow side" rule, so a wrapped
    two-pool dict prices identically to the old flat-dict model.

    ``version`` is the topology generation stamp: a static spec stays at
    0 forever; a :class:`~repro_torch.core.membership.MembershipDirectory`
    bumps it on every join/leave/failure/probe so consumers can tell a
    re-derived snapshot from the one their plan was priced under.
    Derived specs (:meth:`with_uplink_codec`, :meth:`residual`) carry
    their base's version — they re-price the SAME topology generation.
    """

    def __init__(self, pools: Union[Dict[str, Resource], Sequence[Resource]],
                 links: Iterable[Link] = (), *, version: int = 0):
        self.version = int(version)
        if isinstance(pools, Mapping):
            self.pools: Dict[str, Resource] = dict(pools)
        else:
            seq = tuple(pools)
            self.pools = {r.name: r for r in seq}
            if len(self.pools) != len(seq):
                raise ValueError("duplicate pool names in ClusterSpec")
        self._links: Dict[Tuple[str, str], Link] = {}
        for ln in links:
            for end in (ln.src, ln.dst):
                if end not in self.pools:
                    raise ValueError(f"link {ln.src}->{ln.dst} references "
                                     f"unknown pool {end!r}")
            try:    # fail at construction, not deep inside cost evaluation
                from repro_torch.core.codecs import get_codec
                get_codec(ln.codec)
            except KeyError as e:
                raise ValueError(
                    f"link {ln.src}->{ln.dst}: {e.args[0]}") from None
            self._links[(ln.src, ln.dst)] = ln

    # -- construction helpers ----------------------------------------------
    @classmethod
    def of(cls, resources: Union["ClusterSpec", Dict[str, Resource]]
           ) -> "ClusterSpec":
        """Coerce a flat ``{name: Resource}`` dict (the deprecated two-pool
        style) or an existing spec into a ClusterSpec."""
        if isinstance(resources, cls):
            return resources
        return cls(dict(resources))

    @classmethod
    def edge_cloud(cls, edge: Resource = EDGE_NODE,
                   cloud: Resource = CLOUD_POD) -> "ClusterSpec":
        """The classic one-edge/one-cloud topology (back-compat shim for
        pre-ClusterSpec call sites; prefer declaring pools + links)."""
        return cls({edge.name: edge, cloud.name: cloud})

    # -- Mapping interface over pools --------------------------------------
    def __getitem__(self, name: str) -> Resource:
        return self.pools[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self.pools)

    def __len__(self) -> int:
        return len(self.pools)

    # -- topology views -----------------------------------------------------
    @property
    def links(self) -> Tuple[Link, ...]:
        return tuple(self._links.values())

    def pools_of_kind(self, kind: str) -> List[Resource]:
        return [r for r in self.pools.values() if r.kind == kind]

    @property
    def edge_pools(self) -> List[Resource]:
        return self.pools_of_kind("edge")

    @property
    def cloud_pools(self) -> List[Resource]:
        return self.pools_of_kind("cloud")

    def default_source(self) -> str:
        """Where the stream originates: the first edge pool (S2CE ingests
        at the edge gateway), or "" when the spec has no edge pools."""
        edges = self.edge_pools
        return edges[0].name if edges else ""

    def link(self, src: str, dst: str) -> Link:
        """The declared link ``src -> dst``, or the derived default: the
        slower endpoint's ``net_bw``/``net_latency`` and the identity
        codec (the historical charge-the-slow-side rule).

        An unknown endpoint raises ``ValueError`` naming the missing
        pool AND the known pool set — under membership churn a stale
        plan's pool name must fail loudly here, not as an ambiguous
        ``KeyError`` deep inside a cost evaluation."""
        ln = self._links.get((src, dst))
        if ln is not None:
            return ln
        for end in (src, dst):
            if end not in self.pools:
                raise ValueError(
                    f"link {src}->{dst}: unknown pool {end!r} (known "
                    f"pools: {sorted(self.pools)}); the pool may have "
                    "deregistered or failed since this plan was priced")
        a, b = self.pools[src], self.pools[dst]
        # strict <: on equal net_bw the historical rule charged the
        # destination side (``prev if prev.net_bw < res.net_bw else res``)
        slow = a if a.net_bw < b.net_bw else b
        return Link(src, dst, bw=slow.net_bw, latency=slow.net_latency)

    def with_uplink_codec(self, codec: str,
                          override: bool = False) -> "ClusterSpec":
        """A copy of this spec with ``codec`` attached to every
        edge<->cloud wire — the edge->cloud uplink AND the cloud->edge
        downlink, which carries ``downlink_ok`` traffic (the KV cache of
        a cloud-prefill/edge-decode split) and must price the same codec
        the runtime wire round-trip applies on that crossing. Declared
        links keep their bw/latency; missing ones are materialized from
        the derived defaults. This is how the SLA-chosen codec is
        attached to the topology. Edge<->edge and cloud<->cloud links
        are never touched.

        By default only links that don't already declare a lossy codec
        are rewritten — a user's per-link codec declaration wins over
        the blanket choice; pass ``override=True`` to replace those too.
        """
        links = dict(self._links)
        for e in self.edge_pools:
            for c in self.cloud_pools:
                for src, dst in ((e.name, c.name), (c.name, e.name)):
                    ln = self.link(src, dst)
                    if override or ln.codec == "identity":
                        links[(src, dst)] = replace(ln, codec=codec)
        return ClusterSpec(self.pools, links.values(), version=self.version)

    def without_pool(self, name: str) -> "ClusterSpec":
        """The topology with ``name`` (and every link touching it)
        removed and the version bumped — how a consumer derives the
        candidate set AFTER a pool left or failed, so the dead pool is
        excluded before any placement search runs."""
        if name not in self.pools:
            raise ValueError(
                f"without_pool: unknown pool {name!r} (known pools: "
                f"{sorted(self.pools)})")
        pools = {n: r for n, r in self.pools.items() if n != name}
        links = [ln for ln in self._links.values()
                 if name not in (ln.src, ln.dst)]
        return ClusterSpec(pools, links, version=self.version + 1)

    def residual(self,
                 pool_load: Optional[Mapping] = None,
                 link_load: Optional[Mapping] = None,
                 pool_state_bytes: Optional[Mapping] = None
                 ) -> "ClusterSpec":
        """A derived spec pricing a tenant against **residual** capacity
        — the heart of multi-tenant fleet scheduling (core/fleet): other
        tenants' reservations shrink what this tenant's placement search
        may assume, so ``evaluate_graph_plan`` on the residual spec
        prices against what is actually left, not the whole cluster.

        * ``pool_load``: ``{pool: fraction}`` of each pool's original
          compute/memory bandwidth already reserved. The pool's per-chip
          ``flops`` and ``mem_bw`` scale by ``1 - fraction`` — a tenant
          sharing a pool gets a proportional slice, so its utilization,
          compute latency, and energy all price at the fair-share rate,
          and ``utilization > 1`` on the residual pool is exactly
          "does not fit in what is left".
        * ``link_load``: ``{(src, dst): bytes_per_second}`` of wire
          bandwidth already reserved per directed link. The link's ``bw``
          drops by that amount (undeclared pairs are materialized from
          the derived defaults first), so link feasibility on the
          residual spec encodes the shared-capacity split.
        * ``pool_state_bytes``: ``{pool: bytes}`` of resident state
          other tenants hold on the pool; shrinks ``mem_cap``.

        Zero/absent loads return the pool and link objects *unchanged*
        (not merely equal), so a fleet of one tenant prices bitwise
        identically to the standalone spec.
        """
        pool_load = dict(pool_load or {})
        link_load = dict(link_load or {})
        state = dict(pool_state_bytes or {})
        for name in (*pool_load, *state):
            if name not in self.pools:
                raise ValueError(f"residual: unknown pool {name!r}")
        pools: Dict[str, Resource] = {}
        for name, r in self.pools.items():
            f = pool_load.get(name, 0.0)
            sb = state.get(name, 0.0)
            if f < -1e-9 or f > 1.0 + 1e-9:
                raise ValueError(
                    f"residual: pool {name!r} load {f:.4g} not in [0, 1]")
            if f <= 0.0 and sb <= 0.0:
                pools[name] = r
                continue
            # a fully-reserved pool keeps an epsilon share: placement
            # then prices any op there as over-capacity (infeasible)
            # instead of dividing by zero
            share = max(1.0 - f, 1e-9)
            pools[name] = replace(
                r, flops=r.flops * share, mem_bw=r.mem_bw * share,
                mem_cap=max(r.mem_cap - sb / max(r.chips, 1), 0.0))
        links: Dict[Tuple[str, str], Link] = dict(self._links)
        for key in link_load:
            src, dst = key
            if src not in self.pools or dst not in self.pools:
                raise ValueError(f"residual: unknown link {src}->{dst}")
            if key not in links:
                links[key] = self.link(src, dst)
        out = []
        for key, ln in links.items():
            b = link_load.get(key, 0.0)
            out.append(replace(ln, bw=max(ln.bw - b, 1e-9)) if b > 0.0
                       else ln)
        return ClusterSpec(pools, out, version=self.version)

    def __repr__(self) -> str:
        pools = ", ".join(f"{n}:{r.kind}" for n, r in self.pools.items())
        return (f"ClusterSpec(v{self.version}; {pools}; "
                f"{len(self._links)} declared links)")


ResourcesLike = Union[ClusterSpec, Dict[str, Resource]]


@dataclass(frozen=True)
class OperatorCost:
    """Per-event costs of a pipeline stage."""
    name: str
    flops_per_event: float
    bytes_per_event: float          # memory traffic
    out_bytes_per_event: float      # bytes emitted downstream
    state_bytes: float = 0.0        # resident state
    edge_capable: bool = True       # some stages (full DL train) are not
    # True -> this op may consume a cloud-resident producer from an edge
    # pool: the cloud->edge crossing is priced as a normal (costed) link
    # hop instead of being marked infeasible backhaul. This is a semantic
    # declaration like edge_capable — a decode op explicitly designed to
    # receive its KV-cache over the downlink (cloud-prefill/edge-decode)
    # sets it; stream analytics ops never should.
    downlink_ok: bool = False


def stage_time(op: OperatorCost, res: Resource, rate: float) -> float:
    """Seconds-per-second of stream time spent by `op` on `res` at `rate`
    events/s (utilization; >1 means the stage cannot keep up)."""
    t_compute = op.flops_per_event * rate / res.total_flops
    t_memory = op.bytes_per_event * rate / (res.mem_bw * res.chips)
    return max(t_compute, t_memory)


def transfer_time(bytes_per_event: float, rate: float, res: Resource) -> float:
    return bytes_per_event * rate / res.net_bw


def op_placement_terms(op: OperatorCost, res: Resource, rate: float
                       ) -> Tuple[float, float, float]:
    """The per-(op, pool) scalars every placement evaluation accumulates:
    ``(utilization, node compute latency, energy watts)``. Shared by
    :func:`evaluate_graph_plan` and the placement DP
    (:func:`repro_torch.core.placement.place_frontier_dp`) so the two paths
    price an op on a pool with bit-identical arithmetic — the DP's
    incremental bookkeeping must reproduce the evaluator's numbers, not
    merely approximate them."""
    u = stage_time(op, res, rate)
    return u, op.flops_per_event / res.total_flops, u * res.energy_w * res.chips


@dataclass
class PipelinePlan:
    """Assignment of each stage to a resource + derived metrics."""
    assignment: Dict[str, str]            # op name -> pool name
    utilization: Dict[str, float] = field(default_factory=dict)
    latency_s: float = 0.0
    uplink_utilization: float = 0.0       # bottleneck link utilization
    link_utilization: Dict[Tuple[str, str], float] = field(
        default_factory=dict)             # per directed link
    energy_w: float = 0.0
    feasible: bool = True
    notes: List[str] = field(default_factory=list)
    # the blanket uplink codec this plan was priced under when the codec
    # is part of the plan search (placement.frontier_plans codecs=...);
    # None -> whatever the ClusterSpec's links declare
    uplink_codec: Optional[str] = None


def evaluate_plan(ops: List[OperatorCost], assign: Dict[str, str],
                  resources: ResourcesLike, rate: float,
                  source: Optional[str] = None) -> PipelinePlan:
    """Evaluate a linear pipeline: stage order = list order; data crosses
    the network wherever consecutive stages sit on different pools, priced
    on the connecting :class:`Link` (codec-compressed bytes, link latency).

    ``source`` names the pool the stream *originates* at — by default the
    spec's first edge pool (S2CE ingests at the edge gateway), so an
    all-cloud plan pays the raw-event uplink instead of getting it for
    free. Without this charge every placement degenerates to all-cloud
    and the cut never moves. Pass ``source=""`` to disable (data already
    at rest in the cloud).
    """
    spec = ClusterSpec.of(resources)
    if source is None:
        source = spec.default_source()
    plan = PipelinePlan(dict(assign))
    latency = 0.0
    energy = 0.0
    link_bytes: Dict[Tuple[str, str], float] = {}
    per_res_util: Dict[str, float] = {r: 0.0 for r in spec}
    prev = source if source else None
    in_bytes = ops[0].bytes_per_event if ops else 0.0
    for op in ops:
        rname = assign[op.name]
        res = spec.pools[rname]
        if not op.edge_capable and res.kind == "edge":
            plan.feasible = False
            plan.notes.append(f"{op.name} not edge-capable")
        u = stage_time(op, res, rate)
        per_res_util[rname] = per_res_util.get(rname, 0.0) + u
        latency += op.flops_per_event / res.total_flops
        energy += u * res.energy_w * res.chips
        if prev is not None and prev != rname:
            ln = spec.link(prev, rname)
            wire = ln.wire_bytes(in_bytes)
            link_bytes[(prev, rname)] = (link_bytes.get((prev, rname), 0.0)
                                         + wire)
            latency += ln.latency
            energy += wire * rate * ln.energy_per_byte
        in_bytes = op.out_bytes_per_event
        prev = rname
        if op.state_bytes > res.mem_cap * res.chips:
            plan.feasible = False
            plan.notes.append(f"{op.name} state exceeds {rname} memory")
    plan.utilization = per_res_util
    plan.latency_s = latency
    plan.link_utilization = {
        key: b * rate / spec.link(*key).bw for key, b in link_bytes.items()}
    plan.uplink_utilization = (max(plan.link_utilization.values())
                               if plan.link_utilization else 0.0)
    plan.energy_w = energy
    return _finalize_capacity(plan)


def _finalize_capacity(plan: PipelinePlan) -> PipelinePlan:
    for r, u in plan.utilization.items():
        if u > 1.0:
            plan.feasible = False
            plan.notes.append(f"{r} over capacity ({u:.2f})")
    for (src, dst), u in plan.link_utilization.items():
        if u > 1.0:
            plan.feasible = False
            plan.notes.append(f"link {src}->{dst} over capacity ({u:.2f})")
    return plan


@dataclass(frozen=True)
class MigrationCost:
    """The one-shot price of moving resident op state at replan time."""
    seconds: float = 0.0
    bytes: float = 0.0
    moves: Tuple[Tuple[str, str, str], ...] = ()   # (op, src pool, dst pool)


def migration_cost(ops: List[OperatorCost],
                   old_assign: Mapping, new_assign: Mapping,
                   resources: ResourcesLike) -> MigrationCost:
    """Price the state transfer a plan change implies: every op whose pool
    changed ships its ``state_bytes`` over the old->new :class:`Link`
    (plus one link-latency hop per moved op). State moves *raw* — learner
    params/opt-state and KV caches must arrive bit-exact, so the link's
    lossy stream codec does not apply to migration traffic.

    Ops present in only one of the two assignments (a job being admitted
    or drained) move no state. A move *off a pool that has already left
    the spec* (crash/deregistration replans) is recorded but priced at
    zero wire cost: there is nothing left to ship — the op restarts from
    checkpoint at the destination. The offload controller attaches this
    to every repartition decision so a migration's amortization against
    the steady-state win is visible, not implicit."""
    spec = ClusterSpec.of(resources)
    seconds = 0.0
    total = 0.0
    moves: List[Tuple[str, str, str]] = []
    for op in ops:
        src = old_assign.get(op.name)
        dst = new_assign.get(op.name)
        if src is None or dst is None or src == dst:
            continue
        moves.append((op.name, src, dst))
        if src not in spec.pools or dst not in spec.pools:
            continue
        ln = spec.link(src, dst)
        total += op.state_bytes
        seconds += op.state_bytes / ln.bw + ln.latency
    return MigrationCost(seconds, total, tuple(moves))


def evaluate_graph_plan(ops: List[OperatorCost],
                        edges: Sequence[Tuple[str, str]],
                        assign: Dict[str, str],
                        resources: ResourcesLike, rate: float,
                        source: Optional[str] = None,
                        source_consumers: Sequence[str] = (),
                        source_bytes: Optional[float] = None
                        ) -> PipelinePlan:
    """Evaluate an operator *DAG* over a :class:`ClusterSpec`: ``edges``
    are the dataflow edges ``(producer, consumer)``, given with ``ops``
    in topological list order; bytes cross the network on every edge
    whose endpoints sit on different pools, priced at the producer's
    ``out_bytes_per_event`` compressed by the crossing :class:`Link`'s
    codec — per crossing edge, not at one cut point. A producer feeding
    several consumers on the same remote pool ships its output once per
    link (multicast), so crossings are grouped by ``(producer, remote
    pool)``. Link *bandwidth* feasibility is tracked per directed link
    (``link_utilization``; ``uplink_utilization`` reports the bottleneck
    link).

    Plan latency is the **critical path** of the op DAG: each op node
    weighs its compute latency, each crossing edge adds the latency of
    the link it rides, and the plan's latency is the longest source-to-
    sink path. Parallel branches therefore overlap instead of summing —
    and a linear chain (one path) reproduces the historical per-op-sum
    price exactly, which keeps chain plans parity-identical to
    :func:`evaluate_plan`.

    ``source`` names the pool the stream originates at (default: the
    spec's first edge pool); ``source_consumers`` are the ops that read
    raw-stream channels no op produces, and the raw event
    (``source_bytes``) is shipped once to every remote pool one of them
    sits on — an all-cloud plan pays the raw-event uplink.

    Backhaul is not a supported data path: a flow edge from a cloud pool
    down to an edge pool (routing a high-rate stream back over the
    constrained link so a *slower* node can consume it) marks the plan
    infeasible — unless the consumer declares
    ``OperatorCost.downlink_ok``, in which case the crossing is a
    legitimate *downlink* (cloud-prefill/edge-decode serving) and is
    priced like any other hop. The edge-resident set of any feasible
    assignment is therefore downward-closed under the graph's *closure*
    relation (flow parents of downlink-ok consumers excluded), which is
    what makes the frontier search (over frontiers x within-kind pool
    choices) provably complete against the exhaustive oracle.
    """
    spec = ClusterSpec.of(resources)
    if source is None:
        source = spec.default_source()
    by_name = {op.name: op for op in ops}
    plan = PipelinePlan(dict(assign))
    energy = 0.0
    per_res_util: Dict[str, float] = {r: 0.0 for r in spec}
    node_lat: Dict[str, float] = {}
    for op in ops:
        rname = assign[op.name]
        res = spec.pools[rname]
        if not op.edge_capable and res.kind == "edge":
            plan.feasible = False
            plan.notes.append(f"{op.name} not edge-capable")
        u, lat, e = op_placement_terms(op, res, rate)
        per_res_util[rname] = per_res_util.get(rname, 0.0) + u
        node_lat[op.name] = lat
        energy += e
        if op.state_bytes > res.mem_cap * res.chips:
            plan.feasible = False
            plan.notes.append(f"{op.name} state exceeds {rname} memory")
    # -- network: bytes per crossing (grouped per (producer, remote pool)
    # for multicast), bandwidth per directed link, codec-compressed ------
    link_bytes: Dict[Tuple[str, str], float] = {}

    def ship(src: str, dst: str, raw_bytes: float):
        nonlocal energy
        ln = spec.link(src, dst)
        wire = ln.wire_bytes(raw_bytes)
        link_bytes[(src, dst)] = link_bytes.get((src, dst), 0.0) + wire
        energy += wire * rate * ln.energy_per_byte

    source_hop: Dict[str, float] = {}    # consumer pool -> entry latency
    if source:
        sb = (source_bytes if source_bytes is not None else
              max((by_name[c].bytes_per_event for c in source_consumers),
                  default=0.0))
        for rname in sorted({assign[c] for c in source_consumers
                             if assign[c] != source}):
            ship(source, rname, sb)
            source_hop[rname] = spec.link(source, rname).latency
    crossings = sorted({(p, assign[c]) for p, c in edges
                        if assign[p] != assign[c]})
    # a cloud->edge flow crossing is backhaul (infeasible) unless the
    # CONSUMER declares downlink_ok — then it is a legitimate downlink
    # (cloud-prefill/edge-decode) and prices like any other hop below
    backhaul = sorted({(p, assign[c]) for p, c in edges
                       if assign[p] != assign[c]
                       and spec.pools[assign[p]].kind == "cloud"
                       and spec.pools[assign[c]].kind == "edge"
                       and not by_name[c].downlink_ok})
    for p, rname in backhaul:
        plan.feasible = False
        plan.notes.append(f"backhaul {p}->{rname} (cloud->edge) "
                          "not supported")
    for p, rname in crossings:
        ship(assign[p], rname, by_name[p].out_bytes_per_event)
    # -- latency: critical path over (node compute + crossing-link hops).
    # ops is in topological order, so one forward sweep suffices.
    finish: Dict[str, float] = {}
    parents: Dict[str, List[str]] = {}
    for p, c in edges:
        parents.setdefault(c, []).append(p)
    src_consumers = set(source_consumers)
    for op in ops:
        start = 0.0
        if source and op.name in src_consumers:
            start = source_hop.get(assign[op.name], 0.0)
        for p in parents.get(op.name, ()):
            t = finish.get(p, node_lat.get(p, 0.0))
            if assign[p] != assign[op.name]:
                t += spec.link(assign[p], assign[op.name]).latency
            start = max(start, t)
        finish[op.name] = start + node_lat[op.name]
    plan.utilization = per_res_util
    plan.latency_s = max(finish.values()) if finish else 0.0
    plan.link_utilization = {
        key: b * rate / spec.link(*key).bw for key, b in link_bytes.items()}
    plan.uplink_utilization = (max(plan.link_utilization.values())
                               if plan.link_utilization else 0.0)
    plan.energy_w = energy
    return _finalize_capacity(plan)
