"""Operator placement across heterogeneous cloud/edge pools (S2CE O2).

Placement of a stream pipeline onto heterogeneous resources is NP-hard
(§2.3 [17]); the tractable structure is the *downward-closed cut*: in
any feasible assignment the edge-resident op set contains all of its own
ancestors, because a cloud op feeding an edge op would route a high-rate
stream back over the constrained link (backhaul — infeasible by the cost
model). Ops declaring ``OperatorCost.downlink_ok`` relax this per
consumer: their cloud->edge crossing is a priced *downlink* (cloud-
prefill/edge-decode serving), so closure is taken under
``OpGraph.closure_parent_indices`` — identical to the full hazard
relation everywhere else. For a linear chain the downward-closed sets
are the prefixes, so
:func:`place` searches all prefix cuts exactly (unchanged from the
linear IR); for an operator DAG over a :class:`ClusterSpec` there are
two engines behind :func:`place_frontier`:

  * **enumeration** (:func:`frontier_plans`): every downward-closed
    *frontier* of the graph x every within-kind pool assignment
    (frontier ops across edge pools, the complement across cloud pods)
    x every codec candidate — which covers exactly the backhaul-free
    assignments, so the search provably matches the exhaustive all-
    assignments oracle (:func:`place_graph_exhaustive`). Exponential in
    op count: the differential-test twin, not the production path.
  * **dynamic program** (:func:`place_frontier_dp`): a label-correcting
    DP over topological prefixes of the frontier lattice. Ops are placed
    one at a time in graph order; a label carries exactly the state the
    cost model's forward sweep needs (per-pool utilization, per-link
    bytes, finish times of ops that still feed unplaced consumers,
    per-producer shipped-pool sets for multicast dedup, energy) and
    labels that agree on the *discrete* part of that state (the live
    frontier signature) are pruned by Pareto dominance over the
    continuous part — sound because every aggregate enters the score and
    the feasibility checks monotonically. An admissible lower bound
    against a greedy incumbent prunes further. The DP returns a
    cost-identical plan to the enumeration on every DAG (property-tested
    against the oracle) at polynomial label counts on the chain-like
    graphs real jobs are, which lifts the search ceiling from ~7 ops to
    100+ ops x dozens of pools (the ``dag_place_dp_*`` benchmark rows).

Both engines share one canonical tie-break — (score, |frontier|, codec
faithfulness, pool-index tuple) — so equal-cost optima resolve
identically and a controller switching engines does not phantom-migrate.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import (Dict, FrozenSet, Iterator, List, Optional, Sequence,
                    Tuple)

from repro_torch.core.costmodel import (ClusterSpec, OperatorCost, PipelinePlan,
                                  Resource, ResourcesLike,
                                  evaluate_graph_plan, evaluate_plan,
                                  op_placement_terms)


@dataclass
class Objective:
    latency_weight: float = 1.0
    energy_weight: float = 0.0
    uplink_weight: float = 0.2

    def score(self, plan: PipelinePlan) -> float:
        if not plan.feasible:
            return float("inf")
        return (self.latency_weight * plan.latency_s
                + self.energy_weight * plan.energy_w * 1e-3
                + self.uplink_weight * plan.uplink_utilization)


def edge_cloud_pools(resources: ResourcesLike
                     ) -> Tuple[Resource, Resource]:
    """The (edge, cloud) pool pair two-pool placement runs over.

    .. deprecated::
        This is the thin back-compat shim for the flat two-pool world:
        it collapses a :class:`ClusterSpec` (or legacy resource dict) to
        the *first* pool of each kind, ignoring any further pools and
        their links — calling it emits a ``DeprecationWarning``. New
        code should pass a ``ClusterSpec`` to :func:`place_frontier`,
        which places across every pool. The prefix-cut engine
        (:func:`place`/:func:`prefix_cut_plans`) still collapses through
        the same rule internally (it IS the two-pool engine) without
        warning on every replan.

    Raises a clear ``ValueError`` when either kind is missing — instead
    of the bare ``StopIteration`` a ``next()`` over an ill-formed
    resource dict used to surface.
    """
    import warnings
    warnings.warn(
        "edge_cloud_pools is the deprecated two-pool shim: it collapses "
        "the topology to the FIRST pool of each kind, ignoring further "
        "pools and their links; pass the ClusterSpec to place_frontier "
        "instead", DeprecationWarning, stacklevel=2)
    return _first_edge_cloud(resources)


def _first_edge_cloud(resources: ResourcesLike
                      ) -> Tuple[Resource, Resource]:
    """The collapse rule behind :func:`edge_cloud_pools`, warning-free
    for the prefix-cut engine's own use."""
    spec = ClusterSpec.of(resources)
    edges, clouds = spec.edge_pools, spec.cloud_pools
    if not edges or not clouds:
        kinds = sorted({r.kind for r in spec.values()})
        raise ValueError(
            "prefix-cut placement needs at least one 'edge' and one "
            f"'cloud' pool; resource dict has kinds {kinds or '(empty)'}")
    return edges[0], clouds[0]


def stale_pools(assignment: Dict[str, str], resources: ResourcesLike
                ) -> List[str]:
    """The pools ``assignment`` references that no longer exist in
    ``resources`` (sorted). Non-empty means membership churn removed a
    pool out from under the plan — the controller must replan (and may
    never silently hold) before the next batch executes."""
    spec = ClusterSpec.of(resources)
    return sorted({p for p in assignment.values() if p not in spec.pools})


def prefix_cut_plans(ops: List[OperatorCost], resources: ResourcesLike,
                     rate: float):
    """All plans of the form: stages[:k] on edge, stages[k:] on cloud.
    Two-pool only (first pool of each kind, the deprecated
    :func:`edge_cloud_pools` collapse rule)."""
    edge, cloud = _first_edge_cloud(resources)
    for k in range(len(ops) + 1):
        assign = {op.name: (edge.name if i < k else cloud.name)
                  for i, op in enumerate(ops)}
        yield k, evaluate_plan(ops, assign, resources, rate)


def place(ops: List[OperatorCost], resources: ResourcesLike,
          rate: float, objective: Optional[Objective] = None
          ) -> Tuple[PipelinePlan, int]:
    """Best prefix-cut placement. Returns (plan, cut_index)."""
    objective = objective or Objective()
    best, best_k, best_score = None, 0, float("inf")
    for k, plan in prefix_cut_plans(ops, resources, rate):
        s = objective.score(plan)
        if s < best_score:
            best, best_k, best_score = plan, k, s
    if best is None or not best.feasible:
        # all-cloud fallback (always structurally valid; may still be
        # infeasible under extreme rates — caller must check .feasible)
        _, cloud = _first_edge_cloud(resources)
        assign = {op.name: cloud.name for op in ops}
        best = evaluate_plan(ops, assign, resources, rate)
        best_k = 0
    return best, best_k


def _check_state_count(what: str, n_pools: int, n_ops: int,
                       max_states: int) -> None:
    """Guard an exhaustive oracle against silently hanging: the state
    count is pools**ops, compared in log space so the estimate itself
    cannot overflow."""
    if n_pools <= 1 or n_ops == 0:
        return
    if n_ops * math.log(n_pools) > math.log(max_states):
        est10 = n_ops * math.log10(n_pools)
        raise ValueError(
            f"{what} would enumerate {n_pools}^{n_ops} (~1e{est10:.0f}) "
            f"assignments, over the max_states={max_states} cap; it is "
            "an exhaustive test oracle — use place/place_frontier for "
            "real problem sizes, or raise max_states explicitly")


def place_exhaustive(ops: List[OperatorCost], resources: ResourcesLike,
                     rate: float, objective: Optional[Objective] = None,
                     *, max_states: int = 1_000_000) -> PipelinePlan:
    """Oracle: try every assignment (exponential; tests only). Refuses
    inputs whose ``pools**ops`` state count exceeds ``max_states``."""
    objective = objective or Objective()
    names = list(ClusterSpec.of(resources))
    _check_state_count("place_exhaustive", len(names), len(ops), max_states)
    best, best_score = None, float("inf")
    for combo in itertools.product(names, repeat=len(ops)):
        assign = {op.name: r for op, r in zip(ops, combo)}
        plan = evaluate_plan(ops, assign, resources, rate)
        s = objective.score(plan)
        if s < best_score:
            best, best_score = plan, s
    return best


# ---------------------------------------------------------------------------
# DAG placement: frontier (downward-closed) cuts over an OpGraph, with
# multi-pool assignment within each side of the cut
# ---------------------------------------------------------------------------

def _graph_plan(graph, assign: Dict[str, str],
                resources: ResourcesLike, rate: float) -> PipelinePlan:
    return evaluate_graph_plan(
        graph.costs(), graph.flow_edges, assign, resources, rate,
        source_consumers=graph.source_consumers,
        source_bytes=graph.source_bytes_per_event)


def _frontier_assignments(names: List[str], frontier: FrozenSet[str],
                          edge_names: List[str], cloud_names: List[str]
                          ) -> Iterator[Dict[str, str]]:
    """Every assignment that realizes ``frontier``: each frontier op on
    one of the edge pools, each complement op on one of the cloud pods.
    With one pool of each kind this yields exactly one assignment (the
    classic two-pool cut)."""
    f_ops = [n for n in names if n in frontier]
    c_ops = [n for n in names if n not in frontier]
    for e_combo in itertools.product(edge_names, repeat=len(f_ops)):
        base = dict(zip(f_ops, e_combo))
        for c_combo in itertools.product(cloud_names, repeat=len(c_ops)):
            assign = dict(base)
            assign.update(zip(c_ops, c_combo))
            yield assign


def _codec_specs(spec: ClusterSpec, codecs: Optional[Sequence[str]]
                 ) -> List[Tuple[Optional[str], ClusterSpec]]:
    """The (codec name, spec-with-that-uplink-codec) pairs a codec-aware
    search prices. ``codecs=None`` -> the spec as declared (one entry,
    codec ``None``). A user-declared per-link lossy codec is preserved
    (``with_uplink_codec`` default), so the blanket candidate fills only
    undeclared uplinks.

    Candidates are ordered most-faithful-first (by (error_bound, ratio))
    and deduplicated on their *effective* per-uplink codec signature:
    when user-declared link codecs make several blanket candidates
    produce the identical priced topology, only the most faithful name
    survives — the search prices each distinct plan once instead of once
    per admitted candidate, and score ties resolve toward lossless no
    matter what order the caller passed."""
    if codecs is None:
        return [(None, spec)]
    from repro_torch.core.codecs import get_codec
    pairs = [(c, spec.with_uplink_codec(c)) for c in codecs]

    def faithfulness(pair):
        try:
            codec = get_codec(pair[0])
        except KeyError as e:
            raise ValueError(str(e.args[0])) from None
        return (codec.error_bound, codec.ratio, codec.name)

    pairs.sort(key=faithfulness)
    uplinks = [(e.name, c.name) for e in spec.edge_pools
               for c in spec.cloud_pools]
    out: List[Tuple[Optional[str], ClusterSpec]] = []
    seen = set()
    for cname, cspec in pairs:
        sig = tuple(cspec.link(e, c).codec for e, c in uplinks)
        if sig not in seen:
            seen.add(sig)
            out.append((cname, cspec))
    return out


def frontier_plans(graph, resources: ResourcesLike, rate: float,
                   objective: Optional[Objective] = None,
                   codecs: Optional[Sequence[str]] = None
                   ) -> Iterator[Tuple[FrozenSet[str], PipelinePlan]]:
    """For every downward-closed frontier of ``graph``: the best plan
    (under ``objective``) over all within-kind pool assignments — the
    frontier across the spec's edge pools, its complement across the
    cloud pods. For a one-edge/one-cloud spec each frontier has exactly
    one assignment, so this degenerates to the classic two-pool frontier
    enumeration (and, for a linear :class:`~repro_torch.core.pipeline.Pipeline`,
    to :func:`prefix_cut_plans`).

    ``codecs`` makes the uplink codec a searched plan dimension: each
    candidate name is attached to the spec's uplinks
    (:meth:`~repro_torch.core.costmodel.ClusterSpec.with_uplink_codec`) and
    the winning plan per frontier is the best (pool-assignment, codec)
    pair, with ``plan.uplink_codec`` recording the codec it was priced
    under. Candidates are searched most-faithful-first regardless of the
    order passed, and duplicates that price to the identical plan are
    collapsed (see :func:`_codec_specs`), so score ties (e.g. a frontier
    with no uplink crossing) always resolve toward lossless. Ties within
    a frontier break canonically on the pool-index tuple — the same
    order :func:`place_frontier_dp` uses.
    """
    spec = ClusterSpec.of(resources)
    objective = objective or Objective()
    edges, clouds = spec.edge_pools, spec.cloud_pools
    if not edges or not clouds:
        kinds = sorted({r.kind for r in spec.values()})
        raise ValueError(
            "frontier placement needs at least one 'edge' and one 'cloud' "
            f"pool; ClusterSpec has kinds {kinds or '(empty)'}")
    e_names = [r.name for r in edges]
    c_names = [r.name for r in clouds]
    names = graph.names
    specs = _codec_specs(spec, codecs)
    pidx = {name: i for i, name in enumerate(spec)}
    for frontier in graph.frontiers():
        best, best_key = None, None
        for assign in _frontier_assignments(names, frontier,
                                            e_names, c_names):
            ptup = tuple(pidx[assign[n]] for n in names)
            for rank, (cname, cspec) in enumerate(specs):
                plan = _graph_plan(graph, assign, cspec, rate)
                plan.uplink_codec = cname
                key = (objective.score(plan), rank, ptup)
                if best is None or key < best_key:
                    best, best_key = plan, key
        yield frontier, best


def _enumeration_plans(graph, n_edge: int, n_cloud: int,
                       limit: float) -> Optional[float]:
    """Number of (frontier x within-kind pool assignment) plans the
    enumeration engine would price, or None as soon as the running total
    passes ``limit`` (both the frontier walk and the arithmetic stop
    early, so the estimate is cheap even on graphs with exponentially
    many frontiers)."""
    n = len(graph.names)
    total = 0.0
    for f in graph.frontiers():
        k = len(f)
        total += float(n_edge) ** k * float(n_cloud) ** (n - k)
        if total > limit:
            return None
    return total


def _all_cloud_fallback(graph, spec: ClusterSpec, rate: float,
                        objective: Objective,
                        codecs: Optional[Sequence[str]]
                        ) -> Tuple[PipelinePlan, FrozenSet[str]]:
    """The empty frontier on the first pod — always structurally valid;
    may still be infeasible under extreme rates (caller must check
    ``.feasible``). Shared by both search engines so an infeasible
    instance degrades identically whichever engine ran."""
    cloud = spec.cloud_pools[0]
    assign = {name: cloud.name for name in graph.names}
    fb, fb_key = None, None
    for rank, (cname, cspec) in enumerate(_codec_specs(spec, codecs)):
        plan = _graph_plan(graph, assign, cspec, rate)
        plan.uplink_codec = cname
        key = (objective.score(plan), rank)
        if fb is None or key < fb_key:
            fb, fb_key = plan, key
    return fb, frozenset()


def place_frontier(graph, resources: ResourcesLike, rate: float,
                   objective: Optional[Objective] = None,
                   codecs: Optional[Sequence[str]] = None,
                   *, method: str = "auto",
                   enumerate_limit: int = 20_000,
                   max_labels: int = 4096
                   ) -> Tuple[PipelinePlan, FrozenSet[str]]:
    """Best frontier-cut placement of an operator DAG over a
    :class:`ClusterSpec` — multi-pool: each frontier side may split
    across the pools of its kind, priced per crossing link with
    codec-compressed bytes. With ``codecs`` the winning plan is the best
    (frontier, pool-assignment, codec) triple and ``plan.uplink_codec``
    names the codec it was priced under. Returns ``(plan, frontier)``
    where ``frontier`` is the edge-resident op set (``plan.assignment``
    holds the per-op pool detail).

    ``method`` selects the engine: ``"enumerate"`` (the exhaustive
    frontier x pool-product x codec walk), ``"dp"``
    (:func:`place_frontier_dp` — cost-identical, polynomial on real
    graphs), or ``"auto"`` (default): enumerate while the priced-plan
    estimate stays within ``enumerate_limit``, DP above it — small
    graphs keep the historical code path exactly, big graphs stop being
    exponential."""
    objective = objective or Objective()
    spec = ClusterSpec.of(resources)
    edges, clouds = spec.edge_pools, spec.cloud_pools
    if not edges or not clouds:
        kinds = sorted({r.kind for r in spec.values()})
        raise ValueError(
            "frontier placement needs at least one 'edge' and one 'cloud' "
            f"pool; ClusterSpec has kinds {kinds or '(empty)'}")
    if method not in ("auto", "enumerate", "dp"):
        raise ValueError(f"method {method!r} not in ('auto', 'enumerate', "
                         "'dp')")
    if method == "auto":
        n_codecs = max(len(codecs), 1) if codecs else 1
        n_plans = _enumeration_plans(graph, len(edges), len(clouds),
                                     limit=enumerate_limit / n_codecs)
        method = "enumerate" if n_plans is not None else "dp"
    if method == "dp":
        return place_frontier_dp(graph, spec, rate, objective, codecs,
                                 max_labels=max_labels)
    specs = _codec_specs(spec, codecs)
    rank_of = {cname: r for r, (cname, _) in enumerate(specs)}
    pidx = {name: i for i, name in enumerate(spec)}
    best, best_f, best_key = None, frozenset(), None
    for frontier, plan in frontier_plans(graph, spec, rate, objective,
                                         codecs=codecs):
        key = (objective.score(plan), len(frontier),
               rank_of.get(plan.uplink_codec, 0),
               tuple(pidx[plan.assignment[n]] for n in graph.names))
        if best is None or key < best_key:
            best, best_f, best_key = plan, frontier, key
    if best is None or not best.feasible:
        best, best_f = _all_cloud_fallback(graph, spec, rate, objective,
                                           codecs)
    return best, best_f


# ---------------------------------------------------------------------------
# the DP engine: label-correcting search over topological prefixes of
# the frontier lattice with exact dominance + admissible-bound pruning
# ---------------------------------------------------------------------------

_EMPTY_FS: FrozenSet[int] = frozenset()

# Per-bucket Pareto-front width cap inside the DP sweep. Fronts past
# this size are near-tie clouds (e.g. many near-identical pods), where
# the best-bound prefix is what matters; the cap bounds the dominance
# sweep at O(labels x cap) and trips the `truncated` flag when hit.
_BUCKET_CAP = 64


def _dp_tables(graph, spec: ClusterSpec, rate: float):
    """Per-(op, pool) and per-(pool, pool) constants the DP transitions
    read: cost terms via the SAME :func:`op_placement_terms` arithmetic
    the evaluator uses, link latency/bandwidth/codec-ratio matrices, and
    the dependency structure (hazard parents for closure, flow edges for
    bytes and the critical path, retirement indices for the live-set
    signature)."""
    from repro_torch.core.codecs import get_codec
    costs = graph.costs()
    n = len(costs)
    pools = list(spec.values())
    P = len(pools)
    kinds = [r.kind for r in pools]
    pool_names = [r.name for r in pools]
    util = [[0.0] * P for _ in range(n)]
    lat = [[0.0] * P for _ in range(n)]
    eng = [[0.0] * P for _ in range(n)]
    ok = [[True] * P for _ in range(n)]
    for j, op in enumerate(costs):
        for p, res in enumerate(pools):
            u, l, e = op_placement_terms(op, res, rate)
            util[j][p], lat[j][p], eng[j][p] = u, l, e
            if ((not op.edge_capable and res.kind == "edge")
                    or op.state_bytes > res.mem_cap * res.chips
                    or u > 1.0):
                ok[j][p] = False
    latm = [[0.0] * P for _ in range(P)]
    bwm = [[1.0] * P for _ in range(P)]
    ratm = [[1.0] * P for _ in range(P)]
    epbm = [[0.0] * P for _ in range(P)]
    for a in range(P):
        for b in range(P):
            if a == b:
                continue
            ln = spec.link(pool_names[a], pool_names[b])
            latm[a][b] = ln.latency
            bwm[a][b] = ln.bw
            ratm[a][b] = get_codec(ln.codec).ratio
            epbm[a][b] = ln.energy_per_byte
    # the closure relation: full hazard parents, minus flow parents of
    # downlink-ok ops (their inputs may ride the cloud->edge downlink —
    # priced as a ship below, not forbidden by the edge gate). Graphs
    # without downlink ops have closure == hazard parents.
    haz = getattr(graph, "closure_parent_indices",
                  graph.hazard_parent_indices)
    flow_parents: List[List[int]] = [[] for _ in range(n)]
    flow_children: List[List[int]] = [[] for _ in range(n)]
    for i, j in graph.flow_pairs:
        flow_parents[j].append(i)
        flow_children[i].append(j)
    # last_flow[i]: once the DP passes this index, op i's finish time and
    # shipped-pool set can retire from the label (no more ships / path
    # extensions from i). last_need[i]: once passed, op i's POOL also
    # stops mattering (no future hazard child constrains on it) and i
    # drops from the live signature entirely.
    last_flow = [max(cs) if cs else i for i, cs in enumerate(flow_children)]
    last_need = list(last_flow)
    for j in range(n):
        for i in haz[j]:
            if j > last_need[i]:
                last_need[i] = j
    name_idx = {nm: i for i, nm in enumerate(graph.names)}
    src_set = {name_idx[c] for c in graph.source_consumers}
    sidx = pool_names.index(spec.default_source())
    return {
        "n": n, "P": P, "kinds": kinds, "pool_names": pool_names,
        "util": util, "lat": lat, "eng": eng, "ok": ok,
        "latm": latm, "bwm": bwm, "ratm": ratm, "epbm": epbm,
        "haz": haz, "flow_parents": flow_parents,
        "flow_children": flow_children,
        "last_flow": last_flow, "last_need": last_need,
        "src_set": src_set, "last_src": max(src_set, default=-1),
        "sidx": sidx, "sb": graph.source_bytes_per_event,
        "out_bytes": [c.out_bytes_per_event for c in costs],
    }


def _dp_pass(t: dict, rate: float, objective: Objective, incumbent: float,
             beam: Optional[int], max_labels: int, agg: dict):
    """One label-correcting sweep over the op order. A label is::

        (assign_t, energy, lat_dead, max_link_util,
         pool_util, link_bytes, finish, shipped, src_shipped, bound)

    with dict aggregates keyed by pool/link/op index. ``beam=1`` is the
    greedy warm-start (cheapest-bound label per step), ``beam=None`` the
    exact sweep. Returns the surviving final labels (possibly empty)."""
    n, P = t["n"], t["P"]
    kinds, util, lat, eng, ok = (t["kinds"], t["util"], t["lat"], t["eng"],
                                 t["ok"])
    latm, bwm, ratm, epbm = t["latm"], t["bwm"], t["ratm"], t["epbm"]
    haz, flow_parents, flow_children = (t["haz"], t["flow_parents"],
                                        t["flow_children"])
    last_flow, last_need = t["last_flow"], t["last_need"]
    src_set, last_src, sidx, sb = (t["src_set"], t["last_src"], t["sidx"],
                                   t["sb"])
    out_bytes = t["out_bytes"]
    lw, ew, uw = (objective.latency_weight, objective.energy_weight,
                  objective.uplink_weight)
    # incumbent slack: DP link-byte accumulation order differs from the
    # evaluator's (ulp-level drift), so a hard cutoff at the incumbent
    # could shave an exactly-optimal label
    inc_eff = incumbent * (1.0 + 1e-9) + 1e-12

    # suffix minimum energy (admissible energy completion) and deepest
    # min-pool downstream compute path per op (admissible latency tail)
    rem_e = [0.0] * (n + 1)
    down = [0.0] * n
    for j in range(n - 1, -1, -1):
        cheapest = min(eng[j][p] for p in range(P) if ok[j][p])
        rem_e[j] = rem_e[j + 1] + cheapest
        down[j] = (min(lat[j][p] for p in range(P) if ok[j][p])
                   + max((down[c] for c in flow_children[j]), default=0.0))

    labels = [((), 0.0, 0.0, 0.0, {}, {}, {}, {},
               _EMPTY_FS if src_set else None, 0.0)]
    for j in range(n):
        okj, utj, latj, engj = ok[j], util[j], lat[j], eng[j]
        f_par = flow_parents[j]
        hazj = haz[j]
        has_children = bool(flow_children[j])
        is_src = j in src_set
        live = [i for i in range(j + 1) if last_need[i] > j]
        live_flow = [i for i in live if last_flow[i] > j]
        tails = {i: max((down[c] for c in flow_children[i] if c > j),
                        default=0.0) for i in live_flow}
        cands: list = []
        n_expanded = 0
        for lab in labels:
            (assign_t, energy, lat_dead, maxlu, utild, linkd, fin,
             shipped, srcsh, _) = lab
            for p in range(P):
                if not okj[p]:
                    continue
                if kinds[p] == "edge":
                    # closure-downward gate: an edge-resident op needs
                    # every closure parent edge-resident (which rules out
                    # cloud->edge backhaul on flow edges — except into
                    # downlink-ok consumers, whose flow parents are not
                    # closure parents and whose downlink crossing is
                    # priced as a normal ship below)
                    if any(kinds[assign_t[i]] != "edge" for i in hazj):
                        continue
                nu = utild.get(p, 0.0) + utj[p]
                if nu > 1.0:
                    continue
                # --- scalar phase: price the transition without copying
                # any aggregate dict; most candidates die here -----------
                nmaxlu = maxlu
                ships = {}        # link key -> new total bytes
                ship_e = 0.0      # link transmit energy of the new ships
                start = 0.0
                src_ships = is_src and p != sidx and p not in srcsh
                if src_ships:
                    nb = linkd.get((sidx, p), 0.0) + ratm[sidx][p] * sb
                    lu = nb * rate / bwm[sidx][p]
                    if lu > 1.0:
                        continue
                    if lu > nmaxlu:
                        nmaxlu = lu
                    ships[(sidx, p)] = nb
                    ship_e += ratm[sidx][p] * sb * rate * epbm[sidx][p]
                if is_src and p != sidx:
                    start = latm[sidx][p]
                overrun = False
                crossed = []
                for i in f_par:
                    q = assign_t[i]
                    if q != p and p not in shipped[i]:
                        lk = (q, p)
                        nb = (ships.get(lk, linkd.get(lk, 0.0))
                              + ratm[q][p] * out_bytes[i])
                        lu = nb * rate / bwm[q][p]
                        if lu > 1.0:
                            overrun = True
                            break
                        if lu > nmaxlu:
                            nmaxlu = lu
                        ships[lk] = nb
                        ship_e += (ratm[q][p] * out_bytes[i] * rate
                                   * epbm[q][p])
                        crossed.append(i)
                if overrun:
                    continue
                for i in f_par:
                    ti = fin[i]
                    q = assign_t[i]
                    if q != p:
                        ti += latm[q][p]
                    if ti > start:
                        start = ti
                fj = start + latj[p]
                nen = energy + engj[p] + ship_e
                nlat_dead = lat_dead
                for i in f_par:
                    if last_flow[i] == j:
                        ti = fin[i]
                        if ti > nlat_dead:
                            nlat_dead = ti
                if not has_children and fj > nlat_dead:
                    nlat_dead = fj
                # admissible bound: finished critical path so far + the
                # cheapest-pool downstream tails, suffix-min energy, and
                # the (monotone) bottleneck link seen so far
                b_lat = nlat_dead
                for i in live_flow:
                    ti = (fj if i == j else fin[i]) + tails[i]
                    if ti > b_lat:
                        b_lat = ti
                bound = (lw * b_lat + ew * (nen + rem_e[j + 1]) * 1e-3
                         + uw * nmaxlu)
                if bound > inc_eff:
                    continue
                # survivor: record (parent, pool, deltas) — the dict
                # aggregates are materialized only if the candidate is
                # actually kept after the dominance sweep
                key_live = tuple(
                    (i,
                     p if i == j else assign_t[i],
                     (_EMPTY_FS if has_children else None) if i == j
                     else (shipped[i] | {p} if i in crossed
                           else shipped.get(i)))
                    for i in live)
                cands.append(((key_live, srcsh), bound, assign_t, p, lab,
                              nu, fj, nen, nlat_dead, nmaxlu, ships,
                              crossed))
                n_expanded += 1
        agg["labels_expanded"] += n_expanded
        # Pareto-dominance pruning within each bucket: labels agreeing on
        # the discrete live signature compare on the continuous
        # aggregates, every one of which enters the score/feasibility
        # monotonically — a dominated label cannot lead anywhere its
        # dominator cannot lead at least as cheaply. Candidates are
        # processed best-bound-first (ties by pool tuple, so full ties
        # keep the canonically smallest assignment); because the bound is
        # itself monotone in the compared aggregates, a dominator always
        # sorts no later than its victims and a one-directional check
        # against the kept front suffices. The width cap (``beam`` /
        # ``max_labels``) and per-bucket front cap turn the sweep into a
        # best-bound beam on inputs whose fronts outgrow them — flagged
        # via ``truncated``, never silent.
        cands.sort(key=lambda c: (c[1], c[2], c[3]))
        cap = beam if beam is not None else max_labels
        buckets: Dict[tuple, list] = {}
        labels = []
        overflow = False
        for cand in cands:
            if len(labels) >= cap:
                overflow = True
                break
            (key, bound, assign_t, p, lab, nu, fj, nen, nlat_dead,
             nmaxlu, ships, crossed) = cand
            front = buckets.get(key)
            if front is None:
                front = buckets[key] = []
            elif len(front) >= _BUCKET_CAP:
                overflow = True
                continue
            utild, linkd, fin = lab[4], lab[5], lab[6]
            dominated = False
            for f in front:
                if (f[1] <= nen and f[2] <= nlat_dead
                        and all(f[6][i] <= (fj if i == j else fin[i])
                                for i in live_flow)
                        and all(v <= (nu if q == p
                                      else utild.get(q, 0.0))
                                for q, v in f[4].items())
                        and all(v <= ships.get(l, linkd.get(l, 0.0))
                                for l, v in f[5].items())):
                    dominated = True
                    break
            if dominated:
                continue
            # --- materialize the kept label -----------------------------
            shipped, srcsh = lab[7], lab[8]
            nlink = dict(linkd) if ships else linkd
            nlink.update(ships)
            nsrcsh = srcsh
            if is_src:
                if p != sidx and p not in srcsh:
                    nsrcsh = nsrcsh | {p}
                if j == last_src:
                    nsrcsh = None
            nfin = dict(fin)
            nshipped = dict(shipped)
            if has_children:
                nfin[j] = fj
                nshipped[j] = _EMPTY_FS
            for i in crossed:
                nshipped[i] = nshipped[i] | {p}
            for i in f_par:
                if last_flow[i] == j:
                    del nfin[i]
                    del nshipped[i]
            nutil = dict(utild)
            nutil[p] = nu
            new_lab = (assign_t + (p,), nen, nlat_dead, nmaxlu, nutil,
                       nlink, nfin, nshipped, nsrcsh, bound)
            front.append(new_lab)
            labels.append(new_lab)
        if overflow and beam is None:
            # the exact sweep hit a cap: the result is a valid plan but
            # optimality is no longer certified
            agg["truncated"] = True
        if len(labels) > agg["labels_peak"]:
            agg["labels_peak"] = len(labels)
        if not labels:
            return []
    return labels


def _dp_final_key(lab, kinds, lw, ew, uw):
    """Selection key over completed labels — the same canonical order
    the enumeration engine uses: (score, |frontier|, pool tuple)."""
    score = lw * lab[2] + ew * lab[1] * 1e-3 + uw * lab[3]
    n_edge = sum(1 for p in lab[0] if kinds[p] == "edge")
    return (score, n_edge, lab[0])


def place_frontier_dp(graph, resources: ResourcesLike, rate: float,
                      objective: Optional[Objective] = None,
                      codecs: Optional[Sequence[str]] = None,
                      *, max_labels: int = 4096,
                      stats: Optional[dict] = None
                      ) -> Tuple[PipelinePlan, FrozenSet[str]]:
    """Polynomial placement over the frontier lattice: the label DP (see
    module docstring) run once per codec candidate, warm-started by its
    own greedy pass and by the best exact score of earlier candidates
    (most-faithful-first, so ties resolve identically to the
    enumeration). Returns ``(plan, frontier)`` exactly like
    :func:`place_frontier`; the winning assignment is re-priced through
    :func:`~repro_torch.core.costmodel.evaluate_graph_plan`, so the returned
    plan is the evaluator's own numbers, not the DP's bookkeeping.

    ``max_labels`` is the per-step label-front width. While the pruned
    fronts fit (every differential-test graph does, by orders of
    magnitude), the sweep is exhaustive over non-dominated labels and
    the result is provably optimal; past it the sweep degrades to a
    best-bound beam of that width — deliberately, never silently:
    ``stats`` (optional dict) receives the diagnostics (``labels_peak``,
    ``labels_expanded``, and ``truncated``, which is True iff any width
    or per-bucket cap clipped an exact sweep, i.e. iff optimality is no
    longer certified). Runtime is O(ops x max_labels x pools) either
    way — the polynomial envelope the exponential enumeration lacked."""
    spec = ClusterSpec.of(resources)
    objective = objective or Objective()
    edges, clouds = spec.edge_pools, spec.cloud_pools
    if not edges or not clouds:
        kinds = sorted({r.kind for r in spec.values()})
        raise ValueError(
            "frontier placement needs at least one 'edge' and one 'cloud' "
            f"pool; ClusterSpec has kinds {kinds or '(empty)'}")
    lw, ew, uw = (objective.latency_weight, objective.energy_weight,
                  objective.uplink_weight)
    edge_names = {r.name for r in edges}
    pidx = {name: i for i, name in enumerate(spec)}
    agg = {"labels_peak": 0, "labels_expanded": 0, "truncated": False}
    best, best_f, best_key = None, frozenset(), None
    incumbent = float("inf")
    for rank, (cname, cspec) in enumerate(_codec_specs(spec, codecs)):
        t = _dp_tables(graph, cspec, rate)
        if any(not any(row) for row in t["ok"]):
            continue            # some op fits no pool: nothing feasible
        inc = incumbent
        greedy = _dp_pass(t, rate, objective, inc, 1, max_labels, agg)
        if greedy:
            gk = min(_dp_final_key(lab, t["kinds"], lw, ew, uw)
                     for lab in greedy)
            inc = min(inc, gk[0])
        final = _dp_pass(t, rate, objective, inc, None, max_labels, agg)
        if not final:
            continue
        win = min(final, key=lambda lab: _dp_final_key(
            lab, t["kinds"], lw, ew, uw))
        assign = {graph.names[i]: t["pool_names"][p]
                  for i, p in enumerate(win[0])}
        plan = _graph_plan(graph, assign, cspec, rate)
        plan.uplink_codec = cname
        s = objective.score(plan)
        frontier = frozenset(nm for nm, r in assign.items()
                             if r in edge_names)
        key = (s, len(frontier), rank,
               tuple(pidx[assign[nm]] for nm in graph.names))
        if best is None or key < best_key:
            best, best_f, best_key = plan, frontier, key
        if s < incumbent:
            incumbent = s
    if stats is not None:
        stats.update(agg)
    if best is None or not best.feasible:
        best, best_f = _all_cloud_fallback(graph, spec, rate, objective,
                                           codecs)
    return best, best_f


def place_graph_exhaustive(graph, resources: ResourcesLike,
                           rate: float,
                           objective: Optional[Objective] = None,
                           *, max_states: int = 1_000_000) -> PipelinePlan:
    """Oracle for DAG placement: every assignment of every op to every
    pool of the spec — including non-downward-closed and cross-kind-
    scrambled ones (exponential; tests and the benchmark harness only).
    With a multi-pool ClusterSpec this is the multi-pool oracle
    :func:`place_frontier` and :func:`place_frontier_dp` are checked
    against. Refuses inputs whose ``pools**ops`` state count exceeds
    ``max_states``."""
    objective = objective or Objective()
    spec = ClusterSpec.of(resources)
    rnames = list(spec)
    _check_state_count("place_graph_exhaustive", len(rnames),
                       len(graph.names), max_states)
    best, best_score = None, float("inf")
    for combo in itertools.product(rnames, repeat=len(graph.names)):
        assign = dict(zip(graph.names, combo))
        plan = _graph_plan(graph, assign, spec, rate)
        s = objective.score(plan)
        if best is None or s < best_score:
            best, best_score = plan, s
    return best


# ---------------------------------------------------------------------------
# Standard S2CE pipeline stage costs
# ---------------------------------------------------------------------------

def standard_pipeline(dim: int = 32, model_flops_per_event: float = 2e6,
                      sample_rate: float = 0.25) -> List[OperatorCost]:
    """ingest -> preprocess -> sample/sketch -> pre-model -> full train.

    A synthetic DL-payload cost-list *exemplar* (placement oracle tests,
    S3 benchmark, edge_cloud example). Executable jobs should not use
    this: build a :class:`repro_torch.core.pipeline.Pipeline` and price it via
    ``Pipeline.costs()`` so the optimizer and the executor consume the
    same op list.
    """
    ev = 4.0 * dim
    return [
        OperatorCost("ingest", flops_per_event=10 * dim,
                     bytes_per_event=2 * ev, out_bytes_per_event=ev),
        OperatorCost("preprocess", flops_per_event=50 * dim,
                     bytes_per_event=4 * ev, out_bytes_per_event=ev),
        OperatorCost("sample", flops_per_event=20,
                     bytes_per_event=2 * ev,
                     out_bytes_per_event=ev * sample_rate),
        OperatorCost("pre_model", flops_per_event=4 * dim * dim,
                     bytes_per_event=6 * ev,
                     out_bytes_per_event=ev * sample_rate),
        OperatorCost("dl_train", flops_per_event=model_flops_per_event,
                     bytes_per_event=20 * ev,
                     out_bytes_per_event=64, edge_capable=False),
    ]
