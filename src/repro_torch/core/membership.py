"""Dynamic topology: a membership/discovery layer for pools that join,
leave, and fail mid-stream (ECHO-style adaptive
orchestration, arxiv 1707.00889, and FogFlow-style discovery where edge
devices publish themselves with location metadata).

The :class:`MembershipDirectory` owns the authoritative, **versioned**
:class:`~repro_torch.core.costmodel.ClusterSpec`:

* pools :meth:`register`/:meth:`deregister` at runtime, optionally with
  :class:`Locality` metadata — a registered pool's default link
  latencies to located peers derive from geometric distance, so
  placement prefers nearby pools from the moment they join;
* a **heartbeat/lease** mechanism declares silent pools dead: every
  registered pool must :meth:`heartbeat` within ``lease_ticks`` of the
  directory clock or :meth:`tick` expires it (``pool_failed``). The
  clock is the deterministic simulation step the orchestrator already
  counts — never wall time — so failure scenarios replay bitwise;
* a **probe table** rewrites each :class:`Link`'s latency
  (:meth:`observe_latency`) and bandwidth (:meth:`observe_bandwidth`)
  from observed samples via EWMA, turning the hand-declared link matrix
  into a data-driven one. Announcements (``link_update`` events) are
  hysteresis-gated by a relative tolerance so consumers re-price on
  real shifts, not probe noise.

Every mutation bumps ``version`` and appends a typed
:class:`TopologyEvent`; consumers (:class:`~repro_torch.core.orchestrator.
Orchestrator`, :class:`~repro_torch.core.fleet.FleetOrchestrator`) hold a
:class:`TopologySubscription` cursor and drain events at their own
step boundary. A directory nobody mutates emits nothing — consumers'
trajectories are then bitwise identical to a static-``ClusterSpec``
run.

Seed pools (those the directory is constructed with) are NOT
lease-monitored: a static core topology never expires for want of
heartbeats it was never promised. Only pools that arrive through
:meth:`register` (or that start heartbeating) carry a lease.

The JAX package's ``core/membership.py`` in the port: host-side control
state only (no tensors), so the same calls give the same events,
versions and specs in both packages.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.costmodel import ClusterSpec, Link, Resource

# event kinds
POOL_JOINED = "pool_joined"
POOL_LEFT = "pool_left"        # voluntary deregistration
POOL_FAILED = "pool_failed"    # lease expired (silent death)
LINK_UPDATE = "link_update"    # probe-driven latency rewrite


@dataclass(frozen=True)
class Locality:
    """Where a pool physically sits: coordinates in an abstract plane
    (kilometre-ish units) plus an optional region tag. Distance seeds
    the derived link latency for freshly joined pools; probes refine
    it."""
    x: float = 0.0
    y: float = 0.0
    region: str = ""

    def distance(self, other: "Locality") -> float:
        return math.hypot(self.x - other.x, self.y - other.y)


@dataclass(frozen=True)
class TopologyEvent:
    """One membership change, as consumers see it. ``subject`` is the
    pool name (or ``"src->dst"`` for link updates); ``version`` is the
    spec version AFTER the event, so a consumer that re-reads
    ``directory.spec`` at version >= event.version has already absorbed
    it."""
    kind: str
    subject: str
    version: int
    clock: int
    detail: str = ""


class TopologySubscription:
    """A cursor into the directory's event log. :meth:`poll` returns
    the events appended since the last poll — consumers drain at their
    own step boundary instead of being called back mid-mutation."""

    def __init__(self, directory: "MembershipDirectory", cursor: int):
        self._directory = directory
        self._cursor = cursor

    def poll(self) -> List[TopologyEvent]:
        events = self._directory.events[self._cursor:]
        self._cursor = len(self._directory.events)
        return list(events)


class MembershipDirectory:
    """The authoritative, versioned cluster topology.

    ``lease_ticks`` — a monitored pool silent for MORE than this many
    clock ticks is declared dead by :meth:`tick`.
    ``ewma_alpha`` — weight of each new latency sample.
    ``latency_tol`` — relative latency change required before a
    ``link_update`` event is announced (the probe-noise dead band).
    ``latency_per_km`` / ``base_latency`` — the geometric prior for
    links derived from :class:`Locality` at registration time.
    """

    def __init__(self, cluster: Optional[object] = None, *,
                 lease_ticks: int = 3, ewma_alpha: float = 0.3,
                 latency_tol: float = 0.2,
                 latency_per_km: float = 0.05e-3,
                 base_latency: float = 1e-3):
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha {ewma_alpha} not in (0, 1]")
        if lease_ticks < 1:
            raise ValueError(f"lease_ticks {lease_ticks} must be >= 1")
        self.lease_ticks = int(lease_ticks)
        self.ewma_alpha = float(ewma_alpha)
        self.latency_tol = float(latency_tol)
        self.latency_per_km = float(latency_per_km)
        self.base_latency = float(base_latency)
        self.clock = 0
        self._pools: Dict[str, Resource] = {}
        self._links: Dict[Tuple[str, str], Link] = {}
        self._version = 0
        if cluster is not None:
            seed = ClusterSpec.of(cluster)
            self._pools = dict(seed.pools)
            self._links = {(ln.src, ln.dst): ln for ln in seed.links}
        # lease table: only pools registered (or heartbeating) at
        # runtime are monitored; seed pools never expire silently
        self._last_seen: Dict[str, int] = {}
        self._locality: Dict[str, Locality] = {}
        # probe table: EWMA latency estimate per directed pair, plus
        # the latency last ANNOUNCED via a link_update event (the
        # hysteresis reference)
        self._ewma: Dict[Tuple[str, str], float] = {}
        self._announced: Dict[Tuple[str, str], float] = {}
        # bandwidth-probe twin of the latency table (observe_bandwidth)
        self._bw_ewma: Dict[Tuple[str, str], float] = {}
        self._bw_announced: Dict[Tuple[str, str], float] = {}
        self.events: List[TopologyEvent] = []
        self._spec_cache: Optional[ClusterSpec] = None

    # -- views --------------------------------------------------------------
    @property
    def version(self) -> int:
        return self._version

    @property
    def spec(self) -> ClusterSpec:
        """The current topology as an immutable ClusterSpec snapshot,
        stamped with the directory version."""
        if self._spec_cache is None:
            self._spec_cache = ClusterSpec(dict(self._pools),
                                           list(self._links.values()),
                                           version=self._version)
        return self._spec_cache

    @property
    def pool_names(self) -> List[str]:
        return sorted(self._pools)

    def __contains__(self, name: str) -> bool:
        return name in self._pools

    def monitored(self, name: str) -> bool:
        """Whether ``name`` carries a lease (expires without heartbeats)."""
        return name in self._last_seen

    def locality(self, name: str) -> Optional[Locality]:
        return self._locality.get(name)

    def subscribe(self) -> TopologySubscription:
        """A cursor starting AFTER all past events: a late-joining
        consumer sees only changes from now on (it reads the current
        ``spec`` for the present state)."""
        return TopologySubscription(self, len(self.events))

    # -- internals ----------------------------------------------------------
    def _advance(self, now: Optional[int]) -> int:
        if now is not None:
            self.clock = max(self.clock, int(now))
        return self.clock

    def _emit(self, kind: str, subject: str, detail: str = "") -> None:
        self._version += 1
        self._spec_cache = None
        self.events.append(TopologyEvent(kind, subject, self._version,
                                         self.clock, detail))

    def _drop_pool_state(self, name: str) -> None:
        self._pools.pop(name)
        self._last_seen.pop(name, None)
        self._locality.pop(name, None)
        for key in [k for k in self._links if name in k]:
            self._links.pop(key)
        for key in [k for k in self._ewma if name in k]:
            self._ewma.pop(key)
            self._announced.pop(key, None)
        for key in [k for k in self._bw_ewma if name in k]:
            self._bw_ewma.pop(key)
            self._bw_announced.pop(key, None)

    # -- membership mutations ----------------------------------------------
    def register(self, resource: Resource, links: Iterable[Link] = (),
                 locality: Optional[Locality] = None,
                 now: Optional[int] = None, monitored: bool = True
                 ) -> TopologyEvent:
        """A pool joins mid-run. Declared ``links`` must touch the new
        pool; pairs not declared are derived: from geometric distance
        when both endpoints carry :class:`Locality` (so placement
        prefers nearby pools from the start), else from the spec's
        charge-the-slow-side default at :meth:`ClusterSpec.link` time.
        Registered pools are lease-``monitored`` by default — they must
        heartbeat or :meth:`tick` declares them dead."""
        now = self._advance(now)
        name = resource.name
        if name in self._pools:
            raise ValueError(f"register: pool {name!r} already a member")
        links = list(links)
        # validate BEFORE mutating: a rejected registration must leave
        # the directory exactly as it found it
        for ln in links:
            if name not in (ln.src, ln.dst):
                raise ValueError(
                    f"register {name!r}: link {ln.src}->{ln.dst} does not "
                    "touch the registering pool")
            other = ln.dst if ln.src == name else ln.src
            if other not in self._pools:
                raise ValueError(
                    f"register {name!r}: link peer {other!r} is not a "
                    f"member (known pools: {sorted(self._pools)})")
        self._pools[name] = resource
        if locality is not None:
            self._locality[name] = locality
        for ln in links:
            self._links[(ln.src, ln.dst)] = ln
        # geometric prior: derive links to every located peer that has
        # no declared link yet, both directions, bw = slow side's net_bw
        if locality is not None:
            for peer, ploc in self._locality.items():
                if peer == name:
                    continue
                lat = (self.base_latency
                       + locality.distance(ploc) * self.latency_per_km)
                a, b = self._pools[name], self._pools[peer]
                bw = min(a.net_bw, b.net_bw)
                for key in ((name, peer), (peer, name)):
                    if key not in self._links:
                        self._links[key] = Link(key[0], key[1], bw=bw,
                                                latency=lat)
        if monitored:
            self._last_seen[name] = now
        ev_detail = (f"locality=({locality.x:g},{locality.y:g})"
                     if locality is not None else "")
        self._emit(POOL_JOINED, name, ev_detail)
        return self.events[-1]

    def deregister(self, name: str, now: Optional[int] = None
                   ) -> TopologyEvent:
        """A pool leaves voluntarily: it and every link touching it
        disappear from the spec."""
        self._advance(now)
        if name not in self._pools:
            raise ValueError(f"deregister: unknown pool {name!r} "
                             f"(known pools: {sorted(self._pools)})")
        self._drop_pool_state(name)
        self._emit(POOL_LEFT, name, "deregistered")
        return self.events[-1]

    def heartbeat(self, name: str, now: Optional[int] = None) -> None:
        """Renew ``name``'s lease (and start monitoring it if it was an
        unmonitored seed pool)."""
        now = self._advance(now)
        if name not in self._pools:
            raise ValueError(f"heartbeat: unknown pool {name!r} "
                             f"(known pools: {sorted(self._pools)})")
        self._last_seen[name] = now

    def tick(self, now: Optional[int] = None) -> List[str]:
        """Advance the simulation clock and expire every monitored pool
        silent for more than ``lease_ticks`` — each expiry emits a
        ``pool_failed`` event. Idempotent: re-ticking the same clock
        value expires nothing new. Returns the pools declared dead."""
        now = self._advance(now)
        dead = sorted(name for name, seen in self._last_seen.items()
                      if now - seen > self.lease_ticks)
        for name in dead:
            last = self._last_seen[name]
            self._drop_pool_state(name)
            self._emit(POOL_FAILED, name,
                       f"lease expired (last heartbeat t={last}, "
                       f"lease={self.lease_ticks})")
        return dead

    # -- latency probes ------------------------------------------------------
    def observe_latency(self, src: str, dst: str, sample_s: float,
                        now: Optional[int] = None
                        ) -> Optional[TopologyEvent]:
        """Feed one observed latency sample for ``src -> dst``. The EWMA
        estimate rewrites the link's latency in the spec; a
        ``link_update`` event is announced only when the estimate moved
        more than ``latency_tol`` (relative) from the last announced
        value — probe noise stays silent. Returns the event, if any."""
        self._advance(now)
        for end in (src, dst):
            if end not in self._pools:
                raise ValueError(
                    f"observe_latency {src}->{dst}: unknown pool {end!r} "
                    f"(known pools: {sorted(self._pools)})")
        if sample_s < 0.0:
            raise ValueError(f"observe_latency: negative sample {sample_s}")
        key = (src, dst)
        ln = self._links.get(key) or self.spec.link(src, dst)
        prev = self._ewma.get(key, ln.latency)
        est = self.ewma_alpha * float(sample_s) \
            + (1.0 - self.ewma_alpha) * prev
        self._ewma[key] = est
        self._links[key] = replace(ln, latency=est)
        # the spec must always carry the freshest estimate, even when
        # the move is below the announcement dead band
        self._version += 1
        self._spec_cache = None
        ref = self._announced.get(key, ln.latency)
        if abs(est - ref) > self.latency_tol * max(ref, 1e-12):
            self._announced[key] = est
            self.events.append(TopologyEvent(
                LINK_UPDATE, f"{src}->{dst}", self._version, self.clock,
                f"latency {ref * 1e3:.3g}ms -> {est * 1e3:.3g}ms"))
            return self.events[-1]
        return None

    def observe_bandwidth(self, src: str, dst: str, sample_bps: float,
                          now: Optional[int] = None
                          ) -> Optional[TopologyEvent]:
        """Feed one observed throughput sample (bytes/s) for
        ``src -> dst`` — the bandwidth twin of :meth:`observe_latency`.
        The EWMA estimate rewrites the link's ``bw`` in the spec (so the
        placement DP and :func:`~repro_torch.core.costmodel.migration_cost`
        price wire time against measured, not declared, capacity); a
        ``link_update`` event is announced only when the estimate moved
        more than ``latency_tol`` (relative) from the last announced
        value. Returns the event, if any."""
        self._advance(now)
        for end in (src, dst):
            if end not in self._pools:
                raise ValueError(
                    f"observe_bandwidth {src}->{dst}: unknown pool "
                    f"{end!r} (known pools: {sorted(self._pools)})")
        if sample_bps <= 0.0:
            raise ValueError(
                f"observe_bandwidth: non-positive sample {sample_bps}")
        key = (src, dst)
        ln = self._links.get(key) or self.spec.link(src, dst)
        prev = self._bw_ewma.get(key, ln.bw)
        est = self.ewma_alpha * float(sample_bps) \
            + (1.0 - self.ewma_alpha) * prev
        self._bw_ewma[key] = est
        self._links[key] = replace(ln, bw=est)
        # the spec must always carry the freshest estimate, even when
        # the move is below the announcement dead band
        self._version += 1
        self._spec_cache = None
        ref = self._bw_announced.get(key, ln.bw)
        if abs(est - ref) > self.latency_tol * max(ref, 1e-12):
            self._bw_announced[key] = est
            self.events.append(TopologyEvent(
                LINK_UPDATE, f"{src}->{dst}", self._version, self.clock,
                f"bw {ref / 1e6:.3g}MB/s -> {est / 1e6:.3g}MB/s"))
            return self.events[-1]
        return None

    def probe_estimate(self, src: str, dst: str) -> Optional[float]:
        """The current EWMA latency estimate, or None if never probed."""
        return self._ewma.get((src, dst))

    def bandwidth_estimate(self, src: str, dst: str) -> Optional[float]:
        """The current EWMA bandwidth estimate, or None if never probed."""
        return self._bw_ewma.get((src, dst))

    def __repr__(self) -> str:
        return (f"MembershipDirectory(v{self._version}, t={self.clock}, "
                f"{len(self._pools)} pools, {len(self._last_seen)} "
                f"monitored, {len(self.events)} events)")
