"""Collective communication cost models over a :class:`Topology`.

The models are link-structural, not closed-form: a schedule (ring, tree,
hierarchical) is decomposed into concurrent hops per algorithm step; each
hop crosses concrete links; the step's duration is set by the bottleneck
link, accounting for how many concurrent flows share it. Congestion state
(see :mod:`repro_torch.fabric.congestion`) scales effective bandwidth per link.

This is exactly the paper's point (§3.2): aggregate bandwidth says ring
all-reduce should be flat in N, but the *shared up-links* carry
`flows-on-link x chunk` every step, so hierarchical/oversubscribed fabrics
bend the curve well before link peak is reached.

Contracts:

  * **Bit-compat.** Compiled schedules replicate the per-call functions'
    arithmetic exactly (operand order, dict insertion order, bottleneck
    tie-breaking) — held by ``tests/test_compiled_schedules.py`` and the
    golden/fingerprint baselines. ``routing=None`` (== the ``ecmp_static``
    entry of the ``ROUTING`` registry, :mod:`repro_torch.fabric.policies`)
    resolves multi-path route tokens to one hash-pinned member at compile
    time, so single-path topologies are unaffected byte-for-byte.
  * **Algos.** ``ring`` / ``tree`` / ``hierarchical`` plus ``sharp``
    (switch-aggregated in-network allreduce) on topologies that declare
    ``sharp_capacity_bytes >= nbytes``; an explicit ``algo="sharp"``
    beyond capacity falls back deterministically to the faster of
    ring/tree. ``select_algo`` appends ``sharp`` to the default candidate
    set only when the topology's capacity admits the payload, so
    ``algo="auto"`` selections on existing fabrics are unchanged.
  * **Backends.** All schedules run on the reference backend (the
    executable spec). The batched scenario runner encodes ring/tree/
    hierarchical/sharp static plans; schedules carrying adaptive-spray
    entries are reference-only and the batched path raises ``BackendError``
    (nearest-backend contract, :mod:`repro_torch.fabric.backend`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.fabric.topology import (Topology, is_route_token,
                                   parse_route_token)


# adaptive spray rows keep the routing-group identity ("@pp0-1") in
# bottleneck reports instead of any single member link
ROUTE_KEY_PREFIX = "@"


@dataclasses.dataclass
class CollectiveCost:
    total_s: float
    steps: int
    bottleneck_link: str
    per_link_bytes: Dict[str, float]


def _step_time(
    hop_links: List[List[str]],
    chunk_bytes: float,
    topo: Topology,
    link_eff: Optional[Dict[str, float]] = None,
) -> (float, str, Dict[str, float]):
    """One algorithm step: all hops concurrent; returns (time, bottleneck,
    per-link bytes). ``link_eff`` maps link name -> effective bw multiplier
    in (0, 1] (congestion state)."""
    flows: Dict[str, int] = {}
    for links in hop_links:
        for ln in links:
            if is_route_token(ln):
                # per-call path is static-only: ECMP hash-pin (the
                # ecmp_static default; adaptive spray needs a compiled
                # schedule)
                group, salt = parse_route_token(ln)
                members = topo.path_group(group)
                ln = members[salt % len(members)]
            flows[ln] = flows.get(ln, 0) + 1
    worst, worst_link = 0.0, ""
    per_link_bytes: Dict[str, float] = {}
    for ln, f in flows.items():
        link = topo.link(ln)
        eff = (link_eff or {}).get(ln, 1.0)
        bw = link.bw_gbps * 1e9 * eff
        # Shared (oversubscribed-tier) links aggregate: concurrent flows
        # divide capacity. Per-port links (node<->leaf, intra-pod ICI) are
        # non-blocking within the tier: each hop gets the full port.
        conc = f if link.shared else 1
        t = (conc * chunk_bytes) / bw + link.latency_s
        per_link_bytes[ln] = f * chunk_bytes
        if t > worst:
            worst, worst_link = t, ln
    return worst, worst_link, per_link_bytes


def ring_all_reduce(
    topo: Topology,
    ranks: Sequence[int],
    nbytes: float,
    *,
    link_eff: Optional[Dict[str, float]] = None,
) -> CollectiveCost:
    """Bandwidth-optimal ring: 2(n-1) steps of chunk = bytes/n."""
    n = len(ranks)
    if n <= 1:
        return CollectiveCost(0.0, 0, "", {})
    hops = topo.ring_hops(ranks)
    chunk = nbytes / n
    t_step, bott, per_link = _step_time(hops, chunk, topo, link_eff)
    steps = 2 * (n - 1)
    total_bytes = {ln: b * steps for ln, b in per_link.items()}
    return CollectiveCost(t_step * steps, steps, bott, total_bytes)


def tree_all_reduce(
    topo: Topology,
    ranks: Sequence[int],
    nbytes: float,
    *,
    link_eff: Optional[Dict[str, float]] = None,
) -> CollectiveCost:
    """Binary-tree reduce + broadcast: 2*ceil(log2 n) steps of full bytes."""
    import math
    n = len(ranks)
    if n <= 1:
        return CollectiveCost(0.0, 0, "", {})
    depth = math.ceil(math.log2(n))
    total, per_link_total, worst_link = 0.0, {}, ""
    worst_t = 0.0
    for level in range(depth):
        stride = 1 << level
        hops = [topo.hop_links(ranks[i], ranks[i + stride])
                for i in range(0, n - stride, stride * 2)]
        if not hops:
            continue
        t, bott, per_link = _step_time(hops, nbytes, topo, link_eff)
        total += t
        for ln, b in per_link.items():
            per_link_total[ln] = per_link_total.get(ln, 0.0) + b
        if t > worst_t:
            worst_t, worst_link = t, bott
    total *= 2.0                      # reduce + broadcast
    per_link_total = {ln: 2 * b for ln, b in per_link_total.items()}
    return CollectiveCost(total, 2 * depth, worst_link, per_link_total)


def hierarchical_all_reduce(
    topo: Topology,
    ranks: Sequence[int],
    nbytes: float,
    *,
    group: int,
    link_eff: Optional[Dict[str, float]] = None,
) -> CollectiveCost:
    """Reduce-scatter within groups of ``group`` ranks, ring across group
    leaders, all-gather within groups — the standard hierarchical schedule
    that keeps the oversubscribed tier's traffic at bytes/group."""
    n = len(ranks)
    if n <= group:
        return ring_all_reduce(topo, ranks, nbytes, link_eff=link_eff)
    # intra-group phases (ring reduce-scatter + all-gather = ring AR cost)
    intra_groups = [list(ranks[i:i + group]) for i in range(0, n, group)]
    intra = max(
        (ring_all_reduce(topo, g, nbytes, link_eff=link_eff)
         for g in intra_groups if len(g) > 1),
        key=lambda c: c.total_s, default=CollectiveCost(0.0, 0, "", {}))
    leaders = [g[0] for g in intra_groups]
    inter = ring_all_reduce(topo, leaders, nbytes / group,
                            link_eff=link_eff)
    per_link = dict(intra.per_link_bytes)
    for ln, b in inter.per_link_bytes.items():
        per_link[ln] = per_link.get(ln, 0.0) + b
    bott = inter.bottleneck_link if inter.total_s >= intra.total_s \
        else intra.bottleneck_link
    return CollectiveCost(intra.total_s + inter.total_s,
                          intra.steps + inter.steps, bott, per_link)


ALGOS = {
    "ring": ring_all_reduce,
    "tree": tree_all_reduce,
}


def all_reduce(topo: Topology, ranks: Sequence[int], nbytes: float, *,
               algo: str = "ring", group: int = 0,
               link_eff: Optional[Dict[str, float]] = None
               ) -> CollectiveCost:
    if algo == "hierarchical":
        return hierarchical_all_reduce(topo, ranks, nbytes,
                                       group=group or 8, link_eff=link_eff)
    return ALGOS[algo](topo, ranks, nbytes, link_eff=link_eff)


# ---------------------------------------------------------------------------
# compiled schedules
# ---------------------------------------------------------------------------
#
# The per-call functions above re-walk every ring hop and re-count per-link
# flows on each invocation — fine for a one-off cost query, ruinous inside
# the simulator's iteration loop where only the congestion state (link_eff)
# changes between calls. A compiled schedule performs that walk once and
# freezes the flow structure into flat tuples, so evaluating the cost under
# a new congestion state is a short loop over links instead of a walk over
# hops. The arithmetic (operand order, dict insertion order, tie-breaking)
# replicates the per-call path exactly, so compiled costs are bit-identical
# to the legacy functions — tests/test_compiled_schedules.py holds the two
# paths equal across topologies, algorithms, and congestion states.


class _StepPlan:
    """One algorithm step with its flow structure frozen.

    ``entries`` is one row per distinct link, ordered by first encounter
    while walking the hop list (the legacy flows-dict insertion order, which
    fixes bottleneck tie-breaking): ``(name, num, bw1e9, latency)`` where
    ``num = conc * chunk_bytes`` is the serialized bytes on the link and
    ``bw1e9 = bw_gbps * 1e9`` the uncongested bandwidth in B/s.

    Route tokens (``@group#salt`` hop entries from multi-path topologies)
    resolve through ``routing``: static policies pin one member link here
    at compile time (the token disappears into a plain entry); an adaptive
    policy keeps the member group as a ``spray`` row —
    ``(key, num, cap0, max_lat, members)`` with ``members`` as
    ``((name, bw1e9), ...)`` — whose bytes split across members in
    proportion to observed effective capacity at every ``time()`` call.
    Byte accounting for spray rows splits equally across members
    (congestion-independent, so static-bytes schedules stay static).

    ``aggregate=True`` is the in-network (SHARP) mode: the switch tier
    combines payloads, so every link carries one copy of the payload
    regardless of how many flows cross it (``conc = 1``,
    ``step_bytes = chunk``).
    """

    __slots__ = ("entries", "spray", "step_bytes")

    def __init__(self, hop_links: List[List[str]], chunk_bytes: float,
                 topo: Topology, routing=None, aggregate: bool = False):
        adaptive = routing is not None and routing.adaptive
        flows: Dict[str, int] = {}
        groups: Dict[str, Tuple[str, ...]] = {}
        for links in hop_links:
            for ln in links:
                if is_route_token(ln):
                    group, salt = parse_route_token(ln)
                    members = topo.path_group(group)
                    if adaptive:
                        ln = ROUTE_KEY_PREFIX + group
                        groups[ln] = tuple(members)
                    elif routing is not None:
                        ln = routing.choose(members, salt)
                    else:
                        ln = members[salt % len(members)]
                flows[ln] = flows.get(ln, 0) + 1
        entries = []
        spray = []
        step_bytes: Dict[str, float] = {}
        for ln, f in flows.items():
            members = groups.get(ln)
            if members is not None:
                links = [topo.link(m) for m in members]
                conc = 1 if aggregate else \
                    (f if links[0].shared else 1)
                num = conc * chunk_bytes
                cap0 = sum(l.bw_gbps for l in links) * 1e9
                lat = max(l.latency_s for l in links)
                spray.append((ln, num, cap0, lat,
                              tuple((l.name, l.bw_gbps * 1e9)
                                    for l in links)))
                share = (1 if aggregate else f) \
                    * chunk_bytes / len(members)
                for l in links:
                    step_bytes[l.name] = \
                        step_bytes.get(l.name, 0.0) + share
                continue
            link = topo.link(ln)
            if aggregate:
                conc, carried = 1, chunk_bytes
            else:
                conc = f if link.shared else 1
                carried = f * chunk_bytes
            entries.append((ln, conc * chunk_bytes, link.bw_gbps * 1e9,
                            link.latency_s))
            step_bytes[ln] = step_bytes.get(ln, 0.0) + carried
        self.entries = tuple(entries)
        self.spray = tuple(spray)
        self.step_bytes = step_bytes

    def time(self, link_eff: Optional[Dict[str, float]]
             ) -> (float, str):
        worst, worst_link = 0.0, ""
        if link_eff is None:
            for ln, num, bw, lat in self.entries:
                t = num / bw + lat
                if t > worst:
                    worst, worst_link = t, ln
            for ln, num, cap0, lat, members in self.spray:
                t = num / cap0 + lat
                if t > worst:
                    worst, worst_link = t, ln
        else:
            get = link_eff.get
            for ln, num, bw, lat in self.entries:
                t = num / (bw * get(ln, 1.0)) + lat
                if t > worst:
                    worst, worst_link = t, ln
            for ln, num, cap0, lat, members in self.spray:
                cap = 0.0
                for m, bw in members:
                    cap += bw * get(m, 1.0)
                t = num / cap + lat if cap > 0.0 else float("inf")
                if t > worst:
                    worst, worst_link = t, ln
        return worst, worst_link


class CompiledSchedule:
    """Base interface: a collective whose flow structure is precomputed.

    ``cost(link_eff)`` returns a :class:`CollectiveCost` equal to the
    corresponding per-call function; ``total_s(link_eff)`` is the scalar
    fast path used by the simulator's hot loop (no byte dicts built).
    """

    algo: str = ""

    def cost(self, link_eff: Optional[Dict[str, float]] = None
             ) -> CollectiveCost:
        raise NotImplementedError

    def total_s(self, link_eff: Optional[Dict[str, float]] = None) -> float:
        raise NotImplementedError

    def bytes_per_call(self, link_eff: Optional[Dict[str, float]] = None
                       ) -> Dict[str, float]:
        """Per-link bytes one collective moves (== cost().per_link_bytes)."""
        return self.cost(link_eff).per_link_bytes

    def accumulate_bytes(self, link_eff: Optional[Dict[str, float]],
                         totals: Dict[str, float]) -> None:
        """Add one call's per-link bytes into ``totals`` (same add sequence
        as the per-call accumulation in the seed loop)."""
        get = totals.get
        for ln, b in self.bytes_per_call(link_eff).items():
            totals[ln] = get(ln, 0.0) + b


class _ZeroSchedule(CompiledSchedule):
    """Degenerate collective (<= 1 rank): free."""

    def cost(self, link_eff=None) -> CollectiveCost:
        return CollectiveCost(0.0, 0, "", {})

    def total_s(self, link_eff=None) -> float:
        return 0.0

    def accumulate_bytes(self, link_eff, totals) -> None:
        pass


class _StaticBytesSchedule(CompiledSchedule):
    """Schedule whose per-call link bytes are congestion-independent
    (ring, tree): ``self._bytes`` is frozen at compile time."""

    _bytes: Dict[str, float]

    def bytes_per_call(self, link_eff=None) -> Dict[str, float]:
        return dict(self._bytes)

    def accumulate_bytes(self, link_eff, totals) -> None:
        get = totals.get
        for ln, b in self._bytes.items():
            totals[ln] = get(ln, 0.0) + b


class _RingSchedule(_StaticBytesSchedule):
    algo = "ring"

    def __init__(self, topo: Topology, ranks: Sequence[int], nbytes: float,
                 routing=None):
        n = len(ranks)
        self.steps = 2 * (n - 1)
        self.plan = _StepPlan(topo.ring_hops(ranks), nbytes / n, topo,
                              routing)
        self._bytes = {ln: b * self.steps
                       for ln, b in self.plan.step_bytes.items()}

    def cost(self, link_eff=None) -> CollectiveCost:
        t, bott = self.plan.time(link_eff)
        return CollectiveCost(t * self.steps, self.steps, bott,
                              dict(self._bytes))

    def total_s(self, link_eff=None) -> float:
        return self.plan.time(link_eff)[0] * self.steps


class _TreeSchedule(_StaticBytesSchedule):
    algo = "tree"

    def __init__(self, topo: Topology, ranks: Sequence[int], nbytes: float,
                 routing=None):
        import math
        n = len(ranks)
        depth = math.ceil(math.log2(n))
        self.steps = 2 * depth
        self.levels: List[_StepPlan] = []
        per_link_total: Dict[str, float] = {}
        for level in range(depth):
            stride = 1 << level
            hops = [topo.hop_links(ranks[i], ranks[i + stride])
                    for i in range(0, n - stride, stride * 2)]
            if not hops:
                continue
            plan = _StepPlan(hops, nbytes, topo, routing)
            self.levels.append(plan)
            for ln, b in plan.step_bytes.items():
                per_link_total[ln] = per_link_total.get(ln, 0.0) + b
        self._bytes = {ln: 2 * b for ln, b in per_link_total.items()}

    def _walk(self, link_eff) -> (float, str):
        total, worst_t, worst_link = 0.0, 0.0, ""
        for plan in self.levels:
            t, bott = plan.time(link_eff)
            total += t
            if t > worst_t:
                worst_t, worst_link = t, bott
        return total * 2.0, worst_link

    def cost(self, link_eff=None) -> CollectiveCost:
        total, bott = self._walk(link_eff)
        return CollectiveCost(total, self.steps, bott, dict(self._bytes))

    def total_s(self, link_eff=None) -> float:
        return self._walk(link_eff)[0]


class _HierSchedule(CompiledSchedule):
    """Hierarchical = per-group ring schedules (slowest group binds) plus a
    ring across group leaders. Which group is slowest depends on the
    congestion state, so the intra winner is picked per evaluation — exactly
    as the per-call path does."""

    algo = "hierarchical"

    def __init__(self, topo: Topology, ranks: Sequence[int], nbytes: float,
                 group: int, routing=None):
        intra_groups = [list(ranks[i:i + group])
                        for i in range(0, len(ranks), group)]
        self.intra = [_RingSchedule(topo, g, nbytes, routing)
                      for g in intra_groups if len(g) > 1]
        leaders = [g[0] for g in intra_groups]
        self.inter = compile_schedule(topo, leaders, nbytes / group,
                                      algo="ring", routing=routing)

    def cost(self, link_eff=None) -> CollectiveCost:
        intra = CollectiveCost(0.0, 0, "", {})
        for sched in self.intra:            # first max wins, like max(key=)
            c = sched.cost(link_eff)
            if c.total_s > intra.total_s:
                intra = c
        inter = self.inter.cost(link_eff)
        per_link = dict(intra.per_link_bytes)
        for ln, b in inter.per_link_bytes.items():
            per_link[ln] = per_link.get(ln, 0.0) + b
        bott = inter.bottleneck_link if inter.total_s >= intra.total_s \
            else intra.bottleneck_link
        return CollectiveCost(intra.total_s + inter.total_s,
                              intra.steps + inter.steps, bott, per_link)

    def total_s(self, link_eff=None) -> float:
        intra = 0.0
        for sched in self.intra:
            t = sched.total_s(link_eff)
            if t > intra:
                intra = t
        return intra + self.inter.total_s(link_eff)


class _SharpSchedule(_StaticBytesSchedule):
    """Switch-aggregated (SHARP-style) in-network allreduce.

    Every rank pushes its contribution one level up (rank -> locality-group
    leader switch), leaders push to the root switch, and the aggregated
    result broadcasts back down — two mirrored phases over one aggregate
    step plan. The in-network reduction means each link carries *one* copy
    of the payload per direction regardless of fan-in (``aggregate=True``
    on the plan), which is the entire point of offloading the reduction to
    the switch ASICs. Only topologies that declare
    ``sharp_capacity_bytes >= nbytes`` compile this schedule — see
    :func:`compile_schedule` for the oversubscription fallback.
    """

    algo = "sharp"

    def __init__(self, topo: Topology, ranks: Sequence[int], nbytes: float,
                 group: int, routing=None):
        groups = [list(ranks[i:i + group])
                  for i in range(0, len(ranks), group)]
        hops: List[List[str]] = []
        for g in groups:
            leader = g[0]
            for rank in g[1:]:
                hops.append(topo.hop_links(rank, leader))
        root = groups[0][0]
        for g in groups[1:]:
            hops.append(topo.hop_links(g[0], root))
        self.steps = 2                  # reduce-up + broadcast-down
        self.plan = _StepPlan(hops, nbytes, topo, routing, aggregate=True)
        self._bytes = {ln: b * self.steps
                       for ln, b in self.plan.step_bytes.items()}

    def cost(self, link_eff=None) -> CollectiveCost:
        t, bott = self.plan.time(link_eff)
        return CollectiveCost(t * self.steps, self.steps, bott,
                              dict(self._bytes))

    def total_s(self, link_eff=None) -> float:
        return self.plan.time(link_eff)[0] * self.steps


def sharp_available(topo: Topology, nbytes: float) -> bool:
    """True when the topology's in-network aggregation capacity admits a
    payload of ``nbytes`` (0.0 on topologies without SHARP switches)."""
    return getattr(topo, "sharp_capacity_bytes", 0.0) >= nbytes > 0.0


def compile_schedule(topo: Topology, ranks: Sequence[int], nbytes: float, *,
                     algo: str = "ring", group: int = 0,
                     routing=None) -> CompiledSchedule:
    """Precompute the flow structure of one all-reduce over ``ranks``.

    Returns a :class:`CompiledSchedule` whose ``cost(link_eff)`` equals
    :func:`all_reduce` for the same arguments, evaluated without re-walking
    the topology. ``routing`` is a resolved
    :class:`~repro_torch.fabric.policies.RoutingPolicy` (or None for the
    bit-compat ``ecmp_static`` default) deciding how multi-path route
    tokens map onto parallel member links.

    ``algo="sharp"`` beyond the topology's ``sharp_capacity_bytes`` falls
    back deterministically to the faster of ring/tree by uncongested
    duration (ring on ties) — the switch pool is oversubscribed, so the
    collective runs host-based.
    """
    n = len(ranks)
    if n <= 1:
        return _ZeroSchedule()
    if algo == "hierarchical":
        g = group or 8
        if n <= g:
            return _RingSchedule(topo, ranks, nbytes, routing)
        return _HierSchedule(topo, ranks, nbytes, g, routing)
    if algo == "ring":
        return _RingSchedule(topo, ranks, nbytes, routing)
    if algo == "tree":
        return _TreeSchedule(topo, ranks, nbytes, routing)
    if algo == "sharp":
        if sharp_available(topo, nbytes):
            from repro_torch.fabric.placement import group_size
            g = group or group_size(topo)
            return _SharpSchedule(topo, ranks, nbytes, g, routing)
        ring = _RingSchedule(topo, ranks, nbytes, routing)
        tree = _TreeSchedule(topo, ranks, nbytes, routing)
        return ring if ring.total_s(None) <= tree.total_s(None) else tree
    raise KeyError(f"unknown collective algo {algo!r}; "
                   f"one of ('ring', 'tree', 'hierarchical', 'sharp')")


AUTO_CANDIDATES = ("ring", "tree", "hierarchical")


def select_algo(topo: Topology, ranks: Sequence[int], nbytes: float, *,
                group: int = 0,
                candidates: Sequence[str] = AUTO_CANDIDATES,
                weight: float = 1.0,
                routing=None,
                ) -> Tuple[str, CompiledSchedule]:
    """Pick the all-reduce schedule for this placement by measuring, not
    guessing: compile every candidate and rank them by uncongested duration,
    breaking ties by how many bytes the schedule exposes to the shared
    (oversubscribed) tier — the compiled schedules' per-link byte exposure
    is exactly the data the engine already has at (re)placement time.

    ``weight`` is the tenant's WFQ weight: under weighted fair sharing a
    tenant keeps ``w / (w + w_other)`` of a contended shared link, so each
    candidate is costed as its uncongested duration plus a *weighted
    bottleneck-exposure correction* — the duration against one unit-weight
    co-flow on every shared link (shared tier at ``w / (w + 1)``
    efficiency) minus the same estimate at weight 1. A light tenant pays a
    positive penalty proportional to its shared-tier time and steers to
    the schedule that keeps traffic off the oversubscribed tier even at
    some uncongested-duration cost; a heavy tenant discounts shared
    exposure. At ``weight=1.0`` the correction is exactly ``0.0`` and the
    path is skipped outright, so unweighted selection is bit-identical to
    the earlier single-path behavior.

    ``group=0`` resolves the hierarchical group to the topology's locality
    group (nodes per leaf / ranks per pod), so "hierarchical" means "keep
    the oversubscribed tier at bytes/leaf-group" for the fabric at hand.

    On topologies whose in-network capacity admits the payload
    (:func:`sharp_available`), ``sharp`` joins the *default* candidate set
    — appended after the host-based algos, so a tie keeps today's winner
    and existing ``algo="auto"`` selections are bit-identical. An explicit
    ``candidates=`` list is taken as-is.

    Returns ``(algo, schedule)``. Deterministic: candidate order breaks any
    remaining tie (by shared-tier byte exposure, then candidate order).
    """
    from repro_torch.fabric.placement import group_size
    g = group or group_size(topo)
    if candidates is AUTO_CANDIDATES and sharp_available(topo, nbytes):
        candidates = AUTO_CANDIDATES + ("sharp",)
    compiled = [(algo, compile_schedule(topo, ranks, nbytes, algo=algo,
                                        group=g, routing=routing))
                for algo in candidates]
    if weight != 1.0:
        # built after compilation so lazily-materialized (sparse) shared
        # links are present; on dense topologies the dicts — and thus the
        # correction arithmetic — are unchanged
        shared_links = [ln for ln, l in topo.links.items() if l.shared]
        ref_eff = {ln: 0.5 for ln in shared_links}
        w_eff = {ln: weight / (weight + 1.0) for ln in shared_links}
    best = None
    for algo, sched in compiled:
        shared_bytes = sum(
            b for ln, b in sched.bytes_per_call(None).items()
            if topo.link(ln).shared)
        cost = sched.total_s(None)
        if weight != 1.0:
            cost += sched.total_s(w_eff) - sched.total_s(ref_eff)
        key = (cost, shared_bytes)
        if best is None or key < best[0]:
            best = (key, algo, sched)
    return best[1], best[2]


def shared_byte_fraction(topo: Topology,
                         schedule: CompiledSchedule) -> float:
    """Fraction of one collective call's bytes that cross *shared* links.

    Attribution uses this as the byte-exposure weight of a tenant on the
    contended tier: a compact intra-leaf ring moves 0.0 of its bytes on
    shared links, a fully scattered one close to 1.0. Evaluated on the
    uncongested flow structure (``link_eff=None``).
    """
    total = 0.0
    shared = 0.0
    for ln, b in schedule.bytes_per_call(None).items():
        total += b
        if topo.link(ln).shared:
            shared += b
    return shared / total if total > 0.0 else 0.0


def uniform_shared_eff(topo: Topology, eff: float) -> Dict[str, float]:
    """A ``link_eff`` dict applying one efficiency to every shared link
    (non-shared links fall back to 1.0 inside :meth:`_StepPlan.time`).
    The advisor evaluates counterfactual comm floors with this — e.g.
    ``total_s(uniform_shared_eff(topo, 1/ecmp))`` isolates the span
    derate under a quiet, unskewed fabric."""
    return {name: eff for name, link in topo.links.items() if link.shared}
