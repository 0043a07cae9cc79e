"""Shared-link congestion dynamics (paper §3.2-§3.3, "fabric-level
contention").

Two coupled effects on every *shared* (oversubscribed) link:

  * **background utilization** ``u_t`` — an AR(1) process in [0, u_max]
    modelling cross-traffic from co-tenant jobs and transient hotspots.
    Effective bandwidth scales by ``(1 - u_t)``. The AR(1) persistence is
    what produces iteration-to-iteration *oscillation* rather than white
    noise (paper Fig. 1/5's instability at scale).
  * **arrival-burst penalty** — when ranks enter a collective with large
    skew, traffic bunches: late flows collide with retransmissions/queues
    built while early flows idled, ECMP hashing degrades, and switch queues
    at the oversubscribed tier build up. Modelled as a bandwidth derate
    ``1 / (1 + k_burst * skew_ratio)`` applied to shared links only. This is
    the coupling that lets *pacing* (which shrinks skew) recover throughput,
    exactly the paper's §6.3 observation.

Queueing delay on a shared link additionally follows an M/M/1-style
``u/(1-u)`` term on the link latency.

Co-tenant bandwidth sharing on a contended link is resolved by
:func:`maxmin_shares` (progressive-filling max-min fairness — the behavior
of per-flow fair queueing, and what TCP-like transports approximate), or by
its weighted generalization :func:`wfq_shares` (weighted fair queueing:
per-tenant ``weight`` scales the bottleneck share, the engines'
``fairness="wfq"`` mode), with the engine's original offered-bytes
proportional split kept behind the ``fairness="offered"`` switch.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.fabric.topology import Topology

# Residual service floor for shares that would otherwise reach 0.0: a
# literal zero share never completes (and divides the cost model by zero).
# Shared by the strict-priority starved-class floor
# (:class:`repro_torch.fabric.policies.StrictPriorityFairness`) and the
# zero-byte-owner floor in :func:`offered_share`.
RESIDUAL_SHARE = 1e-6


def _check_demands(demands: Sequence[float], capacity: float) -> None:
    """Allocator-boundary validation shared by every progressive-filling
    allocator: demands must be finite non-negative rates and ``capacity``
    a non-negative number. ``not (x >= 0.0)`` catches NaN (every
    comparison with NaN is False), so a NaN demand cannot silently
    propagate into negative or NaN allocations that break the
    conservation invariant the property suites assert."""
    if not capacity >= 0.0:
        raise ValueError(f"capacity must be >= 0, got {capacity!r}")
    for d in demands:
        if not d >= 0.0:
            raise ValueError(f"demands must be >= 0, got {d!r}")


def maxmin_shares(demands: Sequence[float], capacity: float = 1.0
                  ) -> List[float]:
    """Progressive-filling max-min fair allocation of one link's capacity.

    ``demands[j]`` is flow j's rate demand in the same units as
    ``capacity``. Flows are filled in increasing-demand order; at each turn
    a flow receives ``min(demand, remaining / flows_left)``, so unused
    headroom from small flows is redistributed to larger ones. Properties
    (held by ``tests/test_fairness.py``):

      * no flow exceeds its demand;
      * the link saturates iff total demand >= capacity
        (``sum(alloc) == min(capacity, sum(demands))``);
      * no flow is starved below its bottleneck share
        ``min(demand, capacity / n_flows)`` — the delta versus the
        offered-bytes split, which scales shares by byte volume and can
        starve small flows next to heavy ones;
      * equal demands split capacity equally (offered-bytes equivalence for
        symmetric flows).

    Negative or NaN demands (or capacity) raise :class:`ValueError` at the
    boundary — silently accepting them emits negative/NaN allocations that
    violate the conservation invariant.
    """
    _check_demands(demands, capacity)
    n = len(demands)
    alloc = [0.0] * n
    if n == 0:
        return alloc
    remaining = capacity
    order = sorted(range(n), key=demands.__getitem__)
    for pos, j in enumerate(order):
        fair = remaining / (n - pos)
        give = demands[j] if demands[j] < fair else fair
        alloc[j] = give
        remaining -= give
    return alloc


def wfq_shares(demands: Sequence[float],
               weights: Optional[Sequence[float]] = None,
               capacity: float = 1.0) -> List[float]:
    """Weighted progressive-filling allocation of one link's capacity —
    the steady-state bandwidth split of weighted fair queueing.

    Flow j demands ``demands[j]`` and carries positive ``weight[j]``; the
    water level is found by filling flows in increasing *normalized* demand
    (``demand / weight``) order, each receiving
    ``min(demand, remaining * weight / weight_left)`` so headroom unused by
    satisfied flows is redistributed in proportion to weight. Properties
    (held by ``tests/test_fairness.py``):

      * conservation/saturation: ``sum(alloc) == min(capacity,
        sum(demands))`` and no flow exceeds its demand;
      * weighted no-starvation: every flow gets at least
        ``min(demand, capacity * w_j / sum(w))``;
      * monotone in weight: raising one flow's weight never shrinks its
        allocation;
      * **bit-exact reduction**: with every weight exactly ``1.0`` (or
        ``weights=None``) the arithmetic below is operation-for-operation
        :func:`maxmin_shares` — ``x * 1.0`` is exact and ``weight_left``
        stays an exact small integer — so uniform-weight WFQ reproduces
        the unweighted max-min series bit-for-bit, not approximately.
    """
    n = len(demands)
    alloc = [0.0] * n
    if n == 0:
        return alloc
    if weights is None:
        # single source for the unweighted arithmetic: the hot engine
        # paths call maxmin_shares directly, and the explicit-weights
        # path below is held bit-identical to it by the property tests
        return maxmin_shares(demands, capacity)
    if len(weights) != n:
        raise ValueError(f"{n} demands but {len(weights)} weights")
    _check_demands(demands, capacity)
    w_left = 0.0
    for w in weights:
        if not w > 0.0:
            raise ValueError(f"weights must be positive, got {w!r}")
        w_left += w
    remaining = capacity
    order = sorted(range(n), key=lambda j: demands[j] / weights[j])
    for j in order:
        w = weights[j]
        fair = remaining * w / w_left if w_left > 0.0 else remaining
        give = demands[j] if demands[j] < fair else fair
        alloc[j] = give
        remaining -= give
        w_left -= w
    return alloc


def strict_priority_shares(demands: Sequence[float],
                           priorities: Sequence[float],
                           capacity: float = 1.0) -> List[float]:
    """Strict-priority allocation of one link's capacity: priority classes
    are served in descending order, each class splitting whatever capacity
    the classes above it left by progressive-filling max-min fairness.
    A lower class sees bandwidth only after every higher class is satisfied
    — the paper's "protected tenant" extreme, next to WFQ's proportional
    one. Properties (held by ``tests/test_fairness.py``):

      * conservation/saturation: ``sum(alloc) == min(capacity,
        sum(demands))`` and no flow exceeds its demand;
      * dominance: a class receives nothing until all higher classes are
        at their demand;
      * **bit-exact reduction**: uniform priorities collapse to a single
        class, which is allocated by one :func:`maxmin_shares` call over
        the full capacity — operation-for-operation identical to the
        unweighted allocator.
    """
    n = len(demands)
    if len(priorities) != n:
        raise ValueError(f"{n} demands but {len(priorities)} priorities")
    alloc = [0.0] * n
    remaining = capacity
    for prio in sorted(set(priorities), reverse=True):
        idx = [j for j in range(n) if priorities[j] == prio]
        sub = maxmin_shares([demands[j] for j in idx], remaining)
        for j, a in zip(idx, sub):
            alloc[j] = a
            remaining -= a
        if remaining < 0.0:
            remaining = 0.0
    return alloc


def drr_shares(demands: Sequence[float],
               weights: Optional[Sequence[float]] = None,
               capacity: float = 1.0, rounds: int = 64) -> List[float]:
    """Deficit-round-robin allocation of one link's capacity.

    Unlike the fluid WFQ water level, DRR is *quantized*: flows are served
    in fixed ring order, each accumulating a per-round deficit counter of
    ``quantum * weight`` and sending up to its counter. The smallest-weight
    flow's quantum is ``capacity / rounds``, so the schedule drains in at
    most ~``rounds`` passes and the discretization error versus the fluid
    weighted share is bounded by one quantum per flow. Properties (held by
    ``tests/test_fairness.py``):

      * conservation/saturation: ``sum(alloc) == min(capacity,
        sum(demands))`` and no flow exceeds its demand;
      * uniform weights reduce to :func:`maxmin_shares` within one quantum
        (``capacity / rounds``) per flow — the quantization is the only
        difference;
      * ring-order bias is bounded: raising ``rounds`` converges to the
        weighted fluid allocation.

    Negative or NaN demands (or capacity) raise :class:`ValueError` at the
    boundary, mirroring :func:`maxmin_shares` — a NaN backlog would spin
    the deficit loop forever and a negative one emits negative sends.
    """
    _check_demands(demands, capacity)
    n = len(demands)
    alloc = [0.0] * n
    if n == 0:
        return alloc
    if weights is None:
        weights = [1.0] * n
    if len(weights) != n:
        raise ValueError(f"{n} demands but {len(weights)} weights")
    for w in weights:
        if not w > 0.0:
            raise ValueError(f"weights must be positive, got {w!r}")
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    w_min = min(weights)
    unit = capacity / rounds / w_min
    deficit = [0.0] * n
    remaining = capacity
    active = [j for j in range(n) if demands[j] > 0.0]
    while remaining > 1e-15 * capacity and active:
        still = []
        for j in active:
            deficit[j] += unit * weights[j]
            send = deficit[j]
            backlog = demands[j] - alloc[j]
            if backlog < send:
                send = backlog
            if remaining < send:
                send = remaining
            alloc[j] += send
            deficit[j] -= send
            remaining -= send
            if alloc[j] < demands[j]:
                still.append(j)
            if remaining <= 0.0:
                break
        active = still
    return alloc


def batch_bytes(base_bytes: float, occupancy: int) -> float:
    """Batch-occupancy-weighted collective payload for continuous-batching
    inference fleets.

    A serving replica's per-token collective moves activations whose batch
    dimension is the *current* batch occupancy, so the offered bytes (and
    therefore both the collective's duration and the demand it presents to
    co-tenant flows on shared links) scale linearly with how many requests
    share the step — not with the configured maximum. ``occupancy * base``
    is computed as ``float(int) * float`` so occupancy 1 is bit-exactly the
    single-request payload (the ``batching="none"`` compatibility anchor).
    """
    if occupancy < 0:
        raise ValueError(f"occupancy must be >= 0, got {occupancy!r}")
    return float(occupancy) * base_bytes


def offered_share(own_bytes: float, d_i: float,
                  flows: Sequence[Tuple[float, float]]) -> float:
    """Offered-bytes proportional share of one link for a collective of
    duration ``d_i``: each co-tenant flow ``(overlap_s, offered_bytes)``
    contributes its bytes scaled by how much of the window it overlaps;
    the owner keeps ``own / total``. Shared by both engines so the model
    cannot fork.

    The share is floored at :data:`RESIDUAL_SHARE` (mirroring the
    strict-priority starved-class floor): a zero-byte collective next to
    co-tenant flows (``total > own_bytes`` with ``own_bytes == 0.0``)
    would otherwise keep share ``0.0``, which downstream duration
    division turns into ``inf``."""
    total = own_bytes
    for ov, b in flows:
        total += b if ov >= d_i else (ov / d_i) * b
    share = own_bytes / total if total > own_bytes else 1.0
    return share if share > RESIDUAL_SHARE else RESIDUAL_SHARE


def maxmin_share(d_i: float, owner_overlaps: Sequence[float]) -> float:
    """Max-min share of one link for a collective of duration ``d_i``:
    every co-tenant is one flow whose rate demand is the fraction of the
    window its traffic occupies (aggregated per owner, capped at the full
    window); the owner demands the whole link and receives its
    progressive-filling allocation."""
    demands = [1.0] + [min(1.0, ov / d_i) for ov in owner_overlaps]
    return maxmin_shares(demands)[0]


def wfq_share(d_i: float, own_weight: float,
              owner_flows: Sequence[Tuple[float, float]]) -> float:
    """Weighted share of one link for a collective of duration ``d_i``:
    the :func:`maxmin_share` flow model (one flow per co-tenant owner,
    demand = fraction of the window its traffic occupies, owner demands
    the whole link) resolved by :func:`wfq_shares` with per-owner weights.
    ``owner_flows`` holds ``(overlap_s, weight)`` per co-tenant owner.
    All weights 1.0 reduces bit-exactly to :func:`maxmin_share`."""
    demands = [1.0] + [min(1.0, ov / d_i) for ov, _ in owner_flows]
    weights = [own_weight] + [w for _, w in owner_flows]
    return wfq_shares(demands, weights)[0]


def strict_priority_share(d_i: float, own_priority: float,
                          owner_flows: Sequence[Tuple[float, float]]
                          ) -> float:
    """Strict-priority share of one link for a collective of duration
    ``d_i``: the :func:`maxmin_share` flow model resolved by
    :func:`strict_priority_shares` over per-owner priorities.
    ``owner_flows`` holds ``(overlap_s, priority)`` per co-tenant owner.
    Uniform priorities reduce bit-exactly to :func:`maxmin_share`."""
    demands = [1.0] + [min(1.0, ov / d_i) for ov, _ in owner_flows]
    prios = [own_priority] + [p for _, p in owner_flows]
    return strict_priority_shares(demands, prios)[0]


def drr_share(d_i: float, own_weight: float,
              owner_flows: Sequence[Tuple[float, float]]) -> float:
    """Deficit-round-robin share of one link for a collective of duration
    ``d_i``: the :func:`maxmin_share` flow model resolved by
    :func:`drr_shares` over per-owner weights. ``owner_flows`` holds
    ``(overlap_s, weight)`` per co-tenant owner."""
    demands = [1.0] + [min(1.0, ov / d_i) for ov, _ in owner_flows]
    weights = [own_weight] + [w for _, w in owner_flows]
    return drr_shares(demands, weights)[0]


@dataclasses.dataclass(frozen=True)
class CongestionConfig:
    u_mean: float = 0.30              # long-run background utilization
    u_sigma: float = 0.08             # innovation scale of the AR(1)
    u_rho: float = 0.90               # AR(1) persistence (oscillation)
    u_max: float = 0.9
    k_burst: float = 1.0              # skew -> bandwidth derate gain
    ecmp_k: float = 0.8               # per-extra-leaf ECMP/incast derate
    k_kick: float = 0.0               # skew-burst -> queue-buildup hysteresis


class CongestionModel:
    """AR(1) background-utilization state per tracked shared link.

    Dense topologies (``fat_tree``/``tpu_pod``) track every shared link
    from construction — the per-step gaussian draw order over that set is
    part of the bit-exact determinism contract held by the goldens. Sparse
    topologies (``sparse_links = True``) start empty and the engines
    :meth:`track` exactly the shared links their tenants' compiled
    schedules touch, so congestion state scales with *active* links, not
    fabric size."""

    def __init__(self, cfg: CongestionConfig, topo: Topology, seed: int = 0):
        self.cfg = cfg
        self.topo = topo
        self.rng = random.Random(seed)
        if topo.sparse_links:
            self.u: Dict[str, float] = {}
        else:
            self.u = {
                name: cfg.u_mean
                for name, l in topo.links.items() if l.shared}

    def track(self, names) -> None:
        """Start tracking the shared links among ``names`` (idempotent —
        already-tracked links keep their state, so on dense topologies
        this is a no-op and the gauss stream is untouched)."""
        u_map = self.u
        u_mean = self.cfg.u_mean
        link = self.topo.link
        for name in names:
            if name not in u_map and link(name).shared:
                u_map[name] = u_mean

    def advance(self) -> None:
        # Hot loop (once per simulated iteration): random.gauss inlined with
        # its pair cache, AR(1) constants hoisted. Bit-identical to the seed
        # implementation kept in repro_torch.fabric._reference.
        c = self.cfg
        rng = self.rng
        rnd = rng.random
        rho = c.u_rho
        drift = (1 - rho) * c.u_mean
        iscale = (1 - rho) ** 0.5
        sigma = c.u_sigma
        u_max = c.u_max
        cos, sin, log, sqrt = math.cos, math.sin, math.log, math.sqrt
        twopi = 2.0 * math.pi
        u_map = self.u
        g_next = rng.gauss_next
        rng.gauss_next = None
        for name in u_map:
            z = g_next
            if z is None:
                x2pi = rnd() * twopi
                g2rad = sqrt(-2.0 * log(1.0 - rnd()))
                z = cos(x2pi) * g2rad
                g_next = sin(x2pi) * g2rad
            else:
                g_next = None
            u = rho * u_map[name] + drift + iscale * (z * sigma)
            if u < 0.0:
                u = 0.0
            elif u > u_max:
                u = u_max
            u_map[name] = u
        rng.gauss_next = g_next

    def link_eff(self, skew_ratio: float, spanning_groups: int = 1
                 ) -> Dict[str, float]:
        """Effective bandwidth multiplier per shared link for this step.

        ``skew_ratio`` — collective entry spread / serialization time;
        ``spanning_groups`` — leaves (or pods) the collective spans; flow
        concentration and ECMP collisions grow with it.
        """
        c = self.cfg
        burst = 1.0 + c.k_burst * max(0.0, skew_ratio)
        ecmp = 1.0 + c.ecmp_k * max(0, spanning_groups - 1)
        denom = burst * ecmp
        return {name: max(1e-3, (1.0 - u) / denom)
                for name, u in self.u.items()}

    def kick(self, skew_ratio: float) -> None:
        """Queue-buildup hysteresis: a skewed (bursty) collective leaves
        switch queues, ECN marks, and retransmission state behind on the
        shared tier; that damage *persists* and decays through the AR(1),
        producing the paper's multi-iteration oscillations. Pacing earns
        its throughput win here: smoothing arrivals prevents the kick at
        the source rather than riding it out."""
        c = self.cfg
        if c.k_kick <= 0.0 or skew_ratio <= 0.0:
            return
        kk = c.k_kick * skew_ratio
        u_max = c.u_max
        u_map = self.u
        for name, u in u_map.items():
            u = u + kk * (1.0 - u)
            u_map[name] = u_max if u > u_max else u

    def queue_delay(self, link_name: str) -> float:
        """M/M/1-style queueing delay on top of base latency."""
        link = self.topo.link(link_name)
        u = self.u.get(link_name, 0.0)
        return link.latency_s * (u / max(1e-3, 1.0 - u))


def derate_factors(cfg: CongestionConfig, skew_ratio: float,
                   spanning_groups: int = 1) -> Dict[str, float]:
    """The multiplicative derate terms behind :meth:`CongestionModel.
    link_eff`, exposed individually for bottleneck attribution.

    ``link_eff`` divides the raw bandwidth by ``burst * ecmp`` and scales
    it by ``1 - u``; the advisor needs each factor on its own so it can
    apportion a tenant's overhead between synchronization amplification
    (``burst``), background contention (``background``) and placement
    span (``ecmp``). Must mirror the ``link_eff`` arithmetic exactly.
    """
    return {
        "background": 1.0 - cfg.u_mean,
        "burst": 1.0 + cfg.k_burst * max(0.0, skew_ratio),
        "ecmp": 1.0 + cfg.ecmp_k * max(0, spanning_groups - 1),
    }
