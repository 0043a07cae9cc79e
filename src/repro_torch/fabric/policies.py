"""Pluggable policy registries: fairness, scheduling, placement,
request routers, and multi-path routing.

The engines grew three orthogonal policy axes — how contended shared links are
split between co-tenant flows (*fairness*), how the blocked-arrival queue
drains (*scheduling*), and how ranks map onto nodes (*placement*) — but
each was a stringly-typed kwarg resolved by an if/elif chain inside the
engines. This module makes the axes first-class: one
:class:`PolicyRegistry` per axis, each entry addressable by name from
:class:`~repro_torch.fabric.scenario.Scenario` policy blocks, engine kwargs, and
third-party code alike. Registering a new policy is::

    from repro_torch.fabric.policies import FAIRNESS, FairnessPolicy

    @FAIRNESS.register("my_mode")
    class MyFairness(FairnessPolicy):
        name = "my_mode"
        def link_share(self, d_i, own_bytes, own_weight, own_priority,
                       flows, owners):
            ...

— no engine code changes. The built-in entries:

  * **fairness** — ``maxmin`` (default; progressive filling),
    ``wfq`` (weighted progressive filling over tenant ``weight``),
    ``offered`` (the first offered-bytes proportional split),
    ``strict_priority`` (priority classes served in descending order,
    max-min within a class, over tenant ``priority``), and
    ``drr`` (deficit round robin: quantized weighted sharing).
  * **schedulers** — ``fifo`` / ``backfill`` / ``preempt``
    (:mod:`repro_torch.fabric.scheduling` registers them).
  * **placements** — ``compact`` / ``scattered`` / ``striped`` /
    ``random`` / ``slo_aware`` (:mod:`repro_torch.fabric.placement` registers
    them).
  * **routers** — how a multi-replica inference fleet spreads arriving
    requests over its replicas: ``round_robin`` (stateful cycle) and
    ``jsq`` (join-shortest-queue over outstanding work). Registered here
    directly — routers are pure queue-choice functions with no engine
    dependencies.
  * **routing** — how collective schedules map a topology's parallel
    inter-pod paths (``@group#salt`` route tokens, see
    :mod:`repro_torch.fabric.topology`) onto member links: ``ecmp_static``
    (default — the salt hash pins one member per flow at compile time,
    bit-compatible with the pre-routing single-path costs held by the
    goldens and fingerprint baselines) and ``adaptive_spray`` (bytes
    re-split across *all* members each iteration in proportion to their
    observed effective capacity). Registered here directly. Backends:
    ``ecmp_static`` runs on every backend; ``adaptive_spray`` is
    reference-only (the batched scenario runner declares it unsupported via
    the nearest-backend error contract).

Every share function a fairness entry dispatches to lives in
:mod:`repro_torch.fabric.congestion`; the entries here are thin adapters, so the
bit-exact contracts (uniform-weight WFQ == max-min, uniform-priority
strict-priority == max-min) hold through the registry.
"""
from __future__ import annotations

from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

from repro_torch.fabric.congestion import (RESIDUAL_SHARE, drr_share, maxmin_share,
                                     offered_share, strict_priority_share,
                                     wfq_share)

# one co-tenant flow overlapping the window: (overlap_s, offered_bytes)
Flow = Tuple[float, float]
# per-owner aggregated activity: (overlap_s, weight, priority)
OwnerFlow = Tuple[float, float, float]


class PolicyRegistry:
    """Name -> policy mapping with registration-order ``names()`` and
    KeyError messages that list the valid entries. Dict-like read access
    (``in``, ``[...]``, iteration over names) for drop-in compatibility
    with the plain dicts it replaces."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, object] = {}

    def register(self, name: str, entry: object = None):
        """``register(name, entry)`` directly, or ``@register(name)`` as a
        class/function decorator. Re-registering a taken name raises."""
        def _add(obj):
            if name in self._entries:
                raise ValueError(
                    f"{self.kind} {name!r} is already registered")
            self._entries[name] = obj
            return obj
        if entry is not None:
            return _add(entry)
        return _add

    def get(self, name: str):
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(f"unknown {self.kind} {name!r}; "
                           f"one of {self.names()}") from None

    def names(self) -> Tuple[str, ...]:
        return tuple(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __getitem__(self, name: str):
        return self.get(name)

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def items(self):
        return self._entries.items()


FAIRNESS = PolicyRegistry("fairness mode")
SCHEDULERS = PolicyRegistry("scheduler")
PLACEMENTS = PolicyRegistry("placement policy")
ROUTERS = PolicyRegistry("router")
ROUTING = PolicyRegistry("routing policy")


# ---------------------------------------------------------------------------
# routing entries (parallel-path resolution for collective schedules)
# ---------------------------------------------------------------------------


class RoutingPolicy:
    """How a collective schedule resolves a ``@group#salt`` route token
    emitted by a multi-path topology (today: ``multi_pod``'s parallel
    inter-pod links).

    Static policies (``adaptive = False``) pin each flow to one member at
    schedule-compile time via :meth:`choose`; adaptive policies keep the
    whole member group in the compiled plan and re-split the flow's bytes
    at every cost evaluation from the members' observed efficiency (see
    ``collectives._StepPlan``). Policies are stateless values — engines
    share one instance per name via :func:`resolve_routing`."""

    name: str = ""
    adaptive: bool = False

    def choose(self, members: Sequence[str], salt: int) -> str:
        """The member link a statically-routed flow lands on."""
        raise NotImplementedError


@ROUTING.register("ecmp_static")
class EcmpStaticRouting(RoutingPolicy):
    """Hash-pinned single path per flow (the fabric's ECMP): the token
    salt indexes the member list once, at compile time. This is the
    bit-compat default — on single-path topologies it is a no-op."""

    name = "ecmp_static"

    def choose(self, members: Sequence[str], salt: int) -> str:
        return members[salt % len(members)]


@ROUTING.register("adaptive_spray")
class AdaptiveSprayRouting(RoutingPolicy):
    """Per-iteration packet spray: the flow's bytes split across all
    member links in proportion to each member's observed effective
    capacity, so a derated or congested member sheds load to its
    parallel peers every step (reference backend only)."""

    name = "adaptive_spray"
    adaptive = True

    def choose(self, members: Sequence[str], salt: int) -> str:
        # static consumers (byte accounting) fall back to the ECMP pick
        return members[salt % len(members)]


def resolve_routing(spec: Union[str, RoutingPolicy, None]) -> RoutingPolicy:
    """Engine-facing resolver: a registered name, a policy instance, or
    None (the bit-compat ``ecmp_static`` default)."""
    if spec is None:
        spec = "ecmp_static"
    if isinstance(spec, RoutingPolicy):
        return spec
    policy = ROUTING.get(spec)
    return policy() if isinstance(policy, type) else policy


# ---------------------------------------------------------------------------
# router entries (multi-replica inference fleets)
# ---------------------------------------------------------------------------


class RouterPolicy:
    """How an inference fleet assigns an arriving request to one of its
    replicas. ``pick`` receives the per-replica queue depth (waiting +
    in-batch requests, i.e. all outstanding work) at routing time and
    returns the chosen replica index. Routers may be stateful
    (round-robin's cursor), so fleets build a fresh instance per tenant
    via :func:`resolve_router`."""

    name: str = ""

    def pick(self, depths: Sequence[int]) -> int:
        raise NotImplementedError


@ROUTERS.register("round_robin")
class RoundRobinRouter(RouterPolicy):
    """Cycle over replicas regardless of load — the blind baseline."""

    name = "round_robin"

    def __init__(self) -> None:
        self._cursor = 0

    def pick(self, depths: Sequence[int]) -> int:
        i = self._cursor % len(depths)
        self._cursor += 1
        return i


@ROUTERS.register("jsq")
class JoinShortestQueueRouter(RouterPolicy):
    """Join-shortest-queue: the replica with the least outstanding work,
    lowest index among ties (deterministic). Never routes to a strictly
    longer queue — the property ``tests/test_batching.py`` pins."""

    name = "jsq"

    def pick(self, depths: Sequence[int]) -> int:
        return min(range(len(depths)), key=lambda i: (depths[i], i))


def resolve_router(spec: Union[str, RouterPolicy]) -> RouterPolicy:
    """Fleet-facing resolver: a registered name (fresh instance — routers
    carry state) or an already-built policy instance."""
    if isinstance(spec, RouterPolicy):
        return spec
    policy = ROUTERS.get(spec)
    return policy() if isinstance(policy, type) else policy


# ---------------------------------------------------------------------------
# fairness entries
# ---------------------------------------------------------------------------


class FairnessPolicy:
    """How one tenant's collective shares a contended link with co-tenant
    flows overlapping its window.

    ``link_share`` returns the fraction of the (already congestion-derated)
    link bandwidth the owner keeps. ``d_i`` is the owner's tentative
    collective duration, ``own_bytes`` its offered bytes on the link,
    ``own_weight``/``own_priority`` its spec fields, ``flows`` every
    overlapping co-tenant flow as ``(overlap_s, bytes)``, and ``owners``
    the same activity aggregated per co-tenant owner as
    ``(overlap_s, weight, priority)``.

    ``weighted`` declares whether tenant ``weight`` steers the share —
    when True, ``algo="auto"`` selection also costs candidates at the
    tenant's expected contended share (see
    :func:`repro_torch.fabric.collectives.select_algo`).
    """

    name: str = ""
    weighted: bool = False

    def link_share(self, d_i: float, own_bytes: float, own_weight: float,
                   own_priority: float, flows: List[Flow],
                   owners: List[OwnerFlow]) -> float:
        raise NotImplementedError


@FAIRNESS.register("maxmin")
class MaxMinFairness(FairnessPolicy):
    """Unweighted progressive filling (the default behavior)."""

    name = "maxmin"

    def link_share(self, d_i, own_bytes, own_weight, own_priority, flows,
                   owners):
        return maxmin_share(d_i, [ov for ov, _, _ in owners])


@FAIRNESS.register("wfq")
class WfqFairness(FairnessPolicy):
    """Weighted progressive filling over tenant ``weight`` (uniform
    weights are bit-identical to ``maxmin``)."""

    name = "wfq"
    weighted = True

    def link_share(self, d_i, own_bytes, own_weight, own_priority, flows,
                   owners):
        return wfq_share(d_i, own_weight,
                         [(ov, w) for ov, w, _ in owners])


@FAIRNESS.register("offered")
class OfferedFairness(FairnessPolicy):
    """The first offered-bytes proportional split, kept for comparison."""

    name = "offered"

    def link_share(self, d_i, own_bytes, own_weight, own_priority, flows,
                   owners):
        return offered_share(own_bytes, d_i, flows)


@FAIRNESS.register("strict_priority")
class StrictPriorityFairness(FairnessPolicy):
    """Priority classes served in descending ``priority`` order; max-min
    within a class (uniform priorities are bit-identical to ``maxmin``).

    A class fully starved by saturated higher classes is floored at
    ``RESIDUAL_SHARE`` rather than exactly 0.0: a literal zero share
    means the collective never completes (and divides the cost model by
    zero); physically, even strict-priority queues leak residual service
    to lower classes. The floor is far below any share the uniform-
    priority (single-class) reduction can produce, so bit-exactness with
    ``maxmin`` is unaffected.
    """

    name = "strict_priority"
    # single source with congestion.offered_share's zero-byte-owner floor
    RESIDUAL_SHARE = RESIDUAL_SHARE

    def link_share(self, d_i, own_bytes, own_weight, own_priority, flows,
                   owners):
        share = strict_priority_share(d_i, own_priority,
                                      [(ov, p) for ov, _, p in owners])
        return share if share > self.RESIDUAL_SHARE \
            else self.RESIDUAL_SHARE


@FAIRNESS.register("drr")
class DrrFairness(FairnessPolicy):
    """Deficit round robin: quantized weighted sharing in fixed ring
    order (converges to the WFQ fluid share as the quantum shrinks)."""

    name = "drr"
    weighted = True

    def link_share(self, d_i, own_bytes, own_weight, own_priority, flows,
                   owners):
        return drr_share(d_i, own_weight, [(ov, w) for ov, w, _ in owners])


def resolve_fairness(spec: Union[str, FairnessPolicy]) -> FairnessPolicy:
    """Engine-facing resolver: a registered name or a policy instance."""
    if isinstance(spec, FairnessPolicy):
        return spec
    policy = FAIRNESS.get(spec)
    return policy() if isinstance(policy, type) else policy


def resolve_placement(name: str) -> Callable:
    """Placement entry for ``name``: ``fn(topo, n, free, seed=...)``."""
    return PLACEMENTS.get(name)
