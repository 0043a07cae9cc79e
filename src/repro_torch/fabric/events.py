"""Event-driven tenant lifecycle engine: the step from "N static jobs" to
"a cluster with a schedule".

:class:`~repro_torch.fabric.engine.FabricEngine` steps a fixed population of
training jobs that all start at t = 0 and never change. The paper's failure
modes, though, emerge from *dynamic* sharing: jobs arriving while an
incumbent holds the fabric, nodes failing mid-run, and bursty
latency-sensitive inference fleets mixing with BSP training on the same
oversubscribed links. :class:`LifecycleEngine` drives that dynamics from a
**virtual-clock event timeline**:

  * :class:`Arrival` events admit tenants (training
    :class:`~repro_torch.fabric.engine.JobSpec` or open-loop inference
    :class:`~repro_torch.fabric.workloads.InferenceSpec`) at any virtual time,
    placing them on the free-node pool with their placement policy; when
    the pool cannot host an arrival it blocks and retries as soon as
    capacity frees up.
  * :class:`NodeFailure` events kill nodes. The owning tenant's
    :class:`~repro_torch.ft.failure.FailureDetector` — running on the engine's
    *virtual clock*, threaded explicitly — notices when the silent node's
    heartbeat timeout expires; the tenant then releases its nodes back to
    the pool, shrinks by its elastic plan
    (:func:`repro_torch.ft.failure.plan_elastic_mesh` keeps the model-parallel
    width intact), re-places on surviving nodes, and re-compiles its
    collective schedule (re-running ``algo="auto"`` selection for the new
    placement) — mid-run, without touching other tenants.
  * :class:`Departure` events (or ``JobSpec.iters``) retire tenants and
    return their nodes.

Inference fleets are first-class tenants: a multi-replica
:class:`~repro_torch.fabric.workloads.InferenceSpec` consumes ``total_ranks``
(= ``n_ranks * replicas``) nodes from the pool, its placement policy sees
the spec itself (``placement="slo_aware"`` packs latency-bound replica
chunks whole into best-fit leaves), and its per-replica virtual-clock
queues surface *batch-join* events — requests joining a running
continuous batch — into the engine's timeline log after each resolution
(:meth:`~repro_torch.fabric.workloads.Tenant.drain_log`).

Between events, the engine resolves tenants' collectives in global
window-start order. Each tenant owns an independent background-congestion
AR(1) stream (seeded per tenant), so *modeled* co-tenants interact only
through the explicit flow-contention model: progressive-filling **max-min
fairness** over the flows overlapping a collective's window
(:func:`repro_torch.fabric.congestion.maxmin_shares`; ``fairness="wfq"``
resolves the same flows by *weighted* progressive filling over per-tenant
``weight`` — all weights 1.0 is bit-identical to max-min —, and
``fairness="offered"`` keeps the first offered-bytes split for comparison).
That isolation is a testable property: a tenant's step-time series is
bit-identical whether or not a co-tenant runs on disjoint links, and
degrades exactly while a co-tenant's collectives overlap its own on shared
links. Same seed + same event list => bit-identical series, including
across a mid-run failure and re-placement.

The blocked-arrival queue is policy-driven
(:mod:`repro_torch.fabric.scheduling`): ``scheduler="fifo"`` (default) is the
first-engine behavior bit-for-bit, ``"backfill"`` drains the queue in priority
order and backfills small tenants into leftover capacity, and
``"preempt"`` additionally evicts lower-priority running training tenants
for a high-priority blocked entry — the victim re-enters the queue with
its progress intact and resumes through the same re-place/re-compile path
failure recovery uses. Weighted shares reach every consumer: pacing
(:class:`~repro_torch.core.pacing.PacingBank`) observes WFQ-shared collective
durations, and ``algo="auto"`` selection costs each candidate's shared-
tier exposure at the tenant's expected contended share
(:func:`~repro_torch.fabric.collectives.select_algo` ``weight=``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.fabric import _deprecation
from repro_torch.fabric.congestion import CongestionConfig, CongestionModel
from repro_torch.fabric.engine import JobSpec
from repro_torch.fabric.placement import place
from repro_torch.fabric.policies import (FairnessPolicy, resolve_fairness,
                                   resolve_routing)
from repro_torch.fabric.scheduling import (Scheduler, entry_priority,
                                     make_scheduler)
from repro_torch.fabric.topology import Topology
from repro_torch.fabric.workloads import (InferenceSpec, InferenceTenant, Tenant,
                                    TrainingTenant)
from repro_torch.ft.failure import (HeartbeatConfig, RestoreCostModel,
                              simulated_clock_scope)

TenantSpec = Union[JobSpec, InferenceSpec]


# ---------------------------------------------------------------------------
# timeline events
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Arrival:
    """A tenant enters the cluster at virtual time ``t``."""
    t: float
    spec: TenantSpec


@dataclasses.dataclass(frozen=True)
class Departure:
    """The named tenant retires at virtual time ``t``."""
    t: float
    name: str


@dataclasses.dataclass(frozen=True)
class NodeFailure:
    """Node ``node`` dies at virtual time ``t`` and never comes back."""
    t: float
    node: int


# effective-bandwidth multiplier a flapped link keeps while down: routing
# protocols drain a flapping link rather than black-holing it, so cost
# models see a crushed-but-finite capacity instead of a divide-by-zero
FLAP_EFF = 1e-3


@dataclasses.dataclass(frozen=True)
class LinkFlap:
    """Link ``link`` flaps at ``t``: effectively down (``FLAP_EFF``) for
    ``down_s`` simulated seconds, then fully restored."""
    t: float
    link: str
    down_s: float

    def window(self) -> Tuple[float, float, float]:
        return (self.t, self.t + self.down_s, FLAP_EFF)


@dataclasses.dataclass(frozen=True)
class LinkDegrade:
    """Link ``link`` runs at ``factor`` of its bandwidth from ``t`` for
    ``duration_s`` seconds (None: permanently — an unrepaired optics or
    cable fault)."""
    t: float
    link: str
    factor: float
    duration_s: Optional[float] = None

    def window(self) -> Tuple[float, float, float]:
        end = self.t + self.duration_s if self.duration_s is not None \
            else float("inf")
        return (self.t, end, self.factor)


Event = Union[Arrival, Departure, NodeFailure, LinkFlap, LinkDegrade]


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------


class LifecycleResult:
    """Outcome of one lifecycle run: tenant runtimes plus the event log."""

    def __init__(self, topo: Topology, tenants: List[Tenant],
                 log: List[Tuple[float, str, str]],
                 link_bytes: Dict[str, float], horizon: float):
        self.topo = topo
        self.tenants = tenants
        self.log = log
        self.link_bytes = link_bytes
        self.horizon = horizon

    def tenant(self, name: str) -> Tenant:
        for t in self.tenants:
            if t.name == name:
                return t
        raise KeyError(name)

    @property
    def training(self) -> List[TrainingTenant]:
        return [t for t in self.tenants if t.kind == "training"]

    @property
    def inference(self) -> List[InferenceTenant]:
        return [t for t in self.tenants if t.kind == "inference"]


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


class LifecycleEngine:
    """Steps a dynamic tenant population on one topology (virtual clock)."""

    def __init__(self, topo: Topology, events: Sequence[Event], *,
                 congestion: Optional[CongestionConfig] = None,
                 heartbeat: Optional[HeartbeatConfig] = None,
                 fairness: Union[str, FairnessPolicy] = "maxmin",
                 scheduler: Union[str, Scheduler] = "fifo",
                 replan_delay_s: Optional[float] = 0.5,
                 restore_cost: Optional[RestoreCostModel] = None,
                 base_seed: int = 0, routing=None):
        _deprecation.warn_legacy(
            "LifecycleEngine(topo, events, ...)",
            "Scenario(topology=..., events=[...], policies=Policies("
            "fairness=..., scheduler=...)).run()")
        self.policy: FairnessPolicy = resolve_fairness(fairness)
        self.routing = resolve_routing(routing)
        self.topo = topo
        self.fairness = self.policy.name
        self.scheduler = make_scheduler(scheduler)
        self.congestion_cfg = congestion if congestion is not None \
            else CongestionConfig()
        # simulated steps are ~0.2 s, so the wall-clock-scale defaults of
        # HeartbeatConfig would stall a failed job for simulated minutes
        self.heartbeat = heartbeat if heartbeat is not None \
            else HeartbeatConfig(interval_s=0.2, timeout_s=1.0)
        # replan_delay_s=0.5 is the constant the golden determinism
        # fixtures were recorded under; replan_delay_s=None (or an explicit
        # restore_cost) derives the per-tenant delay from the checkpoint-
        # restore cost model instead: param bytes / restore bandwidth.
        self.replan_delay_s = replan_delay_s
        self._restore_cost = restore_cost if restore_cost is not None \
            else (RestoreCostModel() if replan_delay_s is None else None)
        self.base_seed = base_seed
        self._timeline: List[Tuple[float, int, Event]] = sorted(
            (ev.t, i, ev) for i, ev in enumerate(events))
        self._now = 0.0
        self._active: List[Tenant] = []
        self._finished: List[Tenant] = []
        self._weights: Dict[str, float] = {}      # name -> WFQ weight
        self._prios: Dict[str, float] = {}        # name -> priority class
        self._evicted_at: Dict[str, float] = {}   # name -> last eviction t
        self._taken: Dict[int, str] = {}          # node -> tenant name
        self._dead: set = set()
        # per shared link: (start, end, demand_bytes, owner_name) windows
        self._segments: Dict[str, list] = {}
        # per link: (start, end, factor) derate windows from LinkFlap /
        # LinkDegrade events; empty on scenarios without link events, so
        # the fast path in _derate_eff keeps legacy series bit-identical
        self._link_derates: Dict[str, List[Tuple[float, float, float]]] = {}
        self._log: List[Tuple[float, str, str]] = []
        self.link_bytes: Dict[str, float] = {}
        self._tenant_seq = 0
        self._evicted = False
        self._ran = False

    # the virtual clock every FailureDetector consumes
    def _clock(self) -> float:
        return self._now

    def _record(self, kind: str, detail: str) -> None:
        self._log.append((self._now, kind, detail))

    # -- admission ---------------------------------------------------------
    def _replan_delay(self, tenant: Tenant) -> float:
        """Stall between losing a placement (failure or preemption) and
        stepping again on the new one: the 0.5 s constant, or the
        checkpoint-restore cost model when one is configured."""
        if self._restore_cost is not None:
            return self._restore_cost.delay_s(tenant.param_bytes)
        return self.replan_delay_s

    # _try_place outcome for a terminally-rejected entry: it leaves the
    # queue but consumed no capacity, so a drain must not count it as
    # progress (a redundant extra pass would duplicate 'blocked' records)
    _REJECTED = "rejected"

    def _admit(self, entry) -> bool:
        """Admit a queue entry (fresh spec or preempted tenant). Returns
        True only when the entry was actually placed (capacity consumed
        or victims evicted); False when it (re-)blocked, was held back by
        the scheduler's admission gate, or was rejected outright."""
        if not self.scheduler.permits(self, entry):
            # reservation-style schedulers (EASY) hold entries that would
            # delay the reserved head waiter even when capacity fits them
            self.scheduler.enqueue(entry)
            self._record("held",
                         f"{entry.name}: held by {self.scheduler.name} "
                         f"reservation")
            return False
        reason = self._try_place(entry)
        if reason is self._REJECTED:
            return False
        if reason is not None and self.scheduler.on_blocked(self, entry):
            reason = self._try_place(entry)
        if reason is not None:
            self.scheduler.enqueue(entry)
            self._record("blocked", reason)
            return False
        return True

    def _try_place(self, entry) -> Optional[str]:
        """One placement attempt. None on success, ``_REJECTED`` on
        terminal rejection; otherwise the blocked-log message."""
        if isinstance(entry, Tenant):
            return self._try_resume(entry)
        spec = entry
        # the capacity/placement unit is the tenant's *total* node count:
        # n_ranks for a training job, n_ranks * replicas for a fleet
        n = spec.total_ranks
        blocked_free = set(self._taken) | self._dead
        if spec.nodes is not None:
            nodes = list(spec.nodes)
            if len(set(nodes)) != n:
                raise ValueError(
                    f"tenant {spec.name!r}: needs {n} distinct nodes, got "
                    f"{nodes}")
            dead = self._dead.intersection(nodes)
            if dead:
                # pinned to nodes that will never come back: reject
                self._record("rejected",
                             f"{spec.name}: pinned nodes {sorted(dead)} "
                             f"are dead")
                return self._REJECTED
            taken = set(self._taken).intersection(nodes)
            if taken:
                # pinned nodes owned by a co-tenant: wait for them
                return (f"{spec.name}: pinned nodes {sorted(taken)} "
                        f"are taken")
        else:
            try:
                nodes = place(spec.placement, self.topo, n,
                              taken=blocked_free,
                              seed=self.base_seed + 101 * self._tenant_seq,
                              spec=spec)
            except ValueError:
                return f"{spec.name}: no capacity for {n} ranks"
        seed = spec.seed if spec.seed is not None \
            else self.base_seed + 1 + 1009 * self._tenant_seq
        if isinstance(spec, JobSpec):
            tenant: Tenant = TrainingTenant(spec, seed)
        else:
            tenant = InferenceTenant(spec, seed)
        # per-tenant background congestion stream: co-tenants interact only
        # through the explicit contention model, so a tenant's series is
        # independent of who shares the fabric on *disjoint* links
        tenant.congestion = CongestionModel(
            self.congestion_cfg, self.topo,
            seed=self.base_seed + 2 + 1013 * self._tenant_seq)
        tenant.weighted_fairness = self.policy.weighted
        tenant.routing = self.routing
        self._tenant_seq += 1
        self._weights[spec.name] = tenant.weight
        self._prios[spec.name] = tenant.priority
        for nd in nodes:
            self._taken[nd] = spec.name
        tenant.place(self.topo, nodes, self._now, self._clock,
                     self.heartbeat)
        tenant.prepare()
        self._active.append(tenant)
        self._record("arrival",
                     f"{spec.name} ({tenant.kind}) on nodes {nodes} "
                     f"algo={tenant.algo}")
        return None

    def _replace(self, tenant: Tenant, n: int) -> Optional[List[int]]:
        """The shared re-place/re-compile tail of failure recovery and
        preemption resume: fresh placement by the tenant's policy
        (deterministic seed), replan/restore delay, re-bind (schedule
        re-compile, ``algo="auto"`` re-selection), next collective formed.
        A full-size tenant pinned to explicit ``spec.nodes`` resumes on
        exactly those nodes (waiting while any is taken, falling back to
        its policy only if one died); a shrunk tenant re-places by policy.
        Returns the new nodes, or None when the pool cannot host ``n``."""
        spec = tenant.spec
        pin = spec.nodes if spec.nodes is not None \
            and n == len(spec.nodes) \
            and not self._dead.intersection(spec.nodes) else None
        if pin is not None:
            if set(self._taken).intersection(pin):
                return None
            nodes = list(pin)
        else:
            try:
                nodes = place(spec.placement, self.topo, n,
                              taken=set(self._taken) | self._dead,
                              seed=self.base_seed + 101 * self._tenant_seq
                              + tenant.generation, spec=spec)
            except ValueError:
                return None
        for nd in nodes:
            self._taken[nd] = tenant.name
        resume_t = self._now + self._replan_delay(tenant)
        tenant.place(self.topo, nodes, resume_t, self._clock,
                     self.heartbeat)
        tenant.recovery.record(
            "resume", step=getattr(tenant, "iters_done", 0),
            detail=f"{n} ranks on nodes {nodes} algo={tenant.algo} "
                   f"t={resume_t:.3f}")
        tenant.prepare()
        return nodes

    def _try_resume(self, tenant: Tenant) -> Optional[str]:
        """Re-place a preempted tenant through the recovery path, with its
        step history and iteration progress intact."""
        n = len(tenant.nodes)
        nodes = self._replace(tenant, n)
        if nodes is None:
            return f"{tenant.name}: no capacity to resume {n} ranks"
        self._active.append(tenant)
        self._record("resumed",
                     f"{tenant.name} on nodes {nodes} algo={tenant.algo}")
        return None

    def _free_nodes(self, tenant: Tenant) -> None:
        for nd in tenant.nodes:
            if self._taken.get(nd) == tenant.name:
                del self._taken[nd]

    # -- preemption (scheduler="preempt") ----------------------------------
    def _preempt_for(self, entry) -> bool:
        """Evict lower-priority running training tenants until ``entry``
        fits. Returns True when at least one victim was evicted and the
        freed pool can host the entry; never evicts gratuitously (no
        eviction unless the entry then fits). A previously-evicted tenant
        inside the scheduler's anti-thrash window — less than
        ``min_runtime_s`` of *runtime* since its last resume — is not
        eligible again: re-eviction churn would spend every window on
        replan stalls instead of progress, and time spent queued must not
        count toward the budget."""
        resume = isinstance(entry, Tenant)
        spec = entry.spec if resume else entry
        prio = entry_priority(entry)
        need = len(entry.nodes) if resume else spec.total_ranks
        victims = [t for t in self._active
                   if t.kind == "training" and t.priority < prio
                   and not self._inside_thrash_window(t)]
        # lowest priority evicted first; most recently admitted first
        # among equals (deterministic: _active is admission-ordered)
        victims.sort(key=lambda t: (t.priority, -self._active.index(t)))
        pinned = spec.nodes is not None and need == len(spec.nodes) \
            and not self._dead.intersection(spec.nodes)
        if pinned:
            # pinned entry: the victims are exactly the owners of its
            # pinned nodes — all of them must be evictable
            owners = {self._taken[nd] for nd in spec.nodes
                      if nd in self._taken}
            chosen = [t for t in victims if t.name in owners]
            if not owners or len(chosen) < len(
                    {t.name for t in self._active if t.name in owners}):
                return False
        else:
            free = self.topo.n_ranks - len(set(self._taken) | self._dead)
            chosen = []
            for t in victims:
                if free >= need:
                    break
                chosen.append(t)
                free += sum(1 for nd in t.nodes if nd not in self._dead)
            if free < need or not chosen:
                return False
        for t in chosen:
            self._preempt(t)
        self._evicted = True
        return True

    def _inside_thrash_window(self, tenant: Tenant) -> bool:
        """True while a previously-evicted tenant is protected by the
        preempt scheduler's ``min_runtime_s`` budget. The window is armed
        at the tenant's latest *resume* (re-placement time), not at the
        eviction: a victim that sat queued through the whole window would
        otherwise be re-evictable the instant it came back, with zero
        actual runtime between evictions."""
        budget = getattr(self.scheduler, "min_runtime_s", 0.0)
        if budget <= 0.0 or tenant.name not in self._evicted_at:
            return False
        armed = self._evicted_at[tenant.name]
        if tenant.placements:
            # resume timestamps are >= the eviction they follow
            armed = max(armed, tenant.placements[-1][0])
        return self._now - armed < budget

    def _preempt(self, tenant: Tenant) -> None:
        tenant.pending_start = None
        self._evicted_at[tenant.name] = self._now
        self._free_nodes(tenant)
        self._active.remove(tenant)
        tenant.recovery.record(
            "preempted", step=getattr(tenant, "iters_done", 0),
            detail=f"evicted at t={self._now:.3f}")
        self.scheduler.enqueue(tenant)
        self._record("preempted",
                     f"{tenant.name} evicted ({len(tenant.nodes)} nodes "
                     f"freed)")

    def _retry_blocked(self) -> None:
        """Offer freed capacity to the queue. fifo: one pass in arrival
        order (first-engine bit-compat). backfill/preempt: priority-ordered passes
        until no admission succeeds, so capacity freed by one admission
        (or eviction) is offered to the rest of the queue immediately."""
        while True:
            batch = self.scheduler.drain()
            if not batch:
                return
            progress = False
            for entry in self.scheduler.order(batch):
                progress |= self._admit(entry)
            if not (progress and self.scheduler.multipass):
                return

    def _depart(self, tenant: Tenant, t: float, why: str) -> None:
        tenant.departed_t = t
        tenant.pending_start = None
        self._free_nodes(tenant)
        self._active.remove(tenant)
        self._finished.append(tenant)
        self._record("departure", f"{tenant.name}: {why}")
        self._retry_blocked()

    # -- events ------------------------------------------------------------
    def _apply_event(self, ev: Event) -> None:
        if isinstance(ev, Arrival):
            self._evicted = False
            self._admit(ev.spec)
            if self._evicted and self.scheduler.queue:
                # eviction may have freed more than the arrival needed:
                # offer the surplus to the queue (victims included) now
                self._retry_blocked()
        elif isinstance(ev, Departure):
            for tenant in list(self._active):
                if tenant.name == ev.name:
                    self._depart(tenant, ev.t, "scheduled departure")
                    return
            # a tenant still waiting for capacity (blocked spec or
            # preempted tenant) retires from the queue — otherwise a late
            # admission would outlive its own departure
            entry = self.scheduler.remove(ev.name)
            if entry is not None:
                if isinstance(entry, Tenant):
                    entry.departed_t = ev.t
                    self._finished.append(entry)
                self._record("departure",
                             f"{ev.name}: departed while blocked")
                return
            self._record("departure_noop", f"{ev.name} not active")
        elif isinstance(ev, NodeFailure):
            self._dead.add(ev.node)
            owner = self._taken.get(ev.node, None)
            self._record("failure",
                         f"node {ev.node} died"
                         + (f" (owned by {owner})" if owner else " (idle)"))
        elif isinstance(ev, (LinkFlap, LinkDegrade)):
            self._link_derates.setdefault(ev.link, []).append(ev.window())
            if isinstance(ev, LinkFlap):
                self._record("link_flap",
                             f"link {ev.link} down for {ev.down_s:g}s")
            else:
                dur = "permanently" if ev.duration_s is None \
                    else f"for {ev.duration_s:g}s"
                self._record("link_degrade",
                             f"link {ev.link} at {ev.factor:g}x {dur}")
        else:
            raise TypeError(f"unknown event {ev!r}")

    # -- failure recovery --------------------------------------------------
    def _recover(self, tenant: Tenant, dead: List[int]) -> None:
        """A tenant hit the barrier with dead ranks: it stalls until its
        FailureDetector times the silent nodes out (virtual clock), then
        releases its nodes, shrinks by its elastic plan, re-places, and
        re-compiles its schedule."""
        det = tenant.detector
        hb = self.heartbeat
        # the silent node is suspected one monitoring tick after its
        # timeout window expires — but never before the engine clock,
        # which has already passed the failure event itself (a tenant
        # whose step outlasts the heartbeat window would otherwise log a
        # detection timestamped before the node died)
        t_detect = max(det.last_seen[nd] for nd in dead) \
            + hb.timeout_s + hb.interval_s
        t_detect = max(t_detect, self._now)
        self._now = max(self._now, t_detect)
        suspected = set(det.suspected())
        assert suspected.intersection(dead), \
            "virtual clock passed the timeout; detector must agree"
        tenant.recovery.record(
            "failure", step=getattr(tenant, "iters_done", 0),
            detail=f"nodes {sorted(dead)} detected t={t_detect:.3f}")
        self._record("detected",
                     f"{tenant.name} lost nodes {sorted(dead)}")
        self._free_nodes(tenant)
        survivors = len(tenant.nodes) - len(dead)
        new_n = tenant.shrink_plan(survivors)
        if new_n < 2:
            self._depart(tenant, self._now, "too few survivors")
            return
        nodes = self._replace(tenant, new_n)
        if nodes is None:
            self._depart(tenant, self._now, "no capacity to re-place")
            return
        self._record("replaced",
                     f"{tenant.name} -> {new_n} ranks on {nodes} "
                     f"algo={tenant.algo}")
        self._retry_blocked()

    # -- contention --------------------------------------------------------
    def _contend(self, tenant: Tenant, eff: Dict[str, float], d0: float
                 ) -> Dict[str, float]:
        """Split shared-link bandwidth between the resolving tenant's
        collective and every co-tenant flow overlapping its window (other
        tenants' pending collectives, estimated at their uncongested floor,
        plus recorded busy segments of already-resolved collectives)."""
        if d0 <= 0.0 or not tenant.pending_demand:
            return eff
        s_i = tenant.pending_start
        e_i = s_i + d0
        segments = self._segments
        policy = self.policy
        adj: Optional[Dict[str, float]] = None
        for ln, own in tenant.pending_demand.items():
            # same flow accounting as FabricEngine._contended_effs, with
            # the split resolved by the engine's pluggable fairness policy:
            # offered weights each flow by its bytes; the owner-aggregated
            # models see activity per owner with its weight and priority
            flows: List[Tuple[float, float]] = []
            activity: Dict[str, float] = {}
            for other in self._active:
                if other is tenant or other.pending_start is None:
                    continue
                d_k = other.pending_demand.get(ln)
                if not d_k:
                    continue
                ov = min(e_i, other.pending_start + other.pending_floor) \
                    - max(s_i, other.pending_start)
                if ov > 0.0:
                    flows.append((ov, d_k))
                    activity[other.name] = activity.get(other.name, 0.0) \
                        + ov
            for (s_k, e_k, b_k, kname) in segments.get(ln, ()):
                if kname == tenant.name:
                    continue
                ov = min(e_i, e_k) - max(s_i, s_k)
                if ov > 0.0:
                    flows.append((ov, b_k))
                    activity[kname] = activity.get(kname, 0.0) + ov
            if not flows:
                continue
            share = policy.link_share(
                d0, own, tenant.weight, tenant.priority, flows,
                [(ov, self._weights[nm], self._prios[nm])
                 for nm, ov in activity.items()])
            if share < 1.0:
                if adj is None:
                    adj = dict(eff)
                adj[ln] = eff[ln] * share
        return adj if adj is not None else eff

    def _derate_eff(self, eff: Dict[str, float], t: float
                    ) -> Dict[str, float]:
        """Overlay active LinkFlap/LinkDegrade windows onto the congestion
        efficiencies for a collective starting at ``t``. Returns ``eff``
        untouched when no link events are in play (the bit-compat fast
        path); derated links absent from ``eff`` (unshared, or untracked
        on sparse topologies) get explicit entries, which the compiled
        plans' ``link_eff.get(ln, 1.0)`` lookups honor."""
        derates = self._link_derates
        if not derates:
            return eff
        adj: Optional[Dict[str, float]] = None
        for ln, windows in derates.items():
            f = 1.0
            for (s, e, factor) in windows:
                if s <= t < e:
                    f *= factor
            if f < 1.0:
                if adj is None:
                    adj = dict(eff)
                adj[ln] = adj.get(ln, 1.0) * f
        return adj if adj is not None else eff

    def _prune_segments(self) -> None:
        starts = [t.pending_start for t in self._active
                  if t.pending_start is not None]
        horizon = min(starts) if starts else self._now
        for ln, segs in self._segments.items():
            self._segments[ln] = [s for s in segs if s[1] > horizon]

    # -- main loop ---------------------------------------------------------
    def _resolve(self, tenant: Tenant) -> None:
        dead = [nd for nd in tenant.nodes if nd in self._dead]
        if dead:
            self._recover(tenant, dead)
            return
        self._now = max(self._now, tenant.pending_start)
        congestion = tenant.congestion
        # sparse topologies: an inference tenant's occupancy-scaled
        # schedules compile lazily mid-run, so (idempotently) extend the
        # tracked-link set right before the draw; dense topologies track
        # everything from construction and this is a no-op
        congestion.track(tenant.pending_demand)
        congestion.advance()
        eff = congestion.link_eff(tenant.pending_skew,
                                  spanning_groups=tenant.spanning)
        eff = self._derate_eff(eff, tenant.pending_start)
        d0 = tenant.pending_schedule.total_s(eff)
        eff = self._contend(tenant, eff, d0)
        dur = tenant.pending_schedule.total_s(eff)
        start = tenant.pending_start
        finish = start + dur
        for ln, b in tenant.pending_demand.items():
            self._segments.setdefault(ln, []).append(
                (start, finish, b, tenant.name))
        self._prune_segments()
        congestion.kick(tenant.pending_skew)
        tenant.pending_schedule.accumulate_bytes(eff, tenant.link_bytes)
        tenant.pending_schedule.accumulate_bytes(eff, self.link_bytes)
        self._now = max(self._now, finish)
        tenant.resolved(finish, dur, d0)
        for kind, detail in tenant.drain_log():
            self._record(kind, detail)
        if tenant.detector is not None:
            for nd in tenant.nodes:
                if nd not in self._dead:
                    tenant.detector.heartbeat(nd)
        if tenant.wants_departure():
            self._depart(tenant, finish, "completed its iteration budget")
        else:
            tenant.prepare()

    def run(self, until: float) -> LifecycleResult:
        """Advance the virtual clock to ``until`` (simulated seconds).
        One-shot: construct a fresh engine per scenario."""
        if self._ran:
            raise RuntimeError(
                "LifecycleEngine.run() is one-shot (tenant clocks and "
                "congestion state carry over); construct a fresh engine "
                "per scenario")
        self._ran = True
        timeline = self._timeline
        ei = 0
        with simulated_clock_scope():
            while True:
                nxt: Optional[Tenant] = None
                for tenant in self._active:
                    if tenant.pending_start is None:
                        continue
                    if nxt is None or tenant.pending_start \
                            < nxt.pending_start:
                        nxt = tenant
                ev_t = timeline[ei][0] if ei < len(timeline) else None
                if nxt is None and ev_t is None:
                    break
                if ev_t is not None and (
                        nxt is None or ev_t <= nxt.pending_start):
                    if ev_t > until:
                        break
                    self._now = max(self._now, ev_t)
                    self._apply_event(timeline[ei][2])
                    ei += 1
                    continue
                if nxt.pending_start > until:
                    break
                self._resolve(nxt)
        for tenant in self._active:
            tenant.pending_start = None
        # preempted tenants still queued at the horizon carry history too
        leftovers = [e for e in self.scheduler.queue
                     if isinstance(e, Tenant)]
        tenants = self._finished + self._active + leftovers
        tenants.sort(key=lambda t: (t.arrived_t if t.arrived_t is not None
                                    else float("inf")))
        return LifecycleResult(self.topo, tenants, self._log,
                               dict(self.link_bytes), until)
