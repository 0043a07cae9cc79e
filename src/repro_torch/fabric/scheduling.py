"""Blocked-arrival queue policies for the lifecycle engine.

The first :class:`~repro_torch.fabric.events.LifecycleEngine` kept one implicit
policy: blocked arrivals wait in a list and every freed-capacity event
retries them in arrival order. That *is* a scheduler — just an unnamed one.
This module makes the policy explicit and pluggable
(``LifecycleEngine(scheduler=...)``):

  * ``fifo`` (default) — exactly the first engine's behavior, single retry pass in
    arrival order. Kept bit-identical (same admission order, same placement
    seeds, same log records) so the golden determinism fixtures recorded
    against the first engine replay unchanged.
  * ``backfill`` — the queue drains in ``priority`` order (descending,
    arrival order among equals): a freed-capacity event offers nodes to the
    highest-priority waiter first, and smaller low-priority tenants then
    *backfill* whatever is left over. Within a drain, a queued
    higher-priority tenant is never delayed by a backfilled one — the
    backfiller only ever takes capacity the higher-priority tenant could
    not use at that instant. Multiple drain passes run until no further
    admission succeeds, so capacity freed by one admission is immediately
    offered to the rest of the queue. Admission stays work-conserving
    (first-engine semantics): a *fresh arrival* that fits free capacity is
    admitted immediately, without reserving nodes for queued waiters —
    ``easy`` adds exactly that reservation.
  * ``preempt`` — ``backfill`` plus admission-time eviction: when a blocked
    entry outranks running *training* tenants, the engine evicts the
    lowest-priority victims (most recently admitted first among equals)
    until the entry fits. A victim re-enters the queue as a *resumable
    tenant* — its step history, iteration count, and recovery log ride
    along — and resumes later through the usual re-place/re-compile path
    (fresh placement, ``algo="auto"`` re-selection, replan/restore delay),
    finishing exactly the remaining work of its iteration budget. Inference
    tenants are never evicted: they are the latency-sensitive traffic the
    priority exists to protect.

The queue holds two kinds of entry: a :class:`TenantSpec` that has never
been admitted, and a live :class:`~repro_torch.fabric.workloads.Tenant` that was
preempted and will resume with its progress intact. Schedulers are
one-shot, like the engine that owns them — construct a fresh one (or pass
the policy name) per scenario.
"""
from __future__ import annotations

import math
import statistics
from typing import List, Optional, Tuple, Union

from repro_torch.fabric.engine import JobSpec
from repro_torch.fabric.placement import place
from repro_torch.fabric.policies import SCHEDULERS
from repro_torch.fabric.workloads import InferenceSpec, Tenant, _compile

# a spec that has never been admitted, or a preempted tenant that will
# resume with its progress intact
QueueEntry = Union[JobSpec, InferenceSpec, Tenant]


def entry_name(entry: QueueEntry) -> str:
    return entry.name


def entry_priority(entry: QueueEntry) -> int:
    return int(getattr(entry, "priority", 0))


class Scheduler:
    """Queue policy hooks the lifecycle engine drives.

    ``order`` ranks a drained batch for admission; ``on_blocked`` may make
    room for a just-blocked entry (return True to retry its placement
    once); ``multipass`` re-drains until no admission succeeds, offering
    capacity freed by one admission to the rest of the queue in the same
    virtual instant.
    """

    name: str = ""
    multipass: bool = False

    def __init__(self) -> None:
        self.queue: List[QueueEntry] = []

    def enqueue(self, entry: QueueEntry) -> None:
        self.queue.append(entry)

    def drain(self) -> List[QueueEntry]:
        batch, self.queue = self.queue, []
        return batch

    def remove(self, name: str) -> Optional[QueueEntry]:
        for entry in self.queue:
            if entry_name(entry) == name:
                self.queue.remove(entry)
                return entry
        return None

    def order(self, batch: List[QueueEntry]) -> List[QueueEntry]:
        return batch

    def on_blocked(self, engine, entry: QueueEntry) -> bool:
        return False

    def permits(self, engine, entry: QueueEntry) -> bool:
        """Admission gate the engine consults *before* trying to place
        ``entry``. The default is work-conserving (everything is
        permitted); reservation-style schedulers (EASY) return False to
        hold an entry that would delay the reserved head waiter, and the
        engine re-enqueues it without a placement attempt."""
        return True


@SCHEDULERS.register("fifo")
class FifoScheduler(Scheduler):
    """First-engine behavior: retry in arrival order, one pass per freed-capacity
    event, no priorities, no eviction."""

    name = "fifo"


@SCHEDULERS.register("backfill")
class BackfillScheduler(Scheduler):
    """Priority-ordered drain with backfilling into leftover capacity."""

    name = "backfill"
    multipass = True

    def order(self, batch: List[QueueEntry]) -> List[QueueEntry]:
        # stable: arrival order among equal priorities, so uniform-priority
        # scenarios drain exactly like fifo
        return sorted(batch, key=lambda e: -entry_priority(e))


@SCHEDULERS.register("preempt")
class PreemptScheduler(BackfillScheduler):
    """Backfill ordering plus eviction of lower-priority training tenants
    when a blocked entry outranks them (victim selection and eviction live
    in ``LifecycleEngine._preempt_for`` — they need the engine's node
    accounting).

    ``min_runtime_s`` is the anti-thrash preemption budget: a
    previously-evicted tenant cannot be evicted again until it has had
    ``min_runtime_s`` of *runtime* since its latest resume (time spent
    queued does not count), so a stream of high-priority arrivals cannot
    churn the same victim through replan stalls without letting it run.
    ``0.0`` (default) keeps the budget-free behavior bit-for-bit.
    """

    name = "preempt"

    def __init__(self, min_runtime_s: float = 0.0) -> None:
        super().__init__()
        if min_runtime_s < 0.0:
            raise ValueError(
                f"min_runtime_s must be >= 0, got {min_runtime_s!r}")
        self.min_runtime_s = min_runtime_s

    def on_blocked(self, engine, entry: QueueEntry) -> bool:
        return engine._preempt_for(entry)


@SCHEDULERS.register("easy")
class EasyScheduler(BackfillScheduler):
    """Backfill with an EASY-style **reservation** for the head waiter.

    Plain backfill is work-conserving but can starve a wide tenant: while
    it waits for enough free nodes, every smaller arrival slips past it
    and re-occupies the capacity it was accumulating. EASY (the classic
    Argonne backfill variant) fixes that with one reservation: using
    runtime estimates it computes the *shadow time* ``t_res`` — the
    earliest instant enough running tenants will have released nodes for
    the head of the queue — and only backfills an entry when doing so
    cannot delay that start: the entry either finishes by ``t_res``
    (estimated from its ``JobSpec.iters`` iteration budget, observed
    step times for a preempted resume) or fits inside the *extra* nodes
    that will be free at ``t_res`` beyond the head's need.

    Runtime estimates: a running training tenant finishes after its
    remaining iteration budget at its observed mean step time (its
    compiled-schedule floor derated by the configured mean shared-link
    utilization before any step lands); a scheduled :class:`Departure`
    caps any tenant's estimate; tenants with neither (open-ended
    training, inference fleets with no departure) never release — when
    the head's need cannot be met by estimable releases there is no
    reservation to protect and backfill is unrestricted. Entries whose
    completion cannot be estimated (no iteration budget) only backfill
    through the extra-nodes condition, never the time condition, so a
    bad estimate can hold work back but never delay the reserved head.
    """

    name = "easy"

    # -- reservation math --------------------------------------------------
    @staticmethod
    def _need(entry: QueueEntry) -> int:
        if isinstance(entry, Tenant):
            return len(entry.nodes)
        return entry.total_ranks

    def _head(self) -> Optional[QueueEntry]:
        """The reserved waiter: highest priority in the queue, arrival
        order among equals (the first entry a drain would offer)."""
        head = None
        for entry in self.queue:
            if head is None or entry_priority(entry) > entry_priority(head):
                head = entry
        return head

    @staticmethod
    def _est_step(engine, floor: float, base_s: float) -> float:
        """Optimistic per-step estimate before any step has landed: local
        compute plus the schedule floor derated by the mean background
        utilization of the shared tier."""
        u = min(engine.congestion_cfg.u_mean, 0.99)
        return base_s + floor / (1.0 - u)

    @staticmethod
    def _departure_at(engine, name: str) -> float:
        from repro_torch.fabric.events import Departure
        for (t, _i, ev) in engine._timeline:
            if isinstance(ev, Departure) and ev.name == name \
                    and t >= engine._now:
                return t
        return math.inf

    def _est_finish(self, engine, tenant: Tenant) -> float:
        """Estimated release time of a *running* tenant's nodes."""
        est = math.inf
        if tenant.kind == "training" and tenant.spec.iters is not None:
            remaining = max(tenant.spec.iters - tenant.iters_done, 0)
            if tenant.step_times:
                per = statistics.fmean(tenant.step_times)
            else:
                per = self._est_step(engine, tenant.floor_denom,
                                     tenant.spec.stragglers.base_compute_s)
            est = engine._now + remaining * per
        return min(est, self._departure_at(engine, tenant.name))

    def _est_completion(self, engine, entry: QueueEntry
                        ) -> Optional[float]:
        """Estimated completion if ``entry`` were admitted now; None when
        no iteration budget bounds it (inference, open-ended training)."""
        if isinstance(entry, Tenant):
            if entry.kind != "training" or entry.spec.iters is None:
                return None
            remaining = max(entry.spec.iters - entry.iters_done, 0)
            if entry.step_times:
                per = statistics.fmean(entry.step_times)
            else:
                per = self._est_step(engine, entry.floor_denom,
                                     entry.spec.stragglers.base_compute_s)
            return engine._now + remaining * per
        if not isinstance(entry, JobSpec) or entry.iters is None:
            return None
        # fresh spec: trial-place with the exact seed admission would use
        # so the compiled-schedule floor matches the real placement
        taken = set(engine._taken) | engine._dead
        if entry.nodes is not None:
            nodes = list(entry.nodes)
            if taken.intersection(nodes):
                return None
        else:
            try:
                nodes = place(entry.placement, engine.topo,
                              entry.total_ranks, taken=taken,
                              seed=engine.base_seed
                              + 101 * engine._tenant_seq, spec=entry)
            except ValueError:
                return None
        _algo, sched = _compile(engine.topo, nodes, entry.grad_bytes,
                                entry.algo, entry.group)
        per = self._est_step(engine, sched.total_s(None),
                             entry.stragglers.base_compute_s)
        return engine._now + entry.iters * per

    def _reservation(self, engine, head: QueueEntry
                     ) -> Optional[Tuple[float, int]]:
        """``(t_res, extra)`` for the head's reservation: the estimated
        shadow time and the nodes free at it beyond the head's need —
        or None when estimable releases can never satisfy the head
        (nothing to protect)."""
        need_h = self._need(head)
        free = engine.topo.n_ranks - len(set(engine._taken) | engine._dead)
        if free >= need_h:
            return engine._now, free - need_h
        releases = sorted(
            (self._est_finish(engine, t),
             sum(1 for nd in t.nodes if nd not in engine._dead))
            for t in engine._active)
        for est, n in releases:
            if math.isinf(est):
                return None
            free += n
            if free >= need_h:
                return est, free - need_h
        return None

    def permits(self, engine, entry: QueueEntry) -> bool:
        head = self._head()
        if head is None or head is entry \
                or entry_name(head) == entry_name(entry) \
                or entry_priority(entry) > entry_priority(head):
            # no reservation, the reserved waiter itself, or an entry
            # that outranks it (and so becomes the effective head)
            return True
        res = self._reservation(engine, head)
        if res is None:
            return True
        t_res, extra = res
        if self._need(entry) <= extra:
            return True
        est = self._est_completion(engine, entry)
        return est is not None and est <= t_res


def make_scheduler(spec: Union[str, Scheduler], **kwargs) -> Scheduler:
    """Resolve a scheduler through the pluggable registry
    (:data:`repro_torch.fabric.policies.SCHEDULERS`): a registered name (with
    optional constructor kwargs, e.g. ``make_scheduler("preempt",
    min_runtime_s=2.0)``) or an already-built instance."""
    if isinstance(spec, Scheduler):
        if kwargs:
            raise TypeError(
                "scheduler kwargs only apply when resolving by name; got "
                f"an instance plus {sorted(kwargs)}")
        return spec
    return SCHEDULERS.get(spec)(**kwargs)
