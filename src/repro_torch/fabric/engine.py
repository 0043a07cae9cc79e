"""Shared-fabric engine: N BSP training jobs on one topology (paper §3).

The seed simulator stepped exactly one job with fixed contiguous placement,
so two of the paper's recurring failure modes could not be expressed:

  * **cross-tenant topology-induced contention** (§3.2) — a job slows down
    because *someone else's* collectives load the oversubscribed tier it
    shares, even though the job's own traffic never changed;
  * **locality-driven placement variance** (§3.3) — the same job on the same
    fabric scales differently depending on which node set the scheduler
    handed it (see :mod:`repro_torch.fabric.placement`).

This engine steps N independent BSP jobs against one :class:`Topology`.
Each job owns its compute/straggler model, optional pacing controllers, and
a **compiled collective schedule** (:func:`repro_torch.fabric.collectives.
compile_schedule`) — the flow structure over links is derived once at
setup, so the per-iteration cost under a fresh congestion state is a short
loop over links instead of a re-walk of every ring hop. Background (non-job)
cross traffic remains the AR(1) :class:`CongestionModel`; *modeled* jobs
additionally contend with each other explicitly: when two jobs' collectives
overlap in time on a shared link, the link's effective bandwidth is split
between them by progressive-filling **max-min fairness** over the
overlapping flows (``fairness="maxmin"``, the default — per-flow fair
queueing behavior, no flow starved below its bottleneck share) or in
proportion to offered bytes (``fairness="offered"``, the original model,
kept for comparison; ``benchmarks.run --only multitenant`` tables both).

Dynamic tenant populations — jobs arriving at t > 0, failing, departing,
and mixing with open-loop inference traffic — are the event-driven
:class:`repro_torch.fabric.events.LifecycleEngine`, which drives the same
compiled schedules, congestion state, and fairness allocator from a
virtual-clock event timeline. This engine remains the fixed-population
lockstep stepper whose single-job path is the bit-equal executable spec.

Iteration order per simulated step (identical to the seed loop when N = 1,
so ``simulate()`` step-time series are bit-equal to the executable spec in
:mod:`repro_torch.fabric._reference`):

  1. every job samples per-rank compute and forms its collective-arrival
     window;
  2. the fabric's background congestion advances once;
  3. each job's per-link efficiency is derived from its own arrival skew and
     leaf/pod span; with co-tenants, overlapping collectives then split
     shared-link bandwidth (offered-bytes proportional share);
  4. collective costs are evaluated from the compiled schedules; skewed
     (bursty) entries kick the congestion state (queue-buildup hysteresis);
  5. BSP finish times, per-link byte accounting, pacing decisions, and next
     release times are updated per job.

Per-rank :class:`IterationRecord` streams are materialized lazily — the hot
loop stores compact per-iteration tuples and the full record matrix is only
built when a consumer (diagnostics, tests) actually reads ``.records``.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import PacingConfig
from repro_torch.core.instrumentation import IterationRecord
from repro_torch.core.pacing import PacingBank
from repro_torch.fabric import _deprecation
from repro_torch.fabric.collectives import compile_schedule, select_algo
from repro_torch.fabric.congestion import CongestionConfig, CongestionModel
from repro_torch.fabric.placement import place, spanning_groups
from repro_torch.fabric.policies import (FAIRNESS, FairnessPolicy,
                                   resolve_fairness, resolve_routing)
from repro_torch.fabric.stragglers import ComputeModel, StragglerConfig
from repro_torch.fabric.topology import Topology

# Fairness modes are pluggable (repro_torch.fabric.policies.FAIRNESS):
# "maxmin"          — unweighted progressive filling (default);
# "wfq"             — weighted progressive filling over JobSpec/
#                     InferenceSpec .weight (all weights 1.0 is
#                     bit-identical to "maxmin");
# "offered"         — the first offered-bytes proportional split;
# "strict_priority" — priority classes served in descending order;
# "drr"             — deficit round robin (quantized weighted sharing).
# Registration-order snapshot kept for compatibility; the registry is the
# live source of truth.
FAIRNESS_MODES = FAIRNESS.names()


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One tenant: a BSP data-parallel job to place and step on the fabric."""
    name: str
    n_ranks: int
    grad_bytes: float = 1.1e9
    algo: str = "ring"                # "ring"|"tree"|"hierarchical"|"auto"
    group: int = 0                    # hierarchical group size (0 = default)
    samples_per_rank: int = 64
    placement: str = "compact"        # policy name (repro_torch.fabric.placement)
    nodes: Optional[Tuple[int, ...]] = None   # explicit placement override
    stragglers: StragglerConfig = dataclasses.field(
        default_factory=StragglerConfig)
    pacing: Optional[PacingConfig] = None
    seed: Optional[int] = None        # compute-model seed (None = derived)
    # Seed-simulator compatibility: the legacy loop derived the ECMP span
    # from ceil(n / nodes_per_leaf) regardless of actual placement.
    spanning_override: Optional[int] = None
    # Lifecycle-engine fields (repro_torch.fabric.events): depart after this many
    # completed steps (None = run until the horizon), and the model-parallel
    # width the elastic re-mesh plan must keep intact after a node failure.
    iters: Optional[int] = None
    model_parallel: int = 1
    # WFQ share of contended links under fairness="wfq" (ignored by the
    # unweighted modes), and the scheduling priority the lifecycle engine's
    # "backfill"/"preempt" policies order the blocked-arrival queue by.
    weight: float = 1.0
    priority: int = 0
    # Parameter-state footprint for the checkpoint-restore cost model
    # (repro_torch.ft.failure.RestoreCostModel); None estimates it from
    # grad_bytes (fp32 gradients are parameter-sized).
    param_bytes: Optional[float] = None
    # Checkpoint cadence in steps for checkpoint-aware resume: a preempted
    # or failure-recovered tenant rewinds to its newest checkpoint
    # (repro_torch.ckpt.latest_restorable_step) and continues the original
    # compute stream from that step count, re-executing lost work.
    # None (default) keeps the plain behavior: every re-place restarts
    # the epoch stream.
    ckpt_every: Optional[int] = None

    def __post_init__(self):
        if not self.weight > 0.0:
            raise ValueError(
                f"job {self.name!r}: weight must be positive, got "
                f"{self.weight!r}")
        if self.ckpt_every is not None and self.ckpt_every < 1:
            raise ValueError(
                f"job {self.name!r}: ckpt_every must be >= 1 steps, got "
                f"{self.ckpt_every!r}")

    @property
    def total_ranks(self) -> int:
        """Nodes the tenant occupies — the capacity/placement unit shared
        with :class:`~repro_torch.fabric.workloads.InferenceSpec`, whose fleets
        need ``n_ranks`` *per replica*."""
        return self.n_ranks


def _materialize_records(trace, n: int) -> List[List[IterationRecord]]:
    """Expand the engine's compact per-iteration tuples into the standard
    per-rank record matrix (same arithmetic as the eager seed loop)."""
    records: List[List[IterationRecord]] = [[] for _ in range(n)]
    for t, (compute, last, finish, rel, dur, delays) in enumerate(trace):
        scalar = not isinstance(rel, tuple)
        for r in range(n):
            rel_r = rel if scalar else rel[r]
            rec = IterationRecord(
                step=t, compute_time=compute[r], comm_time=dur,
                wait_time=last - (rel_r + compute[r]),
                total_time=finish - rel_r)
            if delays is not None:
                rec.pacing_delay = delays[r]
            records[r].append(rec)
    return records


class JobResult:
    """Per-job outcome: step-time series, link bytes, lazy record matrix."""

    def __init__(self, spec: JobSpec, nodes: List[int],
                 step_times: List[float], link_bytes: Dict[str, float],
                 trace: list, algo: Optional[str] = None,
                 comm_times: Optional[List[float]] = None,
                 comm_solo: Optional[List[float]] = None,
                 skews: Optional[List[float]] = None):
        self.spec = spec
        self.name = spec.name
        self.nodes = nodes
        self.algo = algo if algo is not None else spec.algo
        self.step_times = step_times
        self.link_bytes = link_bytes
        # observation-only instrumentation aligned 1:1 with step_times:
        # contended collective duration, pre-contention (co-tenant-free)
        # duration, and the arrival-skew each step saw (advisor inputs)
        self.comm_times = comm_times if comm_times is not None else []
        self.comm_solo = comm_solo if comm_solo is not None else []
        self.skews = skews if skews is not None else []
        self._trace = trace
        self._records: Optional[List[List[IterationRecord]]] = None

    @property
    def records(self) -> List[List[IterationRecord]]:
        if self._records is None:
            self._records = _materialize_records(self._trace,
                                                 self.spec.n_ranks)
        return self._records

    def per_rank_records(self) -> List[List[IterationRecord]]:
        return self.records

    @property
    def mean_step(self) -> float:
        return statistics.fmean(self.step_times)

    @property
    def cv(self) -> float:
        m = self.mean_step
        return (statistics.pstdev(self.step_times) / m) if m > 0 else 0.0

    @property
    def throughput(self) -> float:
        return (self.spec.n_ranks * self.spec.samples_per_rank
                / self.mean_step)


@dataclasses.dataclass
class EngineResult:
    topo: Topology
    jobs: List[JobResult]
    link_bytes: Dict[str, float]      # fabric-wide totals across all jobs

    def job(self, name: str) -> JobResult:
        for jr in self.jobs:
            if jr.name == name:
                return jr
        raise KeyError(name)


class _JobRuntime:
    """Mutable per-job state owned by the engine loop."""

    __slots__ = ("spec", "n", "nodes", "cm", "bank", "algo", "schedule",
                 "spanning", "floor_denom", "shared_demand", "release",
                 "release_arr", "prev_finish", "step_times", "link_totals",
                 "trace", "compute", "arrival", "first", "last", "skew",
                 "eff", "dur", "dur0", "comm_times", "comm_solo", "skews")

    def __init__(self, spec: JobSpec, nodes: List[int], topo: Topology,
                 compute_seed: int, weighted: bool = False, routing=None):
        self.spec = spec
        self.n = spec.n_ranks
        self.nodes = nodes
        self.cm = ComputeModel(spec.stragglers, spec.n_ranks,
                               seed=compute_seed)
        self.bank = PacingBank(spec.pacing, spec.n_ranks) \
            if spec.pacing is not None else None
        if spec.algo == "auto":
            # weight only steers selection when weighted sharing will
            # actually grant the w/(w+1) contended share it assumes
            sel_w = spec.weight if weighted else 1.0
            self.algo, self.schedule = select_algo(
                topo, nodes, spec.grad_bytes, group=spec.group,
                weight=sel_w, routing=routing)
        else:
            self.algo = spec.algo
            self.schedule = compile_schedule(
                topo, nodes, spec.grad_bytes, algo=spec.algo,
                group=spec.group, routing=routing)
        self.spanning = spec.spanning_override \
            if spec.spanning_override is not None \
            else spanning_groups(topo, nodes)
        floor = self.schedule.total_s(None)
        self.floor_denom = max(floor, 1e-9)
        # static per-link offered bytes on the shared tier: the demand
        # weights used when partitioning bandwidth between co-tenants
        self.shared_demand = {
            ln: b for ln, b in self.schedule.bytes_per_call(None).items()
            if topo.link(ln).shared}
        # scalar release clock while no pacing delay differentiates ranks
        self.release = 0.0
        self.release_arr = np.zeros(spec.n_ranks) \
            if self.bank is not None else None
        self.prev_finish = 0.0
        self.step_times: List[float] = []
        self.link_totals: Dict[str, float] = {}
        self.trace: list = []
        # observation-only per-reported-step logs (advisor attribution)
        self.comm_times: List[float] = []
        self.comm_solo: List[float] = []
        self.skews: List[float] = []


def link_overlaps(i: int, ln: str, s_i: float, e_i: float,
                  jobs: Sequence["_JobRuntime"],
                  spans: Sequence[Tuple[float, float]],
                  segs: Sequence[Tuple[float, float, float, int]],
                  ) -> Tuple[List[Tuple[float, float]], Dict[int, float]]:
    """Busy-segment contention accounting for job ``i`` on shared link
    ``ln`` over its tentative window ``[s_i, e_i)`` — the reference
    ``segment_overlap`` kernel (:mod:`repro_torch.fabric.backend`).

    Co-tenant demand overlapping the window comes from two places: other
    jobs' *current* tentative collectives (``spans``, same-round
    contention) and the recorded busy segments of their past collectives
    (``segs``, the per-link ``(start, end, demand_bytes, owner)`` rows —
    BSP clocks drift apart, so a fast job steps many times inside one
    long co-tenant collective). Returns the per-flow list
    ``(overlap_s, offered_bytes)`` the byte-weighted policies consume and
    the per-owner aggregated activity the owner-flow policies consume.
    """
    flows: List[Tuple[float, float]] = []
    activity: Dict[int, float] = {}
    for k, other in enumerate(jobs):
        if k == i:
            continue
        d_k = other.shared_demand.get(ln)
        if not d_k:
            continue
        ov = min(e_i, spans[k][1]) - max(s_i, spans[k][0])
        if ov > 0.0:
            flows.append((ov, d_k))
            activity[k] = activity.get(k, 0.0) + ov
    for (s_k, e_k, d_k, k) in segs:
        if k == i:
            continue
        ov = min(e_i, e_k) - max(s_i, s_k)
        if ov > 0.0:
            flows.append((ov, d_k))
            activity[k] = activity.get(k, 0.0) + ov
    return flows, activity


class FabricEngine:
    """Steps N jobs against one topology under shared congestion state."""

    def __init__(self, topo: Topology, jobs: Sequence[JobSpec], *,
                 congestion: Optional[CongestionConfig] = None,
                 base_seed: int = 0, fairness="maxmin", routing=None):
        _deprecation.warn_legacy(
            "FabricEngine(topo, jobs, ...)",
            "Scenario(topology=..., jobs=[...], policies=Policies("
            "fairness=...)).run()")
        self.policy: FairnessPolicy = resolve_fairness(fairness)
        self.routing = resolve_routing(routing)
        self.topo = topo
        self.base_seed = base_seed
        self.fairness = self.policy.name
        self.congestion = CongestionModel(
            congestion if congestion is not None else CongestionConfig(),
            topo, seed=base_seed + 2)
        taken: set = set()
        self._ran = False
        # per shared link: (start, end, demand_bytes, job_idx) busy windows
        # of past collectives, pruned as co-tenant clocks pass them
        self._segments: Dict[str, list] = {}
        self._jobs: List[_JobRuntime] = []
        for idx, spec in enumerate(jobs):
            if spec.nodes is not None:
                nodes = list(spec.nodes)
                overlap = taken.intersection(nodes)
                if overlap:
                    raise ValueError(
                        f"job {spec.name!r}: nodes {sorted(overlap)} "
                        f"already taken by a co-tenant")
                if len(set(nodes)) != spec.n_ranks:
                    raise ValueError(
                        f"job {spec.name!r}: needs {spec.n_ranks} distinct "
                        f"nodes, got {len(set(nodes))} ({nodes})")
            else:
                nodes = place(spec.placement, topo, spec.n_ranks,
                              taken=taken, seed=base_seed + idx)
            taken.update(nodes)
            seed = spec.seed if spec.seed is not None \
                else base_seed + 1 + 1009 * idx
            self._jobs.append(_JobRuntime(spec, nodes, topo, seed,
                                          weighted=self.policy.weighted,
                                          routing=self.routing))
        # sparse topologies: congestion tracks exactly the shared links the
        # compiled schedules touch (no-op on dense — their model already
        # tracks every shared link, in the golden-pinned order)
        for jr in self._jobs:
            self.congestion.track(jr.shared_demand)

    # -- multi-tenant bandwidth partitioning -------------------------------
    def _contended_effs(self, durs0: List[float]) -> List[Dict[str, float]]:
        """Per-job link efficiencies after splitting shared-link bandwidth
        between collectives that overlap in time.

        Job i's tentative collective occupies ``[last_i, last_i + dur0_i)``.
        For each shared link, co-tenant demand overlapping that interval
        comes from two places: other jobs' *current* tentative collectives
        (same-round contention) and the recorded busy **segments** of their
        past collectives (BSP clocks drift apart, so a fast job steps many
        times inside one long co-tenant collective — the segment keeps that
        link occupied across those rounds).

        The split is resolved by the engine's pluggable fairness policy
        (:data:`repro_torch.fabric.policies.FAIRNESS`): ``"offered"`` weights
        demand by overlap-scaled offered bytes (job i keeps
        ``own / total``); ``"maxmin"`` (default) treats every overlapping
        co-tenant as one flow whose rate demand is the fraction of job i's
        window it occupies and gives job i its progressive-filling max-min
        share — small flows are never starved below their bottleneck share
        by heavy co-tenants; ``"wfq"`` / ``"drr"`` resolve the same flow
        model by (fluid / quantized) weighted filling over
        ``JobSpec.weight`` (uniform WFQ weights are bit-identical to
        ``"maxmin"``); ``"strict_priority"`` serves ``JobSpec.priority``
        classes in descending order. Any share stacks on the background
        congestion derate.
        """
        jobs = self._jobs
        segments = self._segments
        policy = self.policy
        spans = [(jr.last, jr.last + d0) for jr, d0 in zip(jobs, durs0)]
        effs: List[Dict[str, float]] = []
        for i, jr in enumerate(jobs):
            s_i, e_i = spans[i]
            d_i = durs0[i]
            adj: Optional[Dict[str, float]] = None
            if d_i > 0.0:
                for ln, own in jr.shared_demand.items():
                    # co-tenant flows overlapping job i's window: tentative
                    # same-round collectives, then recorded past segments
                    # — offered weights each flow by its bytes; the owner-
                    # aggregated models see activity per owner (capped at
                    # the window) with that owner's weight and priority
                    flows, activity = link_overlaps(
                        i, ln, s_i, e_i, jobs, spans,
                        segments.get(ln, ()))
                    if not flows:
                        continue
                    share = policy.link_share(
                        d_i, own, jr.spec.weight, jr.spec.priority, flows,
                        [(ov, jobs[k].spec.weight, jobs[k].spec.priority)
                         for k, ov in activity.items()])
                    if share < 1.0:
                        if adj is None:
                            adj = dict(jr.eff)
                        adj[ln] = jr.eff[ln] * share
            effs.append(adj if adj is not None else jr.eff)
        return effs

    def _record_segments(self) -> None:
        """Log each job's just-resolved collective as per-link busy segments
        and drop dead ones. A segment owned by job k only matters to *other*
        jobs, whose future collectives start at or after their own current
        finish — so it is dead once every co-tenant's clock has passed its
        end. Pruning per owner keeps retention bounded (within one slowest-
        tenant step) even when BSP clocks drift far apart."""
        jobs = self._jobs
        segments = self._segments
        finishes = [jr.last + jr.dur for jr in jobs]
        # threshold per owner: the earliest co-tenant clock
        thr = [min(f for j, f in enumerate(finishes) if j != k)
               for k in range(len(jobs))]
        for i, jr in enumerate(jobs):
            start, end = jr.last, jr.last + jr.dur
            for ln, demand in jr.shared_demand.items():
                segments.setdefault(ln, []).append((start, end, demand, i))
        for ln, segs in segments.items():
            segments[ln] = [s for s in segs if s[1] > thr[s[3]]]

    # -- main loop ---------------------------------------------------------
    def run(self, iters: int, warmup: int = 0) -> EngineResult:
        """Step every job ``iters`` times; discard the first ``warmup``
        steps from the reported series. One-shot: construct a fresh engine
        per experiment (job clocks and congestion state carry over)."""
        if self._ran:
            raise RuntimeError(
                "FabricEngine.run() is one-shot (job clocks and congestion "
                "state carry over); construct a fresh engine per experiment")
        self._ran = True
        jobs = self._jobs
        congestion = self.congestion
        multi = len(jobs) > 1
        fabric_totals: Dict[str, float] = {}

        for t in range(iters):
            # 1. compute phase: arrival windows per job
            for jr in jobs:
                compute = jr.cm.sample()
                jr.compute = compute
                if jr.release_arr is None:
                    rel = jr.release
                    # addition is weakly monotone, so the extremes of
                    # (rel + c) are rel + extremes of c, bit-exactly
                    jr.first = rel + min(compute)
                    jr.last = rel + max(compute)
                else:
                    # elementwise add == the scalar rel[r] + compute[r];
                    # ndarray min/max pick the same floats as Python's
                    arrival = jr.release_arr + np.asarray(compute)
                    jr.arrival = arrival
                    jr.first = float(arrival.min())
                    jr.last = float(arrival.max())
                jr.skew = (jr.last - jr.first) / jr.floor_denom

            # 2. background congestion advances once per fabric step
            congestion.advance()
            for jr in jobs:
                jr.eff = congestion.link_eff(jr.skew,
                                             spanning_groups=jr.spanning)

            # 3. collective costs; co-tenants split overlapping bandwidth
            if multi:
                durs0 = [jr.schedule.total_s(jr.eff) for jr in jobs]
                for jr, d0, eff in zip(jobs, durs0,
                                       self._contended_effs(durs0)):
                    jr.eff = eff
                    jr.dur0 = d0
                    jr.dur = jr.schedule.total_s(eff)
                self._record_segments()
            else:
                jr = jobs[0]
                jr.dur = jr.schedule.total_s(jr.eff)
                jr.dur0 = jr.dur

            # 4. bursty entries leave queue state behind on the shared tier
            for jr in jobs:
                congestion.kick(jr.skew)

            # 5. BSP finish, accounting, pacing, release updates
            for jr in jobs:
                finish = jr.last + jr.dur
                jr.schedule.accumulate_bytes(jr.eff, jr.link_totals)
                if multi:
                    jr.schedule.accumulate_bytes(jr.eff, fabric_totals)
                step = finish - jr.prev_finish if t > 0 else finish
                if t >= warmup:
                    jr.step_times.append(step)
                    jr.comm_times.append(jr.dur)
                    jr.comm_solo.append(jr.dur0)
                    jr.skews.append(jr.skew)

                if jr.bank is None:
                    jr.trace.append((jr.compute, jr.last, finish,
                                     jr.release, jr.dur, None))
                    jr.release = finish
                else:
                    # one vectorized observe/decide for the whole job; the
                    # bank is float-exact against per-rank controllers, so
                    # the reference-equality contract survives
                    rel_arr = jr.release_arr
                    rel_snapshot = tuple(rel_arr.tolist())
                    arrival = jr.arrival
                    jr.bank.observe(jr.last - arrival, finish - rel_arr)
                    delays = jr.bank.decide()
                    jr.release_arr = finish + delays
                    jr.trace.append((jr.compute, jr.last, finish,
                                     rel_snapshot, jr.dur, delays.tolist()))
                jr.prev_finish = finish

        results = [JobResult(jr.spec, jr.nodes, jr.step_times,
                             jr.link_totals, jr.trace, algo=jr.algo,
                             comm_times=jr.comm_times,
                             comm_solo=jr.comm_solo, skews=jr.skews)
                   for jr in jobs]
        if not multi:
            fabric_totals = dict(results[0].link_bytes)
        return EngineResult(topo=self.topo, jobs=results,
                            link_bytes=fabric_totals)
