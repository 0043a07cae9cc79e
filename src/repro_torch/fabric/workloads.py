"""Tenant runtimes for the event-driven lifecycle engine.

The static :class:`repro_torch.fabric.engine.FabricEngine` steps one population of
BSP training jobs in lockstep rounds. A real cluster is a *schedule*: jobs
arrive and depart, nodes fail, and latency-sensitive inference fleets share
the same oversubscribed tier as training traffic. This module gives the
:class:`repro_torch.fabric.events.LifecycleEngine` a uniform tenant abstraction
over that mix:

  * :class:`TrainingTenant` — a BSP data-parallel job (the existing
    :class:`~repro_torch.fabric.engine.JobSpec`): per-rank compute from the
    straggler model, one gradient all-reduce per step, optional vectorized
    pacing (:class:`~repro_torch.core.pacing.PacingBank`);
  * :class:`InferenceTenant` — an **open-loop** serving fleet shaped like
    the ``launch/serve`` path: requests arrive by a Poisson process
    (exponential interarrivals, independent of service state — queueing
    delay builds when the fabric slows the fleet down), and each request is
    one *prefill* phase (compute + one large collective) followed by
    ``decode_tokens`` *decode* iterations (compute + one small collective
    each). Decode fleets are bursts of frequent small collectives — exactly
    the co-tenant traffic mix the paper's contention analysis worries
    about. A fleet is ``replicas`` independent serving groups of
    ``n_ranks`` each; a fleet-level *router* (``round_robin`` / ``jsq``
    via :data:`repro_torch.fabric.policies.ROUTERS`) assigns each arriving
    request to one replica's queue. ``batching="none"`` (default) serves
    each replica as a FIFO single stream — bit-identical to the pre-fleet
    path, the compatibility anchor the golden fixtures pin —; with
    ``batching="continuous"`` requests *join a running batch mid-flight*:
    joiners are prefetched into the batch by a prefill collective
    (batch-join events in the engine log) and every per-token decode
    collective scales with the **current batch occupancy**
    (:func:`repro_torch.fabric.congestion.batch_bytes`), up to ``max_batch``,
    instead of one prefill+decode stream per request.

Every tenant exposes one *pending collective* (window start, skew, compiled
schedule, shared-link demand) that the engine resolves against congestion
and co-tenant contention; ``resolved()`` advances the tenant's own virtual
clock and forms the next pending collective. Placement (and re-placement
after failures) compiles schedules via ``algo="auto"``
(:func:`repro_torch.fabric.collectives.select_algo`) when requested.
"""
from __future__ import annotations

import dataclasses
import random
import statistics
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.pacing import PacingBank
from repro_torch.fabric.collectives import (CompiledSchedule, compile_schedule,
                                      select_algo)
from repro_torch.fabric.congestion import batch_bytes
from repro_torch.fabric.engine import JobSpec
from repro_torch.fabric.placement import spanning_groups
from repro_torch.fabric.policies import resolve_router
from repro_torch.fabric.stragglers import ComputeModel
from repro_torch.fabric.topology import Topology
from repro_torch.ft.failure import FailureDetector, HeartbeatConfig, RecoveryLog


BATCHING_MODES = ("none", "continuous")


@dataclasses.dataclass(frozen=True)
class InferenceSpec:
    """One open-loop serving fleet sharing the fabric with training jobs.

    ``n_ranks`` is the size of *one* serving replica; the fleet occupies
    ``n_ranks * replicas`` nodes (``total_ranks``) and spreads arriving
    requests over its replicas with the named ``router``. ``batching``
    selects the per-replica service discipline: ``"none"`` (default) is
    the FIFO single stream the golden fixtures pin bit-exactly,
    ``"continuous"`` lets up to ``max_batch`` requests share the decode
    loop, joining mid-flight."""
    name: str
    n_ranks: int
    rate_rps: float = 10.0            # Poisson request arrival rate
    prefill_bytes: float = 2e8        # collective payload of the prefill
    decode_bytes: float = 1.6e7       # per-token collective payload
    decode_tokens: int = 16           # decode iterations per request
    prefill_compute_s: float = 0.02
    decode_compute_s: float = 0.004
    algo: str = "auto"
    group: int = 0
    placement: str = "compact"
    nodes: Optional[Tuple[int, ...]] = None
    seed: Optional[int] = None
    # WFQ share of contended links under fairness="wfq"; scheduling
    # priority for the lifecycle engine's backfill/preempt queue policies.
    weight: float = 1.0
    priority: int = 0
    # p99 latency target: when set, the tenant tracks per-request SLO
    # attainment (slo_ok / slo_attainment / attainment_series) — and
    # marks the fleet latency-bound for placement="slo_aware".
    slo_p99_s: Optional[float] = None
    # Model-state footprint for the checkpoint-restore cost model; None
    # estimates it from the prefill payload (activation-sized, the right
    # order for the weight shards a replica must reload).
    param_bytes: Optional[float] = None
    # Continuous-batching fleet shape: service discipline, batch capacity
    # per replica, replica count, and the fleet-level request router
    # (repro_torch.fabric.policies.ROUTERS). Defaults reproduce the pre-fleet
    # single-stream tenant bit-exactly.
    batching: str = "none"
    max_batch: int = 8
    replicas: int = 1
    router: str = "round_robin"

    def __post_init__(self):
        if not self.weight > 0.0:
            raise ValueError(
                f"fleet {self.name!r}: weight must be positive, got "
                f"{self.weight!r}")
        if self.batching not in BATCHING_MODES:
            raise ValueError(
                f"fleet {self.name!r}: unknown batching mode "
                f"{self.batching!r}; one of {BATCHING_MODES}")
        if self.max_batch < 1:
            raise ValueError(
                f"fleet {self.name!r}: max_batch must be >= 1, got "
                f"{self.max_batch!r}")
        if self.replicas < 1:
            raise ValueError(
                f"fleet {self.name!r}: replicas must be >= 1, got "
                f"{self.replicas!r}")
        if self.decode_tokens < 0:
            raise ValueError(
                f"fleet {self.name!r}: decode_tokens must be >= 0, got "
                f"{self.decode_tokens!r}")

    @property
    def total_ranks(self) -> int:
        """Nodes the whole fleet occupies (``n_ranks`` per replica)."""
        return self.n_ranks * self.replicas


def _compile(topo: Topology, nodes: Sequence[int], nbytes: float,
             algo: str, group: int, weight: float = 1.0, routing=None
             ) -> Tuple[str, CompiledSchedule]:
    if algo == "auto":
        return select_algo(topo, nodes, nbytes, group=group, weight=weight,
                           routing=routing)
    return algo, compile_schedule(topo, nodes, nbytes, algo=algo,
                                  group=group, routing=routing)


def _shared_demand(topo: Topology, sched: CompiledSchedule
                   ) -> Dict[str, float]:
    return {ln: b for ln, b in sched.bytes_per_call(None).items()
            if topo.link(ln).shared}


class Tenant:
    """Base runtime the lifecycle engine drives.

    State contract with the engine: ``pending_start`` is ``None`` when the
    tenant has nothing in flight (departed, or an inference fleet idle
    until its next request); otherwise the pending collective starts at
    ``pending_start``, runs ``pending_schedule`` with entry skew
    ``pending_skew``, and offers ``pending_demand`` bytes to shared links
    over roughly ``pending_floor`` seconds.
    """

    kind: str = ""
    # WFQ weight / scheduling priority; subclasses copy them from the spec
    weight: float = 1.0
    priority: int = 0
    # set at admission when the owning engine's fairness policy is
    # *weighted* (wfq/drr, or a third-party registration with
    # FairnessPolicy.weighted): weight then steers algo="auto" selection,
    # because the contended share it assumes will actually be granted
    weighted_fairness: bool = False
    # resolved RoutingPolicy, set at admission by the owning engine (None
    # keeps the bit-compat ecmp_static path resolution)
    routing = None

    def __init__(self, name: str, seed: int):
        self.name = name
        self.seed = seed
        self.nodes: List[int] = []
        self.arrived_t: Optional[float] = None
        self.departed_t: Optional[float] = None
        self.generation = 0           # bumped on every (re)placement
        self.placements: List[Tuple[float, Tuple[int, ...]]] = []
        self.recovery = RecoveryLog()
        self.link_bytes: Dict[str, float] = {}
        self.detector: Optional[FailureDetector] = None
        self.congestion = None        # per-tenant AR(1), set by the engine
        self.algo: str = ""
        self.spanning: int = 1
        self.pending_start: Optional[float] = None
        self.pending_skew: float = 0.0
        self.pending_schedule: Optional[CompiledSchedule] = None
        self.pending_demand: Dict[str, float] = {}
        self.pending_floor: float = 0.0
        # tenant-internal events (batch joins, ...) the owning engine
        # drains into its timeline log after each resolution
        self._pending_log: List[Tuple[str, str]] = []

    # -- engine hooks ------------------------------------------------------
    def place(self, topo: Topology, nodes: Sequence[int], t: float,
              clock: Callable[[], float], heartbeat: HeartbeatConfig
              ) -> None:
        """(Re)bind the tenant to a node set at virtual time ``t``."""
        self.nodes = list(nodes)
        self.placements.append((t, tuple(nodes)))
        self.spanning = spanning_groups(topo, nodes)
        self.detector = FailureDetector(list(nodes), heartbeat, clock)
        if self.arrived_t is None:
            self.arrived_t = t
        self.generation += 1
        self._bind(topo, t)

    def _bind(self, topo: Topology, t: float) -> None:
        raise NotImplementedError

    def prepare(self) -> None:
        """Form the next pending collective (sets ``pending_*``)."""
        raise NotImplementedError

    def resolved(self, finish: float, dur: float,
                 d0: Optional[float] = None) -> None:
        """The pending collective completed at ``finish`` after ``dur``
        seconds contended (``d0`` = its co-tenant-free duration under the
        same background congestion; observation only — advisor input)."""
        raise NotImplementedError

    def shrink_plan(self, survivors: int) -> int:
        """Ranks to run with after a failure left ``survivors`` nodes."""
        return survivors

    def wants_departure(self) -> bool:
        return False

    def drain_log(self) -> List[Tuple[str, str]]:
        """Tenant-internal ``(kind, detail)`` events since the last drain
        (the engine timestamps them into its timeline log)."""
        out, self._pending_log = self._pending_log, []
        return out

    @property
    def param_bytes(self) -> float:
        """Model-state bytes a restore must reload (checkpoint-restore
        cost model input)."""
        return 0.0


class TrainingTenant(Tenant):
    kind = "training"

    def __init__(self, spec: JobSpec, seed: int):
        super().__init__(spec.name, seed)
        self.spec = spec
        self.weight = spec.weight
        self.priority = spec.priority
        self.step_times: List[float] = []
        # trace instrumentation (repro_torch.fabric.trace): absolute finish
        # timestamp and contended collective duration per step, aligned
        # 1:1 with step_times — observation only, no engine effect
        self.step_finish: List[float] = []
        self.comm_times: List[float] = []
        # advisor instrumentation — observation only, no engine effect:
        # pre-contention collective duration, entry skew, and per-rank
        # compute mean/max per resolved step, aligned 1:1 with step_times
        self.comm_solo: List[float] = []
        self.skews: List[float] = []
        self.comp_means: List[float] = []
        self.comp_maxs: List[float] = []
        self._comp_mean = 0.0
        self._comp_max = 0.0
        self.iters_done = 0
        self._release = 0.0
        self._release_arr: Optional[np.ndarray] = None
        self._bank: Optional[PacingBank] = None
        self._prev_finish: Optional[float] = None
        self._arrival: Optional[np.ndarray] = None
        self._last = 0.0

    def _bind(self, topo: Topology, t: float) -> None:
        spec = self.spec
        n = len(self.nodes)
        self.n = n
        if spec.ckpt_every is None or self.generation <= 1:
            # fresh streams per generation: a re-placed job is a restart
            gen_seed = self.seed + 7919 * (self.generation - 1)
            self.cm = ComputeModel(spec.stragglers, n, seed=gen_seed)
        else:
            # checkpoint-aware resume: rewind to the newest checkpoint at
            # the spec's cadence and continue the *original* compute
            # stream from that step count, instead of restarting the
            # epoch stream per generation — steps past the checkpoint are
            # lost work and will be re-executed (visible in-series)
            from repro_torch.ckpt import latest_restorable_step
            restore = latest_restorable_step(self.iters_done,
                                             spec.ckpt_every)
            self.cm = ComputeModel(spec.stragglers, n, seed=self.seed)
            for _ in range(restore):
                self.cm.sample()
            self.iters_done = restore
        self._bank = PacingBank(spec.pacing, n) \
            if spec.pacing is not None else None
        self.algo, self.schedule = _compile(
            topo, self.nodes, spec.grad_bytes, spec.algo, spec.group,
            spec.weight if self.weighted_fairness else 1.0, self.routing)
        self.floor_denom = max(self.schedule.total_s(None), 1e-9)
        self.demand = _shared_demand(topo, self.schedule)
        self._release = t
        self._release_arr = np.full(n, float(t)) \
            if self._bank is not None else None
        if self._prev_finish is None:
            self._prev_finish = t
        # else: keep the pre-failure clock — the detection stall and replan
        # delay surface as one long step, which is what the job's consumers
        # actually observed
        self._arrival = None

    def prepare(self) -> None:
        compute = self.cm.sample()
        if self._release_arr is None:
            rel = self._release
            first = rel + min(compute)
            last = rel + max(compute)
        else:
            arrival = self._release_arr + np.asarray(compute)
            self._arrival = arrival
            first = float(arrival.min())
            last = float(arrival.max())
        self._last = last
        self._comp_mean = statistics.fmean(compute)
        self._comp_max = max(compute)
        self.pending_start = last
        self.pending_skew = (last - first) / self.floor_denom
        self.pending_schedule = self.schedule
        self.pending_demand = self.demand
        self.pending_floor = self.floor_denom

    def resolved(self, finish: float, dur: float,
                 d0: Optional[float] = None) -> None:
        self.step_times.append(finish - self._prev_finish)
        self.step_finish.append(finish)
        self.comm_times.append(dur)
        self.comm_solo.append(d0 if d0 is not None else dur)
        self.skews.append(self.pending_skew)
        self.comp_means.append(self._comp_mean)
        self.comp_maxs.append(self._comp_max)
        self._prev_finish = finish
        self.iters_done += 1
        if self._bank is None:
            self._release = finish
        else:
            self._bank.observe(self._last - self._arrival,
                               finish - self._release_arr)
            self._release_arr = finish + self._bank.decide()
        self.pending_start = None

    def shrink_plan(self, survivors: int) -> int:
        from repro_torch.ft.failure import plan_elastic_mesh
        shape, _axes = plan_elastic_mesh(
            survivors, model_parallel=self.spec.model_parallel,
            prefer_pods=False)
        n = 1
        for d in shape:
            n *= d
        return n

    def wants_departure(self) -> bool:
        return self.spec.iters is not None \
            and self.iters_done >= self.spec.iters

    @property
    def param_bytes(self) -> float:
        # fp32 gradients are parameter-sized, so the gradient payload is
        # the natural estimate of the checkpoint a restart must reload
        return self.spec.param_bytes if self.spec.param_bytes is not None \
            else self.spec.grad_bytes

    # -- metrics -----------------------------------------------------------
    @property
    def mean_step(self) -> float:
        return statistics.fmean(self.step_times) if self.step_times else 0.0

    @property
    def cv(self) -> float:
        m = self.mean_step
        return (statistics.pstdev(self.step_times) / m) if m > 0 else 0.0

    @property
    def throughput(self) -> float:
        m = self.mean_step
        return (len(self.nodes) * self.spec.samples_per_rank / m) \
            if m > 0 else 0.0


class _Request:
    """One serving request: arrival time, a stable sequence number (tie
    break for redistribution sorts), and — once in a batch — the decode
    tokens it still owes."""

    __slots__ = ("arrival", "seq", "tokens_left")

    def __init__(self, arrival: float, seq: int):
        self.arrival = arrival
        self.seq = seq
        self.tokens_left = 0


class _Replica(object):
    """One serving replica: its own node subset, compiled (and
    occupancy-scaled) schedules, and virtual-clock queue state.

    The replica alternates two collective kinds on its private clock
    (``free_at`` = finish of its last collective):

      * **prefill / batch-join** — admit the FIFO-head waiters whose
        arrival precedes the join instant, up to the batch capacity; the
        joiners' prefill payload scales with how many join at once;
      * **decode** — one token for every request in the batch; payload
        scales with the current occupancy.

    ``batching="none"`` is the degenerate capacity-1 instance of the same
    machinery: at most one request in the "batch", so joins only happen on
    an empty server and every decode runs at occupancy 1 — which makes the
    arithmetic operation-for-operation identical to the pre-fleet
    single-stream tenant (held by the golden fixtures).
    """

    def __init__(self, fleet: "InferenceTenant", index: int,
                 topo: Topology, nodes: Sequence[int], t: float):
        spec = fleet.spec
        self.fleet = fleet
        self.index = index
        self.nodes = list(nodes)
        self.spanning = spanning_groups(topo, nodes)
        self._topo = topo
        w = spec.weight if fleet.weighted_fairness else 1.0
        self.algo, prefill1 = _compile(
            topo, nodes, spec.prefill_bytes, spec.algo, spec.group, w,
            fleet.routing)
        self.decode_algo, decode1 = _compile(
            topo, nodes, spec.decode_bytes, spec.algo, spec.group, w,
            fleet.routing)
        # occupancy-scaled schedule caches; occupancy 1 is *exactly* the
        # select_algo result above (the batching="none" bit-compat anchor),
        # higher occupancies recompile the selected algo at the
        # batch-weighted payload (repro_torch.fabric.congestion.batch_bytes)
        self._scheds: Dict[Tuple[str, int],
                           Tuple[CompiledSchedule, Dict[str, float], float]]
        self._scheds = {("prefill", 1): self._pack(topo, prefill1),
                        ("decode", 1): self._pack(topo, decode1)}
        self.wait: List[_Request] = []      # routed, not yet in the batch
        self.batch: List[_Request] = []     # decoding (tokens_left > 0)
        self._joining: List[_Request] = []  # joiners of a pending prefill
        self.free_at = t
        self._kind = ""                     # kind of the pending collective

    @staticmethod
    def _pack(topo: Topology, sched: CompiledSchedule
              ) -> Tuple[CompiledSchedule, Dict[str, float], float]:
        return (sched, _shared_demand(topo, sched),
                max(sched.total_s(None), 1e-9))

    def _sched(self, kind: str, occupancy: int
               ) -> Tuple[CompiledSchedule, Dict[str, float], float]:
        key = (kind, occupancy)
        hit = self._scheds.get(key)
        if hit is None:
            spec = self.fleet.spec
            base = spec.prefill_bytes if kind == "prefill" \
                else spec.decode_bytes
            algo = self.algo if kind == "prefill" else self.decode_algo
            hit = self._pack(self._topo, compile_schedule(
                self._topo, self.nodes, batch_bytes(base, occupancy),
                algo=algo, group=spec.group, routing=self.fleet.routing))
            self._scheds[key] = hit
        return hit

    def depth(self) -> int:
        """Outstanding work: waiting + joining + in-batch requests (the
        router's queue-length signal)."""
        return len(self.wait) + len(self._joining) + len(self.batch)

    def requests_held(self) -> List[_Request]:
        """Every request currently owned by this replica (conservation /
        redistribution)."""
        return self._joining + self.batch + self.wait

    def _join_ready(self) -> bool:
        cap = self.fleet._capacity
        return bool(self.wait) and len(self.batch) < cap and (
            not self.batch or self.wait[0].arrival <= self.free_at)

    def next_start(self) -> Optional[float]:
        """Window start of this replica's next collective (pure), or None
        when idle with an empty queue."""
        spec = self.fleet.spec
        if self._join_ready():
            return max(self.free_at, self.wait[0].arrival) \
                + spec.prefill_compute_s
        if self.batch:
            return self.free_at + spec.decode_compute_s
        return None

    def form_pending(self) -> Tuple[float, CompiledSchedule,
                                    Dict[str, float], float]:
        """Commit to the next collective: pop joiners / pick the decode
        step, and return ``(start, schedule, shared_demand, floor)``."""
        spec = self.fleet.spec
        if self._join_ready():
            base = max(self.free_at, self.wait[0].arrival)
            room = self.fleet._capacity - len(self.batch)
            j = 0
            while j < len(self.wait) and j < room \
                    and self.wait[j].arrival <= base:
                j += 1
            self._joining, self.wait = self.wait[:j], self.wait[j:]
            self._kind = "prefill"
            sched, demand, floor = self._sched("prefill", j)
            return base + spec.prefill_compute_s, sched, demand, floor
        self._kind = "decode"
        sched, demand, floor = self._sched("decode", len(self.batch))
        return self.free_at + spec.decode_compute_s, sched, demand, floor

    def resolved(self, finish: float) -> None:
        fleet = self.fleet
        spec = fleet.spec
        if self._kind == "prefill":
            if spec.decode_tokens < 1:
                # prefill-only requests complete at the prefill finish
                # (the pre-fleet path's behavior for decode_tokens=0)
                for req in self._joining:
                    fleet._complete(req, finish)
            else:
                for req in self._joining:
                    req.tokens_left = spec.decode_tokens
                self.batch.extend(self._joining)
                if fleet._capacity > 1:
                    fleet._pending_log.append((
                        "batch_join",
                        f"{fleet.name}[r{self.index}]: "
                        f"+{len(self._joining)} joined -> occupancy "
                        f"{len(self.batch)}"))
            self._joining = []
        else:
            fleet.decode_step_times.append(finish - self.free_at)
            still: List[_Request] = []
            for req in self.batch:
                req.tokens_left -= 1
                if req.tokens_left <= 0:
                    fleet._complete(req, finish)
                else:
                    still.append(req)
            self.batch = still
        self.free_at = finish
        self._kind = ""


class InferenceTenant(Tenant):
    kind = "inference"

    def __init__(self, spec: InferenceSpec, seed: int):
        super().__init__(spec.name, seed)
        self.spec = spec
        self.weight = spec.weight
        self.priority = spec.priority
        self.latencies: List[float] = []
        self.slo_ok: List[bool] = []  # per request, when slo_p99_s is set
        self.decode_step_times: List[float] = []
        # trace instrumentation (repro_torch.fabric.trace) — observation only:
        # (arrival, finish) per completed request, and (finish, kind,
        # duration, payload bytes, occupancy) per resolved collective
        self.request_log: List[Tuple[float, float]] = []
        self.collective_log: List[Tuple[float, str, float, float,
                                        int]] = []
        # advisor instrumentation — observation only: pre-contention
        # duration of each resolved collective, aligned 1:1 with
        # collective_log (parallel list; trace.py unpacks the 5-tuples)
        self.collective_solo: List[float] = []
        self.requests_arrived = 0
        self.requests_done = 0
        self.tokens_done = 0
        # (chosen replica, per-replica depths) per routing decision — the
        # JSQ no-worse-queue property test reads this
        self.routing_log: List[Tuple[int, Tuple[int, ...]]] = []
        self._capacity = spec.max_batch if spec.batching == "continuous" \
            else 1
        self._router = resolve_router(spec.router)
        self._rng = random.Random(seed)
        self._replicas: List[_Replica] = []
        self._pending_replica: Optional[_Replica] = None
        self._next_arrival: Optional[float] = None
        self._seq = 0
        self._last_finish = 0.0

    # -- placement ---------------------------------------------------------
    def _bind(self, topo: Topology, t: float) -> None:
        spec = self.spec
        # carry queue state across (re)placements: in-flight requests
        # restart from prefill on the new placement (their activation/KV
        # state died with it) keeping their arrival times — the recovery
        # stall shows up in their latency —, waiting requests re-route
        # over the new replica set; nothing is ever dropped (request
        # conservation, held by tests/test_batching.py)
        carried = sorted((req for rep in self._replicas
                          for req in rep.requests_held()),
                        key=lambda r: (r.arrival, r.seq))
        old_free = [rep.free_at for rep in self._replicas]
        if spec.replicas == 1:
            chunks = [list(self.nodes)]
        else:
            k = spec.n_ranks
            chunks = [self.nodes[i * k:(i + 1) * k]
                      for i in range(len(self.nodes) // k)]
        self._replicas = []
        for i, chunk in enumerate(chunks):
            rep = _Replica(self, i, topo, chunk, t)
            if i < len(old_free):
                rep.free_at = max(old_free[i], t)
            self._replicas.append(rep)
        self.algo = self._replicas[0].algo
        if self._next_arrival is None:
            self._next_arrival = t + self._rng.expovariate(spec.rate_rps)
        self._pending_replica = None
        for req in carried:
            req.tokens_left = 0
            self._dispatch(req)

    def shrink_plan(self, survivors: int) -> int:
        if self.spec.replicas == 1:
            # pre-fleet behavior: a single serving group recompiles its
            # collectives at whatever width survived
            return survivors
        # multi-replica fleets shrink in whole replicas: a partial serving
        # group cannot hold the sharded model
        return (survivors // self.spec.n_ranks) * self.spec.n_ranks

    # -- completion --------------------------------------------------------
    def _complete(self, req: _Request, finish: float) -> None:
        spec = self.spec
        lat = finish - req.arrival
        self.latencies.append(lat)
        self.request_log.append((req.arrival, finish))
        if spec.slo_p99_s is not None:
            self.slo_ok.append(lat <= spec.slo_p99_s)
        self.requests_done += 1
        self.tokens_done += spec.decode_tokens

    # -- routing -----------------------------------------------------------
    def _dispatch(self, req: _Request) -> None:
        depths = tuple(rep.depth() for rep in self._replicas)
        i = self._router.pick(depths)
        if not 0 <= i < len(self._replicas):
            raise ValueError(
                f"router {self.spec.router!r} picked replica {i} of "
                f"{len(self._replicas)}")
        self.routing_log.append((i, depths))
        self._replicas[i].wait.append(req)

    def _pump(self) -> None:
        """Materialize (and route) every arrival that precedes the fleet's
        next service event — open-loop: arrivals happen regardless of
        whether any replica is free. Routing at arrival order keeps JSQ
        causally sane: each decision sees the queue depths as of that
        arrival."""
        rate = self.spec.rate_rps
        while True:
            nxt = None
            for rep in self._replicas:
                s = rep.next_start()
                if s is not None and (nxt is None or s < nxt):
                    nxt = s
            if nxt is not None and self._next_arrival > nxt:
                return
            req = _Request(self._next_arrival, self._seq)
            self._seq += 1
            self.requests_arrived += 1
            self._next_arrival += self._rng.expovariate(rate)
            self._dispatch(req)

    # -- engine hooks ------------------------------------------------------
    def prepare(self) -> None:
        self._pump()
        best: Optional[_Replica] = None
        best_start = 0.0
        for rep in self._replicas:
            s = rep.next_start()
            if s is not None and (best is None or s < best_start):
                best, best_start = rep, s
        # the pump always leaves at least one replica with work
        assert best is not None, "open-loop fleet ran out of arrivals"
        start, sched, demand, floor = best.form_pending()
        self._pending_replica = best
        self.spanning = best.spanning
        self.pending_start = start
        self.pending_skew = 0.0       # replicas dispatch decode in lockstep
        self.pending_schedule = sched
        self.pending_demand = demand
        self.pending_floor = floor

    def resolved(self, finish: float, dur: float,
                 d0: Optional[float] = None) -> None:
        rep = self._pending_replica
        # snapshot the collective before the replica resets its pending
        # kind: occupancy is the joiner count for a prefill, the batch
        # size for a decode, and payload follows batch_bytes
        ckind = rep._kind
        occ = len(rep._joining) if ckind == "prefill" else len(rep.batch)
        base = self.spec.prefill_bytes if ckind == "prefill" \
            else self.spec.decode_bytes
        self.collective_log.append(
            (finish, ckind, dur, batch_bytes(base, max(occ, 1)),
             max(occ, 1)))
        self.collective_solo.append(d0 if d0 is not None else dur)
        rep.resolved(finish)
        self._pending_replica = None
        if finish > self._last_finish:
            self._last_finish = finish
        self.pending_start = None

    # -- metrics -----------------------------------------------------------
    @property
    def mean_latency(self) -> float:
        return statistics.fmean(self.latencies) if self.latencies else 0.0

    def latency_quantile(self, q: float) -> float:
        if not self.latencies:
            return 0.0
        s = sorted(self.latencies)
        return s[min(len(s) - 1, int(q * len(s)))]

    @property
    def tokens_per_s(self) -> float:
        if not self.latencies or self.departed_t is None:
            span = self._last_finish - (self.arrived_t or 0.0)
        else:
            span = self.departed_t - (self.arrived_t or 0.0)
        return self.tokens_done / span if span > 0 else 0.0

    @property
    def requests_outstanding(self) -> int:
        """Requests arrived but not yet completed (waiting, joining, or
        decoding on some replica) — ``requests_arrived ==
        requests_done + requests_outstanding`` is the conservation
        invariant the batching tests pin across failures and re-places."""
        return sum(rep.depth() for rep in self._replicas)

    @property
    def replica_spans(self) -> List[int]:
        """Leaf/pod span of each replica's node chunk (the locality the
        ``slo_aware`` placement policy optimizes)."""
        return [rep.spanning for rep in self._replicas]

    @property
    def param_bytes(self) -> float:
        return self.spec.param_bytes if self.spec.param_bytes is not None \
            else self.spec.prefill_bytes

    # -- SLO attainment ----------------------------------------------------
    @property
    def slo_attainment(self) -> float:
        """Fraction of completed requests inside ``slo_p99_s``. A fleet
        with an SLO that completed *nothing* reports 0.0 — total
        starvation is the worst outcome, not a vacuous pass. Without a
        configured SLO the metric is vacuously 1.0."""
        if not self.slo_ok:
            return 1.0 if self.spec.slo_p99_s is None else 0.0
        return sum(self.slo_ok) / len(self.slo_ok)

    def attainment_series(self, window: int = 50) -> List[float]:
        """Rolling SLO attainment over trailing ``window`` requests — the
        per-tenant series benchmarks plot against training throughput."""
        out: List[float] = []
        hits = 0
        for i, ok in enumerate(self.slo_ok):
            hits += ok
            if i >= window:
                hits -= self.slo_ok[i - window]
            out.append(hits / min(i + 1, window))
        return out
