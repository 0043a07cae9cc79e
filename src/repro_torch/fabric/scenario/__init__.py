"""Declarative scenario API: one spec, one front door, one result shape.

The paper's diagnostic claim is that scaling failures come from the
*combination* of topology, placement, sharing, and scheduling choices.
Before this API those choices were spread over three entry points
(``simulate()``, ``FabricEngine``, ``LifecycleEngine``) and a pile of
positional kwargs — awkward to sweep, easy to mis-wire. A
:class:`Scenario` folds the whole experiment into one declarative value:

    >>> from repro_torch.fabric.scenario import Policies, Scenario, TopologySpec
    >>> from repro_torch.fabric import Arrival, InferenceSpec, JobSpec
    >>> scn = Scenario(
    ...     name="noisy-neighbor",
    ...     topology=TopologySpec(n_nodes=64, nodes_per_leaf=8),
    ...     events=[
    ...         Arrival(0.0, JobSpec("train", 12, nodes=tuple(range(12)),
    ...                              grad_bytes=4e9)),
    ...         Arrival(0.0, InferenceSpec("serve", 8,
    ...                                    nodes=tuple(range(12, 20)),
    ...                                    weight=4.0, slo_p99_s=0.5)),
    ...     ],
    ...     policies=Policies(fairness="wfq", backend="reference"),
    ...     horizon=12.0)
    >>> result = scn.run()
    >>> result.series("serve"), result.slo_attainment()["serve"]

Design contract:

  * **eager validation** — unknown policy names, oversubscribed or
    overlapping pinned nodes, bad algos, and malformed horizons raise
    :class:`ScenarioError` at construction, not mid-run;
  * **serialization** — ``to_dict()`` / ``from_dict()`` round-trip through
    plain JSON values and reproduce the run bit-identically (the sweep
    and storage format PRISM-style what-if studies use);
  * **one front door** — ``run()`` dispatches to
    :class:`~repro_torch.fabric.engine.FabricEngine` (static ``jobs``
    population) or :class:`~repro_torch.fabric.events.LifecycleEngine`
    (``events`` timeline) internally and returns a :class:`Result` that
    unifies per-tenant series, SLO attainment, locality/contention
    diagnostics, and the determinism fingerprint the golden suite pins;
  * **pluggable policies** — the ``policies`` block resolves fairness /
    scheduler / placement by name through
    :mod:`repro_torch.fabric.policies`, so third-party registrations are
    immediately addressable from scenarios.

:class:`ScenarioGrid` sweeps dotted-path overrides over a base scenario;
:mod:`repro_torch.fabric.scenario.library` names ready-made scenarios for
the paper's failure modes. Trace fitting and export
(:mod:`repro_torch.fabric.trace`) and attribution and advice
(:mod:`repro_torch.fabric.advisor`) are reached from :meth:`Scenario.
from_trace` and the :class:`Result` methods.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
from typing import (Any, Dict, Iterator, List, Optional, Sequence, Tuple,
                    Union)

from repro_torch.configs.base import PacingConfig
from repro_torch.fabric import _deprecation
from repro_torch.fabric.congestion import CongestionConfig
from repro_torch.fabric.engine import EngineResult, FabricEngine, JobSpec
from repro_torch.fabric.events import (Arrival, Departure, Event, LifecycleEngine,
                                 LifecycleResult, LinkDegrade, LinkFlap,
                                 NodeFailure)
from repro_torch.fabric.placement import spanning_groups
from repro_torch.fabric.policies import (FAIRNESS, PLACEMENTS, ROUTERS, ROUTING,
                                   SCHEDULERS)
from repro_torch.fabric.scheduling import make_scheduler
from repro_torch.fabric.stragglers import StragglerConfig
from repro_torch.fabric.topology import (Topology, fat_tree, multi_pod,
                                   rail_optimized, tpu_pod)
from repro_torch.fabric.workloads import InferenceSpec
from repro_torch.ft.failure import HeartbeatConfig, RestoreCostModel

ALGOS = ("ring", "tree", "hierarchical", "sharp", "auto")

TOPOLOGY_KINDS = ("fat_tree", "tpu_pod", "rail_optimized", "multi_pod")


class ScenarioError(ValueError):
    """Eager scenario validation failure (bad policy name, oversubscribed
    nodes, malformed spec) — raised at construction, not mid-run."""


# ---------------------------------------------------------------------------
# spec blocks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Serializable fabric description (replaces passing a built
    :class:`Topology`). ``fat_tree`` uses the ``n_nodes`` /
    ``nodes_per_leaf`` / ``oversubscription`` / ``leaf_bw`` group;
    ``tpu_pod`` uses ``n_pods`` / ``ranks_per_pod`` / ``ici_bw`` /
    ``dcn_bw``; ``rail_optimized`` reads ``n_nodes`` as the total GPU
    count with ``gpus_per_node`` / ``nv_bw`` (NVLink) / ``leaf_bw`` (rail
    NIC); ``multi_pod`` uses ``n_pods`` / ``ranks_per_pod`` /
    ``nodes_per_leaf`` / ``inter_pod_links`` / ``global_bw`` /
    ``sharp_capacity_bytes``. The sparse kinds (``rail_optimized``,
    ``multi_pod``) materialize links lazily, so 100k+ rank fabrics build
    with memory proportional to the links tenants actually touch."""
    kind: str = "fat_tree"
    n_nodes: int = 64
    nodes_per_leaf: int = 8
    oversubscription: float = 2.0
    leaf_bw: float = 50.0
    latency_s: float = 5e-6
    nic_spread: float = 0.0
    n_pods: int = 2
    ranks_per_pod: int = 256
    ici_bw: float = 50.0
    dcn_bw: float = 6.25
    gpus_per_node: int = 8
    nv_bw: float = 400.0
    inter_pod_links: int = 4
    global_bw: float = 25.0
    sharp_capacity_bytes: float = 0.0
    seed: int = 0

    def validate(self) -> None:
        if self.kind not in TOPOLOGY_KINDS:
            raise ScenarioError(
                f"unknown topology kind {self.kind!r}; one of "
                f"{TOPOLOGY_KINDS}")
        if self.kind == "tpu_pod":
            positive = (("n_nodes", self.n_nodes),
                        ("nodes_per_leaf", self.nodes_per_leaf),
                        ("oversubscription", self.oversubscription),
                        ("leaf_bw", self.leaf_bw),
                        ("n_pods", self.n_pods),
                        ("ranks_per_pod", self.ranks_per_pod),
                        ("ici_bw", self.ici_bw),
                        ("dcn_bw", self.dcn_bw))
        elif self.kind == "rail_optimized":
            positive = (("n_nodes", self.n_nodes),
                        ("gpus_per_node", self.gpus_per_node),
                        ("oversubscription", self.oversubscription),
                        ("leaf_bw", self.leaf_bw),
                        ("nv_bw", self.nv_bw))
        elif self.kind == "multi_pod":
            positive = (("n_pods", self.n_pods),
                        ("ranks_per_pod", self.ranks_per_pod),
                        ("nodes_per_leaf", self.nodes_per_leaf),
                        ("inter_pod_links", self.inter_pod_links),
                        ("oversubscription", self.oversubscription),
                        ("leaf_bw", self.leaf_bw),
                        ("global_bw", self.global_bw))
        else:
            positive = (("n_nodes", self.n_nodes),
                        ("nodes_per_leaf", self.nodes_per_leaf),
                        ("oversubscription", self.oversubscription),
                        ("leaf_bw", self.leaf_bw))
        for name, val in positive:
            if not val > 0:
                raise ScenarioError(
                    f"topology {name} must be positive, got {val!r}")
        if self.latency_s < 0 or self.nic_spread < 0:
            raise ScenarioError(
                f"topology latency_s/nic_spread must be >= 0, got "
                f"{self.latency_s!r}/{self.nic_spread!r}")
        if self.kind == "rail_optimized" \
                and self.n_nodes % self.gpus_per_node != 0:
            raise ScenarioError(
                f"rail_optimized n_nodes (total GPUs) must divide by "
                f"gpus_per_node, got {self.n_nodes} % {self.gpus_per_node}")
        if self.kind == "multi_pod":
            if self.ranks_per_pod % self.nodes_per_leaf != 0:
                raise ScenarioError(
                    f"multi_pod ranks_per_pod must divide by nodes_per_leaf, "
                    f"got {self.ranks_per_pod} % {self.nodes_per_leaf}")
            if self.sharp_capacity_bytes < 0:
                raise ScenarioError(
                    f"sharp_capacity_bytes must be >= 0, got "
                    f"{self.sharp_capacity_bytes!r}")
        if self.n_ranks < 2:
            raise ScenarioError(
                f"topology must offer >= 2 ranks, got {self.n_ranks}")

    @property
    def n_ranks(self) -> int:
        if self.kind in ("tpu_pod", "multi_pod"):
            return self.n_pods * self.ranks_per_pod
        return self.n_nodes

    def build(self) -> Topology:
        if self.kind == "fat_tree":
            return fat_tree(
                self.n_nodes, nodes_per_leaf=self.nodes_per_leaf,
                oversubscription=self.oversubscription,
                leaf_bw=self.leaf_bw, latency_s=self.latency_s,
                nic_spread=self.nic_spread, seed=self.seed)
        if self.kind == "rail_optimized":
            return rail_optimized(
                self.n_nodes, gpus_per_node=self.gpus_per_node,
                oversubscription=self.oversubscription, nv_bw=self.nv_bw,
                rail_bw=self.leaf_bw, latency_s=self.latency_s)
        if self.kind == "multi_pod":
            return multi_pod(
                self.n_pods, self.ranks_per_pod,
                nodes_per_leaf=self.nodes_per_leaf,
                inter_pod_links=self.inter_pod_links,
                oversubscription=self.oversubscription,
                leaf_bw=self.leaf_bw, global_bw=self.global_bw,
                latency_s=self.latency_s,
                sharp_capacity_bytes=self.sharp_capacity_bytes)
        return tpu_pod(self.n_pods, self.ranks_per_pod,
                       ici_bw=self.ici_bw, dcn_bw=self.dcn_bw,
                       seed=self.seed)


@dataclasses.dataclass(frozen=True)
class Policies:
    """The scenario's policy block, resolved by name through the pluggable
    registries (:mod:`repro_torch.fabric.policies`).

    ``min_runtime_s`` is the preempt scheduler's anti-thrash budget.
    ``replan_delay_s=None`` (or explicit ``restore_read_bw_Bps`` /
    ``restore_overhead_s``) derives re-place stalls from the
    checkpoint-restore cost model instead of the 0.5 s constant.

    ``backend`` is the default execution backend for ``run()`` — a
    :class:`repro_torch.fabric.backend.KernelType` name: ``"cuda"``, the
    default, is the batched runner on the card with the allocator and
    segment-overlap calls served by the hand-written CUDA kernels;
    ``"torch"`` the same runner on plain PyTorch kernels; ``"reference"``
    the sequential Python engine on the host and the bit-exactness spec.
    The host engine runs only where it is asked for by name: event
    timelines, ``offered``/``drr`` fairness and adaptive routing are
    outside the batched runner's scope, so a scenario declaring one of
    them also declares ``backend="reference"``.
    ``Scenario.run(backend=...)`` and ``ScenarioGrid.run(backend=...)``
    override it per call.

    ``routing`` resolves multi-path route tokens (only ``multi_pod``
    topologies emit them): ``"ecmp_static"`` pins each flow to one hashed
    member at compile time (bit-compatible with single-path costs);
    ``"adaptive_spray"`` re-splits shared-segment bytes across the
    parallel inter-pod paths at every evaluation from observed link
    efficiency (reference backend only).
    """
    fairness: str = "maxmin"
    scheduler: str = "fifo"
    min_runtime_s: float = 0.0
    replan_delay_s: Optional[float] = 0.5
    restore_read_bw_Bps: Optional[float] = None
    restore_overhead_s: Optional[float] = None
    backend: str = "cuda"
    routing: str = "ecmp_static"

    def validate(self) -> None:
        if self.fairness not in FAIRNESS:
            raise ScenarioError(
                f"unknown fairness mode {self.fairness!r}; one of "
                f"{FAIRNESS.names()}")
        if self.routing not in ROUTING:
            raise ScenarioError(
                f"unknown routing policy {self.routing!r}; one of "
                f"{ROUTING.names()}")
        from repro_torch.fabric.backend import BACKENDS
        if self.backend not in BACKENDS:
            raise ScenarioError(
                f"unknown backend {self.backend!r}; one of {BACKENDS}")
        if self.scheduler not in SCHEDULERS:
            raise ScenarioError(
                f"unknown scheduler {self.scheduler!r}; one of "
                f"{SCHEDULERS.names()}")
        if self.min_runtime_s < 0.0:
            raise ScenarioError(
                f"min_runtime_s must be >= 0, got {self.min_runtime_s!r}")
        if self.min_runtime_s > 0.0 and self.scheduler != "preempt":
            raise ScenarioError(
                "min_runtime_s is the preempt scheduler's anti-thrash "
                f"budget; scheduler is {self.scheduler!r}")
        if self.replan_delay_s is not None and self.replan_delay_s < 0.0:
            raise ScenarioError(
                f"replan_delay_s must be >= 0 (or None for the restore "
                f"cost model), got {self.replan_delay_s!r}")
        if self.restore_read_bw_Bps is not None \
                and not self.restore_read_bw_Bps > 0.0:
            raise ScenarioError(
                f"restore_read_bw_Bps must be positive, got "
                f"{self.restore_read_bw_Bps!r}")
        if self.restore_overhead_s is not None \
                and self.restore_overhead_s < 0.0:
            raise ScenarioError(
                f"restore_overhead_s must be >= 0, got "
                f"{self.restore_overhead_s!r}")

    def lifecycle_only_settings(self) -> List[str]:
        """Fields that only reach the lifecycle backend — a static-jobs
        scenario declaring them is a misdeclaration, not a no-op."""
        out = []
        if self.scheduler != "fifo":
            out.append(f"scheduler={self.scheduler!r}")
        if self.replan_delay_s != 0.5:
            out.append(f"replan_delay_s={self.replan_delay_s!r}")
        if self.restore_read_bw_Bps is not None:
            out.append("restore_read_bw_Bps")
        if self.restore_overhead_s is not None:
            out.append("restore_overhead_s")
        return out

    def build_scheduler(self):
        """A fresh scheduler instance (they are one-shot, like engines)."""
        kwargs = {"min_runtime_s": self.min_runtime_s} \
            if self.min_runtime_s > 0.0 else {}
        return make_scheduler(self.scheduler, **kwargs)

    def restore_cost(self) -> Optional[RestoreCostModel]:
        if self.restore_read_bw_Bps is None \
                and self.restore_overhead_s is None:
            return None
        defaults = RestoreCostModel()
        return RestoreCostModel(
            read_bw_Bps=self.restore_read_bw_Bps
            if self.restore_read_bw_Bps is not None else defaults.read_bw_Bps,
            overhead_s=self.restore_overhead_s
            if self.restore_overhead_s is not None else defaults.overhead_s)


# ---------------------------------------------------------------------------
# serialization helpers (plain-JSON dict trees)
# ---------------------------------------------------------------------------


def _opt(cls, d):
    return None if d is None else cls(**d)


def _spec_to_dict(spec: Union[JobSpec, InferenceSpec]) -> Dict[str, Any]:
    out = dataclasses.asdict(spec)
    if out.get("nodes") is not None:
        out["nodes"] = list(out["nodes"])
    out["kind"] = "training" if isinstance(spec, JobSpec) else "inference"
    return out


def _spec_from_dict(d: Dict[str, Any]) -> Union[JobSpec, InferenceSpec]:
    d = dict(d)
    kind = d.pop("kind", "training")
    if d.get("nodes") is not None:
        d["nodes"] = tuple(d["nodes"])
    try:
        if kind == "training":
            d["stragglers"] = StragglerConfig(**d.get(
                "stragglers", {}) or {})
            pacing = d.get("pacing")
            d["pacing"] = PacingConfig(**pacing) \
                if pacing is not None else None
            return JobSpec(**d)
        if kind == "inference":
            return InferenceSpec(**d)
    except TypeError as e:
        raise ScenarioError(f"malformed tenant spec {d.get('name')!r}: "
                            f"{e}") from None
    raise ScenarioError(f"unknown tenant kind {kind!r}; "
                        f"one of ('training', 'inference')")


def _event_to_dict(ev: Event) -> Dict[str, Any]:
    if isinstance(ev, Arrival):
        return {"type": "arrival", "t": ev.t,
                "spec": _spec_to_dict(ev.spec)}
    if isinstance(ev, Departure):
        return {"type": "departure", "t": ev.t, "name": ev.name}
    if isinstance(ev, NodeFailure):
        return {"type": "node_failure", "t": ev.t, "node": ev.node}
    if isinstance(ev, LinkFlap):
        return {"type": "link_flap", "t": ev.t, "link": ev.link,
                "down_s": ev.down_s}
    if isinstance(ev, LinkDegrade):
        return {"type": "link_degrade", "t": ev.t, "link": ev.link,
                "factor": ev.factor, "duration_s": ev.duration_s}
    raise ScenarioError(f"unknown event {ev!r}")


def _event_from_dict(d: Dict[str, Any]) -> Event:
    kind = d.get("type")
    if kind == "arrival":
        return Arrival(float(d["t"]), _spec_from_dict(d["spec"]))
    if kind == "departure":
        return Departure(float(d["t"]), d["name"])
    if kind == "node_failure":
        return NodeFailure(float(d["t"]), int(d["node"]))
    if kind == "link_flap":
        return LinkFlap(float(d["t"]), d["link"], float(d["down_s"]))
    if kind == "link_degrade":
        dur = d.get("duration_s")
        return LinkDegrade(float(d["t"]), d["link"], float(d["factor"]),
                           None if dur is None else float(dur))
    raise ScenarioError(
        f"unknown event type {kind!r}; one of ('arrival', 'departure', "
        f"'node_failure', 'link_flap', 'link_degrade')")


# ---------------------------------------------------------------------------
# the scenario itself
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One declarative experiment: topology + tenant population + event
    timeline + policy block. Validates eagerly (:class:`ScenarioError`),
    serializes round-trip to/from JSON dicts, and runs through the single
    :meth:`run` front door.

    Exactly one of ``jobs`` (static population, lockstep
    :class:`~repro_torch.fabric.engine.FabricEngine` for ``iters`` steps) and
    ``events`` (virtual-clock :class:`~repro_torch.fabric.events.
    LifecycleEngine` timeline up to ``horizon`` seconds) must be given.
    """
    name: str = "scenario"
    topology: TopologySpec = dataclasses.field(default_factory=TopologySpec)
    jobs: Optional[Tuple[JobSpec, ...]] = None
    events: Optional[Tuple[Event, ...]] = None
    policies: Policies = dataclasses.field(default_factory=Policies)
    congestion: Optional[CongestionConfig] = None
    heartbeat: Optional[HeartbeatConfig] = None
    base_seed: int = 0
    iters: int = 130
    warmup: int = 20
    horizon: float = 20.0

    def __post_init__(self):
        if self.jobs is not None:
            object.__setattr__(self, "jobs", tuple(self.jobs))
        if self.events is not None:
            object.__setattr__(self, "events", tuple(self.events))
        self.validate()

    # -- eager validation --------------------------------------------------
    def validate(self) -> None:
        self.topology.validate()
        self.policies.validate()
        try:
            self.policies.build_scheduler()
        except TypeError as e:
            raise ScenarioError(f"scheduler {self.policies.scheduler!r} "
                                f"rejected its options: {e}") from None
        static = self.jobs is not None
        timed = self.events is not None
        if static == timed:
            raise ScenarioError(
                "exactly one of jobs= (static population) and events= "
                "(timeline) must be given")
        from repro_torch.fabric.backend import (BATCHED_SCENARIO_BACKENDS,
                                                BATCHED_SCENARIO_FAIRNESS)
        if self.policies.backend in BATCHED_SCENARIO_BACKENDS:
            # eager: the batched runner's scope is known at declaration
            # (torch and cuda share the batched runner and its envelope)
            bk = self.policies.backend
            if timed:
                raise ScenarioError(
                    f"backend={bk!r} runs static-jobs scenarios only; "
                    f"event timelines need backend='reference'")
            if self.policies.fairness not in BATCHED_SCENARIO_FAIRNESS:
                raise ScenarioError(
                    f"backend={bk!r} supports fairness "
                    f"{BATCHED_SCENARIO_FAIRNESS}, got "
                    f"{self.policies.fairness!r}")
            if ROUTING.get(self.policies.routing).adaptive:
                raise ScenarioError(
                    f"backend={bk!r} encodes static routes only; adaptive "
                    f"routing {self.policies.routing!r} re-splits bytes "
                    f"per iteration and needs backend='reference'")
        if static:
            if not self.jobs:
                raise ScenarioError("jobs= must name at least one tenant")
            misdeclared = self.policies.lifecycle_only_settings()
            if misdeclared:
                raise ScenarioError(
                    f"{', '.join(misdeclared)} only applies to event "
                    f"scenarios (static populations never queue, fail, "
                    f"or replan)")
            if self.heartbeat is not None:
                raise ScenarioError(
                    "heartbeat= only applies to event scenarios (static "
                    "populations have no failure detection)")
            if self.iters < 1:
                raise ScenarioError(f"iters must be >= 1, got {self.iters}")
            if not 0 <= self.warmup < self.iters:
                raise ScenarioError(
                    f"warmup must be in [0, iters), got {self.warmup}")
            self._validate_specs(list(self.jobs), static=True)
        else:
            if not self.events:
                raise ScenarioError("events= must hold at least one event")
            if not self.horizon > 0.0:
                raise ScenarioError(
                    f"horizon must be positive, got {self.horizon!r}")
            specs = []
            link_events = []
            for ev in self.events:
                if not isinstance(ev, (Arrival, Departure, NodeFailure,
                                       LinkFlap, LinkDegrade)):
                    raise ScenarioError(f"unknown event {ev!r}")
                if ev.t < 0.0:
                    raise ScenarioError(
                        f"event times must be >= 0, got {ev!r}")
                if isinstance(ev, Arrival):
                    specs.append(ev.spec)
                elif isinstance(ev, NodeFailure) \
                        and not 0 <= ev.node < self.topology.n_ranks:
                    raise ScenarioError(
                        f"failure of node {ev.node} outside the "
                        f"{self.topology.n_ranks}-rank topology")
                elif isinstance(ev, LinkFlap):
                    if not ev.down_s > 0.0:
                        raise ScenarioError(
                            f"LinkFlap down_s must be positive, got {ev!r}")
                    link_events.append(ev)
                elif isinstance(ev, LinkDegrade):
                    if not 0.0 < ev.factor <= 1.0:
                        raise ScenarioError(
                            f"LinkDegrade factor must be in (0, 1], got "
                            f"{ev!r}")
                    if ev.duration_s is not None and not ev.duration_s > 0.0:
                        raise ScenarioError(
                            f"LinkDegrade duration_s must be positive (or "
                            f"None for permanent), got {ev!r}")
                    link_events.append(ev)
            if link_events:
                # topology build is cheap for sparse kinds (links are
                # lazy) and only paid when link events are declared
                topo = self.topology.build()
                for ev in link_events:
                    if not topo.has_link(ev.link):
                        raise ScenarioError(
                            f"event names unknown link {ev.link!r} on "
                            f"topology {topo.name!r}")
            if not specs:
                raise ScenarioError(
                    "events= must include at least one Arrival")
            self._validate_specs(specs, static=False)

    def _validate_specs(self, specs: List, static: bool) -> None:
        cap = self.topology.n_ranks
        names: set = set()
        pinned: set = set()
        total = 0
        for spec in specs:
            if not isinstance(spec, (JobSpec, InferenceSpec)):
                raise ScenarioError(f"unknown tenant spec {spec!r}")
            if spec.name in names:
                raise ScenarioError(
                    f"duplicate tenant name {spec.name!r}")
            names.add(spec.name)
            if spec.n_ranks < 1:
                raise ScenarioError(
                    f"tenant {spec.name!r}: n_ranks must be >= 1, got "
                    f"{spec.n_ranks}")
            # capacity is consumed in total nodes: n_ranks per replica
            need = spec.total_ranks
            if need > cap:
                raise ScenarioError(
                    f"tenant {spec.name!r} wants {need} ranks on "
                    f"a {cap}-rank topology")
            total += need
            if spec.algo not in ALGOS:
                raise ScenarioError(
                    f"tenant {spec.name!r}: unknown algo {spec.algo!r}; "
                    f"one of {ALGOS}")
            if isinstance(spec, InferenceSpec) \
                    and spec.router not in ROUTERS:
                raise ScenarioError(
                    f"tenant {spec.name!r}: unknown router "
                    f"{spec.router!r}; one of {ROUTERS.names()}")
            if spec.nodes is not None:
                bad = [nd for nd in spec.nodes if not 0 <= nd < cap]
                if bad:
                    raise ScenarioError(
                        f"tenant {spec.name!r}: pinned nodes {bad} outside "
                        f"the {cap}-rank topology")
                if len(set(spec.nodes)) != need:
                    raise ScenarioError(
                        f"tenant {spec.name!r}: needs {need} "
                        f"distinct pinned nodes, got {list(spec.nodes)}")
                if static:
                    overlap = pinned.intersection(spec.nodes)
                    if overlap:
                        raise ScenarioError(
                            f"tenant {spec.name!r}: pinned nodes "
                            f"{sorted(overlap)} already pinned by a "
                            f"co-tenant")
                    pinned.update(spec.nodes)
            elif spec.placement not in PLACEMENTS:
                raise ScenarioError(
                    f"tenant {spec.name!r}: unknown placement policy "
                    f"{spec.placement!r}; one of {PLACEMENTS.names()}")
        if static and total > cap:
            raise ScenarioError(
                f"jobs oversubscribe the topology: {total} ranks wanted, "
                f"{cap} available")

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "topology": dataclasses.asdict(self.topology),
            "jobs": [_spec_to_dict(s) for s in self.jobs]
            if self.jobs is not None else None,
            "events": [_event_to_dict(ev) for ev in self.events]
            if self.events is not None else None,
            "policies": dataclasses.asdict(self.policies),
            "congestion": dataclasses.asdict(self.congestion)
            if self.congestion is not None else None,
            "heartbeat": dataclasses.asdict(self.heartbeat)
            if self.heartbeat is not None else None,
            "base_seed": self.base_seed,
            "iters": self.iters,
            "warmup": self.warmup,
            "horizon": self.horizon,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Scenario":
        d = dict(d)
        jobs = d.get("jobs")
        events = d.get("events")
        try:
            return cls(
                name=d.get("name", "scenario"),
                topology=TopologySpec(**d.get("topology", {}) or {}),
                jobs=tuple(_spec_from_dict(s) for s in jobs)
                if jobs is not None else None,
                events=tuple(_event_from_dict(ev) for ev in events)
                if events is not None else None,
                policies=Policies(**d.get("policies", {}) or {}),
                congestion=_opt(CongestionConfig, d.get("congestion")),
                heartbeat=_opt(HeartbeatConfig, d.get("heartbeat")),
                base_seed=int(d.get("base_seed", 0)),
                iters=int(d.get("iters", 130)),
                warmup=int(d.get("warmup", 20)),
                horizon=float(d.get("horizon", 20.0)),
            )
        except TypeError as e:
            raise ScenarioError(f"malformed scenario dict: {e}") from None

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "Scenario":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_trace(cls, path_or_records, topology=None) -> "Scenario":
        """Fit a replayable scenario to a PRISM-style trace (a
        :class:`repro_torch.fabric.trace.Trace`, a file path, a dict tree,
        or a bare record list with an explicit ``topology=``). See
        :func:`repro_torch.fabric.trace.fit_trace` for the fitting
        contract; malformed traces raise
        :class:`repro_torch.fabric.trace.TraceError` with the offending
        record index."""
        from repro_torch.fabric import trace as _trace
        return _trace.scenario_from_trace(path_or_records,
                                          topology=topology)

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)

    # -- the front door ----------------------------------------------------
    def run(self, topo: Optional[Topology] = None,
            backend: Optional[str] = None, device=None,
            dtype=None) -> "Result":
        """Run the scenario on an execution backend and wrap the outcome.

        ``topo`` overrides the built topology (escape hatch for callers
        holding a hand-constructed :class:`Topology`; such scenarios
        still validate against their declared ``topology`` spec).
        ``backend`` (a :class:`repro_torch.fabric.backend.KernelType`
        name) overrides ``policies.backend`` for this call. The
        declared default is ``"cuda"``: a bare ``run()`` runs on the card
        and raises ``RuntimeError`` without one; ``"reference"``, the
        sequential Python engine on the host, is asked for by name.

        ``device`` and ``dtype`` apply to the batched backends (``torch``
        and ``cuda``): ``device=None`` is the card and raises
        ``RuntimeError`` without one, ``device="cpu"`` asks for the CPU;
        ``dtype=None`` is ``torch.float32``, ``torch.float64`` by
        argument. The ``reference`` backend ignores both.
        """
        from repro_torch.fabric.backend import KernelType, get_kernel
        bk = KernelType.parse(backend,
                              KernelType.parse(self.policies.backend))
        return get_kernel("scenario", bk)(self, topo, device=device,
                                          dtype=dtype)

    def _run_reference(self, topo: Optional[Topology] = None) -> "Result":
        """The sequential engine loop — the ``reference`` backend's
        registered ``scenario`` kernel (and the executable spec every
        other backend is measured against)."""
        topo = topo if topo is not None else self.topology.build()
        with _deprecation.scenario_scope():
            if self.jobs is not None:
                engine = FabricEngine(
                    topo, list(self.jobs), congestion=self.congestion,
                    base_seed=self.base_seed,
                    fairness=self.policies.fairness,
                    routing=self.policies.routing)
                raw: Union[EngineResult, LifecycleResult] = engine.run(
                    self.iters, warmup=self.warmup)
            else:
                engine = LifecycleEngine(
                    topo, list(self.events), congestion=self.congestion,
                    heartbeat=self.heartbeat,
                    fairness=self.policies.fairness,
                    scheduler=self.policies.build_scheduler(),
                    replan_delay_s=self.policies.replan_delay_s,
                    restore_cost=self.policies.restore_cost(),
                    base_seed=self.base_seed,
                    routing=self.policies.routing)
                raw = engine.run(self.horizon)
        return Result(self, raw, topo)


# ---------------------------------------------------------------------------
# the unified result
# ---------------------------------------------------------------------------


def _hex_series(xs: Sequence[float]) -> List[str]:
    return [float(x).hex() for x in xs]


class Result:
    """Unified outcome of ``Scenario.run()``: per-tenant step/latency
    series, SLO attainment, locality/contention diagnostics, and the
    bit-exact determinism fingerprint the golden suite pins — one shape
    over both backends (``kind`` is ``"fabric"`` or ``"lifecycle"``)."""

    def __init__(self, scenario: Scenario,
                 raw: Union[EngineResult, LifecycleResult],
                 topo: Topology):
        self.scenario = scenario
        self.raw = raw
        self.topo = topo
        self.kind = "fabric" if isinstance(raw, EngineResult) \
            else "lifecycle"

    # -- tenant access -----------------------------------------------------
    def _tenants(self) -> List:
        return self.raw.jobs if self.kind == "fabric" \
            else self.raw.tenants

    def names(self) -> List[str]:
        return [t.name for t in self._tenants()]

    def tenant(self, name: str):
        for t in self._tenants():
            if t.name == name:
                return t
        raise KeyError(name)

    def series(self, name: str) -> List[float]:
        """The tenant's primary series: per-step times for training,
        per-request latencies for inference."""
        t = self.tenant(name)
        return t.latencies if getattr(t, "kind", "training") \
            == "inference" else t.step_times

    @property
    def link_bytes(self) -> Dict[str, float]:
        return self.raw.link_bytes

    @property
    def log(self) -> List[Tuple[float, str, str]]:
        return self.raw.log if self.kind == "lifecycle" else []

    # -- SLO / diagnostics -------------------------------------------------
    def slo_attainment(self) -> Dict[str, float]:
        """Per-inference-tenant fraction of requests inside their SLO
        (empty for fabric-backend scenarios: no inference tenants)."""
        if self.kind == "fabric":
            return {}
        return {t.name: t.slo_attainment for t in self.raw.inference}

    def diagnostics(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant locality and contention summary: node set, leaf/pod
        span, selected algo, the fraction of the tenant's traffic that
        crossed shared (oversubscribed) links, and the headline
        throughput/latency stats."""
        out: Dict[str, Dict[str, Any]] = {}
        for t in self._tenants():
            link_bytes = t.link_bytes
            total = sum(link_bytes.values())
            shared = sum(b for ln, b in link_bytes.items()
                         if self.topo.link(ln).shared)
            d: Dict[str, Any] = {
                "kind": getattr(t, "kind", "training") or "training",
                "nodes": list(t.nodes),
                "spanning_groups": spanning_groups(self.topo, t.nodes)
                if t.nodes else 0,
                "algo": t.algo,
                "shared_bytes_frac": shared / total if total > 0 else 0.0,
            }
            if d["kind"] == "inference":
                spans = t.replica_spans
                d.update(requests=t.requests_done,
                         mean_latency_s=t.mean_latency,
                         p99_latency_s=t.latency_quantile(0.99),
                         slo_attainment=t.slo_attainment,
                         batching=t.spec.batching,
                         replicas=len(spans),
                         max_replica_span=max(spans) if spans else 0)
            else:
                d.update(steps=len(t.step_times),
                         mean_step_s=t.mean_step, cv=t.cv,
                         throughput=t.throughput)
            out[t.name] = d
        return out

    # -- determinism fingerprint -------------------------------------------
    def fingerprint(self) -> Dict[str, Any]:
        """Bit-exact (float-hex) snapshot of every tenant series — the
        exact structure the golden fixtures under ``tests/golden/``
        record, so a fixture replays through ``Scenario.run()`` with a
        plain ``==``."""
        if self.kind == "fabric":
            return {
                "jobs": [{"name": jr.name, "nodes": list(jr.nodes),
                          "algo": jr.algo,
                          "series": _hex_series(jr.step_times)}
                         for jr in self.raw.jobs],
                "link_bytes": {ln: float(b).hex()
                               for ln, b in sorted(
                                   self.raw.link_bytes.items())}}
        snap: Dict[str, Any] = {
            "tenants": [],
            "log": [[float(t).hex(), kind] for t, kind, _ in self.raw.log]}
        for t in self.raw.tenants:
            entry: Dict[str, Any] = {
                "name": t.name, "kind": t.kind, "nodes": list(t.nodes),
                "generation": t.generation}
            if t.kind == "training":
                entry["series"] = _hex_series(t.step_times)
                entry["iters_done"] = t.iters_done
            else:
                entry["series"] = _hex_series(t.latencies)
                entry["requests_done"] = t.requests_done
            snap["tenants"].append(entry)
        return snap

    # -- attribution + advice ----------------------------------------------
    def attribute(self):
        """Bottleneck attribution (:func:`repro_torch.fabric.advisor.
        attribute`): decompose each tenant's overhead above its
        uncontended compute+comm floor into the paper's failure-mode
        buckets (synchronization / contention / locality) plus a signed
        residual that reconstructs the measured overhead bit-exactly.
        Needs a reference-backend result (the batched backends carry
        series only)."""
        from repro_torch.fabric import advisor as _advisor
        return _advisor.attribute(self)

    def advise(self, **kw):
        """Attribution-guided counterfactual recommendations
        (:func:`repro_torch.fabric.advisor.advise`): ranked
        :class:`~repro_torch.fabric.advisor.Recommendation` values along
        the axes the attribution implicates, executed as one batched
        sweep and reference-verified at the top."""
        from repro_torch.fabric import advisor as _advisor
        return _advisor.advise(self.scenario, self, **kw)

    def diagnose(self) -> str:
        """The attribution summary as a report string (``diagnostics()``
        stays the raw per-tenant metric dict)."""
        return self.attribute().summary()

    # -- trace export / validation ------------------------------------------
    def to_trace(self):
        """Export this run as a :class:`repro_torch.fabric.trace.Trace`
        (reference backend only — the export walks the engines' step
        instrumentation). The round trip
        ``Scenario.from_trace(result.to_trace())`` is the self-
        consistency anchor the trace tests pin."""
        from repro_torch.fabric import trace as _trace
        return _trace.result_to_trace(self)

    def validate(self, trace, topology=None):
        """Predicted-vs-observed error report against a trace:
        :class:`repro_torch.fabric.trace.TraceValidation` with per-tenant
        mean/p99 relative error and series correlation."""
        from repro_torch.fabric import trace as _trace
        return _trace.validate_result(self, trace, topology=topology)


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------


def _set_path(tree: Any, path: str, value: Any) -> None:
    keys = path.split(".")
    node = tree
    for k in keys[:-1]:
        node = node[int(k)] if k.lstrip("-").isdigit() else node[k]
    last = keys[-1]
    if last.lstrip("-").isdigit():
        node[int(last)] = value
    else:
        if last not in node:
            # overrides replace existing fields; silently *creating* a
            # key would make a typo'd axis a no-op sweep
            raise KeyError(last)
        node[last] = value


class ScenarioGrid:
    """Cartesian sweep over dotted-path overrides of a base scenario —
    the what-if harness the paper's diagnostic method calls for.

    ``axes`` maps dotted paths into the scenario's dict form to value
    lists; integer segments index into lists::

        grid = ScenarioGrid(base, {
            "policies.fairness": ["maxmin", "wfq", "strict_priority"],
            "events.1.spec.weight": [0.5, 1.0, 4.0],
            "base_seed": [0, 1, 2],
        })
        for params, result in grid.run():
            ...

    Every variant is rebuilt through ``Scenario.from_dict`` and therefore
    re-validated eagerly; invalid combinations fail before anything runs.
    """

    def __init__(self, base: Scenario, axes: Dict[str, Sequence[Any]]):
        if not axes:
            raise ScenarioError("axes must name at least one sweep path")
        self.base = base
        self.axes = {k: list(v) for k, v in axes.items()}
        for k, vals in self.axes.items():
            if not vals:
                raise ScenarioError(f"axis {k!r} has no values")
        # eager: every combination must build a valid scenario
        self._variants = list(self._build())

    def _build(self) -> Iterator[Tuple[Dict[str, Any], Scenario]]:
        keys = list(self.axes)
        for combo in itertools.product(*(self.axes[k] for k in keys)):
            params = dict(zip(keys, combo))
            d = self.base.to_dict()
            for path, value in params.items():
                try:
                    _set_path(d, path, value)
                except (KeyError, IndexError, TypeError):
                    raise ScenarioError(
                        f"axis path {path!r} does not resolve in "
                        f"scenario {self.base.name!r}") from None
            label = ",".join(f"{k.split('.')[-1]}={v}"
                             for k, v in params.items())
            d["name"] = f"{self.base.name}[{label}]"
            yield params, Scenario.from_dict(d)

    def __len__(self) -> int:
        return len(self._variants)

    def __iter__(self) -> Iterator[Tuple[Dict[str, Any], Scenario]]:
        return iter(self._variants)

    def scenarios(self) -> List[Scenario]:
        return [scn for _, scn in self._variants]

    def run(self, backend: Optional[str] = None, device=None, dtype=None,
            stats: Optional[dict] = None
            ) -> List[Tuple[Dict[str, Any], Result]]:
        """Run every variant; ``backend`` overrides each variant's
        ``policies.backend`` for this sweep. Variants resolving to a
        batched backend (``torch`` or ``cuda``) run as *one batched
        program per structural group*
        (:func:`repro_torch.fabric.backend.torch_engine.run_scenarios`,
        with the allocator/overlap kernels dispatched per backend)
        instead of sequential engine loops; results keep grid order
        either way. ``device`` and ``dtype`` are those of
        :meth:`Scenario.run`: with nothing given, every variant runs on
        the card (``policies.backend`` defaults to ``"cuda"``) in
        ``torch.float32``; only variants whose backend is ``"reference"``
        by name run the Python engine on the host. ``stats``, when given a dict, receives the
        batched runner's group count and its host-prep / device / wrap
        seconds (summed over the batched calls of this sweep).
        """
        from repro_torch.fabric.backend import KernelType
        resolved = [
            KernelType.parse(backend,
                             KernelType.parse(scn.policies.backend))
            for _, scn in self._variants]
        out: List[Optional[Tuple[Dict[str, Any], Result]]] = \
            [None] * len(self._variants)
        batched_kinds = (KernelType.TORCH, KernelType.CUDA)
        batched_set = {i for i, bk in enumerate(resolved)
                       if bk in batched_kinds}
        for i, (params, scn) in enumerate(self._variants):
            if i not in batched_set:
                out[i] = (params, scn.run(backend=resolved[i].value))
        if batched_set:
            from repro_torch.fabric.backend.torch_engine import run_scenarios
            for kind in batched_kinds:
                idxs = [i for i in sorted(batched_set)
                        if resolved[i] is kind]
                if not idxs:
                    continue
                call: dict = {}
                results = run_scenarios(
                    [(self._variants[i][1], None) for i in idxs],
                    kernels=kind, device=device, dtype=dtype, stats=call)
                if stats is not None:
                    for k, v in call.items():
                        stats[k] = stats.get(k, 0) + v
                for i, res in zip(idxs, results):
                    out[i] = (self._variants[i][0], res)
        return out

    # columns to_csv emits per (variant, tenant) row, pulled from
    # Result.diagnostics(); missing keys (e.g. inference metrics on a
    # training tenant) are left empty
    CSV_METRICS = ("kind", "algo", "spanning_groups", "shared_bytes_frac",
                   "steps", "mean_step_s", "cv", "throughput", "requests",
                   "mean_latency_s", "p99_latency_s", "slo_attainment",
                   "batching", "replicas", "max_replica_span")

    def to_csv(self, path: Optional[str] = None,
               results: Optional[List[Tuple[Dict[str, Any], Result]]] = None
               ) -> str:
        """Run the grid (or reuse ``results`` from a prior :meth:`run`)
        and flatten it into CSV: one row per (variant, tenant), the sweep
        axes as leading columns — the benchmark/CI artifact format, so a
        sweep's whole outcome diffs as a table instead of a transcript.
        Writes to ``path`` when given; always returns the CSV text."""
        import csv as _csv
        import io
        if results is None:
            results = self.run()
        axes = list(self.axes)
        buf = io.StringIO()
        w = _csv.writer(buf, lineterminator="\n")
        w.writerow(axes + ["scenario", "tenant"] + list(self.CSV_METRICS))
        for params, result in results:
            diags = result.diagnostics()
            for tenant, d in diags.items():
                w.writerow([params[a] for a in axes]
                           + [result.scenario.name, tenant]
                           + [d.get(m, "") for m in self.CSV_METRICS])
        text = buf.getvalue()
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text
