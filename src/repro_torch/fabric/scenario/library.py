"""Named scenario library: the paper's failure modes as ready-made,
fast-horizon :class:`~repro_torch.fabric.scenario.Scenario` values.

Each entry is a zero-argument function registered under a stable name, so
CI can smoke-run every scenario (``python -m benchmarks.run --only
scenarios`` / ``make scenarios``) and studies can start from a named
baseline and perturb it with :class:`~repro_torch.fabric.scenario.
ScenarioGrid`::

    from repro_torch.fabric.scenario import ScenarioGrid
    from repro_torch.fabric.scenario import library

    base = library.build("noisy_neighbor_inference")
    grid = ScenarioGrid(base, {"events.1.spec.weight": [0.5, 1.0, 4.0]})

The four core entries map onto the paper's taxonomy:

  * ``synchronization_amplification`` — §3.1: one BSP job whose straggler
    skew is amplified by the barrier into fabric-level burst penalties;
  * ``topology_contention`` — §3.2: two pinned tenants sharing one
    oversubscribed up-link; the primary slows from traffic it doesn't own;
  * ``locality_variance`` — §3.3: the same job scattered across leaves
    pays the shared tier on every hop while a co-tenant roams;
  * ``noisy_neighbor_inference`` — §3.2 with latency-sensitive traffic: a
    weighted (WFQ) inference fleet vs a heavy trainer on shared up-links.

Two more exercise the scheduling/recovery machinery end to end:
``priority_preemption`` (preempt scheduler with an anti-thrash budget and
checkpoint-aware resume) and ``failure_recovery`` (heartbeat detection,
elastic shrink, re-place). Two serve the continuous-batching fleet model:
``continuous_batching_relief`` (an arrival rate single-stream serving
cannot keep up with, absorbed by batch-joins over a JSQ-routed two-replica
fleet) and ``slo_placement`` (the noisy-neighbor mix with the fleet placed
by ``slo_aware`` and routed by ``jsq`` — sweep the placement/router back
to ``compact``/``round_robin`` to reproduce the SLO-attainment gap).

Two exercise the giga-scale fabric path (multi-pod topologies and the
routing registry): ``cross_pod_interference`` (two tenants straddling a
pod boundary collide on one statically-hashed inter-pod link) and
``routing_rescue`` (the same population under ``adaptive_spray``, which
re-splits inter-pod bytes across the parallel global links and strictly
improves the contended p99).

All entries run at test scale (a few seconds each) — they are smoke
surfaces and study seeds, not paper-horizon reproductions.
"""
from __future__ import annotations

from typing import Callable, List

from repro_torch.fabric.congestion import CongestionConfig
from repro_torch.fabric.engine import JobSpec
from repro_torch.fabric.events import Arrival, NodeFailure
from repro_torch.fabric.policies import PolicyRegistry
from repro_torch.fabric.scenario import Policies, Scenario, TopologySpec
from repro_torch.fabric.stragglers import StragglerConfig
from repro_torch.fabric.workloads import InferenceSpec

LIBRARY = PolicyRegistry("library scenario")

_FABRIC64 = TopologySpec(kind="fat_tree", n_nodes=64, nodes_per_leaf=8)


@LIBRARY.register("synchronization_amplification")
def synchronization_amplification() -> Scenario:
    """One 32-rank BSP job with a heavy straggler mix on an oversubscribed
    fabric: per-rank compute jitter is amplified by the barrier into
    arrival-burst penalties on the shared tier (step CV far above the
    compute CV — the diagnostics attribute it to synchronization)."""
    return Scenario(
        name="synchronization_amplification",
        topology=_FABRIC64,
        jobs=(JobSpec("bsp", 32, placement="compact",
                      stragglers=StragglerConfig(
                          jitter_sigma=0.03, locality_spread=0.12,
                          spike_prob=0.004, spike_mult=1.6,
                          heavy_frac=0.2, heavy_mult=2.0)),),
        congestion=CongestionConfig(u_mean=0.15, u_sigma=0.08,
                                    k_burst=0.8, k_kick=0.1),
        iters=150, warmup=20)


@LIBRARY.register("topology_contention")
def topology_contention() -> Scenario:
    """Two pinned 12-rank tenants whose node sets share the leaf-1
    up-link: the primary's series degrades purely from the co-tenant's
    6 GB gradient exchanges — traffic the primary does not own."""
    return Scenario(
        name="topology_contention",
        topology=_FABRIC64,
        jobs=(JobSpec("primary", 12, nodes=tuple(range(12))),
              JobSpec("cotenant", 12, nodes=tuple(range(12, 24)),
                      grad_bytes=6e9)),
        iters=150, warmup=20)


@LIBRARY.register("locality_variance")
def locality_variance() -> Scenario:
    """The same 8-rank job under the worst-locality placement (scattered:
    every ring hop crosses the shared tier) next to a scattered 16-rank
    co-tenant — sweep ``jobs.0.placement`` over the placement registry to
    reproduce the §3.3 run-to-run variance."""
    return Scenario(
        name="locality_variance",
        topology=_FABRIC64,
        jobs=(JobSpec("job", 8, placement="scattered"),
              JobSpec("cotenant", 16, placement="scattered",
                      grad_bytes=2e9)),
        iters=150, warmup=20)


@LIBRARY.register("noisy_neighbor_inference")
def noisy_neighbor_inference() -> Scenario:
    """A heavy trainer and a weighted latency-sensitive inference fleet
    (open-loop Poisson, p99 SLO) on the same up-links under WFQ — the
    weight buys the fleet its tail latency back."""
    return Scenario(
        name="noisy_neighbor_inference",
        topology=_FABRIC64,
        events=(
            Arrival(0.0, JobSpec("train", 12, nodes=tuple(range(12)),
                                 grad_bytes=4e9)),
            Arrival(0.0, InferenceSpec("serve", 8,
                                       nodes=tuple(range(12, 20)),
                                       rate_rps=6.0, weight=4.0,
                                       slo_p99_s=0.5)),
        ),
        # event timelines need the Python engine: named, not the default
        policies=Policies(fairness="wfq", backend="reference"),
        horizon=12.0)


@LIBRARY.register("priority_preemption")
def priority_preemption() -> Scenario:
    """A low-priority incumbent fills the fabric; a high-priority arrival
    preempts it under the anti-thrash budget, and the victim resumes from
    its per-step checkpoint (``ckpt_every=1``) with its compute stream
    intact, finishing exactly its remaining iteration budget."""
    return Scenario(
        name="priority_preemption",
        topology=_FABRIC64,
        events=(
            Arrival(0.0, JobSpec("low", 56, placement="compact",
                                 priority=0, iters=60, ckpt_every=1)),
            Arrival(2.0, JobSpec("high", 24, placement="compact",
                                 priority=5, iters=20)),
            Arrival(3.0, JobSpec("fill", 6, placement="compact",
                                 priority=1)),
        ),
        # event timelines need the Python engine: named, not the default
        policies=Policies(scheduler="preempt", min_runtime_s=2.0,
                          backend="reference"),
        horizon=16.0)


@LIBRARY.register("failure_recovery")
def failure_recovery() -> Scenario:
    """A node dies mid-run: heartbeat timeout on the virtual clock,
    elastic shrink, re-place, schedule re-selection — with the replan
    stall derived from the checkpoint-restore cost model."""
    return Scenario(
        name="failure_recovery",
        topology=_FABRIC64,
        events=(
            Arrival(0.0, JobSpec("job", 12, placement="compact",
                                 algo="auto", grad_bytes=2e9)),
            NodeFailure(6.0, 3),
        ),
        # event timelines need the Python engine: named, not the default
        policies=Policies(replan_delay_s=None, backend="reference"),
        horizon=20.0)


@LIBRARY.register("continuous_batching_relief")
def continuous_batching_relief() -> Scenario:
    """An arrival rate far above the single-stream service rate: with
    ``batching="none"`` the open-loop queue grows without bound and p99
    explodes; continuous batching (``max_batch=8`` over a JSQ-routed
    two-replica fleet) amortizes the per-token collectives over the batch
    and absorbs the same traffic inside the SLO. Sweep
    ``events.1.spec.max_batch`` (or flip ``batching``) to reproduce the
    p99-vs-throughput tradeoff curve (``benchmarks.run --only
    batching``)."""
    return Scenario(
        name="continuous_batching_relief",
        topology=_FABRIC64,
        events=(
            Arrival(0.0, JobSpec("train", 16, placement="compact",
                                 grad_bytes=2e9)),
            Arrival(0.0, InferenceSpec("serve", 4, replicas=2,
                                       batching="continuous", max_batch=8,
                                       router="jsq", rate_rps=40.0,
                                       decode_tokens=8, slo_p99_s=0.6,
                                       placement="slo_aware")),
        ),
        # event timelines need the Python engine: named, not the default
        policies=Policies(backend="reference"),
        horizon=10.0)


@LIBRARY.register("slo_placement")
def slo_placement() -> Scenario:
    """The noisy-neighbor mix with SLO-aware placement: a heavy trainer
    packs compactly (filling leaf 0 and half of leaf 1), and the
    latency-bound fleet's replicas are each best-fit into a whole leaf
    (span 1, away from the trainer's loaded up-link) and JSQ-routed.
    Sweeping ``events.1.spec.placement`` -> ``compact`` and
    ``events.1.spec.router`` -> ``round_robin`` straddles one replica
    across the trainer's leaf boundary and load-blinds the router — the
    measurable ``slo_attainment`` drop the batching tests pin."""
    return Scenario(
        name="slo_placement",
        topology=_FABRIC64,
        events=(
            Arrival(0.0, JobSpec("train", 12, placement="compact",
                                 grad_bytes=6e9)),
            Arrival(1.0, InferenceSpec("serve", 6, replicas=2,
                                       batching="continuous", max_batch=4,
                                       router="jsq", rate_rps=20.0,
                                       decode_tokens=8, slo_p99_s=0.15,
                                       placement="slo_aware")),
        ),
        # event timelines need the Python engine: named, not the default
        policies=Policies(backend="reference"),
        horizon=12.0)


_MULTIPOD64 = TopologySpec(kind="multi_pod", n_pods=2, ranks_per_pod=32,
                           nodes_per_leaf=8, inter_pod_links=2)


@LIBRARY.register("cross_pod_interference")
def cross_pod_interference() -> Scenario:
    """Two pinned 16-rank tenants each straddling the pod boundary of a
    2-pod fabric with two parallel inter-pod links: static ECMP hashes
    both tenants' cross-pod flows onto the *same* member (the pod-pair
    salt is placement-independent), so the primary pays for the
    interferer's 4 GB exchanges on one global link while the second link
    idles — the giga-scale variant of ``topology_contention``."""
    return Scenario(
        name="cross_pod_interference",
        topology=_MULTIPOD64,
        jobs=(JobSpec("primary", 16, nodes=tuple(range(24, 40))),
              JobSpec("interferer", 16,
                      nodes=tuple(range(16, 24)) + tuple(range(40, 48)),
                      grad_bytes=4e9)),
        iters=150, warmup=20)


@LIBRARY.register("routing_rescue")
def routing_rescue() -> Scenario:
    """The ``cross_pod_interference`` population rescued by adaptive
    routing: ``adaptive_spray`` re-splits each tenant's inter-pod bytes
    across both parallel global links in proportion to observed capacity,
    recovering the idle member that static ECMP strands. Sweep
    ``policies.routing`` back to ``ecmp_static`` to reproduce the strict
    p99 regression the routing tests pin."""
    return Scenario(
        name="routing_rescue",
        topology=_MULTIPOD64,
        jobs=(JobSpec("primary", 16, nodes=tuple(range(24, 40))),
              JobSpec("interferer", 16,
                      nodes=tuple(range(16, 24)) + tuple(range(40, 48)),
                      grad_bytes=4e9)),
        # adaptive routing needs the Python engine: named, not the default
        policies=Policies(routing="adaptive_spray", backend="reference"),
        iters=150, warmup=20)


def names() -> List[str]:
    return list(LIBRARY.names())


def build(name: str) -> Scenario:
    """Build the named scenario (fresh value per call)."""
    make: Callable[[], Scenario] = LIBRARY.get(name)
    return make()
