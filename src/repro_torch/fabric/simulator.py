"""Bulk-synchronous training-step simulator (paper §3.1 system model).

Each iteration, per rank: release -> compute (straggler model) -> arrive at
the gradient collective; the collective starts when traffic meets the fabric
(cost from the link-structural model under the current congestion state,
derated by the arrival burst); BSP semantics make every rank finish at
``max(arrival) + T_collective``. The coordination layer (paper §4/§5) hooks
in per rank as a local :class:`PacingController`: it observes its own
barrier wait, and its bounded delay shifts the rank's next release.

:func:`simulate` is a thin single-job wrapper over the shared-fabric engine
(:mod:`repro_torch.fabric.engine`), which compiles the collective schedule once
and steps the job without re-walking the topology per iteration — the
step-time series is bit-identical to the seed implementation (kept as the
executable spec in :mod:`repro_torch.fabric._reference`) at a fraction of the
wall-clock. Multi-tenant scenarios (co-tenant contention, placement
variance) use the engine directly.

This is the engine behind the paper-reproduction benchmarks (Table 1,
Figures 1/5) and it emits standard :class:`IterationRecord` streams, so the
taxonomy diagnostics (:mod:`repro_torch.core.diagnostics`) run unchanged on
simulated and real traces.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional

from repro_torch.configs.base import PacingConfig
from repro_torch.core.instrumentation import IterationRecord
from repro_torch.fabric.congestion import CongestionConfig
from repro_torch.fabric.stragglers import StragglerConfig
from repro_torch.fabric.topology import Topology, fat_tree


@dataclasses.dataclass(frozen=True)
class SimConfig:
    n_nodes: int = 16
    samples_per_node: int = 64
    grad_bytes: float = 1.1e9         # DP all-reduce payload per step
    algo: str = "ring"
    nodes_per_leaf: int = 8
    oversubscription: float = 2.0
    leaf_bw: float = 50.0             # GB/s
    iters: int = 400
    warmup: int = 50
    seed: int = 0
    stragglers: StragglerConfig = dataclasses.field(
        default_factory=StragglerConfig)
    congestion: CongestionConfig = dataclasses.field(
        default_factory=CongestionConfig)
    pacing: Optional[PacingConfig] = None      # None => baseline run

    @staticmethod
    def paper(n_nodes: int, *, coordination: bool,
              seed: int = 0) -> "SimConfig":
        """Calibrated configuration reproducing the paper's Table 1.

        Free parameters (straggler mix, congestion coupling) were fit by
        coordinate search against the paper's 20 published numbers (5 node
        counts x {throughput, CV} x {baseline, coordination}); see
        EXPERIMENTS.md §Table-1 for the resulting comparison.
        """
        pacing = PacingConfig(
            enabled=True, window=6, cv_threshold=0.05, skew_threshold=0.04,
            max_delay_frac=0.6, gain=0.85, decay=0.8, warmup_iters=8,
        ) if coordination else None
        return SimConfig(
            n_nodes=n_nodes, pacing=pacing, seed=seed,
            stragglers=StragglerConfig(
                jitter_sigma=0.02, locality_spread=0.10,
                spike_prob=0.0006, spike_mult=1.3, spike_exit_prob=0.06,
                heavy_frac=0.15, heavy_mult=1.8),
            congestion=CongestionConfig(
                u_mean=0.10, u_sigma=0.10, u_rho=0.9,
                k_burst=0.4, ecmp_k=0.18, k_kick=0.10),
        )

    @staticmethod
    def fast(n_nodes: int, *, coordination: bool = False,
             seed: int = 0) -> "SimConfig":
        """Short-horizon preset for tests: the paper-calibrated stochastic
        models at a third of the iterations. Statistical signatures (scaling
        decay, CV growth, coordination benefit) survive the truncation;
        absolute Table-1 numbers need the full :meth:`paper` horizon."""
        cfg = SimConfig.paper(n_nodes, coordination=coordination, seed=seed)
        return dataclasses.replace(cfg, iters=130, warmup=20)


class SimResult:
    """Single-job simulation outcome.

    The per-rank record matrix is materialized lazily when constructed from
    an engine trace: the hot loop stores one compact tuple per iteration and
    ``.records`` expands them only when diagnostics/tests actually look.
    """

    def __init__(self, cfg: SimConfig,
                 records: Optional[List[List[IterationRecord]]] = None,
                 step_times: Optional[List[float]] = None,
                 link_bytes: Optional[Dict[str, float]] = None,
                 _job=None):
        self.cfg = cfg
        self._records = records
        self._job = job = _job
        self.step_times = step_times if step_times is not None \
            else (job.step_times if job is not None else [])
        self.link_bytes = link_bytes if link_bytes is not None \
            else (job.link_bytes if job is not None else {})

    @property
    def records(self) -> List[List[IterationRecord]]:
        if self._records is None:
            self._records = self._job.records
        return self._records

    @property
    def mean_step(self) -> float:
        return statistics.fmean(self.step_times)

    @property
    def cv(self) -> float:
        m = self.mean_step
        return (statistics.pstdev(self.step_times) / m) if m > 0 else 0.0

    @property
    def throughput(self) -> float:
        """Samples/sec across the cluster."""
        return (self.cfg.n_nodes * self.cfg.samples_per_node
                / self.mean_step)

    def per_rank_records(self) -> List[List[IterationRecord]]:
        return self.records


def build_topology(cfg: SimConfig) -> Topology:
    return fat_tree(
        cfg.n_nodes,
        nodes_per_leaf=cfg.nodes_per_leaf,
        oversubscription=cfg.oversubscription,
        leaf_bw=cfg.leaf_bw,
        seed=cfg.seed,
    )


def job_spec_from(cfg: SimConfig, name: str = "job0"):
    """The engine job equivalent to a legacy single-job simulation."""
    from repro_torch.fabric.engine import JobSpec
    spanning = max(1, (cfg.n_nodes + cfg.nodes_per_leaf - 1)
                   // cfg.nodes_per_leaf)
    return JobSpec(
        name=name, n_ranks=cfg.n_nodes, grad_bytes=cfg.grad_bytes,
        algo=cfg.algo, samples_per_rank=cfg.samples_per_node,
        placement="compact", stragglers=cfg.stragglers, pacing=cfg.pacing,
        spanning_override=spanning)


def scenario_from(cfg: SimConfig, name: str = "sim"):
    """The declarative :class:`~repro_torch.fabric.scenario.Scenario` equivalent
    of a legacy single-job simulation: same topology spec, same job, same
    seeds — ``scenario_from(cfg).run()`` reproduces ``simulate(cfg)``
    step-for-step, bit-identically."""
    from repro_torch.fabric.scenario import Scenario, TopologySpec
    return Scenario(
        name=name,
        topology=TopologySpec(
            kind="fat_tree", n_nodes=cfg.n_nodes,
            nodes_per_leaf=cfg.nodes_per_leaf,
            oversubscription=cfg.oversubscription, leaf_bw=cfg.leaf_bw,
            seed=cfg.seed),
        jobs=(job_spec_from(cfg),),
        congestion=cfg.congestion,
        base_seed=cfg.seed,
        iters=cfg.iters, warmup=cfg.warmup)


def _run_quiet(cfg: SimConfig, topo: Optional[Topology] = None
               ) -> SimResult:
    # the per-rank records are the Python engine's: named, not the default
    result = scenario_from(cfg).run(topo=topo, backend="reference")
    return SimResult(cfg=cfg, _job=result.raw.jobs[0])


def simulate(cfg: SimConfig, topo: Optional[Topology] = None) -> SimResult:
    """Legacy single-job entry point: a thin shim that builds the
    equivalent Scenario (:func:`scenario_from`) and runs it through the
    one front door; the step-time series is bit-identical to the seed
    loop (executable spec in :mod:`repro_torch.fabric._reference`)."""
    from repro_torch.fabric import _deprecation
    _deprecation.warn_legacy(
        "simulate(cfg)", "scenario_from(cfg).run() — or build the "
        "Scenario directly")
    return _run_quiet(cfg, topo)


def efficiency_curve(node_counts, *, coordination: bool, seed: int = 0
                     ) -> Dict[int, Dict[str, float]]:
    """Observed-vs-ideal scaling (paper Fig. 1 / Fig. 5)."""
    out = {}
    base = None
    for n in node_counts:
        res = _run_quiet(SimConfig.paper(n, coordination=coordination,
                                         seed=seed))
        thr = res.throughput
        if base is None:
            base = thr / n            # per-node throughput at smallest scale
        out[n] = {
            "throughput": thr,
            "ideal": base * n,
            "efficiency": thr / (base * n),
            "cv": res.cv,
        }
    return out
