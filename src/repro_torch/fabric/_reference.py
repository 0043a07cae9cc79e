"""Executable spec: the seed's per-call simulator loop, kept verbatim.

The shared-fabric engine (:mod:`repro_torch.fabric.engine`) replaces this loop
with compiled collective schedules and tightened stochastic-model kernels,
all of which are required to be *bit-identical* in arithmetic. This module
preserves the original implementation — per-call :func:`all_reduce` inside
the iteration loop, the original ``random.gauss``-based samplers, eager
:class:`IterationRecord` construction — so that

  * tests can assert ``simulate(cfg).step_times ==
    simulate_reference(cfg).step_times`` exactly (same RNG streams, same
    float operations), and
  * the engine-speedup benchmark measures against the true seed wall-clock
    rather than a partially optimized strawman.

Do not "fix" or optimize this module; it is the comparison point.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

from repro_torch.core.instrumentation import IterationRecord
from repro_torch.core.pacing import PacingController
from repro_torch.fabric import collectives
from repro_torch.fabric.congestion import CongestionModel
from repro_torch.fabric.stragglers import ComputeModel
from repro_torch.fabric.topology import Topology


class ReferenceComputeModel(ComputeModel):
    """Seed implementation of :meth:`ComputeModel.sample` (random.gauss)."""

    def sample(self) -> List[float]:
        cfg = self.cfg
        out = []
        for r in range(self.n):
            if self.spiking[r]:
                if self.rng.random() < cfg.spike_exit_prob:
                    self.spiking[r] = 0.0
            elif self.rng.random() < cfg.spike_prob:
                heavy = self.rng.random() < cfg.heavy_frac
                self.spiking[r] = cfg.heavy_mult if heavy else cfg.spike_mult
            jitter = math.exp(self.rng.gauss(0.0, cfg.jitter_sigma))
            t = cfg.base_compute_s * self.locality[r] * jitter
            if self.spiking[r]:
                t *= self.spiking[r]
            out.append(t)
        return out


class ReferenceCongestionModel(CongestionModel):
    """Seed implementation of :meth:`CongestionModel.advance`."""

    def advance(self) -> None:
        c = self.cfg
        for name in self.u:
            innov = self.rng.gauss(0.0, c.u_sigma)
            u = c.u_rho * self.u[name] + (1 - c.u_rho) * c.u_mean + \
                (1 - c.u_rho) ** 0.5 * innov
            self.u[name] = min(max(u, 0.0), c.u_max)


def simulate_reference(cfg, topo: Optional[Topology] = None):
    """The seed's :func:`repro_torch.fabric.simulator.simulate`, verbatim."""
    from repro_torch.fabric.simulator import SimResult, build_topology

    n = cfg.n_nodes
    topo = topo or build_topology(cfg)
    compute_model = ReferenceComputeModel(cfg.stragglers, n, seed=cfg.seed + 1)
    congestion = ReferenceCongestionModel(cfg.congestion, topo,
                                          seed=cfg.seed + 2)
    controllers = [PacingController(cfg.pacing) for _ in range(n)] \
        if cfg.pacing is not None else None

    ranks = list(range(n))
    spanning = max(1, (n + cfg.nodes_per_leaf - 1) // cfg.nodes_per_leaf)
    floor = collectives.all_reduce(
        topo, ranks, cfg.grad_bytes, algo=cfg.algo).total_s

    release = [0.0] * n
    records: List[List[IterationRecord]] = [[] for _ in range(n)]
    step_times: List[float] = []
    link_totals: Dict[str, float] = {}
    prev_finish = 0.0

    for t in range(cfg.iters):
        compute = compute_model.sample()
        arrival = [release[r] + compute[r] for r in range(n)]
        first, last = min(arrival), max(arrival)
        skew_ratio = (last - first) / max(floor, 1e-9)

        congestion.advance()
        eff = congestion.link_eff(skew_ratio, spanning_groups=spanning)
        coll = collectives.all_reduce(
            topo, ranks, cfg.grad_bytes, algo=cfg.algo, link_eff=eff)
        congestion.kick(skew_ratio)
        finish = last + coll.total_s
        for ln, b in coll.per_link_bytes.items():
            link_totals[ln] = link_totals.get(ln, 0.0) + b

        step = finish - prev_finish if t > 0 else finish
        if t >= cfg.warmup:
            step_times.append(step)

        for r in range(n):
            wait = last - arrival[r]
            rec = IterationRecord(
                step=t, compute_time=compute[r], comm_time=coll.total_s,
                wait_time=wait, total_time=finish - release[r])
            records[r].append(rec)
            delay = 0.0
            if controllers is not None:
                controllers[r].observe(wait, finish - release[r])
                decision = controllers[r].decide()
                delay = decision.delay
                rec.pacing_delay = delay
            release[r] = finish + delay
        prev_finish = finish

    return SimResult(cfg=cfg, records=records, step_times=step_times,
                     link_bytes=link_totals)
