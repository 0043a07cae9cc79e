"""Failure-mode taxonomy + diagnostic report (paper §3.3 and §7).

Maps observed per-rank timing records to the paper's four recurring failure
modes and scores each, so symptoms ("throughput plateaued", "step time
oscillates") become attributable root causes instead of being misdiagnosed
as framework inefficiency:

  * ``sync_amplification``  — cluster-wide idle time from barrier skew; the
    statistical signature is mean wait growing like sigma*sqrt(2 ln N).
  * ``fabric_contention``   — collective time above the topology's transfer
    floor, with *temporally correlated* spikes across ranks (shared links).
  * ``locality_variance``   — persistent per-rank offsets (non-uniform
    GPU<->NIC paths): the same ranks are slow every iteration.
  * ``runtime_jitter``      — iid residual noise (allocator, background
    services, dispatch skew).

The report also carries the paper's practical diagnostic principles.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.core.instrumentation import IterationRecord


def _mean(xs) -> float:
    xs = list(xs)
    return sum(xs) / len(xs) if xs else 0.0


def _std(xs) -> float:
    xs = list(xs)
    if len(xs) < 2:
        return 0.0
    m = _mean(xs)
    return math.sqrt(sum((x - m) ** 2 for x in xs) / len(xs))


def expected_max_factor(n_ranks: int) -> float:
    """E[max of n std normals] ~ sqrt(2 ln n) — the synchronization
    amplification factor of the paper's system model (§3.2)."""
    if n_ranks <= 1:
        return 0.0
    return math.sqrt(2.0 * math.log(n_ranks))


@dataclasses.dataclass
class ModeScore:
    mode: str
    score: float                      # 0..1 — fraction of step time explained
    evidence: str


@dataclasses.dataclass
class DiagnosticReport:
    n_ranks: int
    n_iters: int
    mean_step: float
    cv_step: float
    scores: List[ModeScore]
    dominant: str
    principles: List[str]

    def to_dict(self) -> Dict:
        return {
            "n_ranks": self.n_ranks,
            "n_iters": self.n_iters,
            "mean_step": self.mean_step,
            "cv_step": self.cv_step,
            "scores": {s.mode: {"score": s.score, "evidence": s.evidence}
                       for s in self.scores},
            "dominant": self.dominant,
            "principles": self.principles,
        }


PRINCIPLES = [
    "Track variance/CV and tail latency of iteration time, not just mean "
    "throughput — jitter is the leading indicator of scaling failure.",
    "Separate compute / communication / barrier-wait per phase; aggregate "
    "step time hides where the cliff comes from.",
    "Judge the fabric by queueing behaviour on shared links at collective "
    "time, not by average utilization — hotspots hide in the mean.",
    "Treat persistent per-rank offsets as topology/locality defects "
    "(GPU<->NIC paths), not as model nondeterminism.",
    "Mitigate amplification with bounded, adaptive pacing near barriers "
    "before buying bandwidth — skew, not bytes, is often the binding "
    "constraint.",
]


def diagnose(per_rank: Sequence[Sequence[IterationRecord]],
             transfer_floor: float = 0.0) -> DiagnosticReport:
    """``per_rank[r]`` is the record list of rank r (equal lengths)."""
    R = len(per_rank)
    T = min(len(rs) for rs in per_rank) if R else 0
    if R == 0 or T == 0:
        raise ValueError("need at least one rank with one record")
    steps = [[per_rank[r][t] for r in range(R)] for t in range(T)]
    step_totals = [max(rec.total_time for rec in col) for col in steps]
    mean_step = _mean(step_totals)
    cv_step = _std(step_totals) / mean_step if mean_step > 0 else 0.0

    # --- sync amplification: mean wait fraction, scaled by the sqrt(2 ln N)
    # signature (does observed wait match the order-statistics prediction?)
    waits = [rec.wait_time for col in steps for rec in col]
    compute_jitter = _std([rec.compute_time for col in steps for rec in col])
    wait_frac = _mean(waits) / mean_step if mean_step > 0 else 0.0
    predicted_wait = compute_jitter * expected_max_factor(R)
    sync_score = min(1.0, wait_frac)
    sync_ev = (f"mean wait = {_mean(waits):.4g}s ({100 * wait_frac:.1f}% of "
               f"step); order-stat prediction sigma*sqrt(2lnN) = "
               f"{predicted_wait:.4g}s")

    # --- fabric contention: comm time above the transfer floor, with
    # cross-rank temporal correlation (same iterations slow everywhere).
    comm_by_iter = [_mean([rec.comm_time for rec in col]) for col in steps]
    comm_mean = _mean(comm_by_iter)
    excess = max(0.0, comm_mean - transfer_floor)
    # correlation proxy: do per-iter comm means vary much more than the
    # per-rank-within-iter spread would predict under independence?
    within = _mean([_std([rec.comm_time for rec in col]) for col in steps])
    across = _std(comm_by_iter)
    corr = across / (within / math.sqrt(R) + 1e-12) if within > 0 else \
        (1.0 if across > 0 else 0.0)
    contention_score = min(1.0, (excess / mean_step) if mean_step else 0.0)
    contention_ev = (f"comm mean {comm_mean:.4g}s vs floor "
                     f"{transfer_floor:.4g}s; cross-rank correlation factor "
                     f"{corr:.2f} (>3 suggests shared-link congestion)")

    # --- locality variance: persistent rank effects in compute+comm.
    rank_means = [_mean([per_rank[r][t].compute_time
                         + per_rank[r][t].comm_time for t in range(T)])
                  for r in range(R)]
    rank_spread = (max(rank_means) - min(rank_means)) if R > 1 else 0.0
    locality_score = min(1.0, rank_spread / mean_step if mean_step else 0.0)
    locality_ev = (f"persistent per-rank spread {rank_spread:.4g}s "
                   f"(fastest {min(rank_means):.4g}s, slowest "
                   f"{max(rank_means):.4g}s)")

    # --- runtime jitter: residual iid noise within ranks.
    resid = []
    for r in range(R):
        mu = _mean([per_rank[r][t].compute_time for t in range(T)])
        resid.extend(per_rank[r][t].compute_time - mu for t in range(T))
    jitter_score = min(1.0, _std(resid) / mean_step if mean_step else 0.0)
    jitter_ev = f"within-rank compute std {_std(resid):.4g}s"

    scores = [
        ModeScore("sync_amplification", sync_score, sync_ev),
        ModeScore("fabric_contention", contention_score, contention_ev),
        ModeScore("locality_variance", locality_score, locality_ev),
        ModeScore("runtime_jitter", jitter_score, jitter_ev),
    ]
    dominant = max(scores, key=lambda s: s.score).mode
    return DiagnosticReport(
        n_ranks=R, n_iters=T, mean_step=mean_step, cv_step=cv_step,
        scores=scores, dominant=dominant, principles=list(PRINCIPLES))


def diagnose_jobs(engine_result,
                  transfer_floors: Optional[Dict[str, float]] = None
                  ) -> Dict[str, DiagnosticReport]:
    """Per-tenant diagnostic reports for a shared-fabric engine run.

    ``engine_result`` is a :class:`repro_torch.fabric.engine.EngineResult`; each
    job's lazily-materialized record matrix is diagnosed independently, so
    cross-tenant contention shows up as ``fabric_contention`` on the victim
    job. ``transfer_floors`` optionally maps job name -> uncongested
    collective time (the job's compiled-schedule floor) to sharpen the
    contention attribution.
    """
    floors = transfer_floors or {}
    return {jr.name: diagnose(jr.per_rank_records(),
                              transfer_floor=floors.get(jr.name, 0.0))
            for jr in engine_result.jobs}
