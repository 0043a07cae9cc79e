"""Per-rank compute/locality variance models (paper §3.3).

Three stochastic ingredients, each mapping to one taxonomy entry:

  * lognormal per-iteration compute jitter         -> runtime jitter
  * persistent per-rank locality multiplier        -> locality variance
    (non-uniform GPU<->NIC paths: the same ranks are always a bit slow)
  * Markov on/off background interference spikes   -> straggler events
    (transient co-located load, GC, scrubbing, etc.)
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import List


@dataclasses.dataclass(frozen=True)
class StragglerConfig:
    base_compute_s: float = 0.2       # per-iteration local work at batch size
    jitter_sigma: float = 0.02        # lognormal sigma (relative)
    locality_spread: float = 0.06     # max persistent per-rank slowdown
    spike_prob: float = 0.002         # per-iter chance a rank enters a spike
    spike_mult: float = 1.25          # slowdown while spiking
    spike_exit_prob: float = 0.1      # geometric spike duration
    heavy_frac: float = 0.0           # fraction of spikes that are heavy-tail
    heavy_mult: float = 2.0           # slowdown for heavy-tail spikes


class ComputeModel:
    """Samples per-rank compute time per iteration; owns straggler state.

    :meth:`sample` is the simulator's single hottest function (n_ranks RNG
    draws per iteration), so its loop is hand-tightened: locals for every
    attribute, the per-rank ``base * locality`` product precomputed, and
    ``random.gauss`` inlined (same Box-Muller pair caching through
    ``rng.gauss_next``). The draw sequence and float arithmetic are
    bit-identical to the seed implementation, which is preserved as
    :class:`repro_torch.fabric._reference.ReferenceComputeModel` and held equal
    by tests.
    """

    def __init__(self, cfg: StragglerConfig, n_ranks: int, seed: int = 0):
        self.cfg = cfg
        self.n = n_ranks
        self.rng = random.Random(seed)
        # persistent locality multiplier per rank (>= 1.0)
        self.locality = [1.0 + cfg.locality_spread * self.rng.random()
                         for _ in range(n_ranks)]
        self.spiking = [0.0] * n_ranks   # 0 => healthy, else active multiplier
        self._scale = [cfg.base_compute_s * loc for loc in self.locality]

    def sample(self) -> List[float]:
        cfg = self.cfg
        rng = self.rng
        rnd = rng.random
        spiking = self.spiking
        scale = self._scale
        sigma = cfg.jitter_sigma
        spike_prob = cfg.spike_prob
        exit_prob = cfg.spike_exit_prob
        heavy_frac = cfg.heavy_frac
        heavy_mult = cfg.heavy_mult
        spike_mult = cfg.spike_mult
        exp, cos, sin, log, sqrt = \
            math.exp, math.cos, math.sin, math.log, math.sqrt
        twopi = 2.0 * math.pi
        # take over the Box-Muller pair cache for the duration of the loop
        g_next = rng.gauss_next
        rng.gauss_next = None
        out = []
        append = out.append
        for r in range(self.n):
            s = spiking[r]
            if s:
                if rnd() < exit_prob:
                    spiking[r] = s = 0.0
            elif rnd() < spike_prob:
                heavy = rnd() < heavy_frac
                spiking[r] = s = heavy_mult if heavy else spike_mult
            z = g_next
            if z is None:
                x2pi = rnd() * twopi
                g2rad = sqrt(-2.0 * log(1.0 - rnd()))
                z = cos(x2pi) * g2rad
                g_next = sin(x2pi) * g2rad
            else:
                g_next = None
            t = scale[r] * exp(z * sigma)
            if s:
                t *= s
            append(t)
        rng.gauss_next = g_next
        return out

    def expected_max_wait(self) -> float:
        """sigma * sqrt(2 ln N) order-statistics estimate (paper §3.2)."""
        sigma_abs = self.cfg.base_compute_s * self.cfg.jitter_sigma
        return sigma_abs * math.sqrt(2.0 * math.log(max(self.n, 2)))
