"""Adaptive bounded pacing (paper §4.3 + §5.3) — the coordination control
mechanism.

Each rank runs one controller. The controller watches a rolling window of
its own *barrier wait* estimates (from :class:`CollectiveTrace`) and step
times. When the wait variability (CV) or the relative arrival spread exceeds
the configured thresholds, early-arriving ranks (those with above-median
wait) are delayed by a **bounded** amount before the next iteration.

Properties the paper requires, kept explicitly:

  * **local** — decisions use only locally observed signals; no controller
    peer-to-peer traffic, no central scheduler;
  * **bounded** — delay <= ``max_delay_frac`` x rolling-median step time;
  * **adaptive / self-limiting** — the delay decays geometrically whenever
    imbalance subsides, so stable phases pay ~zero overhead;
  * **conservative** — activates only after ``warmup_iters`` observations and
    only above thresholds; never attempts lock-step equalization.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Optional

import numpy as np

from repro_torch.configs.base import PacingConfig


def _clamp(x: float) -> float:
    """Observation sanitizer: negative, -0.0, and **NaN** inputs all clamp
    to ``0.0``. Bit-identical to the old ``max(0.0, x)`` for ordinary
    floats; the explicit comparison pins the NaN case, where Python's
    ``max(0.0, nan)`` keeps 0.0 but numpy's ``np.maximum`` propagates the
    NaN — the divergence that silently broke the scalar-vs-bank
    bit-equality contract (:class:`PacingBank` uses the matching
    ``where(x > 0, x, 0)`` form)."""
    return x if x > 0.0 else 0.0


def _median(xs) -> float:
    s = sorted(xs)
    n = len(s)
    if n == 0:
        return 0.0
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _cv(xs) -> float:
    n = len(xs)
    if n < 2:
        return 0.0
    mean = sum(xs) / n
    if mean <= 0:
        return 0.0
    # (x - mean) * (x - mean), not ** 2: multiplication is a single correctly
    # rounded operation on every platform, so the vectorized PacingBank can
    # reproduce these floats exactly without depending on libm's pow.
    var = sum((x - mean) * (x - mean) for x in xs) / n
    return math.sqrt(var) / mean


@dataclasses.dataclass
class PacingDecision:
    delay: float                      # seconds to sleep before next iteration
    active: bool                      # is the controller currently engaged
    cv_wait: float                    # diagnostic: window CV of waits
    skew: float                       # diagnostic: own wait - median wait


class PacingController:
    """One per rank. Feed observations, read back a bounded delay.

    The controller's state variable is *earliness* = applied delay +
    observed barrier wait: how much earlier than the last arriver this rank
    would have been with no pacing. Pacing by ``gain x min(window
    earliness)`` is conservative in exactly the paper's sense — a rank only
    absorbs skew it exhibited on *every* recent iteration (persistent
    locality offsets, multi-iteration straggler episodes), never transient
    jitter — and it self-limits instantly: the first iteration after an
    imbalance subsides pulls the window minimum down to ~zero.
    """

    def __init__(self, cfg: PacingConfig):
        self.cfg = cfg
        self._waits: Deque[float] = deque(maxlen=cfg.window)
        self._early: Deque[float] = deque(maxlen=cfg.window)
        self._steps: Deque[float] = deque(maxlen=cfg.window)
        self._delay = 0.0
        self._seen = 0
        self.activations = 0          # lifetime count (diagnostics)

    # -- observation -------------------------------------------------------
    def observe(self, wait_time: float, step_time: float) -> None:
        wait = _clamp(wait_time)      # NaN/negative -> 0.0 (see _clamp)
        self._waits.append(wait)
        self._early.append(wait + self._delay)
        self._steps.append(_clamp(step_time))
        self._seen += 1

    # -- decision ----------------------------------------------------------
    def decide(self) -> PacingDecision:
        cfg = self.cfg
        if not cfg.enabled or self._seen < cfg.warmup_iters \
                or len(self._waits) < 2:
            return PacingDecision(0.0, False, 0.0, 0.0)

        cv_wait = _cv(self._waits)
        med_wait = _median(self._waits)
        med_step = _median(self._steps)
        own_wait = self._waits[-1]
        # Time spent idling at the barrier equals this rank's earliness vs
        # the last arriver — inferred without exchanging any timing data
        # (paper §5.3). Combined with the delay we already applied, it
        # recovers unpaced earliness.
        min_early = min(self._early)
        rel_med = (med_wait / med_step) if med_step > 0 else 0.0
        rel_last = (own_wait / med_step) if med_step > 0 else 0.0

        # Activate on persistent imbalance (median wait above threshold) or
        # on spiky imbalance (high CV with the latest wait elevated).
        imbalanced = rel_med > cfg.skew_threshold or \
            (cv_wait > cfg.cv_threshold and rel_last > cfg.skew_threshold)
        if imbalanced and min_early > 0:
            # Conservative predictor: the window *minimum* of earliness is
            # skew this rank exhibited on every recent iteration. Transient
            # jitter never enters it, so pacing cannot chase noise; and the
            # first balanced iteration zeroes it, so pacing disengages
            # before it can turn a former-early rank into the straggler.
            self._delay = cfg.gain * min_early
            self.activations += 1
        else:
            # Self-limiting: geometric decay back to zero.
            self._delay *= cfg.decay
            if self._delay < 1e-6 * max(med_step, 1e-9):
                self._delay = 0.0

        bound = cfg.max_delay_frac * med_step
        delay = min(self._delay, bound)
        return PacingDecision(delay=delay, active=delay > 0.0,
                              cv_wait=cv_wait, skew=own_wait)

    # -- introspection -----------------------------------------------------
    @property
    def current_delay(self) -> float:
        return self._delay

    def reset(self) -> None:
        self._waits.clear()
        self._early.clear()
        self._steps.clear()
        self._delay = 0.0
        self._seen = 0


class PacingBank:
    """All of a job's per-rank controllers, vectorized across ranks.

    The fabric engine steps every rank of a job in lockstep, so the N
    per-rank :class:`PacingController` calls per iteration (deque appends,
    two sorts, three window sums — the coordination run is controller-bound)
    collapse into one ``observe``/``decide`` pair over ``(n_ranks, window)``
    arrays.

    The bank is **float-exact** against N scalar controllers fed the same
    observations (``tests/test_coordination.py`` holds them equal): window
    sums accumulate column-by-column left to right (Python ``sum()`` order —
    never a numpy axis-reduction, whose pairwise summation rounds
    differently for window >= 8), medians index sorted rows with the scalar
    ``_median`` formula, and the delay update replicates the scalar branch
    structure with masks. This is what lets the engine keep its bit-equality
    contract with the per-rank reference loop while dropping the per-rank
    Python overhead (``benchmarks.run --only pacing``).
    """

    def __init__(self, cfg: PacingConfig, n_ranks: int):
        self.cfg = cfg
        self.n = n_ranks
        w = cfg.window
        self._w = w
        self._bw = np.zeros((n_ranks, w))   # waits
        self._be = np.zeros((n_ranks, w))   # earliness = wait + delay
        self._bs = np.zeros((n_ranks, w))   # step times
        self._pos = 0                       # next write column
        self._count = 0                     # filled columns (<= window)
        self._delay = np.zeros(n_ranks)     # unbounded internal delay state
        self._seen = 0
        self.activations = np.zeros(n_ranks, dtype=np.int64)

    # -- observation -------------------------------------------------------
    def observe(self, wait_times: np.ndarray, step_times: np.ndarray) -> None:
        """One iteration's observations for every rank at once.

        Sanitized like the scalar controller's ``_clamp``: ``where(x > 0,
        x, 0)`` clamps negative *and NaN* observations to 0.0 — the old
        ``np.maximum(0.0, x)`` propagated NaN while the scalar path kept
        0.0, silently breaking the bit-equality contract between them."""
        pos = self._pos
        wait_times = np.asarray(wait_times)
        w = np.where(wait_times > 0.0, wait_times, 0.0)
        self._bw[:, pos] = w
        self._be[:, pos] = w + self._delay
        step_times = np.asarray(step_times)
        self._bs[:, pos] = np.where(step_times > 0.0, step_times, 0.0)
        self._pos = (pos + 1) % self._w
        if self._count < self._w:
            self._count += 1
        self._seen += 1

    def _window(self, buf: np.ndarray) -> np.ndarray:
        """The rolling window in deque order (oldest -> newest)."""
        if self._count < self._w:
            return buf[:, :self._count]
        if self._pos == 0:
            return buf
        idx = np.arange(self._w)
        idx = (idx + self._pos) % self._w
        return buf[:, idx]

    @staticmethod
    def _rowsum(a: np.ndarray) -> np.ndarray:
        # Left-to-right accumulation per row: bit-equal to Python's sum()
        # over the deque for any window length.
        s = a[:, 0].copy()
        for j in range(1, a.shape[1]):
            s += a[:, j]
        return s

    @staticmethod
    def _rowmedian(sorted_rows: np.ndarray) -> np.ndarray:
        c = sorted_rows.shape[1]
        if c % 2:
            return sorted_rows[:, c // 2]
        return 0.5 * (sorted_rows[:, c // 2 - 1] + sorted_rows[:, c // 2])

    # -- decision ----------------------------------------------------------
    def decide(self) -> np.ndarray:
        """Bounded per-rank delays (same values as N scalar ``decide()``)."""
        cfg = self.cfg
        if not cfg.enabled or self._seen < cfg.warmup_iters \
                or self._count < 2:
            return np.zeros(self.n)

        waits = self._window(self._bw)
        c = waits.shape[1]
        mean = self._rowsum(waits) / c
        dev = waits - mean[:, None]
        var = self._rowsum(dev * dev) / c
        mean_pos = mean > 0
        cv_wait = np.where(
            mean_pos, np.sqrt(var) / np.where(mean_pos, mean, 1.0), 0.0)

        med_wait = self._rowmedian(np.sort(waits, axis=1))
        med_step = self._rowmedian(np.sort(self._window(self._bs), axis=1))
        own_wait = waits[:, -1]
        min_early = self._window(self._be).min(axis=1)

        step_pos = med_step > 0
        safe_step = np.where(step_pos, med_step, 1.0)
        rel_med = np.where(step_pos, med_wait / safe_step, 0.0)
        rel_last = np.where(step_pos, own_wait / safe_step, 0.0)

        imbalanced = (rel_med > cfg.skew_threshold) | \
            ((cv_wait > cfg.cv_threshold) & (rel_last > cfg.skew_threshold))
        active = imbalanced & (min_early > 0)

        decayed = self._delay * cfg.decay
        decayed[decayed < 1e-6 * np.maximum(med_step, 1e-9)] = 0.0
        self._delay = np.where(active, cfg.gain * min_early, decayed)
        self.activations += active

        bound = cfg.max_delay_frac * med_step
        return np.minimum(self._delay, bound)
