"""The per-rank coordination agent (paper §5.1): instrumentation + pacing
wrapped around an existing synchronous step function.

The agent integrates at the boundary between the framework runtime and the
collective library: it never modifies the step function, the collectives, or
the model. On a real multi-host TPU deployment one agent wraps each
process's dispatch loop; under the fabric simulator the same agent code runs
against virtual time. ``sleep`` and ``clock`` are injectable so behaviour is
identical (and testable) in both contexts.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from repro_torch.configs.base import PacingConfig
from repro_torch.core.instrumentation import (CollectiveTrace, IterationRecord,
                                        PhaseRecorder, summarize)
from repro_torch.core.pacing import PacingController, PacingDecision


class CoordinationAgent:
    """Wraps one rank's step dispatch with observe -> decide -> pace.

    Usage in a training loop::

        agent = CoordinationAgent(pacing_cfg)
        for step in range(n):
            batch = agent.timed_data(lambda: next(it))
            out = agent.timed_step(lambda: step_fn(state, batch))
            rec = agent.end_iteration(step)
    """

    def __init__(
        self,
        cfg: PacingConfig,
        *,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        comm_floor: Optional[float] = None,
    ):
        self.cfg = cfg
        self._clock = clock
        self._sleep = sleep
        self.recorder = PhaseRecorder(clock=clock)
        self.trace = CollectiveTrace(clock=clock)
        self.controller = PacingController(cfg)
        self.decisions: List[PacingDecision] = []
        self._comm_floor = comm_floor

    # -- phase-timed helpers -------------------------------------------------
    def timed_data(self, fn: Callable[[], object]) -> object:
        with self.recorder.phase("data"):
            return fn()

    def timed_step(self, fn: Callable[[], object]) -> object:
        """Times the jitted step. The step function blocks until the result
        is ready, which includes the gradient collective; the collective
        trace brackets the same region so the wait estimate is derived from
        the step's blocking time."""
        self.trace.enter()
        with self.recorder.phase("compute"):
            out = fn()
        inside = self.trace.exit()
        # split: floor ~= pure compute+transfer; excess ~= barrier wait
        wait = max(0.0, inside - (self._comm_floor
                                  if self._comm_floor is not None
                                  else self.trace.transfer_floor()))
        self.recorder.add("wait", wait)
        self.recorder.add("compute", -min(wait, inside))
        return out

    def observe_explicit(self, *, compute: float, comm: float,
                         wait: float) -> None:
        """Simulator path: phase durations are known exactly."""
        self.recorder.add("compute", compute)
        self.recorder.add("comm", comm)
        self.recorder.add("wait", wait)

    # -- iteration boundary ----------------------------------------------------
    def end_iteration(self, step: int, *,
                      step_time: Optional[float] = None) -> IterationRecord:
        """Close the iteration: observe, decide, pace (bounded sleep)."""
        acc = self.recorder._acc
        wait = acc["wait"]
        total_guess = step_time if step_time is not None else \
            (self._clock() - self.recorder._iter_start)
        self.controller.observe(wait, max(total_guess, 1e-12))
        decision = self.controller.decide()
        self.decisions.append(decision)
        if decision.delay > 0:
            with self.recorder.phase("pacing"):
                self._sleep(decision.delay)
        return self.recorder.finish(step)

    # -- reporting ---------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        s = summarize(list(self.recorder.records))
        s["pacing_activations"] = float(self.controller.activations)
        return s
