"""Per-phase instrumentation (paper §5.2).

Three signal classes, all local to a rank, all low-overhead:

  1. per-iteration phase timings (data wait / forward+backward dispatch /
     gradient sync / pacing / total);
  2. collective entry+exit timestamps — each rank infers its *relative
     arrival skew* from its own wait time inside the collective, without
     exchanging any timing data (an early rank waits longer);
  3. static locality info sampled at startup (device kind, process index,
     mesh coordinates) used to contextualize runs, never to schedule.

The recorder is dependency-injectable on the clock so the same code runs
under the discrete-event fabric simulator (virtual time), the real training
loop (wall time), and unit tests (scripted traces).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

Clock = Callable[[], float]


@dataclasses.dataclass
class IterationRecord:
    """Timing of one synchronous training iteration on one rank."""
    step: int
    compute_time: float = 0.0        # fwd+bwd+optimizer (local work)
    comm_time: float = 0.0           # time inside gradient collectives
    wait_time: float = 0.0           # inferred barrier wait (early-arrival)
    pacing_delay: float = 0.0        # delay injected by the coordination layer
    data_time: float = 0.0           # input pipeline wait
    total_time: float = 0.0

    @property
    def useful_fraction(self) -> float:
        if self.total_time <= 0:
            return 0.0
        return self.compute_time / self.total_time


@dataclasses.dataclass(frozen=True)
class LocalityInfo:
    """Static per-process placement info (paper §5.2, sampled at startup)."""
    process_index: int
    device_kind: str
    num_local_devices: int
    mesh_coords: Optional[tuple] = None
    notes: str = ""


# Departure from the copy rule (the module is otherwise the reference's):
# the reference reads jax's process index and local devices; the port reads
# the running process group's rank (0 without one) and the CUDA cards
# ("cpu" and 1 on a machine without one).
def sample_locality(mesh_coords: Optional[tuple] = None) -> LocalityInfo:
    import torch
    import torch.distributed as dist
    rank = dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0
    if torch.cuda.is_available():
        kind, n = torch.cuda.get_device_name(0), torch.cuda.device_count()
    else:
        kind, n = "cpu", 1
    return LocalityInfo(process_index=rank, device_kind=kind,
                        num_local_devices=n, mesh_coords=mesh_coords)


class PhaseRecorder:
    """Records per-phase timings for the current iteration.

    Usage::

        rec = PhaseRecorder()
        with rec.phase("compute"):
            ...
        with rec.phase("comm"):
            ...
        record = rec.finish(step)
    """

    _PHASES = ("data", "compute", "comm", "wait", "pacing")

    def __init__(self, clock: Clock = time.monotonic, history: int = 1024):
        self._clock = clock
        self._acc: Dict[str, float] = {k: 0.0 for k in self._PHASES}
        self._iter_start = self._clock()
        self.records: Deque[IterationRecord] = deque(maxlen=history)

    class _Phase:
        def __init__(self, rec: "PhaseRecorder", name: str):
            self.rec, self.name = rec, name

        def __enter__(self):
            self.t0 = self.rec._clock()
            return self

        def __exit__(self, *exc):
            self.rec._acc[self.name] += self.rec._clock() - self.t0
            return False

    def phase(self, name: str) -> "_Phase":
        if name not in self._PHASES:
            raise KeyError(name)
        return self._Phase(self, name)

    def add(self, name: str, dt: float) -> None:
        self._acc[name] += dt

    def finish(self, step: int) -> IterationRecord:
        now = self._clock()
        rec = IterationRecord(
            step=step,
            data_time=self._acc["data"],
            compute_time=self._acc["compute"],
            comm_time=self._acc["comm"],
            wait_time=self._acc["wait"],
            pacing_delay=self._acc["pacing"],
            total_time=now - self._iter_start,
        )
        self.records.append(rec)
        self._acc = {k: 0.0 for k in self._PHASES}
        self._iter_start = now
        return rec


class CollectiveTrace:
    """Entry/exit timestamps around a collective.

    A rank that enters early spends longer *inside* the collective (it waits
    for the stragglers), so ``inside = exit - entry`` minus the transfer-time
    floor is a local estimate of how early this rank arrived. No timing data
    crosses the network.
    """

    def __init__(self, clock: Clock = time.monotonic, window: int = 64):
        self._clock = clock
        self.inside_times: Deque[float] = deque(maxlen=window)
        self._entry: Optional[float] = None

    def enter(self) -> None:
        self._entry = self._clock()

    def exit(self) -> float:
        assert self._entry is not None, "exit() before enter()"
        dt = self._clock() - self._entry
        self._entry = None
        self.inside_times.append(dt)
        return dt

    def transfer_floor(self) -> float:
        """Minimum observed inside-time ~= pure transfer cost (no waiting)."""
        return min(self.inside_times) if self.inside_times else 0.0

    def wait_estimate(self) -> float:
        """Latest inside-time minus the floor: inferred barrier wait."""
        if not self.inside_times:
            return 0.0
        return max(0.0, self.inside_times[-1] - self.transfer_floor())


def summarize(records: List[IterationRecord]) -> Dict[str, float]:
    """Aggregate stats used by the diagnostics report and benchmarks."""
    import math
    if not records:
        return {}
    totals = [r.total_time for r in records]
    n = len(totals)
    mean = sum(totals) / n
    var = sum((t - mean) ** 2 for t in totals) / n
    std = math.sqrt(var)
    out = {
        "iters": float(n),
        "mean_step": mean,
        "std_step": std,
        "cv_step": (std / mean) if mean > 0 else 0.0,
        "p95_step": sorted(totals)[min(n - 1, int(0.95 * n))],
        "mean_compute": sum(r.compute_time for r in records) / n,
        "mean_comm": sum(r.comm_time for r in records) / n,
        "mean_wait": sum(r.wait_time for r in records) / n,
        "mean_pacing": sum(r.pacing_delay for r in records) / n,
        "useful_fraction": sum(r.useful_fraction for r in records) / n,
    }
    return out
