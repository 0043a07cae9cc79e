"""Fault tolerance: heartbeat failure detection, restart policy, and elastic
re-mesh planning.

At the scale the paper studies (and the 1000+ node target), node failure is
a steady-state condition, not an exception. The design follows the paper's
constraint that the coordination layer must not add central control-plane
state: detection is local-observation based (missed heartbeats), recovery is
checkpoint-restart, and elasticity is a *plan* — a deterministic function
from surviving device count to the next mesh — so every process computes the
same answer without negotiation.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Callable, Dict, Iterator, List, Optional, Tuple

# Nesting depth of simulated-clock scopes (repro_torch.fabric.events engines).
# While > 0, constructing a FailureDetector on the wall clock is almost
# certainly a bug — detection timeouts would be measured in real seconds
# while the engine's virtual clock races through simulated hours.
_SIM_CLOCK_DEPTH = 0


@contextlib.contextmanager
def simulated_clock_scope() -> Iterator[None]:
    """Marks the dynamic extent in which a simulation's virtual clock is the
    only sane time source. :class:`repro_torch.fabric.events.LifecycleEngine`
    wraps its run in this scope; any :class:`FailureDetector` constructed
    inside it without an explicit ``clock`` draws a warning."""
    global _SIM_CLOCK_DEPTH
    _SIM_CLOCK_DEPTH += 1
    try:
        yield
    finally:
        _SIM_CLOCK_DEPTH -= 1


@dataclasses.dataclass
class HeartbeatConfig:
    interval_s: float = 5.0
    timeout_s: float = 20.0           # missed window => suspected failure


class FailureDetector:
    """Phi-style accrual simplified to a timeout detector over heartbeats.

    ``clock`` is injectable so tests (and the simulator) drive virtual
    time; ``None`` (the default) selects the wall clock. Under a simulation
    engine the virtual clock must be threaded explicitly — defaulting to
    ``time.monotonic`` there silently disables detection (simulated seconds
    pass in wall-clock microseconds), so constructing a wall-clock detector
    inside :func:`simulated_clock_scope` warns.
    """

    def __init__(self, ranks: List[int], cfg: HeartbeatConfig,
                 clock: Optional[Callable[[], float]] = None):
        if clock is None:
            if _SIM_CLOCK_DEPTH > 0:
                warnings.warn(
                    "FailureDetector constructed on the wall clock "
                    "(clock=None -> time.monotonic) inside a simulated-"
                    "clock scope; pass the engine's virtual clock or "
                    "heartbeat timeouts will never fire in simulated time",
                    RuntimeWarning, stacklevel=2)
            clock = time.monotonic
        self.cfg = cfg
        self._clock = clock
        now = clock()
        self.last_seen: Dict[int, float] = {r: now for r in ranks}

    def heartbeat(self, rank: int) -> None:
        self.last_seen[rank] = self._clock()

    def suspected(self) -> List[int]:
        now = self._clock()
        return [r for r, t in self.last_seen.items()
                if now - t > self.cfg.timeout_s]

    def healthy(self) -> List[int]:
        sus = set(self.suspected())
        return [r for r in self.last_seen if r not in sus]


@dataclasses.dataclass(frozen=True)
class RestoreCostModel:
    """Checkpoint-restore cost for the recovery/preemption replan delay.

    The first engine charged a flat 0.5 s for every re-place. Physically the stall is
    dominated by reloading the parameter state from the checkpoint store
    (``repro_torch.ckpt`` restores full leaves at the store's read bandwidth) plus
    a size-independent overhead (manifest read, process re-init, schedule
    re-compile). ``delay_s(param_bytes)`` models exactly that; the defaults
    reproduce the old constant to within 5% for the default 1.1 GB job
    (0.25 + 1.1e9 / 4e9 = 0.525 s), so switching a scenario to the model
    perturbs rather than rewrites its series.

    The lifecycle engine uses this when constructed with
    ``replan_delay_s=None``; the constant remains the default (explicit
    override) because the first golden determinism fixtures were
    recorded under it.
    """
    read_bw_Bps: float = 4e9          # aggregate checkpoint read bandwidth
    overhead_s: float = 0.25          # manifest, re-init, re-compile

    def delay_s(self, param_bytes: float) -> float:
        if param_bytes < 0.0:
            raise ValueError(f"param_bytes must be >= 0, got {param_bytes}")
        return self.overhead_s + param_bytes / self.read_bw_Bps


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 100
    backoff_s: float = 10.0
    backoff_mult: float = 2.0
    backoff_max_s: float = 600.0
    _restarts: int = 0

    def next_delay(self) -> Optional[float]:
        """Returns backoff delay for the next restart, or None if exhausted."""
        if self._restarts >= self.max_restarts:
            return None
        d = min(self.backoff_s * (self.backoff_mult ** self._restarts),
                self.backoff_max_s)
        self._restarts += 1
        return d

    def record_success(self) -> None:
        """A healthy interval resets the backoff ladder."""
        self._restarts = 0


def plan_elastic_mesh(
    n_devices: int,
    *,
    model_parallel: int = 16,
    prefer_pods: bool = True,
    pod_size: int = 256,
) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Deterministic mesh plan for the surviving device count.

    Keeps the model axis intact (parameter shards must stay complete) and
    gives remaining devices to data parallelism; drops to fewer pods/DP
    groups as needed. Every process computes the same plan — no negotiation.
    """
    if n_devices < model_parallel:
        # degenerate: shrink model axis to the largest power-of-two divisor
        m = 1
        while m * 2 <= n_devices:
            m *= 2
        return (1, m), ("data", "model")
    usable = (n_devices // model_parallel) * model_parallel
    dp = usable // model_parallel
    if prefer_pods and usable % pod_size == 0 and usable // pod_size >= 2:
        pods = usable // pod_size
        dp_per_pod = pod_size // model_parallel
        return (pods, dp_per_pod, model_parallel), ("pod", "data", "model")
    return (dp, model_parallel), ("data", "model")


@dataclasses.dataclass
class RecoveryEvent:
    kind: str                # "failure" | "restart" | "resume" | "preempted"
    step: int
    detail: str


class RecoveryLog:
    """Append-only in-memory recovery journal (mirrors what an external
    supervisor would persist)."""

    def __init__(self):
        self.events: List[RecoveryEvent] = []

    def record(self, kind: str, step: int, detail: str = "") -> None:
        self.events.append(RecoveryEvent(kind, step, detail))

    def failures(self) -> int:
        return sum(1 for e in self.events if e.kind == "failure")
