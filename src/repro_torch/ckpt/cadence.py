"""Checkpoint cadence arithmetic shared by the real checkpoint store and
the fabric simulation.

:class:`CheckpointManager` persists ``step_<n>`` directories; a training
loop saving every ``every`` steps leaves ``latest_step()`` at the newest
multiple of the cadence. The lifecycle engine's checkpoint-aware resume
(:class:`repro_torch.fabric.workloads.TrainingTenant` with
``JobSpec(ckpt_every=...)``) models exactly that store without touching
disk: a preempted or failure-recovered tenant rewinds to
:func:`latest_restorable_step` and re-executes the steps since — the lost
work a coarser cadence trades for save bandwidth.
"""
from __future__ import annotations

import dataclasses


def latest_restorable_step(step: int, every: int) -> int:
    """The newest checkpointed step at cadence ``every`` at or before
    ``step`` — what ``CheckpointManager.latest_step()`` reports for a loop
    that has completed ``step`` steps, saving every ``every``-th."""
    if every < 1:
        raise ValueError(f"cadence must be >= 1 steps, got {every!r}")
    if step < 0:
        raise ValueError(f"step must be >= 0, got {step!r}")
    return (step // every) * every


@dataclasses.dataclass(frozen=True)
class CheckpointCadence:
    """A save-every-N-steps policy: restore points and lost work."""

    every: int = 1

    def __post_init__(self):
        if self.every < 1:
            raise ValueError(
                f"cadence must be >= 1 steps, got {self.every!r}")

    def restore_step(self, step: int) -> int:
        return latest_restorable_step(step, self.every)

    def lost_steps(self, step: int) -> int:
        """Steps of work a restart at ``step`` re-executes."""
        return step - self.restore_step(step)
