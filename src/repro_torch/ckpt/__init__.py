"""Checkpoint cadence arithmetic the fabric simulation's checkpoint-aware
resume uses. The sharded checkpoint store arrives with the training path."""
from repro_torch.ckpt.cadence import (CheckpointCadence,        # noqa: F401
                                      latest_restorable_step)
