"""Checkpoint substrate: atomic, async save with elastic restore in the
reference's on-disk layout, plus the cadence arithmetic the fabric
simulation's checkpoint-aware resume shares with the real store."""
from repro_torch.ckpt.cadence import (CheckpointCadence,        # noqa: F401
                                      latest_restorable_step)
from repro_torch.ckpt.checkpoint import (CheckpointManager,     # noqa: F401
                                         Stacked)
