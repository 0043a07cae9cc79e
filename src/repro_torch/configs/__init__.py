"""Configuration dataclasses the fabric simulator reads. Only the pacing
block is here so far; the model, mesh and optimizer configs arrive with
the model path."""
from repro_torch.configs.base import PacingConfig  # noqa: F401 (re-export)
