"""Configuration dataclasses for the repro_torch framework.

Everything is a frozen dataclass so configs hash/compare cleanly and can be
used as cache keys and structural (static) arguments.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PacingConfig:
    """Paper §4.3/§5.3: adaptive bounded pacing of early-arriving ranks."""
    enabled: bool = True
    window: int = 32                # rolling window of observed wait times
    cv_threshold: float = 0.05      # activate when CV of step/wait exceeds this
    skew_threshold: float = 0.10    # or when relative arrival spread exceeds this
    max_delay_frac: float = 0.5     # bounded: delay <= frac * median step time
    gain: float = 0.5               # fraction of observed skew corrected per step
    decay: float = 0.9              # self-limiting decay when imbalance subsides
    warmup_iters: int = 8           # no pacing until the window has data
