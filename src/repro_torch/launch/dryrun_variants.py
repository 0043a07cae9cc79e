"""Variant-tag parsing for the dry-run / §Perf hillclimbs.

Kept separate from ``repro_torch.launch.dryrun`` so tests can import it without
triggering that module's 512-device ``XLA_FLAGS`` initialization.
"""
from __future__ import annotations

from typing import Dict, Tuple


def apply_variant_pure(cfg, variant: str):
    """Parse a '+'-separated variant tag.

    Returns ``(cfg, microbatches, int8pod, noz1, rules, env)``. Parts:
      * ``opt``     — pad attention heads to the 16-way model axis
      * ``mb<k>``   — gradient accumulation over k microbatches
      * ``lc<n>``   — chunked cross-entropy, n tokens per chunk
      * ``int8pod`` — explicit int8 ring gradient exchange over `pod`
      * ``noz1``    — ZeRO-1 off (control variant)
      * ``seqkv``   — cache-sequence parallelism (shard seq over `model`)
      * ``nf32``    — norm statistics in activation dtype (probe)
      * ``nr``      — remat off
    """
    mb, int8pod, noz1 = 1, False, False
    rules: Dict[str, str] = {}
    env: Dict[str, str] = {}
    for part in (variant.split("+") if variant else []):
        if part == "opt":
            cfg = cfg.replace(pad_heads_to=16)
        elif part.startswith("mb"):
            mb = int(part[2:])
        elif part.startswith("lc"):
            cfg = cfg.replace(loss_chunk=int(part[2:]))
        elif part == "int8pod":
            int8pod = True
        elif part == "noz1":
            noz1 = True
        elif part == "nr":
            cfg = cfg.replace(remat="none")
        elif part == "nf32":
            env["REPRO_NORM_BF16"] = "1"
        elif part == "bf16tp":
            env["REPRO_BF16_TP"] = "1"
        elif part == "seqkv":
            rules["seq"] = "model"
        elif part:
            raise ValueError(f"unknown variant part {part!r}")
    return cfg, mb, int8pod, noz1, rules, env
