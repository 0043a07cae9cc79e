"""Architecture registry: ``--arch <id>`` ids map to config modules.

Every assigned architecture is selectable by its public id (with dashes).
Each module exposes FULL (exact published dims) and SMOKE (reduced config,
same family pattern, runs on 1 CPU device).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401 (re-export)
    DECODE_32K,
    LONG_500K,
    MLAConfig,
    MeshConfig,
    ModelConfig,
    MoEConfig,
    MULTI_POD_MESH,
    OptimizerConfig,
    PacingConfig,
    PREFILL_32K,
    SHAPES,
    SHAPES_BY_NAME,
    SINGLE_POD_MESH,
    SMOKE_MESH,
    SSMConfig,
    ShapeConfig,
    TRAIN_4K,
    TrainConfig,
)

# public arch id -> module name
ARCH_MODULES: Dict[str, str] = {
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
}

ARCH_IDS: List[str] = list(ARCH_MODULES)

# Archs with a sub-quadratic decode path (SSM state / rolling SWA window /
# context-parallel hybrid): these run long_500k. Pure full-attention archs
# skip it (DESIGN.md §4).
LONG_CONTEXT_ARCHS = {"rwkv6-3b", "jamba-v0.1-52b", "mixtral-8x7b"}


def get_model_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_MODULES)}")
    mod = importlib.import_module(ARCH_MODULES[arch])
    return mod.SMOKE if smoke else mod.FULL


def get_optimized_config(arch: str) -> ModelConfig:
    """Beyond-paper optimized variant: head padding to the 16-way model axis.

    The paper-faithful baseline keeps published head counts (replicated attention
    compute when heads % 16 != 0); the optimized variant pads heads to the next
    multiple of 16 so attention TP shards cleanly. See EXPERIMENTS.md §Perf.
    """
    cfg = get_model_config(arch)
    return cfg.replace(pad_heads_to=16)


def applicable_shapes(arch: str) -> List[ShapeConfig]:
    cfg = get_model_config(arch)
    out = []
    for s in SHAPES:
        if s.name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
            continue  # requires sub-quadratic attention; skip per assignment
        out.append(s)
    del cfg
    return out


def all_cells() -> List[tuple]:
    """All (arch, shape) cells, including skipped ones flagged."""
    cells = []
    for arch in ARCH_IDS:
        runnable = {s.name for s in applicable_shapes(arch)}
        for s in SHAPES:
            cells.append((arch, s.name, s.name in runnable))
    return cells
