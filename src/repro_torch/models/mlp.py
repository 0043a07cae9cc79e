"""Dense MLP (SwiGLU / GELU, optional bias).

The counterpart of the dense half of ``repro.models.mlp``. On one card the
reference's row-parallel ``tp_row_matmul`` is a plain product. The dropless
MoE layer comes with the MoE slice (``ROADMAP.md``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import dense_init, param, zeros


def mlp_init(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None, *, device=None) -> nn.ParameterDict:
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    kw = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
    out_std = 1.0 / math.sqrt(2 * cfg.num_layers * Fd)
    if cfg.act == "swiglu":
        p = {
            "w_gate": dense_init(gen, D, Fd, **kw),
            "w_up": dense_init(gen, D, Fd, **kw),
            "w_down": dense_init(gen, Fd, D, std=out_std, **kw),
        }
    else:
        p = {
            "w_up": dense_init(gen, D, Fd, **kw),
            "w_down": dense_init(gen, Fd, D, std=out_std, **kw),
        }
    if cfg.mlp_bias:
        p["b_up"] = zeros((Fd,), **kw)
        p["b_down"] = zeros((D,), **kw)
    return nn.ParameterDict({k: param(v) for k, v in p.items()})


def mlp_apply(p: nn.ParameterDict, x: torch.Tensor, *, cfg: ModelConfig
              ) -> torch.Tensor:
    if cfg.act == "swiglu":
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        if cfg.mlp_bias:
            u = u + p["b_up"]
        h = F.silu(g) * u
    else:
        h = x @ p["w_up"]
        if cfg.mlp_bias:
            h = h + p["b_up"]
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    out = h @ p["w_down"]
    if cfg.mlp_bias:
        out = out + p["b_down"]
    return out
