"""SSM mixers: RWKV-6 ("Finch") time-mix and channel-mix.

The counterpart of the RWKV-6 half of ``repro.models.ssm``: projections,
token-shift plumbing and decode-state management. The recurrence itself is
in :mod:`repro_torch.kernels.ops` (K6 on ``backend="cuda"`` for a prefill,
the plain recurrence on ``"torch"``; the single-token decode step is torch
ops on both, as it is XLA in the reference). The logical-sharding
annotations drop out (one card, no mesh).

Where the reference returns a new cache (with the cache donated to the
step), the port writes ``last_x`` and the recurrent state into the
preallocated cache in place and returns the same dict. Mamba comes with its
slice (``ROADMAP.md``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.params import (dense_init, ones, param, trunc_normal,
                                       zeros)

Cache = Optional[Dict[str, Any]]

RWKV_LORA_RANK = 32          # ddlerp lora rank (32 for small models)
RWKV_DECAY_RANK = 64


# ---------------------------------------------------------------------------
# RWKV-6 time mix
# ---------------------------------------------------------------------------


def rwkv_tmix_init(gen: torch.Generator, cfg: ModelConfig, *, device=None
                   ) -> nn.ParameterDict:
    D = cfg.d_model
    H = cfg.num_heads
    K = cfg.ssm.head_dim
    if H * K != D:
        raise ValueError(f"{H} heads x {K} != d_model {D}")
    dt = getattr(torch, cfg.param_dtype)
    kw = dict(dtype=dt, device=device)
    r = RWKV_LORA_RANK
    p = {
        # ddlerp: 5 interpolation targets (r, k, v, w, g) + base mu
        "mu_x": trunc_normal(gen, (D,), std=0.02, **kw),
        "mu_rkvwg": trunc_normal(gen, (5, D), std=0.02, **kw),
        "lora_a": dense_init(gen, D, 5 * r, **kw),
        "lora_b": trunc_normal(gen, (5, r, D), std=0.01, **kw),
        "wr": dense_init(gen, D, D, **kw),
        "wk": dense_init(gen, D, D, **kw),
        "wv": dense_init(gen, D, D, **kw),
        "wg": dense_init(gen, D, D, **kw),
        "wo": dense_init(gen, D, D,
                         std=1.0 / math.sqrt(2 * cfg.num_layers * D), **kw),
        # decay: w = exp(-exp(w0 + tanh(x @ da) @ db))
        "w0": torch.full((D,), -2.0, **kw),
        "decay_a": dense_init(gen, D, RWKV_DECAY_RANK, **kw),
        "decay_b": trunc_normal(gen, (RWKV_DECAY_RANK, D), std=0.01, **kw),
        # float32 whatever param_dtype is, as in the reference
        "u": trunc_normal(gen, (H, K), std=0.02, dtype=torch.float32,
                          device=device),
        # per-head group norm on the wkv output
        "gn_scale": ones((D,), **kw),
        "gn_bias": zeros((D,), **kw),
    }
    return nn.ParameterDict({k: param(v) for k, v in p.items()})


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """x_{t-1}; position 0 uses ``last`` (decode cache) or zeros."""
    if x.shape[1] == 1:
        return (torch.zeros_like(x) if last is None
                else last[:, None].to(x.dtype))
    prev = F.pad(x[:, :-1], (0, 0, 1, 0))
    if last is not None:
        prev[:, 0] = last.to(x.dtype)
    return prev


def _group_norm(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                H: int, eps: float) -> torch.Tensor:
    """LayerNorm per head over the K dim. y: (B,S,D) with D = H*K."""
    B, S, D = y.shape
    yf = y.float().reshape(B, S, H, D // H)
    mean = yf.mean(-1, keepdim=True)
    var = (yf - mean).square().mean(-1, keepdim=True)
    yf = (yf - mean) * torch.rsqrt(var + eps)
    yf = yf.reshape(B, S, D)
    return (yf * scale.float() + bias.float()).to(y.dtype)


def rwkv_tmix_apply(
    p: nn.ParameterDict,
    x: torch.Tensor,               # (B, S, D)
    *,
    cfg: ModelConfig,
    mode: str = "train",
    cache: Cache = None,           # {"last_x": (B,D), "state": (B,H,K,V)}
    backend: str = "cuda",
) -> Tuple[torch.Tensor, Cache]:
    B, S, D = x.shape
    H = cfg.num_heads
    K = cfg.ssm.head_dim
    last_x = cache["last_x"] if cache else None
    prev = _token_shift(x, last_x)
    delta = prev - x

    # data-dependent interpolation (ddlerp)
    xx = x + delta * p["mu_x"]
    lora = torch.tanh(xx @ p["lora_a"]).reshape(B, S, 5, RWKV_LORA_RANK)
    offs = torch.einsum("bsnr,nrd->nbsd", lora, p["lora_b"])   # (5,B,S,D)
    mixed = x[None] + delta[None] * (p["mu_rkvwg"][:, None, None] + offs)
    xr, xk, xv, xw, xg = mixed.unbind(0)

    r = (xr @ p["wr"]).reshape(B, S, H, K)
    k = (xk @ p["wk"]).reshape(B, S, H, K)
    v = (xv @ p["wv"]).reshape(B, S, H, K)
    g = xg @ p["wg"]
    w_raw = p["w0"] + torch.tanh(xw @ p["decay_a"]) @ p["decay_b"]
    # the decay is rounded to r's dtype before the recurrence, as there
    w = torch.exp(-torch.exp(w_raw.float())).reshape(B, S, H, K).to(r.dtype)

    s0 = cache["state"] if cache else None
    if mode == "decode":
        if S != 1 or cache is None:
            raise ValueError(f"decode takes one token and a cache, got "
                             f"S={S} and cache={cache is not None}")
        y, s_out = ops.wkv6_decode(r, k, v.to(r.dtype), w, p["u"], s0,
                                   backend=backend)
    else:
        y, s_out = ops.wkv6(r, k, v, w, p["u"], s0, backend=backend)
    y = y.reshape(B, S, D)
    y = _group_norm(y, p["gn_scale"], p["gn_bias"], H, cfg.norm_eps * 64)
    out = (y * F.silu(g)) @ p["wo"]

    new_cache = None
    if mode in ("prefill", "decode"):
        cache["last_x"].copy_(x[:, -1])
        cache["state"].copy_(s_out)
        new_cache = cache
    return out, new_cache


# ---------------------------------------------------------------------------
# RWKV-6 channel mix
# ---------------------------------------------------------------------------


def rwkv_cmix_init(gen: torch.Generator, cfg: ModelConfig, *, device=None
                   ) -> nn.ParameterDict:
    D, Fd = cfg.d_model, cfg.d_ff
    kw = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
    p = {
        "mu_k": trunc_normal(gen, (D,), std=0.02, **kw),
        "mu_r": trunc_normal(gen, (D,), std=0.02, **kw),
        "wk": dense_init(gen, D, Fd, **kw),
        "wv": dense_init(gen, Fd, D,
                         std=1.0 / math.sqrt(2 * cfg.num_layers * Fd), **kw),
        "wr": dense_init(gen, D, D, **kw),
    }
    return nn.ParameterDict({k: param(v) for k, v in p.items()})


def rwkv_cmix_apply(
    p: nn.ParameterDict,
    x: torch.Tensor,
    *,
    cfg: ModelConfig,
    mode: str = "train",
    cache: Cache = None,           # {"last_x": (B, D)}
) -> Tuple[torch.Tensor, Cache]:
    last_x = cache["last_x"] if cache else None
    prev = _token_shift(x, last_x)
    delta = prev - x
    xk = x + delta * p["mu_k"]
    xr = x + delta * p["mu_r"]
    h = torch.relu(xk @ p["wk"]).square()
    kv = h @ p["wv"]
    out = torch.sigmoid(xr @ p["wr"]) * kv
    new_cache = None
    if mode in ("prefill", "decode"):
        cache["last_x"].copy_(x[:, -1])
        new_cache = cache
    return out, new_cache
