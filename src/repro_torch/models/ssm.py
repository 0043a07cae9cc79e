"""SSM mixers: RWKV-6 ("Finch") time-mix and channel-mix, and Mamba-1 in
the Jamba flavour (RMSNorm on dt, B and C).

The counterpart of ``repro.models.ssm``: projections, token-shift and
convolution plumbing, and decode-state management. The recurrences
themselves are in :mod:`repro_torch.kernels.ops` (K6 and K7 on
``backend="cuda"`` for a prefill, the plain recurrences on ``"torch"``; the
single-token decode steps are torch ops on both, as they are XLA in the
reference). The logical-sharding annotations drop out: a rank holds its
shards and runs its part by hand.

Under a bound mesh whose ``model`` axis is larger than 1
(``launch.sharding.model_axis``) the mixers run tensor parallel, in the
Megatron manner. RWKV-6's time mix computes the ddlerp and the decay's
low-rank ``tanh(xw @ decay_a)`` whole on every rank, then runs this
rank's heads: ``wr`` / ``wk`` / ``wv`` / ``wg`` column-parallel, each
entered with ``copy_to_model`` on its mixed input; ``w0``, ``decay_b``'s
columns, ``u``, ``gn_scale`` and ``gn_bias``, which every rank keeps
whole (the reference's specs leave them so), read at the local heads
through ``shd.local_part``; the group norm and K6 per local head; ``wo``
row-parallel; the cache's ``state`` at the local heads, ``last_x``
whole. The channel mix is column-parallel in ``wk`` and row-parallel in
``wv`` on ``d_ff``, ``wr`` whole. Mamba cuts its inner channels: each
half of ``in_proj`` (``x`` and ``z``) at this rank's ``Din / tp``
channels (``launch.sharding.Halves``), ``conv_*``, ``dt_proj``,
``dt_bias`` (whole on every rank, read through ``local_part``),
``A_log`` and ``D`` on them, ``x_proj`` row-parallel (its
``(B, S, dt_rank + 2N)`` sum precedes the three norms, and ``dt_low``,
``B`` and ``C`` enter the local channels with ``copy_to_model``),
``out_proj`` row-parallel, the cache's ``conv`` and ``h`` at the local
channels. A mixer whose heads (RWKV-6) or channels (Mamba) the axis does
not divide runs whole on every rank (``launch.sharding.runs_whole``).

Where the reference returns a new cache (with the cache donated to the
step), the port writes the recurrent state (RWKV: ``last_x`` and
``state``; Mamba: ``conv`` and ``h``) into the preallocated cache in place
and returns the same dict.

Where a ``seq`` rule cuts a train or prefill pass's sequence
(``launch.sharding.seq_block``) each rank runs its block: the token
shifts' first row (RWKV-6's time and channel mix) and the convolution's
first ``d_conv - 1`` inputs (Mamba) are the previous block's last rows
(``launch.sharding.halo``; zeros before the first block, as a prefill's
fresh cache holds), and K6 and K7 start from the state with which the
previous block ended (``launch.sharding.relay_scan``: one all-gather a
round, the gradient relayed back in reverse). Over ``model``, a mixer
(or the channel mix) whose heads (channels, ``d_ff``) the axis divides
instead runs its shard on the gathered sequence
(``launch.sharding.tp_layer``), K6 and K7 over the whole sequence at the
rank's heads or channels, with no relay. A prefill writes the whole
sequence's final states into every rank's cache: the last block's.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch import sharding as shd
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


def _shift(x: torch.Tensor, last: Optional[torch.Tensor],
           block: Optional[shd.SeqBlock]
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_{t-1} for every row of ``x``, the sequence's last row): with
    ``block`` the first row is the previous block's last
    (:func:`launch.sharding.halo`) and the last row the last block's."""
    if block is None:
        return _token_shift(x, last), x[:, -1]
    first, tail = shd.halo(x, 1, block)
    return torch.cat([first, x[:, :-1]], 1), tail[:, 0]


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


def rwkv_tmix_apply(p: nn.ParameterDict, x: torch.Tensor, *,
                    cfg: ModelConfig, **kw) -> Tuple[torch.Tensor, Cache]:
    """The time mix (:func:`_rwkv_tmix_apply`, whose keywords it takes)
    as ``launch.sharding.tp_layer`` runs a layer of the heads."""
    return shd.tp_layer(cfg.num_heads, _rwkv_tmix_apply, p, x, cfg=cfg,
                        **kw)


def _rwkv_tmix_apply(
    p: nn.ParameterDict,
    x: torch.Tensor,               # (B, S, D)
    *,
    cfg: ModelConfig,
    mode: str = "train",
    cache: Cache = None,           # {"last_x": (B,D), "state": (B,H,K,V)}
    backend: str = "cuda",
) -> Tuple[torch.Tensor, Cache]:
    """At this rank's heads under a model axis: the module's
    docstring."""
    B, S, D = x.shape
    H = shd.local_size(cfg.num_heads)
    K = cfg.ssm.head_dim
    last_x = cache["last_x"] if cache else None
    block = shd.seq_block() if mode != "decode" else None
    prev, tail = _shift(x, last_x, block)
    delta = prev - x

    # data-dependent interpolation (ddlerp)
    xx = x + delta * p["mu_x"]
    lora = torch.tanh(xx @ p["lora_a"]).reshape(B, S, 5, RWKV_LORA_RANK)
    offs = torch.einsum("bsnr,nrd->nbsd", lora, p["lora_b"])   # (5,B,S,D)
    mixed = x[None] + delta[None] * (p["mu_rkvwg"][:, None, None] + offs)
    xr, xk, xv, xw, xg = mixed.unbind(0)

    r = (shd.copy_to_model(xr) @ p["wr"]).reshape(B, S, H, K)
    k = (shd.copy_to_model(xk) @ p["wk"]).reshape(B, S, H, K)
    v = (shd.copy_to_model(xv) @ p["wv"]).reshape(B, S, H, K)
    g = shd.copy_to_model(xg) @ p["wg"]
    w_raw = shd.local_part(p["w0"]) + shd.copy_to_model(
        torch.tanh(xw @ p["decay_a"])) @ shd.local_part(p["decay_b"])
    u = shd.local_part(p["u"], 0)
    # the decay is rounded to r's dtype before the recurrence, as there
    w = torch.exp(-torch.exp(w_raw.float())).reshape(B, S, H, K).to(r.dtype)

    s0 = cache["state"] if cache else None
    if mode == "decode":
        if S != 1 or cache is None:
            raise ValueError(f"decode takes one token and a cache, got "
                             f"S={S} and cache={cache is not None}")
        y, s_out = ops.wkv6_decode(r, k, v.to(r.dtype), w, u, s0,
                                   backend=backend)
    elif block is None:
        y, s_out = ops.wkv6(r, k, v, w, u, s0, backend=backend)
    else:
        s_init = s0 if s0 is not None else torch.zeros(
            (B, H, K, K), dtype=torch.float32, device=x.device)
        y, s_out = shd.relay_scan(
            lambda *a: ops.wkv6(*a, backend=backend), ops.wkv6_vjp,
            (r, k, v, w, u), s_init, block, final=mode == "prefill")
    y = y.reshape(B, S, H * K)
    y = _group_norm(y, shd.local_part(p["gn_scale"]),
                    shd.local_part(p["gn_bias"]), H, cfg.norm_eps * 64)
    out = shd.tp_row_matmul(y * F.silu(g), p["wo"], "heads")

    new_cache = None
    if mode in ("prefill", "decode"):
        cache["last_x"].copy_(tail)
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
    """Under a model axis ``wk`` is column-parallel and ``wv``
    row-parallel on ``d_ff``, ``wr`` whole on every rank; where the axis
    does not divide ``d_ff`` the channel mix runs whole on every rank, with
    no collective (``launch.sharding.runs_whole``), as the reference's
    fallback replicates ``wk`` (``launch.sharding.tp_layer``)."""
    return shd.tp_layer(cfg.d_ff, _rwkv_cmix_apply, p, x, cfg=cfg,
                        mode=mode, cache=cache)


def _rwkv_cmix_apply(p: nn.ParameterDict, x: torch.Tensor, *,
                     cfg: ModelConfig, mode: str, cache: Cache
                     ) -> Tuple[torch.Tensor, Cache]:
    last_x = cache["last_x"] if cache else None
    prev, tail = _shift(x, last_x,
                        shd.seq_block() if mode != "decode" else None)
    delta = prev - x
    xk = x + delta * p["mu_k"]
    xr = x + delta * p["mu_r"]
    h = torch.relu(shd.copy_to_model(xk) @ p["wk"]).square()
    kv = shd.tp_row_matmul(h, p["wv"], "ff")
    out = torch.sigmoid(xr @ p["wr"]) * kv
    new_cache = None
    if mode in ("prefill", "decode"):
        cache["last_x"].copy_(tail)
        new_cache = cache
    return out, new_cache


# ---------------------------------------------------------------------------
# Mamba-1 (Jamba flavour: RMSNorm on dt/B/C)
# ---------------------------------------------------------------------------


def _dt_rank(cfg: ModelConfig) -> int:
    return cfg.ssm.dt_rank or max(1, cfg.d_model // 16)


def mamba_init(gen: torch.Generator, cfg: ModelConfig, *, device=None
               ) -> nn.ParameterDict:
    D = cfg.d_model
    s = cfg.ssm
    Din = s.expand * D
    N = s.d_state
    dt_rank = _dt_rank(cfg)
    kw = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
    f32 = dict(dtype=torch.float32, device=device)
    # S4D-real init for A; dt bias init so softplus(dt_bias) in [1e-3, 1e-1]
    A = torch.arange(1, N + 1, **f32).expand(Din, N)
    u = torch.empty((Din,), **f32).uniform_(math.log(1e-3), math.log(1e-1),
                                            generator=gen)
    dt_init = torch.exp(u)
    dt_bias = dt_init + torch.log1p(-torch.exp(-dt_init))     # inv softplus
    p = {
        "in_proj": dense_init(gen, D, 2 * Din, **kw),
        "conv_w": trunc_normal(gen, (s.d_conv, Din),
                               std=1.0 / math.sqrt(s.d_conv), **kw),
        "conv_b": zeros((Din,), **kw),
        "x_proj": dense_init(gen, Din, dt_rank + 2 * N, **kw),
        "dt_proj": dense_init(gen, dt_rank, Din, std=dt_rank ** -0.5, **kw),
        # float32 whatever param_dtype is, as in the reference
        "dt_bias": dt_bias,
        "A_log": torch.log(A),
        "D": ones((Din,), **f32),
        "out_proj": dense_init(gen, Din, D,
                               std=1.0 / math.sqrt(2 * cfg.num_layers * Din),
                               **kw),
        "norm_dt": ones((dt_rank,), **kw),
        "norm_B": ones((N,), **kw),
        "norm_C": ones((N,), **kw),
    }
    return nn.ParameterDict({k: param(v) for k, v in p.items()})


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Depthwise causal conv1d. x: (B,S,Din), w: (k,Din), prev: (B,k-1,Din).

    A sum of ``k`` shifted products in x's dtype, as the reference writes
    it (not ``F.conv1d``: cuDNN runs float32 convolutions in TF32 by
    default)."""
    kk = w.shape[0]
    if prev is None:
        prev = torch.zeros((x.shape[0], kk - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([prev.to(x.dtype), x], dim=1)           # (B,S+k-1,Din)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(kk))
    return out + b


def mamba_apply(p: nn.ParameterDict, x: torch.Tensor, *, cfg: ModelConfig,
                **kw) -> Tuple[torch.Tensor, Cache]:
    """Mamba (:func:`_mamba_apply`, whose keywords it takes) as
    ``launch.sharding.tp_layer`` runs a layer of the inner channels."""
    return shd.tp_layer(cfg.ssm.expand * cfg.d_model, _mamba_apply, p, x,
                        cfg=cfg, **kw)


def _mamba_apply(
    p: nn.ParameterDict,
    x: torch.Tensor,               # (B, S, D)
    *,
    cfg: ModelConfig,
    mode: str = "train",
    cache: Cache = None,           # {"conv": (B,k-1,Din), "h": (B,Din,N)}
    backend: str = "cuda",
) -> Tuple[torch.Tensor, Cache]:
    """Mamba-1 mixer. The inner norms of dt, B and C are RMSNorm through
    :func:`ops.rmsnorm` (K5 on ``backend="cuda"``); softplus is
    ``logaddexp(x, 0)``, as ``jax.nn.softplus`` is (``F.softplus`` returns
    x above 20). In ``prefill`` and ``decode`` the last ``k - 1`` inputs of
    the convolution and the final state are written into ``cache`` in
    place, and the same dict is returned. Under a model axis: this rank's
    channels, as the module's docstring says.
    ``x_proj``'s partial products are summed as ``tp_row_matmul`` sums
    them, in float32 (the reference's compiled HLO of the bf16 smoke
    Jamba's prefill at ``(data 1, model 2)`` on the CPU all-reduces
    ``f32[B, S, dt_rank + 2N]`` there, each partial ``dot`` rounded to
    bf16 first, as it does for ``wo`` and ``w_down``)."""
    B, S, D = x.shape
    s = cfg.ssm
    Din = shd.local_size(s.expand * D)
    N = s.d_state
    dt_rank = _dt_rank(cfg)
    eps = cfg.norm_eps

    xz = shd.copy_to_model(x) @ p["in_proj"]
    xin, z = xz.chunk(2, dim=-1)
    kk = p["conv_w"].shape[0]
    block = shd.seq_block() if mode != "decode" else None
    prev_conv = cache["conv"] if cache else None
    if block is not None:
        prev_conv, conv_tail = shd.halo(xin, kk - 1, block)
    xc = F.silu(_causal_conv(xin, p["conv_w"], p["conv_b"], prev_conv))

    proj = shd.tp_row_matmul(xc, p["x_proj"], "ff")          # (B,S,r+2N)
    # K5's wrapper takes contiguous rows only: the slices are copied
    dt_low = ops.rmsnorm(proj[..., :dt_rank].contiguous(), p["norm_dt"],
                         eps, backend=backend)
    Bm = ops.rmsnorm(proj[..., dt_rank:dt_rank + N].contiguous(),
                     p["norm_B"], eps, backend=backend)
    C = ops.rmsnorm(proj[..., dt_rank + N:].contiguous(), p["norm_C"], eps,
                    backend=backend)
    # the whole dt_low, B and C meet this rank's channels
    dt_low, Bm, C = (shd.copy_to_model(t) for t in (dt_low, Bm, C))
    dt_raw = dt_low @ p["dt_proj"] + shd.local_part(p["dt_bias"]).to(x.dtype)
    dt = torch.logaddexp(dt_raw, dt_raw.new_zeros(()))
    A = -torch.exp(p["A_log"])

    h0 = cache["h"] if cache else None
    if mode == "decode":
        if S != 1 or cache is None:
            raise ValueError(f"decode takes one token and a cache, got "
                             f"S={S} and cache={cache is not None}")
        y, h_out = ops.mamba_decode(xc, dt, A, Bm, C, p["D"], h0,
                                    backend=backend)
    elif block is None:
        y, h_out = ops.mamba_scan(xc, dt, A, Bm, C, p["D"], h0,
                                  backend=backend)
    else:
        h_init = h0 if h0 is not None else torch.zeros(
            (B, Din, N), dtype=torch.float32, device=x.device)
        y, h_out = shd.relay_scan(
            lambda *a: ops.mamba_scan(*a, backend=backend),
            ops.mamba_scan_vjp, (xc, dt, A, Bm, C, p["D"]), h_init, block,
            final=mode == "prefill")
    out = shd.tp_row_matmul(y * F.silu(z), p["out_proj"], "ff")

    new_cache = None
    if mode in ("prefill", "decode"):
        if mode == "decode":
            conv_new = torch.cat([prev_conv[:, 1:].to(xin.dtype), xin], dim=1)
        elif block is not None:
            conv_new = conv_tail
        else:
            pad = torch.zeros((B, kk - 1, Din), dtype=xin.dtype,
                              device=xin.device)
            conv_new = torch.cat([pad, xin], dim=1)[:, -(kk - 1):]
        cache["conv"].copy_(conv_new)
        cache["h"].copy_(h_out)
        new_cache = cache
    return out, new_cache
