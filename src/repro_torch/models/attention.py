"""GQA attention mixer (RoPE / sliding window / QKV bias) with a KV cache.

The counterpart of the GQA half of ``repro.models.attention``:
``gqa_init``, ``gqa_init_cache``, ``cache_capacity``, ``_ring_write`` and
``gqa_apply``, with mode in {"train", "prefill", "decode"}:

  * train   -- full causal self-attention, no cache.
  * prefill -- causal self-attention AND fills the cache.
  * decode  -- single-token query against the cache (S_q == 1).

Caches are plain dicts of tensors. SWA layers use a ring buffer of size
``window`` (rope is applied at write time, so ring order is irrelevant).
Where the reference returns a new cache (``.at[].set``, with the cache
donated to the step), the port writes into the preallocated cache in
place and returns the same dict. MLA and cross attention come with their
slices (``ROADMAP.md``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.params import dense_init, param, zeros
from repro_torch.models.rope import apply_rope

Cache = Optional[Dict[str, Any]]


def gqa_init(gen: torch.Generator, cfg: ModelConfig, *, device=None
             ) -> nn.ParameterDict:
    D = cfg.d_model
    H = cfg.padded_heads()
    KV = cfg.padded_kv_heads()
    Dh = cfg.resolved_head_dim()
    dt = getattr(torch, cfg.param_dtype)
    kw = dict(dtype=dt, device=device)
    p = {
        "wq": dense_init(gen, D, H * Dh, **kw),
        "wk": dense_init(gen, D, KV * Dh, **kw),
        "wv": dense_init(gen, D, KV * Dh, **kw),
        "wo": dense_init(gen, H * Dh, D,
                         std=1.0 / math.sqrt(2 * cfg.num_layers * H * Dh),
                         **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros((H * Dh,), **kw)
        p["bk"] = zeros((KV * Dh,), **kw)
        p["bv"] = zeros((KV * Dh,), **kw)
    return nn.ParameterDict({k: param(v) for k, v in p.items()})


def _rope_qk(q, k, cfg: ModelConfig, positions):
    if cfg.rope == "none":
        return q, k
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def cache_capacity(cfg: ModelConfig, max_len: int) -> int:
    if cfg.sliding_window and cfg.sliding_window > 0:
        return min(cfg.sliding_window, max_len)
    return max_len


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                   device=None) -> Dict[str, torch.Tensor]:
    KV = cfg.padded_kv_heads()
    Dh = cfg.resolved_head_dim()
    C = cache_capacity(cfg, max_len)
    dt = dtype or getattr(torch, cfg.dtype)
    return {
        "k": torch.zeros((batch, C, KV, Dh), dtype=dt, device=device),
        "v": torch.zeros((batch, C, KV, Dh), dtype=dt, device=device),
    }


def _ring_write(cache_kv: torch.Tensor, new: torch.Tensor,
                pos: Union[int, torch.Tensor]) -> torch.Tensor:
    """Write (B, S, KV, Dh) ``new`` at positions [pos, pos+S) modulo
    capacity, in place; returns ``cache_kv``.

    Works for both plain caches (pos+S <= C by construction) and SWA rings.
    """
    S = new.shape[1]
    C = cache_kv.shape[1]
    dev = cache_kv.device
    if S >= C:
        # keep the last C entries, aligned to ring slots of their positions
        last = new[:, -C:]
        start = (pos + S - C) % C
        idx = (start + torch.arange(C, device=dev)) % C
        cache_kv[:, idx] = last.to(cache_kv.dtype)
        return cache_kv
    idx = (pos + torch.arange(S, device=dev)) % C
    cache_kv[:, idx] = new.to(cache_kv.dtype)
    return cache_kv


def gqa_apply(
    p: nn.ParameterDict,
    x: torch.Tensor,               # (B, S, D)
    *,
    cfg: ModelConfig,
    positions: torch.Tensor,       # (B, S) absolute positions
    mode: str = "train",
    cache: Cache = None,
    kv_len: Optional[torch.Tensor] = None,  # (B,) valid length (decode)
    pos0: Union[int, torch.Tensor] = 0,     # position of x[:, 0] (cache write)
    causal: bool = True,
    backend: str = "cuda",
) -> Tuple[torch.Tensor, Cache]:
    """``pos0`` is the position of the first token, the scalar the
    reference reads back from ``positions[0, 0]``; the caller passes it so
    that a Python int stays on the host and the cache write needs no
    device-to-host copy."""
    B, S, D = x.shape
    H = cfg.padded_heads()
    KV = cfg.padded_kv_heads()
    Dh = cfg.resolved_head_dim()

    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, KV, Dh)
    v = v.reshape(B, S, KV, Dh)
    q, k = _rope_qk(q, k, cfg, positions)

    window = cfg.sliding_window or 0
    if mode == "train":
        out = ops.attention(q, k, v, causal=causal, window=window,
                            backend=backend)
        new_cache = None
    elif mode == "prefill":
        out = ops.attention(q, k, v, causal=causal, window=window,
                            backend=backend)
        _ring_write(cache["k"], k, pos0)
        _ring_write(cache["v"], v, pos0)
        new_cache = cache
    elif mode == "decode":
        if S != 1 or cache is None:
            raise ValueError(f"decode takes one token and a cache, got "
                             f"S={S} and cache={cache is not None}")
        ck = _ring_write(cache["k"], k, pos0)
        cv = _ring_write(cache["v"], v, pos0)
        C = ck.shape[1]
        if kv_len is None:
            kv_len = torch.full((B,), int(pos0) + 1, dtype=torch.int32,
                                device=x.device)
        eff_len = torch.clamp(kv_len, max=C)
        out = ops.decode_attention(q, ck, cv, kv_len=eff_len,
                                   backend=backend)
        new_cache = cache
    else:
        raise ValueError(mode)

    out = out.reshape(B, S, H * Dh)
    return out @ p["wo"], new_cache
