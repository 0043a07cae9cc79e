"""The non-kernel implementations of the model ops, as torch ops.

The counterpart of ``repro.kernels.xla_impl``. The serving paths need only
the single-token steps the reference leaves to XLA rather than to a Pallas
kernel: decode attention over a KV cache (``decode_attention_xla`` there),
the RWKV-6 decode step (``wkv6_decode``) and the Mamba decode step
(``mamba_decode``); here they are plain PyTorch on both backends. The
chunked flash forward and its hand-rolled backward, and the chunked WKV6
(``wkv6_chunked``, the backward's forward) and Mamba (``mamba_chunked``)
scans, come with the training slice (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ref import NEG_INF


def decode_attention(
    q: torch.Tensor,               # (B, 1, H, Dh) single new token
    k_cache: torch.Tensor,         # (B, S, KV, Dh)
    v_cache: torch.Tensor,         # (B, S, KV, Dv)
    *,
    kv_len: torch.Tensor,          # (B,) valid lengths (new token included)
    window: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode attention over a (possibly rolling) KV cache.

    For a rolling SWA cache the caller passes the cache as stored
    (unrotated); masking is position-free because every resident entry is
    in-window by construction, so only the kv_len mask applies.
    """
    B, _, H, Dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv "
                         f"heads")
    g = H // KV
    scale = scale if scale is not None else Dh ** -0.5
    dev = q.device
    qf = q.float() * scale
    kf = k_cache.float()
    vf = v_cache.float()
    qg = qf.reshape(B, 1, KV, g, Dh)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg, kf)           # (B,KV,g,1,S)
    kpos = torch.arange(S, device=dev)
    kv_len = kv_len.to(dev)
    mask = kpos[None, :] < kv_len[:, None]                  # (B,S)
    if window and window > 0 and S > window:
        # unrotated full cache: also mask entries older than the window
        mask = mask & (kpos[None, :] >= (kv_len[:, None] - window))
    s = s.masked_fill(~mask[:, None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqs,bshd->bqhgd", p, vf)
    return out.reshape(B, 1, H, vf.shape[-1]).to(q.dtype)


def wkv6_decode(
    r: torch.Tensor,               # (B, 1, H, K)
    k: torch.Tensor,               # (B, 1, H, K)
    v: torch.Tensor,               # (B, 1, H, V)
    w: torch.Tensor,               # (B, 1, H, K)
    u: torch.Tensor,               # (H, K)
    state: torch.Tensor,           # (B, H, K, V) running state, float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token RWKV-6 step (serving path); the counterpart of
    ``repro.kernels.xla_impl.wkv6_decode``. Returns (y (B,1,H,V) in r's
    dtype, the new state float32); ``state`` is not written."""
    rf, kf, vf, wf = (a[:, 0].float() for a in (r, k, v, w))
    kv = kf[..., :, None] * vf[..., None, :]               # (B,H,K,V)
    y = torch.einsum("bhk,bhkv->bhv", rf,
                     state + u.float()[None, ..., None] * kv)
    new_state = wf[..., None] * state + kv
    return y[:, None].to(r.dtype), new_state


def mamba_decode(
    x: torch.Tensor,               # (B, 1, D)
    dt: torch.Tensor,              # (B, 1, D)
    A: torch.Tensor,               # (D, N)
    Bm: torch.Tensor,              # (B, 1, N)
    C: torch.Tensor,               # (B, 1, N)
    D: torch.Tensor,               # (D,)
    h: torch.Tensor,               # (B, D, N) running state, float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token selective-scan step (serving path); the counterpart of
    ``repro.kernels.xla_impl.mamba_decode``. Returns (y (B,1,D) in x's
    dtype, the new state float32); ``h`` is not written."""
    xf = x[:, 0].float()
    dtf = dt[:, 0].float()
    Bf = Bm[:, 0].float()
    Cf = C[:, 0].float()
    dA = torch.exp(dtf[..., None] * A.float()[None])
    h_new = dA * h + (dtf * xf)[..., None] * Bf[:, None, :]
    y = torch.einsum("bdn,bn->bd", h_new, Cf) + D.float()[None] * xf
    return y[:, None].to(x.dtype), h_new
