"""The non-kernel implementations of the model ops, as torch ops.

The counterpart of ``repro.kernels.xla_impl``. The serving path needs only
single-token decode attention over a KV cache (``decode_attention_xla``
there), which the reference leaves to XLA rather than to a Pallas kernel;
here it is plain PyTorch on both backends. The chunked flash forward and
its hand-rolled backward, and the chunked WKV6 / Mamba scans, come with
the training slice (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Optional

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
