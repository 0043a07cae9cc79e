"""The non-kernel implementations of the model ops, as torch ops.

The counterpart of ``repro.kernels.xla_impl``. Two parts of it are here:

- the chunked flash attention, forward and hand-written backward
  (``_mask_block``, ``_fa_fwd_scan``, ``_flash_xla_bwd`` and
  ``flash_attention_xla`` there; :func:`flash_attention` here, a
  ``torch.autograd.Function``). Its backward is the flash-attention
  identity, recomputing each kv block's probabilities from the saved
  logsumexp, never autograd of the online softmax; it is also the
  backward of K4 (:func:`attention_vjp`, which ``kernels/ops.py`` calls).
  It keeps the reference's ``block_k`` of 512, its zero padding of Sk
  masked through a kv length, ``NEG_INF = -1e30``, float32 for all of its
  arithmetic, and its GQA rule: k and v broadcast over a group of query
  heads, and dk and dv summed over it;
- the single-token steps the reference leaves to XLA rather than to a
  Pallas kernel: decode attention over a KV cache
  (``decode_attention_xla`` there), the RWKV-6 decode step
  (``wkv6_decode``) and the Mamba decode step (``mamba_decode``).

The chunked WKV6 (``wkv6_chunked``) and Mamba (``mamba_chunked``) scans,
the backward of K6 and K7, come with their training slice (``ROADMAP.md``
Queue 1 item 9b).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.ref import NEG_INF



# ---------------------------------------------------------------------------
# flash attention: chunked forward and hand-written backward
# ---------------------------------------------------------------------------
#
# Inside, q is grouped as (B, KV, g, Sq, D) (head h = kv * g + i, as the
# reference's reshape of H into (KV, g)) and k, v are (B, KV, Sk, D): an
# einsum over the group broadcasts k and v to it and sums dk and dv over
# it.


def _mask_block(s: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor,
                *, causal: bool, window: int,
                kv_len: Optional[torch.Tensor]) -> torch.Tensor:
    """``s`` (B, KV, g, Sq, bk) logits with the masked entries set to
    ``NEG_INF``: keys after the query (causal), outside the window, or at
    or past the row's kv length."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=s.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window and window > 0:
        mask &= k_pos[None, :] > (q_pos[:, None] - window)
    mask = mask[None, None, None]
    if kv_len is not None:
        mask = mask & (k_pos[None, None, None, None, :]
                       < kv_len[:, None, None, None, None])
    return s.masked_fill(~mask, NEG_INF)


def _pad_kv(k: torch.Tensor, v: torch.Tensor, kv_len, block_k: int):
    """k, v (B, KV, Sk, ·) zero-padded to a multiple of ``block_k`` keys;
    when padded, a kv length of Sk masks the padding. Returns (k, v,
    kv_len, number of blocks)."""
    B, _, Sk, _ = k.shape
    nk = math.ceil(Sk / block_k)
    pad = nk * block_k - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        if kv_len is None:
            kv_len = torch.full((B,), Sk, dtype=torch.int32, device=k.device)
    return k, v, kv_len, nk


def _fa_fwd_scan(qf, k, v, *, causal, window, q_offset, kv_len, block_k):
    """Online-softmax forward over kv blocks. qf: (B, KV, g, Sq, D) float32
    with the scale folded in; k, v: (B, KV, Sk, D) / (B, KV, Sk, Dv).
    Returns (out (B, KV, g, Sq, Dv) float32, lse (B, KV, g, Sq) float32)."""
    B, KV, g, Sq, _ = qf.shape
    Dv = v.shape[3]
    k, v, kv_len, nk = _pad_kv(k, v, kv_len, block_k)
    dev = qf.device
    q_pos = torch.arange(Sq, device=dev) + q_offset
    m = torch.full((B, KV, g, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, g, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, g, Sq, Dv), dtype=torch.float32, device=dev)
    for ik in range(nk):
        blk = slice(ik * block_k, (ik + 1) * block_k)
        k_pos = ik * block_k + torch.arange(block_k, device=dev)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k[:, :, blk].float())
        s = _mask_block(s, q_pos, k_pos, causal=causal, window=window,
                        kv_len=kv_len)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p, v[:, :, blk].float())
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return acc / l_safe[..., None], m + torch.log(l_safe)


def _flash_xla_bwd(qf, k, v, out, lse, gf, *, causal, window, q_offset,
                   kv_len, scale, block_k):
    """The flash-attention backward: per kv block, P recomputed from the
    logsumexp, dV = P^T dO, dS = P (dO V^T - rowsum(dO O)), dQ += dS K
    scale, dK = dS^T (q scale). ``qf``, ``out``, ``gf`` (the output's
    cotangent) are float32 and grouped; returns float32 (dq grouped,
    dk (B, KV, Sk, D), dv (B, KV, Sk, Dv))."""
    Sk = k.shape[2]
    dev = qf.device
    Sq = qf.shape[3]
    kp, vp, kv_len, nk = _pad_kv(k, v, kv_len, block_k)
    d_row = (gf * out).sum(-1)                            # (B, KV, g, Sq)
    q_pos = torch.arange(Sq, device=dev) + q_offset
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for ik in range(nk):
        blk = slice(ik * block_k, (ik + 1) * block_k)
        k_pos = ik * block_k + torch.arange(block_k, device=dev)
        kbf = kp[:, :, blk].float()
        vbf = vp[:, :, blk].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kbf)
        s = _mask_block(s, q_pos, k_pos, causal=causal, window=window,
                        kv_len=kv_len)
        p = torch.exp(s - lse[..., None])
        dvs.append(torch.einsum("bhgqk,bhgqd->bhkd", p, gf))
        dp = torch.einsum("bhgqd,bhkd->bhgqk", gf, vbf)
        ds = p * (dp - d_row[..., None])
        dq = dq + torch.einsum("bhgqk,bhkd->bhgqd", ds, kbf) * scale
        dks.append(torch.einsum("bhgqk,bhgqd->bhkd", ds, qf))
    return dq, torch.cat(dks, 2)[:, :, :Sk], torch.cat(dvs, 2)[:, :, :Sk]


def _grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale):
    """(B, S, H, D) inputs to the grouped layout: qf (B, KV, g, Sq, D)
    float32 times the scale, k and v (B, KV, Sk, ·) in their dtype."""
    B, Sq, H, Dh = q.shape
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv "
                         f"heads")
    qf = q.reshape(B, Sq, KV, H // KV, Dh).permute(0, 2, 3, 1, 4).float() \
        * scale
    return qf, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)


def _ungrouped(x: torch.Tensor) -> torch.Tensor:
    """(B, KV, g, Sq, D) back to (B, Sq, KV * g, D)."""
    B, KV, g, Sq, D = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(B, Sq, KV * g, D)


def _bwd(q, k, v, out, lse, g, *, causal, window, q_offset, kv_len, scale,
         block_k):
    qf, kt, vt = _grouped(q, k, v, scale)
    B, KV, gs, Sq, _ = qf.shape
    gf = g.reshape(B, Sq, KV, gs, -1).permute(0, 2, 3, 1, 4).float()
    dq, dk, dv = _flash_xla_bwd(qf, kt, vt, out, lse, gf, causal=causal,
                                window=window, q_offset=q_offset,
                                kv_len=kv_len, scale=scale, block_k=block_k)
    return (_ungrouped(dq).to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class _FlashXla(torch.autograd.Function):
    """``_flash_xla`` of the reference: the chunked forward, whose
    residuals are the inputs, the float32 output and the logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_len, scale,
                block_k):
        qf, kt, vt = _grouped(q, k, v, scale)
        out, lse = _fa_fwd_scan(qf, kt, vt, causal=causal, window=window,
                                q_offset=q_offset, kv_len=kv_len,
                                block_k=block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset,
                        kv_len=kv_len, scale=scale, block_k=block_k)
        return _ungrouped(out).to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, out, lse, g, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,               # (B, Sq, H, Dqk)
    k: torch.Tensor,               # (B, Sk, KV, Dqk)
    v: torch.Tensor,               # (B, Sk, KV, Dv)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    kv_len: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_k: int = 512,
) -> torch.Tensor:
    """Chunked online-softmax attention, (B, S, H, D) layout, GQA by
    broadcast; ``xla_impl.flash_attention_xla``. Differentiable, with the
    hand-written flash backward; output in q's dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _FlashXla.apply(q, k, v, causal, window, q_offset, kv_len, scale,
                           block_k)


def attention_vjp(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,               # (B, Sq, H, Dv) the output's cotangent
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    scale: Optional[float] = None,
    block_k: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention` at (q, k, v) for the
    cotangent ``g``, from the inputs alone: the chunked forward recomputes
    the float32 output and the logsumexp, then the flash backward runs.
    The backward of K4, as ``jax.vjp(flash_attention_xla)`` is the Pallas
    forward's in the reference (``kernels/ops.py``); no grad is recorded."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    with torch.no_grad():
        qf, kt, vt = _grouped(q, k, v, scale)
        out, lse = _fa_fwd_scan(qf, kt, vt, causal=causal, window=window,
                                q_offset=q_offset, kv_len=None,
                                block_k=block_k)
        del qf, kt, vt
        return _bwd(q, k, v, out, lse, g, causal=causal, window=window,
                    q_offset=q_offset, kv_len=None, scale=scale,
                    block_k=block_k)


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
