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
- the chunked WKV6 and Mamba scans (``wkv6_chunked`` and
  ``mamba_chunked`` there, and here), differentiated by autograd: the
  backward of K6 and K7 (``kernels/ops.py``), as ``jax.vjp`` of them is
  the Pallas forwards' in the reference. They keep its arithmetic:
  float32 throughout, the log-decay clamped at :data:`LOGW_MIN`, the
  midpoint shift, the padding of S, the default chunks (16 and 64). Only
  the batching differs: WKV6 forms every chunk's pair matrix, bonus and
  state increment at once and loops over chunks for the state advance
  alone; Mamba checkpoints each chunk, as the reference's
  ``jax.checkpoint`` does, so that its backward holds one chunk's
  ``(B, c, D, N)`` tensors at a time;
- the single-token steps the reference leaves to XLA rather than to a
  Pallas kernel: decode attention over a KV cache
  (``decode_attention_xla`` there), the RWKV-6 decode step
  (``wkv6_decode``) and the Mamba decode step (``mamba_decode``). For
  context-parallel decode, where the reference's GSPMD partitions that
  softmax over the cache's sequence, :func:`decode_partial` takes one
  block of the slots at its global offset and :func:`decode_merge`
  merges the blocks' partials through a caller's all-reduce.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


# ---------------------------------------------------------------------------
# WKV6 and Mamba: the chunked scans
# ---------------------------------------------------------------------------

LOGW_MIN = -8.0     # the per-step log-decay floor: w >= e^-8 ~= 3.4e-4
WKV6_CHUNK = 16     # the reference's default chunks
MAMBA_CHUNK = 64


def _pad_steps(a: torch.Tensor, s_pad: int, value: float = 0.0
               ) -> torch.Tensor:
    """``a`` (B, S, ...) padded along S to ``s_pad`` steps with
    ``value``."""
    extra = s_pad - a.shape[1]
    if extra == 0:
        return a
    return F.pad(a, [0, 0] * (a.dim() - 2) + [0, extra], value=value)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, whose gradient is
    split in half at a tie (``torch.clamp`` passes all of it)."""
    # the bounds filled on the device: a tensor made from a Python number
    # is copied from the host, and the copy waits for the device
    lo_t = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi_t = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def wkv6_chunked(
    r: torch.Tensor,               # (B, S, H, K)
    k: torch.Tensor,               # (B, S, H, K)
    v: torch.Tensor,               # (B, S, H, V)
    w: torch.Tensor,               # (B, S, H, K) decay in (0, 1)
    u: torch.Tensor,               # (H, K)
    s0: Optional[torch.Tensor] = None,  # (B, H, K, V)
    *,
    chunk: int = WKV6_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RWKV-6 recurrence in chunk-parallel form;
    ``xla_impl.wkv6_chunked``. Returns (y (B, S, H, V) in r's dtype, the
    final state (B, H, K, V) float32).

    Within a chunk of ``c = min(chunk, S)`` steps every pair j < t
    interacts through the relative decay exp(L_{t-1} - L_j), built from
    two factors shifted by the per-channel midpoint M = L_c / 2 so that
    neither under- nor overflows in float32; the per-step log-decay is
    clipped to [``LOGW_MIN``, 0] (w first to [1e-12, 1]). The current
    token adds the bonus (r_t . (u * k_t)) v_t, the state before the
    chunk adds (r_t exp(L_{t-1}))^T S, and the state advances as
    S <- diag(P_c) S + sum_j (k_j P_c / P_j) v_j^T. Padded steps have
    w = 1 and zero r, k and v. Everything but the state advance is formed
    for all chunks at once; the advance is a loop over the chunks, and
    the state before each is kept for the inter-chunk term."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    if s0 is None:
        s0 = torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
    else:
        s0 = s0.float()
    c = min(chunk, S)
    nc = math.ceil(S / c)
    s_pad = nc * c
    rf, kf = (_pad_steps(a, s_pad).float().reshape(B, nc, c, H, K)
              for a in (r, k))
    vf = _pad_steps(v, s_pad).float().reshape(B, nc, c, H, V)
    wf = _clip(_pad_steps(w, s_pad, 1.0).float(), 1e-12, 1.0).reshape(
        B, nc, c, H, K)
    uf = u.float()

    logw = _clip(torch.log(wf), LOGW_MIN, 0.0)             # (B,nc,c,H,K)
    L = torch.cumsum(logw, 2)                              # L_t
    Lprev = L - logw                                       # L_{t-1}
    Lc = L[:, :, -1:]                                      # (B,nc,1,H,K)
    M = 0.5 * Lc
    q_dec = rf * torch.exp(Lprev - M)
    k_dec = kf * torch.exp(M - L)
    pairs = torch.einsum("bnchk,bndhk->bnhcd", q_dec, k_dec)
    lower = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)
    pairs = torch.where(lower, pairs, torch.zeros((), device=r.device))
    y_intra = torch.einsum("bnhcd,bndhv->bnchv", pairs, vf)
    bonus = torch.einsum("bnchk,hk,bnchk->bnch", rf, uf, kf)
    y_bonus = bonus[..., None] * vf
    Pc = torch.exp(Lc[:, :, 0])[..., None]                 # (B,nc,H,K,1)
    k_fold = kf * torch.exp(Lc - L)                        # exps <= 1
    kv = torch.einsum("bnchk,bnchv->bnhkv", k_fold, vf)    # (B,nc,H,K,V)

    # the chunks as views by unbind, whose backward stacks their gradients
    # once (a slice's would write each into a zeroed whole)
    state = s0
    before = []
    for P_i, kv_i in zip(Pc.unbind(1), kv.unbind(1)):
        before.append(state)
        state = P_i * state + kv_i
    y_inter = torch.einsum("bnchk,bnhkv->bnchv", rf * torch.exp(Lprev),
                           torch.stack(before, 1))
    y = y_inter + y_intra + y_bonus                        # (B,nc,c,H,V)
    y = y.reshape(B, s_pad, H, V)[:, :S]
    return y.to(r.dtype), state


def _slice(dim: int, start: int, stop: Optional[int] = None,
           step: int = 1) -> tuple:
    return (slice(None),) * dim + (slice(start, stop, step),)


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int
                ) -> torch.Tensor:
    """a0, b0, a1, b1, ... along ``dim``; ``a`` is as long as ``b`` or one
    longer."""
    n = b.shape[dim]
    out = torch.stack([a.narrow(dim, 0, n), b], dim + 1).flatten(dim,
                                                                 dim + 1)
    if a.shape[dim] > n:
        out = torch.cat([out, a.narrow(dim, n, 1)], dim)
    return out


def associative_scan(
    combine: Callable[[Sequence[torch.Tensor], Sequence[torch.Tensor]],
                      List[torch.Tensor]],
    elems: Sequence[torch.Tensor], dim: int) -> List[torch.Tensor]:
    """The inclusive scan of ``elems`` along ``dim`` under the associative
    ``combine(earlier, later)``, in ``jax.lax.associative_scan``'s order:
    combine adjacent pairs (0, 1), (2, 3), ...; scan those recursively,
    which gives the prefixes at the odd positions; combine each with the
    next even element for the prefixes at the even positions (the first
    is the first element); interleave. log2(n) levels of torch ops."""
    n = elems[0].shape[dim]
    if n < 2:
        return list(elems)
    reduced = combine([e[_slice(dim, 0, -1, 2)] for e in elems],
                      [e[_slice(dim, 1, None, 2)] for e in elems])
    odd = associative_scan(combine, reduced, dim)
    nxt = [e[_slice(dim, 2, None, 2)] for e in elems]
    if n % 2 == 0:
        even = combine([e[_slice(dim, 0, -1)] for e in odd], nxt)
    else:
        even = combine(odd, nxt)
    even = [torch.cat([e[_slice(dim, 0, 1)], x], dim)
            for e, x in zip(elems, even)]
    return [_interleave(a, b, dim) for a, b in zip(even, odd)]


def _linear_combine(e1, e2):
    """h -> a h + b composed: (a1, b1) then (a2, b2)."""
    a1, b1 = e1
    a2, b2 = e2
    return [a2 * a1, a2 * b1 + b2]


def _mamba_chunk(h, xc, dtc, Bc, Cc, Af, Df):
    """One chunk of :func:`mamba_chunked` (the reference's checkpointed
    body): (the state after it (B, D, N), y (B, c, D))."""
    dA = torch.exp(dtc[..., None] * Af)                    # (B,c,D,N)
    dBx = (dtc * xc)[..., None] * Bc[:, :, None, :]        # (B,c,D,N)
    a_cum, b_cum = associative_scan(_linear_combine, (dA, dBx), 1)
    hs = a_cum * h[:, None] + b_cum
    y = torch.einsum("bcdn,bcn->bcd", hs, Cc) + Df * xc
    return hs[:, -1], y


def mamba_chunked(
    x: torch.Tensor,               # (B, S, D)
    dt: torch.Tensor,              # (B, S, D)
    A: torch.Tensor,               # (D, N) negative
    Bm: torch.Tensor,              # (B, S, N)
    C: torch.Tensor,               # (B, S, N)
    D: torch.Tensor,               # (D,)
    h0: Optional[torch.Tensor] = None,  # (B, D, N)
    *,
    chunk: int = MAMBA_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan by chunks; ``xla_impl.mamba_chunked``. Returns
    (y (B, S, D) in x's dtype, the final state (B, D, N) float32).

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t composes associatively as
    (a, b) pairs: within a chunk of ``c = min(chunk, S)`` steps the pairs
    are scanned by :func:`associative_scan` (the reference's
    ``jax.lax.associative_scan``, in its order), and the state carried
    into the chunk is applied after. A loop over the chunks carries the
    state; with grad enabled each chunk is checkpointed
    (``torch.utils.checkpoint``, non-reentrant), so that the backward
    keeps only the chunks' inputs and recomputes one chunk's graph at a
    time. Padded steps are zeros (dA = 1, no input)."""
    B, S, Dm = x.shape
    N = A.shape[-1]
    if h0 is None:
        h = torch.zeros((B, Dm, N), dtype=torch.float32, device=x.device)
    else:
        h = h0.float()
    c = min(chunk, S)
    nc = math.ceil(S / c)
    # the chunks as views by split, whose backward concatenates their
    # gradients once
    parts = zip(*(_pad_steps(a, nc * c).float().split(c, 1)
                  for a in (x, dt, Bm, C)))
    Af, Df = A.float(), D.float()
    ys = []
    for xc, dtc, Bc, Cc in parts:
        args = (h, xc, dtc, Bc, Cc, Af, Df)
        if torch.is_grad_enabled():
            h, y = checkpoint(_mamba_chunk, *args, use_reentrant=False)
        else:
            h, y = _mamba_chunk(*args)
        ys.append(y)
    y = torch.cat(ys, 1)[:, :S]
    return y.to(x.dtype), h


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


def partial_softmax(s: torch.Tensor, mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pieces of a softmax over the last dim of float32 scores ``s``
    that one block of keys contributes: (the weights ``exp(s - m)``
    unnormalised, the block's max ``m`` and its sum of exponentials
    ``l``, both with the last dim kept), the masked entries set to
    ``NEG_INF`` first. ``NEG_INF`` is finite, so a block whose every entry
    is masked has ``m = NEG_INF`` and ``l`` its length: its weight in
    :func:`decode_merge`, ``exp(NEG_INF - M)``, is exactly 0."""
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    return p, m, p.sum(-1, keepdim=True)


def decode_partial(
    q: torch.Tensor,               # (B, 1, H, Dh) single new token
    k_block: torch.Tensor,         # (B, L, KV, Dh) a block of the cache
    v_block: torch.Tensor,         # (B, L, KV, Dv)
    *,
    kv_len: torch.Tensor,          # (B,) valid lengths (new token included)
    offset: int,                   # the block's first global slot
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`decode_attention`'s scores over one block of the cache's
    slots, ``[offset, offset + L)`` of the whole, the global slot masked
    by ``kv_len``: (the float32 output unnormalised (B, 1, H, Dv), the
    running max and the sum of exponentials (B, H, 1, 1) each), for
    :func:`decode_merge`."""
    B, _, H, Dh = q.shape
    L, KV = k_block.shape[1], k_block.shape[2]
    if H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv "
                         f"heads")
    g = H // KV
    scale = scale if scale is not None else Dh ** -0.5
    dev = q.device
    qg = (q.float() * scale).reshape(B, 1, KV, g, Dh)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg, k_block.float())
    kpos = offset + torch.arange(L, device=dev)
    mask = kpos[None, :] < kv_len.to(dev)[:, None]          # (B, L)
    p, m, l = partial_softmax(s, mask[:, None, None, None, :])
    o = torch.einsum("bhgqs,bshd->bqhgd", p, v_block.float())
    Dv = v_block.shape[-1]
    return (o.reshape(B, 1, H, Dv), m.reshape(B, H, 1, 1),
            l.reshape(B, H, 1, 1))


def decode_merge(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                 reduce: Callable[[torch.Tensor, str], torch.Tensor]
                 ) -> torch.Tensor:
    """Merge each rank's partial (``o`` (B, 1, H, Dv) unnormalised, ``m``
    and ``l`` (B, H, 1, 1): :func:`decode_partial`) into the softmax
    over every rank's slots, float32: the largest max over the ranks
    (``reduce(t, "max")``, an in-place all-reduce), each rank's ``o`` and
    ``l`` weighted by ``exp(m - M)`` and summed (``reduce(t, "sum")``,
    one all-reduce of both), then divided."""
    M = reduce(m.clone(), "max")
    w = torch.exp(m - M)                                    # (B, H, 1, 1)
    Dv = o.shape[-1]
    part = torch.cat([o * w.permute(0, 2, 1, 3),
                      (l * w).permute(0, 2, 1, 3)], -1).contiguous()
    tot = reduce(part, "sum")
    return tot[..., :Dv] / tot[..., Dv:]


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
