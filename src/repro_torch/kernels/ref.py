"""Plain PyTorch versions of the model kernels: the oracles the hand-written
CUDA kernels are held against on the card, and what runs where the caller
asks for the CPU or for ``backend="torch"``.

The counterpart of ``repro.kernels.ref`` for the serving path: ``rmsnorm``,
``attention`` (GQA / causal / sliding window / ``q_offset`` / ``kv_len``),
``swiglu``, ``wkv6`` and ``mamba_scan``, operation for operation but for
RMSNorm's mean of squares (formed in float64, see :func:`rmsnorm`).
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """RMSNorm over the last dim. x: (..., D), scale: (D,).

    ``x * rsqrt(mean(x^2) + eps) * scale`` in float32, with the mean of
    squares formed in float64 and rounded once to float32: the squares are
    exact there and the sum's error is far below float32's rounding, so
    the mean is the correctly rounded one in any summation order. The
    reciprocal square root is sqrt then 1/x, both correctly rounded
    (``torch.rsqrt`` is an approximation on the card)."""
    xd = x.double()
    var = (xd * xd).mean(dim=-1, keepdim=True).float()
    y = x.float() * torch.sqrt(var + eps).reciprocal()
    return (y * scale.float()).to(x.dtype)


def attention(
    q: torch.Tensor,               # (B, Sq, H, Dh)
    k: torch.Tensor,               # (B, Sk, KV, Dh)
    v: torch.Tensor,               # (B, Sk, KV, Dv)
    *,
    causal: bool = True,
    window: int = 0,               # 0 => full; else sliding window size
    q_offset: Union[int, torch.Tensor] = 0,  # absolute position of q[0]
    kv_len: Optional[torch.Tensor] = None,   # (B,) valid kv length
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Naive full-softmax attention with GQA / causal / SWA / cache mask."""
    B, Sq, H, Dh = q.shape
    _, Sk, KV, Dv = v.shape
    if H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv "
                         f"heads")
    g = H // KV
    scale = scale if scale is not None else Dh ** -0.5
    dev = q.device

    qf = q.float() * scale
    kf = k.float()
    vf = v.float()
    qg = qf.reshape(B, Sq, KV, g, Dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf)

    # q_offset may be a scalar or a per-batch (B,) tensor (cache decode)
    qpos = torch.arange(Sq, device=dev)[None, :]             # (B or 1, Sq)
    if isinstance(q_offset, torch.Tensor) and q_offset.dim():
        qpos = qpos + q_offset.to(dev).reshape(-1, 1)
    else:
        qpos = qpos + q_offset
    kpos = torch.arange(Sk, device=dev)
    mask = torch.ones((qpos.shape[0], Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos[None, None, :] <= qpos[:, :, None]
    if window and window > 0:
        mask &= kpos[None, None, :] > (qpos[:, :, None] - window)
    mask = mask[:, None, None].expand(B, 1, 1, Sq, Sk)
    if kv_len is not None:
        mask = mask & (kpos[None, None, None, None, :]
                       < kv_len.to(dev)[:, None, None, None, None])
    logits = logits.masked_fill(~mask, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    return out.reshape(B, Sq, H, Dv).to(q.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: silu(x@wg) * (x@wu) @ wd."""
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def wkv6(
    r: torch.Tensor,                   # (B, S, H, K)
    k: torch.Tensor,                   # (B, S, H, K)
    v: torch.Tensor,                   # (B, S, H, V)
    w: torch.Tensor,                   # (B, S, H, K) decay in (0,1)
    u: torch.Tensor,                   # (H, K) bonus for the current token
    s0: Optional[torch.Tensor] = None,  # (B, H, K, V) initial state
):
    """RWKV-6 linear-attention recurrence (data-dependent decay).

    y_t = r_t @ (S_t + u * (k_t ⊗ v_t))
    S_{t+1} = w_t[:,None] * S_t + k_t ⊗ v_t
    Returns (y: (B,S,H,V) in r's dtype, s_out: (B,H,K,V) float32). Math in
    float32, one token at a time (the reference's ``lax.scan``).
    """
    B, S, H, K = r.shape
    V = v.shape[-1]
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[None, :, :, None]                     # (1,H,K,1)
    if s0 is None:
        state = torch.zeros((B, H, K, V), dtype=torch.float32,
                            device=r.device)
    else:
        state = s0.float()
    ys = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B,H,K,V)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], state + uf * kv))
        state = wf[:, t, :, :, None] * state + kv
    y = torch.stack(ys, dim=1) if ys else \
        torch.zeros((B, 0, H, V), dtype=torch.float32, device=r.device)
    return y.to(r.dtype), state


def mamba_scan(
    x: torch.Tensor,                   # (B, S, D) post-conv, post-silu input
    dt: torch.Tensor,                  # (B, S, D) softplus'd timestep
    A: torch.Tensor,                   # (D, N) negative (= -exp(A_log))
    Bm: torch.Tensor,                  # (B, S, N)
    C: torch.Tensor,                   # (B, S, N)
    D: torch.Tensor,                   # (D,)
    h0: Optional[torch.Tensor] = None,  # (B, D, N)
):
    """Selective state-space scan (Mamba-1).

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t;
    y_t = C_t . h_t + D * x_t
    Returns (y: (B,S,D) in x's dtype, h_out: (B,D,N) float32). Math in
    float32, one token at a time (the reference's ``lax.scan``).
    """
    B, S, Dm = x.shape
    N = A.shape[-1]
    xf, dtf, Bf, Cf = (a.float() for a in (x, dt, Bm, C))
    Af = A.float()
    if h0 is None:
        h = torch.zeros((B, Dm, N), dtype=torch.float32, device=x.device)
    else:
        h = h0.float()
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, t, :, None] * Af[None])           # (B,D,N)
        dBx = (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else \
        torch.zeros((B, 0, Dm), dtype=torch.float32, device=x.device)
    y = y + xf * D.float()[None, None, :]
    return y.to(x.dtype), h
