"""Public kernel ops: dispatch between the hand-written CUDA kernels and
their plain PyTorch versions.

The counterpart of ``repro.kernels.ops``, forward only. The backend is an
argument of every op, with the fabric backends' names:

  * ``"cuda"`` (the default) -- the hand-written kernel, on CUDA tensors
    only: a CPU tensor raises, and nothing stands in for a missing card,
    a failed build or a refused launch;
  * ``"torch"`` -- the plain PyTorch version, on any device.

Single-token decode attention, attention with a dynamic ``kv_len`` and
the single-token RWKV-6 and Mamba steps are not Pallas kernels in the
reference either (it sends them to XLA): they are torch ops on both
backends.
Gradients (``custom_vjp`` there, ``torch.autograd.Function`` here) come
with the training slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import chunked, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba_scan import mamba_scan as mamba_scan_kernel
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_kernel
from repro_torch.kernels.wkv6 import wkv6 as wkv6_kernel

BACKENDS = ("cuda", "torch")


def check_backend(backend: str, x: torch.Tensor) -> None:
    """Raise unless ``backend`` is known and can run on ``x``'s device."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend == "cuda" and x.device.type != "cuda":
        raise ValueError(
            f"backend='cuda' runs the hand-written kernels on CUDA tensors; "
            f"got a tensor on {x.device}. backend='torch' is the plain "
            f"version and runs on the CPU")


def attention(
    q: torch.Tensor,               # (B, Sq, H, Dh)
    k: torch.Tensor,               # (B, Sk, KV, Dh)
    v: torch.Tensor,               # (B, Sk, KV, Dv)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    kv_len: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    backend: str = "cuda",
) -> torch.Tensor:
    """Attention (causal / GQA / SWA): K4 on ``"cuda"``; the plain version
    on ``"torch"`` and, on both, whenever a dynamic ``kv_len`` is given
    (the reference's kernel takes a static kv length only)."""
    check_backend(backend, q)
    if backend == "torch" or kv_len is not None:
        return ref.attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, kv_len=kv_len, scale=scale)
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset, scale=scale)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    *,
    kv_len: torch.Tensor,
    window: int = 0,
    scale: Optional[float] = None,
    backend: str = "cuda",
) -> torch.Tensor:
    """Single-token decode over a KV cache: torch ops on both backends, as
    the reference keeps it on XLA (a one-token GEMV)."""
    check_backend(backend, q)
    return chunked.decode_attention(q, k_cache, v_cache, kv_len=kv_len,
                                    window=window, scale=scale)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5, *,
            backend: str = "cuda") -> torch.Tensor:
    """RMSNorm: K5 on ``"cuda"``, the plain version on ``"torch"``."""
    check_backend(backend, x)
    if backend == "torch":
        return ref.rmsnorm(x, scale, eps)
    return rmsnorm_kernel(x, scale, eps)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor,
         s0: Optional[torch.Tensor] = None, *, backend: str = "cuda"
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence -> (y, final state): K6 on ``"cuda"``, the plain
    sequential recurrence on ``"torch"``."""
    check_backend(backend, r)
    if backend == "torch":
        return ref.wkv6(r, k, v, w, u, s0)
    return wkv6_kernel(r, k, v, w, u, s0)


def wkv6_decode(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
                backend: str = "cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token RWKV-6 step: torch ops on both backends, as the
    reference keeps it on XLA."""
    check_backend(backend, r)
    return chunked.wkv6_decode(r, k, v, w, u, state)


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
               h0: Optional[torch.Tensor] = None, *, backend: str = "cuda"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 selective scan -> (y, final state): K7 on ``"cuda"``, the
    plain sequential recurrence on ``"torch"``. ``h0=None`` is zeros."""
    check_backend(backend, x)
    if backend == "torch":
        return ref.mamba_scan(x, dt, A, Bm, C, D, h0)
    return mamba_scan_kernel(x, dt, A, Bm, C, D, h0)


def mamba_decode(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                 h: torch.Tensor, *, backend: str = "cuda"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token Mamba step: torch ops on both backends, as the
    reference keeps it on XLA."""
    check_backend(backend, x)
    return chunked.mamba_decode(x, dt, A, Bm, C, D, h)
