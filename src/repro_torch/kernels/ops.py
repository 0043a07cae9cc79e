"""Public kernel ops: dispatch between the hand-written CUDA kernels and
their plain PyTorch versions.

The counterpart of ``repro.kernels.ops``. The backend is an argument of
every op, with the fabric backends' names:

  * ``"cuda"`` (the default) -- the hand-written kernel, on CUDA tensors
    only: a CPU tensor raises, and nothing stands in for a missing card,
    a failed build or a refused launch;
  * ``"torch"`` -- the plain PyTorch version, on any device.

Single-token decode attention, attention with a dynamic ``kv_len`` and
the single-token RWKV-6 and Mamba steps are not Pallas kernels in the
reference either (it sends them to XLA): they are torch ops on both
backends, differentiated by autograd.

Gradients. Where the reference wraps a Pallas forward in
``jax.custom_vjp``, the port has a ``torch.autograd.Function``, used
whenever an input requires grad. Its forward is the kernel (``"cuda"``)
or the plain version (``"torch"``) and saves only the inputs; its
backward is the reference's, on both backends:

  * attention -- :func:`repro_torch.kernels.chunked.attention_vjp`, the
    chunked flash backward, which recomputes the output and the
    logsumexp from q, k and v (``jax.vjp(flash_attention_xla)`` there).
    K4's output is not read by it;
  * rmsnorm -- autograd of the plain version ``ref.rmsnorm``.

No backward kernel exists in the reference, and none here. The backward
of K6 and K7 (``wkv6_chunked`` / ``mamba_chunked``) is not ported yet:
on ``"cuda"``, :func:`wkv6` and :func:`mamba_scan` raise
``NotImplementedError`` when an input requires grad, rather than return
a result cut off from the gradient.
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


class _Attention(torch.autograd.Function):
    """K4 (``"cuda"``) or the plain attention (``"torch"``) forward, the
    chunked flash backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale, backend):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset,
                        scale=scale)
        return _attention_fwd(q, k, v, backend=backend, **ctx.opts)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = chunked.attention_vjp(q, k, v, g, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def _attention_fwd(q, k, v, *, causal, window, q_offset, scale, backend):
    if backend == "torch":
        return ref.attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, scale=scale)
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset, scale=scale)


def _needs_grad(*ts: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and \
        any(t is not None and t.requires_grad for t in ts)


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
    (the reference's kernel takes a static kv length only; autograd of
    the plain version differentiates it). Differentiable on both
    backends: the backward is the chunked flash backward."""
    check_backend(backend, q)
    if kv_len is not None:
        return ref.attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, kv_len=kv_len, scale=scale)
    if _needs_grad(q, k, v):
        return _Attention.apply(q, k, v, causal, window, q_offset, scale,
                                backend)
    return _attention_fwd(q, k, v, causal=causal, window=window,
                          q_offset=q_offset, scale=scale, backend=backend)


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


class _RMSNorm(torch.autograd.Function):
    """K5 (``"cuda"``) or the plain RMSNorm (``"torch"``) forward; the
    backward is autograd of the plain version, recomputed from x and
    scale."""

    @staticmethod
    def forward(ctx, x, scale, eps, backend):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rmsnorm_fwd(x, scale, eps, backend=backend)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, ds = rmsnorm_vjp(x, scale, g, ctx.eps,
                             needs=ctx.needs_input_grad[:2])
        return dx, ds, None, None


def rmsnorm_vjp(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                eps: float, needs=(True, True)):
    """(dx, dscale) of RMSNorm at (x, scale) for the cotangent ``g``:
    autograd of the plain version, recomputed from the inputs (``None``
    where ``needs`` says no)."""
    with torch.enable_grad():
        xd = x.detach().requires_grad_(needs[0])
        sd = scale.detach().requires_grad_(needs[1])
        y = ref.rmsnorm(xd, sd, eps)
        wrt = [t for t in (xd, sd) if t.requires_grad]
        grads = iter(torch.autograd.grad(y, wrt, g))
    return (next(grads) if needs[0] else None,
            next(grads) if needs[1] else None)


def _rmsnorm_fwd(x, scale, eps, *, backend):
    if backend == "torch":
        return ref.rmsnorm(x, scale, eps)
    return rmsnorm_kernel(x, scale, eps)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5, *,
            backend: str = "cuda") -> torch.Tensor:
    """RMSNorm: K5 on ``"cuda"``, the plain version on ``"torch"``.
    Differentiable on both backends (autograd of the plain version)."""
    check_backend(backend, x)
    if _needs_grad(x, scale):
        return _RMSNorm.apply(x, scale, eps, backend)
    return _rmsnorm_fwd(x, scale, eps, backend=backend)


def _refuse_grad(op: str, *ts: Optional[torch.Tensor]) -> None:
    if _needs_grad(*ts):
        raise NotImplementedError(
            f"{op} on backend='cuda' has no backward yet: the reference's "
            f"chunked backward of its kernel comes with ROADMAP.md Queue 1 "
            f"item 9b (RWKV-6 and Jamba training)")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor,
         s0: Optional[torch.Tensor] = None, *, backend: str = "cuda"
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence -> (y, final state): K6 on ``"cuda"``, the plain
    sequential recurrence on ``"torch"`` (differentiated by autograd).
    ``"cuda"`` raises ``NotImplementedError`` when an input requires
    grad."""
    if backend == "cuda":
        _refuse_grad("wkv6", r, k, v, w, u, s0)
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
    plain sequential recurrence on ``"torch"`` (differentiated by
    autograd). ``h0=None`` is zeros. ``"cuda"`` raises
    ``NotImplementedError`` when an input requires grad."""
    if backend == "cuda":
        _refuse_grad("mamba_scan", x, dt, A, Bm, C, D, h0)
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
