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
  * rmsnorm -- autograd of the plain version ``ref.rmsnorm``;
  * wkv6 and mamba_scan -- autograd of the chunked scans,
    :func:`repro_torch.kernels.chunked.wkv6_chunked` (chunk 16) and
    :func:`~repro_torch.kernels.chunked.mamba_chunked` (chunk 64),
    recomputed from the inputs (``jax.vjp`` of ``xla_impl``'s there).
    With the cotangents of y and of the final state; the state's is
    ``None`` when the final state is not used, as in training.

On the meta device (the dry run's trace, ``launch.steps.lower_*``) the
plain forwards of attention, wkv6 and mamba_scan are the chunked forms,
those the backward differentiates and the reference's XLA path: the
full-softmax attention would hold an S x S float32 score per head (343
GB a rank for MiniCPM3's 32k-token prefill), which K4 never does, and
the recurrence one token at a time would dispatch some 15 ops a token,
minutes of host time for a 32k-token layer with no values behind them.
The chunked attention counts the same FLOPs as the full one where the
keys are a multiple of its 512-key block. On a real device the plain
forwards are always the full softmax and the sequential recurrences.

This split is the reference's, and so is what it implies for WKV6: the
forward (K6, the Pallas kernel, or the plain recurrence) keeps no clamp
of the decay, while the backward is the gradient of the chunked form,
which clamps the per-step log-decay at ``chunked.LOGW_MIN`` (-8). For a
decay below e^-8 the gradient is not that of the forward that ran
(``ROADMAP.md`` Queue 3 item 6). No backward kernel exists in the
reference, and none here.
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
        if q.is_meta:
            return chunked.flash_attention(q, k, v, causal=causal,
                                           window=window, q_offset=q_offset,
                                           scale=scale)
        return ref.attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, scale=scale)
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset, scale=scale)


def _needs_grad(*ts: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and \
        any(t is not None and t.requires_grad for t in ts)


def _vjp(fn, inputs, cotangents, needs):
    """The gradients of ``fn``'s outputs at ``inputs`` for
    ``cotangents`` (an output whose cotangent is ``None`` is left out),
    recomputed under grad; ``None`` for an input that is ``None`` or that
    ``needs`` does not ask for."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(bool(n))
                  for t, n in zip(inputs, needs)]
        outs = fn(*leaves)
        pairs = [(o, g) for o, g in zip(outs, cotangents) if g is not None]
        wrt = [t for t in leaves if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                         [g for _, g in pairs]))
        return tuple(next(grads) if t is not None and t.requires_grad
                     else None for t in leaves)


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
    return _vjp(lambda x, s: (ref.rmsnorm(x, s, eps),), (x, scale), (g,),
                needs)


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


class _WKV6(torch.autograd.Function):
    """K6 (``"cuda"``) or the plain recurrence (``"torch"``) forward,
    with no clamp; the backward is :func:`wkv6_vjp`."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, backend):
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.set_materialize_grads(False)
        return _wkv6_fwd(r, k, v, w, u, s0, backend=backend)

    @staticmethod
    def backward(ctx, gy, gs):
        return (*wkv6_vjp(*ctx.saved_tensors, gy, gs,
                          needs=ctx.needs_input_grad[:6]), None)


def wkv6_vjp(r, k, v, w, u, s0, gy, gs, needs=(True,) * 6):
    """(dr, dk, dv, dw, du, ds0) of the chunked WKV6 at the inputs for
    the cotangents of y and of the final state (either may be ``None``):
    autograd of :func:`chunked.wkv6_chunked`, recomputed from the
    inputs."""
    return _vjp(chunked.wkv6_chunked, (r, k, v, w, u, s0), (gy, gs), needs)


def _wkv6_fwd(r, k, v, w, u, s0, *, backend):
    if backend == "torch":
        if r.is_meta:
            return chunked.wkv6_chunked(r, k, v, w, u, s0)
        return ref.wkv6(r, k, v, w, u, s0)
    return wkv6_kernel(r, k, v, w, u, s0)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor,
         s0: Optional[torch.Tensor] = None, *, backend: str = "cuda"
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence -> (y, final state): K6 on ``"cuda"``, the plain
    sequential recurrence on ``"torch"``. Differentiable on both
    backends: the backward is the chunked WKV6's (:func:`wkv6_vjp`)."""
    check_backend(backend, r)
    if _needs_grad(r, k, v, w, u, s0):
        return _WKV6.apply(r, k, v, w, u, s0, backend)
    return _wkv6_fwd(r, k, v, w, u, s0, backend=backend)


def wkv6_decode(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
                backend: str = "cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token RWKV-6 step: torch ops on both backends, as the
    reference keeps it on XLA."""
    check_backend(backend, r)
    return chunked.wkv6_decode(r, k, v, w, u, state)


class _MambaScan(torch.autograd.Function):
    """K7 (``"cuda"``) or the plain recurrence (``"torch"``) forward; the
    backward is :func:`mamba_scan_vjp`."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, C, D, h0, backend):
        ctx.save_for_backward(x, dt, A, Bm, C, D, h0)
        ctx.set_materialize_grads(False)
        return _mamba_scan_fwd(x, dt, A, Bm, C, D, h0, backend=backend)

    @staticmethod
    def backward(ctx, gy, gh):
        return (*mamba_scan_vjp(*ctx.saved_tensors, gy, gh,
                                needs=ctx.needs_input_grad[:7]), None)


def mamba_scan_vjp(x, dt, A, Bm, C, D, h0, gy, gh, needs=(True,) * 7):
    """(dx, ddt, dA, dB, dC, dD, dh0) of the chunked selective scan at the
    inputs for the cotangents of y and of the final state (either may be
    ``None``): autograd of :func:`chunked.mamba_chunked`, recomputed from
    the inputs, one checkpointed chunk at a time."""
    return _vjp(chunked.mamba_chunked, (x, dt, A, Bm, C, D, h0), (gy, gh),
                needs)


def _mamba_scan_fwd(x, dt, A, Bm, C, D, h0, *, backend):
    if backend == "torch":
        if x.is_meta:
            return chunked.mamba_chunked(x, dt, A, Bm, C, D, h0)
        return ref.mamba_scan(x, dt, A, Bm, C, D, h0)
    return mamba_scan_kernel(x, dt, A, Bm, C, D, h0)


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
               h0: Optional[torch.Tensor] = None, *, backend: str = "cuda"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 selective scan -> (y, final state): K7 on ``"cuda"``, the
    plain sequential recurrence on ``"torch"``. ``h0=None`` is zeros.
    Differentiable on both backends: the backward is the chunked scan's
    (:func:`mamba_scan_vjp`)."""
    check_backend(backend, x)
    if _needs_grad(x, dt, A, Bm, C, D, h0):
        return _MambaScan.apply(x, dt, A, Bm, C, D, h0, backend)
    return _mamba_scan_fwd(x, dt, A, Bm, C, D, h0, backend=backend)


def mamba_decode(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                 h: torch.Tensor, *, backend: str = "cuda"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token Mamba step: torch ops on both backends, as the
    reference keeps it on XLA."""
    check_backend(backend, x)
    return chunked.mamba_decode(x, dt, A, Bm, C, D, h)
