"""K4, flash-attention forward (causal / GQA / sliding window), in CUDA C++.

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention._flash_kernel``
(wrapper ``flash_attention``). The kernel is ``flash_fwd_kernel`` in
``repro_torch/csrc/model_kernels.cu``; its note says what bounds it on the
card and how its design answers that. Its plain PyTorch version is
:func:`plain` (``repro_torch.kernels.ref.attention``), its launch count is
``cuda_kernels.launch_counts()["flash_attention"]``.

Public layout as in the reference: q ``(B, Sq, H, D)``, k and v
``(B, Sk, KV, D)``; output ``(B, Sq, H, D)`` in q's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda_kernels
from repro_torch.kernels.ref import attention as plain

MAX_GRID_Y = 65535                  # B * H blocks along the grid's y axis


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got "
                             f"shape {tuple(t.shape)}")
        if t.dtype not in cuda_kernels.DTYPE_CODES:
            raise ValueError(f"flash_attention takes torch.float32 or "
                             f"torch.bfloat16; {name} is {t.dtype}")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last dimension "
                             f"must be contiguous (stride {t.stride(-1)})")
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"match")
    if H % k.shape[2]:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {k.shape[2]} kv heads")
    if D not in cuda_kernels.HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in "
                         f"{cuda_kernels.HEAD_DIMS}")
    if B * H > MAX_GRID_Y:
        raise ValueError(f"flash_attention: B * H = {B * H} exceeds "
                         f"{MAX_GRID_Y}")


def flash_attention(
    q: torch.Tensor,               # (B, Sq, H, D)
    k: torch.Tensor,               # (B, Sk, KV, D)
    v: torch.Tensor,               # (B, Sk, KV, D)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Forward attention: the kernel for CUDA tensors, the plain version
    for CPU tensors. Raises on any other device, dtype, layout or head dim
    the kernel does not take, and when the build or the launch fails."""
    D = q.shape[-1]
    scale = scale if scale is not None else D ** -0.5
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window,
                     q_offset=q_offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    _check(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    cuda_kernels.flash_attention_fwd(q, k, v, out, scale=scale,
                                     causal=causal, window=window,
                                     q_offset=q_offset)
    return out
