"""K5, fused RMSNorm, in CUDA C++.

Replaces the Pallas TPU kernel ``repro.kernels.rmsnorm._rmsnorm_kernel``
(wrapper ``rmsnorm``). The kernel is ``rmsnorm_kernel`` in
``repro_torch/csrc/model_kernels.cu``; its note says what bounds it on the
card, how its design answers that, and why it uses ``1 / sqrtf``. Its plain
PyTorch version is :func:`plain` (``repro_torch.kernels.ref.rmsnorm``),
its launch count is ``cuda_kernels.launch_counts()["rmsnorm"]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_kernels
from repro_torch.kernels.ref import rmsnorm as plain


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """``x * rsqrt(mean(x^2, -1) + eps) * scale`` in float32, output in x's
    dtype: the kernel for CUDA tensors, the plain version for CPU tensors.
    x: ``(..., D)`` contiguous; scale: ``(D,)``. Raises on what the kernel
    does not take, and when the build or the launch fails."""
    if x.device.type == "cpu":
        return plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    for name, t in (("x", x), ("scale", scale)):
        if t.dtype not in cuda_kernels.DTYPE_CODES:
            raise ValueError(f"rmsnorm takes torch.float32 or "
                             f"torch.bfloat16; {name} is {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"rmsnorm: {name} is on {t.device}, x is on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"rmsnorm: {name} must be contiguous")
    if x.dim() < 1 or scale.shape != (x.shape[-1],):
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} does not "
                         f"match x {tuple(x.shape)}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    cuda_kernels.rmsnorm_fwd(x, scale, out, eps)
    return out
