"""K6, the RWKV-6 (WKV6) forward recurrence, in CUDA C++.

Replaces the Pallas TPU kernel ``repro.kernels.wkv6._wkv6_kernel``
(wrapper ``wkv6``). The kernel is ``wkv6_fwd_kernel`` in
``repro_torch/csrc/model_kernels.cu``; its note says what bounds it on the
card and how its design answers that. Its plain PyTorch version is
:func:`plain` (``repro_torch.kernels.ref.wkv6``, the sequential
recurrence), its launch count is ``cuda_kernels.launch_counts()["wkv6"]``.

Public layout as in the reference: r, k, w ``(B, S, H, K)``, v
``(B, S, H, V)``, u ``(H, K)``, s0 ``(B, H, K, V)``; returns y
``(B, S, H, V)`` in r's dtype and the final state ``(B, H, K, V)`` in
float32. The kernel reads the inputs through their strides: no
``moveaxis`` copy and no padding of S. Its final state is the plain
version's bits (each state element is rounded as the plain version rounds
it); y is summed in another order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import cuda_kernels
from repro_torch.kernels.ref import wkv6 as plain

MAX_GRID_Y = 65535                  # B * H blocks along the grid's y axis


def _check(r, k, v, w, u, s0) -> None:
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.dim() != 4:
            raise ValueError(f"wkv6: {name} must be 4-D, got shape "
                             f"{tuple(t.shape)}")
        if t.dtype not in cuda_kernels.DTYPE_CODES:
            raise ValueError(f"wkv6 takes torch.float32 or torch.bfloat16; "
                             f"{name} is {t.dtype}")
        if t.device != r.device or t.dtype != r.dtype:
            raise ValueError(f"wkv6: {name} is {t.dtype} on {t.device}, r "
                             f"is {r.dtype} on {r.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"wkv6: {name}'s last dimension must be "
                             f"contiguous (stride {t.stride(-1)})")
    B, S, H, K = r.shape
    V = v.shape[-1]
    if k.shape != r.shape or w.shape != r.shape or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"wkv6: r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, w {tuple(w.shape)} do not match")
    if K not in cuda_kernels.WKV_KEY_DIMS:
        raise ValueError(f"wkv6: key dim K = {K} not in "
                         f"{cuda_kernels.WKV_KEY_DIMS}")
    if not 1 <= V <= cuda_kernels.WKV_MAX_V:
        raise ValueError(f"wkv6: value dim V = {V} not in 1 .. "
                         f"{cuda_kernels.WKV_MAX_V}")
    if B * H > MAX_GRID_Y:
        raise ValueError(f"wkv6: B * H = {B * H} exceeds {MAX_GRID_Y}")
    for name, t, shape in (("u", u, (H, K)), ("s0", s0, (B, H, K, V))):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.device != r.device:
            raise ValueError(f"wkv6: {name} must be torch.float32 on "
                             f"{r.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"wkv6: {name} must be a contiguous {shape}, "
                             f"got {tuple(t.shape)}")


def wkv6(
    r: torch.Tensor,                   # (B, S, H, K)
    k: torch.Tensor,                   # (B, S, H, K)
    v: torch.Tensor,                   # (B, S, H, V)
    w: torch.Tensor,                   # (B, S, H, K) decay in (0,1)
    u: torch.Tensor,                   # (H, K) float32
    s0: Optional[torch.Tensor] = None,  # (B, H, K, V) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence -> (y (B,S,H,V) in r's dtype, s_out (B,H,K,V)
    float32): the kernel for CUDA tensors, the plain version for CPU
    tensors. Raises on any other device, and on a dtype, layout or K the
    kernel does not take, and when the build or the launch fails."""
    if r.device.type == "cpu":
        return plain(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on CUDA or CPU tensors, got {r.device}")
    _check(r, k, v, w, u, s0)
    B, S, H, K = r.shape
    V = v.shape[-1]
    y = torch.empty((B, S, H, V), dtype=r.dtype, device=r.device)
    s_out = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    if B * H == 0:
        return y, s_out
    cuda_kernels.wkv6_fwd(r, k, v, w, u, s0, y, s_out)
    return y, s_out
