"""K7, the Mamba-1 selective scan, in CUDA C++.

Replaces the Pallas TPU kernel ``repro.kernels.mamba_scan._mamba_kernel``
(wrapper ``mamba_scan``). The kernel is ``mamba_scan_fwd_kernel`` in
``repro_torch/csrc/model_kernels.cu``; its note says what bounds it on the
card and how its design answers that. Its plain PyTorch version is
:func:`plain` (``repro_torch.kernels.ref.mamba_scan``, the sequential
recurrence), its launch count is
``cuda_kernels.launch_counts()["mamba_scan"]``.

Public layout as in the reference: x, dt ``(B, S, Din)``, A ``(Din, N)``,
B, C ``(B, S, N)``, D ``(Din,)``, h0 ``(B, Din, N)``; returns y
``(B, S, Din)`` in x's dtype and the final state ``(B, Din, N)`` in
float32. The kernel reads x, dt, B and C through their strides (x and dt
by 16-byte ``cp.async`` copies where their rows are 16-byte aligned,
element by element otherwise) and masks the ragged edges of S and Din
itself: no copy and no padding.

Rounding: the kernel rounds the state as the plain version does (dt A,
dt x, (dt x) B, dA h and their sum each one correctly rounded float32
operation, ``expf`` for the exponential), so ``h_out`` is the plain
version's bits, whatever the chunk. Only y's sum over n runs in another
order; it is held to the plain version at 2e-4 (float32) and 2e-2
(bfloat16).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import cuda_kernels
from repro_torch.kernels.ref import mamba_scan as plain

MAX_GRID_Y = 65535                  # B blocks along the grid's y axis


def _check(x, dt, A, Bm, C, D, h0) -> None:
    for name, t in (("x", x), ("dt", dt), ("B", Bm), ("C", C)):
        if t.dim() != 3:
            raise ValueError(f"mamba_scan: {name} must be 3-D, got shape "
                             f"{tuple(t.shape)}")
        if t.dtype not in cuda_kernels.DTYPE_CODES:
            raise ValueError(f"mamba_scan takes torch.float32 or "
                             f"torch.bfloat16; {name} is {t.dtype}")
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"mamba_scan: {name} is {t.dtype} on "
                             f"{t.device}, x is {x.dtype} on {x.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"mamba_scan: {name}'s last dimension must be "
                             f"contiguous (stride {t.stride(-1)})")
    Bsz, S, Din = x.shape
    N = A.shape[-1] if A.dim() == 2 else -1
    if dt.shape != x.shape or Bm.shape != (Bsz, S, N) or C.shape != Bm.shape:
        raise ValueError(f"mamba_scan: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(C.shape)} do not "
                         f"match")
    if N not in cuda_kernels.MAMBA_STATE_DIMS:
        raise ValueError(f"mamba_scan: state dim N = {N} not in "
                         f"{cuda_kernels.MAMBA_STATE_DIMS}")
    if Bsz > MAX_GRID_Y:
        raise ValueError(f"mamba_scan: batch {Bsz} exceeds {MAX_GRID_Y}")
    for name, t, shape in (("A", A, (Din, N)), ("D", D, (Din,)),
                           ("h0", h0, (Bsz, Din, N))):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"mamba_scan: {name} must be torch.float32 on "
                             f"{x.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"mamba_scan: {name} must be a contiguous "
                             f"{shape}, got {tuple(t.shape)}")


def mamba_scan(
    x: torch.Tensor,                   # (B, S, Din)
    dt: torch.Tensor,                  # (B, S, Din)
    A: torch.Tensor,                   # (Din, N) float32
    Bm: torch.Tensor,                  # (B, S, N)
    C: torch.Tensor,                   # (B, S, N)
    D: torch.Tensor,                   # (Din,) float32
    h0: Optional[torch.Tensor] = None,  # (B, Din, N) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan -> (y (B,S,Din) in x's dtype, h_out (B,Din,N)
    float32): the kernel for CUDA tensors, the plain version for CPU
    tensors. Raises on any other device, and on a dtype, layout or N the
    kernel does not take, and when the build or the launch fails."""
    if x.device.type == "cpu":
        return plain(x, dt, A, Bm, C, D, h0)
    if x.device.type != "cuda":
        raise ValueError(f"mamba_scan runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    _check(x, dt, A, Bm, C, D, h0)
    Bsz, S, Din = x.shape
    N = A.shape[-1]
    y = torch.empty((Bsz, S, Din), dtype=x.dtype, device=x.device)
    h_out = torch.empty((Bsz, Din, N), dtype=torch.float32, device=x.device)
    if Bsz * Din == 0:
        return y, h_out
    cuda_kernels.mamba_scan_fwd(x, dt, A, Bm, C, D, h0, y, h_out)
    return y, h_out
