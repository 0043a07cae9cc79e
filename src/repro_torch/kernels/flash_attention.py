"""K4, flash-attention forward (causal / GQA / sliding window), in CUDA C++.

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention._flash_kernel``
(wrapper ``flash_attention``). Two kernels in
``repro_torch/csrc/model_kernels.cu``, one per dtype, picked by
:func:`select_kernel`:

- ``torch.bfloat16``: ``flash_fwd_wgmma_kernel``, on the tensor cores
  (``wgmma`` on tiles that TMA copies into shared memory). TMA needs every
  base address, and every stride of a dimension longer than 1, to be a
  multiple of 16 bytes; a bfloat16 input that is not is refused with
  ``ValueError``, never sent another way. The prefill's q, k and v,
  slices of one fused (B, S, 2 KV, D) tensor, and MLA's v, the slice
  ``kv[..., dn:]`` of its (B, S, H, dn + dv) product (128 bytes into each
  row at dn 64), always qualify; nothing is copied to make them
  contiguous.
- ``torch.float32``: ``flash_fwd_kernel``, float32 FMAs on the CUDA cores:
  the 2e-5 float32 tolerance rules out TF32, the tensor cores' only
  float32 path.

Their notes in the source say what bounds each on the card and how its
design answers that. The plain PyTorch version is :func:`plain`
(``repro_torch.kernels.ref.attention``); both kernels count under
``cuda_kernels.launch_counts()["flash_attention"]``.

Public layout as ``repro.kernels.ops.attention`` documents it: q
``(B, Sq, H, Dqk)``, k ``(B, Sk, KV, Dqk)``, v ``(B, Sk, KV, Dv)``;
output ``(B, Sq, H, Dv)`` in q's dtype. (Dqk, Dv) is one of the built
pairs ``cuda_kernels.HEAD_DIMS``: equal dims 32, 64 and 128, and MLA's
96 / 64 (MiniCPM3) and 192 / 128 (DeepSeek-V3); any other pair raises
``ValueError``. The Pallas kernel takes v's head dim from q's, so for
Dqk != Dv it is not the oracle: the JAX XLA path
(``xla_impl.flash_attention_xla``) is, and the plain version computes it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda_kernels
from repro_torch.kernels.ref import attention as plain

MAX_GRID_Y = 65535                  # blocks along a grid's y axis
WGMMA_BQ = 128                      # query rows per block of the bf16 kernel
TMA_ALIGN = 16                      # bytes, of TMA's base addresses and strides


def select_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The K4 kernel for these inputs, by dtype: ``"flash_fwd_wgmma_kernel"``
    for bfloat16, ``"flash_fwd_kernel"`` for float32. Raises ``ValueError``
    for a bfloat16 input whose base address, or the stride of a dimension
    longer than 1, is not a multiple of 16 bytes (TMA cannot read it), and
    for any other dtype. Reads only dtypes, pointers, shapes and strides, so
    it runs on CPU tensors as well."""
    if q.dtype == torch.float32:
        return "flash_fwd_kernel"
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention takes torch.float32 or "
                         f"torch.bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        size = t.element_size()
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(
                f"flash_attention: {name}'s base address is not a multiple "
                f"of {TMA_ALIGN} bytes, which the bfloat16 kernel's TMA "
                f"copies need (offset {t.data_ptr() % TMA_ALIGN})")
        for dim, (n, st) in enumerate(zip(t.shape[:3], t.stride()[:3])):
            if n > 1 and (st * size) % TMA_ALIGN:
                raise ValueError(
                    f"flash_attention: {name}'s stride {st} along dimension "
                    f"{dim} is not a multiple of {TMA_ALIGN} bytes, which "
                    f"the bfloat16 kernel's TMA copies need")
    return "flash_fwd_wgmma_kernel"


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
    B, Sq, H, Dqk = q.shape
    Dv = v.shape[3]
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != Dqk:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"match")
    if H % k.shape[2]:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {k.shape[2]} kv heads")
    if (Dqk, Dv) not in cuda_kernels.HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {Dqk} for q and k "
                         f"with {Dv} for v is not a built (Dqk, Dv) pair "
                         f"{cuda_kernels.HEAD_DIMS}")


def flash_attention(
    q: torch.Tensor,               # (B, Sq, H, Dqk)
    k: torch.Tensor,               # (B, Sk, KV, Dqk)
    v: torch.Tensor,               # (B, Sk, KV, Dv)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Forward attention: the kernel for CUDA tensors, the plain version
    for CPU tensors. Raises on any other device, dtype, layout or head dim
    the kernel does not take, and when the build or the launch fails."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window,
                     q_offset=q_offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    _check(q, k, v)
    kernel = select_kernel(q, k, v)
    # the grid's y axis: B * H blocks (float32 kernel) or the q tiles
    # (bfloat16 kernel)
    B, Sq, H, _ = q.shape
    n_y = B * H if kernel == "flash_fwd_kernel" else -(-Sq // WGMMA_BQ)
    if n_y > MAX_GRID_Y:
        raise ValueError(f"flash_attention: {n_y} blocks along the grid's y "
                         f"axis exceed {MAX_GRID_Y}")
    out = torch.empty((B, Sq, H, v.shape[3]), dtype=q.dtype,
                      device=q.device)
    if out.numel() == 0:
        return out
    cuda_kernels.flash_attention_fwd(q, k, v, out, kernel=kernel,
                                     scale=scale, causal=causal,
                                     window=window, q_offset=q_offset)
    return out
