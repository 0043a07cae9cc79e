"""Build, binding and launch counts of the model substrate's CUDA kernels.

``csrc/model_kernels.cu`` holds K4 (flash-attention forward: a
tensor-core kernel for bfloat16 and a CUDA-core one for float32), K5
(RMSNorm), K6 (the RWKV-6 recurrence) and K7 (the Mamba-1 selective
scan). :mod:`repro_torch._nvcc`
compiles it at first use into ``build/repro_torch/`` and ``ctypes`` loads
it; a failed build raises with the compiler's output. The functions here
launch a kernel on ``torch.cuda.current_stream()`` with pointers the caller
has checked (:mod:`repro_torch.kernels.flash_attention`,
:mod:`repro_torch.kernels.rmsnorm`, :mod:`repro_torch.kernels.wkv6`,
:mod:`repro_torch.kernels.mamba_scan` hold the checks and the plain
versions), raise when ``cudaGetLastError()`` is
not 0 after the launch, and add one to the kernel's launch count, which is
counted nowhere else. Nothing synchronises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch import _nvcc

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "model_kernels.cu"
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC")
# after a build, its ptxas report is in LIBRARY.ptxas_log
LIBRARY = _nvcc.NvccLibrary(SOURCE, NVCC_FLAGS, "model_kernels")

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# K4's built (query/key head dim, value head dim) pairs: the GQA models'
# equal dims, and MLA's dn + dr with dv (MiniCPM3, DeepSeek-V3)
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (96, 64), (192, 128))
# K4's two kernels, as model_flash_attention_fwd numbers them
FLASH_KERNELS = {"flash_fwd_kernel": 0, "flash_fwd_wgmma_kernel": 1}
WKV_KEY_DIMS = (8, 16, 32, 64)      # K6 is built for these K
WKV_MAX_V = 1024
MAMBA_STATE_DIMS = (8, 16)          # K7 is built for these N

_LAUNCHES: Dict[str, int] = {"flash_attention": 0, "rmsnorm": 0, "wkv6": 0,
                             "mamba_scan": 0}
_LIB: Optional[ctypes.CDLL] = None


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset (a copy)."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = LIBRARY.load()
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.model_flash_attention_fwd.argtypes = \
            [p, p, p, p] + [i] * 8 + [ll] * 9 + [f, i, i, i, p]
        lib.model_flash_attention_fwd.restype = i
        lib.model_rmsnorm_fwd.argtypes = [p, p, p, i, i, ll, i, f, p]
        lib.model_rmsnorm_fwd.restype = i
        lib.model_wkv6_fwd.argtypes = [p] * 8 + [i] * 6 + [ll] * 12 + [p]
        lib.model_wkv6_fwd.restype = i
        lib.model_mamba_scan_fwd.argtypes = [p] * 9 + [i] * 5 + [ll] * 8 \
            + [p]
        lib.model_mamba_scan_fwd.restype = i
        lib.model_flash_wgmma_smem_bytes.argtypes = [i, i]
        lib.model_flash_wgmma_smem_bytes.restype = i
        lib.model_mamba_smem_bytes.argtypes = [i, i]
        lib.model_mamba_smem_bytes.restype = i
        lib.model_error_string.argtypes = [i]
        lib.model_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(name: str, lib, code: int) -> None:
    if code != 0:
        raise RuntimeError(
            f"cuda kernel {name!r} failed to launch: "
            f"{lib.model_error_string(code).decode()} (cudaError {code})")
    _LAUNCHES[name] += 1


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, *, kernel: str, scale: float,
                        causal: bool, window: int, q_offset: int) -> None:
    """Launch K4's ``kernel`` (a key of :data:`FLASH_KERNELS`) writing
    ``out`` (B, Sq, H, Dv), contiguous."""
    B, Sq, H, Dqk = q.shape
    Sk, KV, Dv = v.shape[1], v.shape[2], v.shape[3]
    lib = _library()
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]]
    with torch.cuda.device(q.device):
        code = lib.model_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            FLASH_KERNELS[kernel], B, Sq, Sk, H, KV, Dqk, Dv, *strides,
            float(scale), int(bool(causal)), int(window), int(q_offset),
            torch.cuda.current_stream(q.device).cuda_stream)
    _check("flash_attention", lib, code)


def flash_wgmma_smem_bytes(Dqk: int, Dv: int) -> int:
    """Dynamic shared memory of ``flash_fwd_wgmma_kernel`` at the head dims
    (Dqk, Dv), one of :data:`HEAD_DIMS`."""
    return int(_library().model_flash_wgmma_smem_bytes(Dqk, Dv))


def mamba_smem_bytes(dtype: torch.dtype, N: int) -> int:
    """Dynamic shared memory of ``mamba_scan_fwd_kernel`` for x's dtype and
    state dim N."""
    return int(_library().model_mamba_smem_bytes(DTYPE_CODES[dtype], N))


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, out: torch.Tensor,
                eps: float) -> None:
    """Launch K5 over the rows of a contiguous ``x`` (..., D)."""
    D = x.shape[-1]
    rows = x.numel() // D
    lib = _library()
    with torch.cuda.device(x.device):
        code = lib.model_rmsnorm_fwd(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(),
            DTYPE_CODES[x.dtype], DTYPE_CODES[scale.dtype], rows, D,
            float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    _check("rmsnorm", lib, code)


def wkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, s0: Optional[torch.Tensor],
             y: torch.Tensor, s_out: torch.Tensor) -> None:
    """Launch K6 writing ``y`` (B, S, H, V) and ``s_out`` (B, H, K, V),
    both contiguous; ``s0=None`` is a zero initial state."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    lib = _library()
    strides = [*r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *w.stride()[:3]]
    with torch.cuda.device(r.device):
        code = lib.model_wkv6_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            y.data_ptr(), s_out.data_ptr(), DTYPE_CODES[r.dtype], B, S, H,
            K, V, *strides, torch.cuda.current_stream(r.device).cuda_stream)
    _check("wkv6", lib, code)


def mamba_scan_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   h0: Optional[torch.Tensor], y: torch.Tensor,
                   h_out: torch.Tensor) -> None:
    """Launch K7 writing ``y`` (B, S, Din) and ``h_out`` (B, Din, N), both
    contiguous; ``h0=None`` is a zero initial state."""
    B, S, Din = x.shape
    N = A.shape[-1]
    lib = _library()
    strides = [*x.stride()[:2], *dt.stride()[:2], *Bm.stride()[:2],
               *C.stride()[:2]]
    with torch.cuda.device(x.device):
        code = lib.model_mamba_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            C.data_ptr(), D.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_out.data_ptr(), DTYPE_CODES[x.dtype], B, S, Din, N, *strides,
            torch.cuda.current_stream(x.device).cuda_stream)
    _check("mamba_scan", lib, code)
