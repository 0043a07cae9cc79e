"""Hand-written CUDA kernels for the fabric hot paths — the
``KernelType.CUDA`` registrations.

Three kernels, in ``repro_torch/csrc/fabric_kernels.cu``, carry the sweep
runner's per-step contention arithmetic:

  * the **waterfilling allocator** — one kernel serves ``maxmin_shares``
    (unit weights) and ``wfq_shares`` (real weights);
  * the **strict-priority allocator** — the same fill, as a shared
    ``__device__`` function, once per descending priority class with the
    per-class capacity carry kept inside the thread;
  * the **busy-segment overlap reduction** — window-vs-segment clamped
    overlaps, summed left to right per row.

The allocators are one thread per row; the overlap reduction stages
tiles of 32 rows through shared memory and sums each row in one lane
(see the notes in the source). Bit-exactness
(the ``exact`` equivalence tier): the kernels compute each flow's *stable
rank* by O(n²) comparison, which reproduces Python ``sorted``'s
tie-breaking, then run the fill over rank positions with arithmetic that
is operand-for-operand the reference loop; the library is built with
``-fmad=false`` and without fast-math so that no multiply is fused into a
following add. Under float64 the allocations are bit-identical to the
plain PyTorch versions in
:mod:`repro_torch.fabric.backend.torch_kernels` and to the Python loops in
:mod:`repro_torch.fabric.congestion`.

Build and binding: :mod:`repro_torch._nvcc` compiles the source into a
shared library with a plain C interface at first use, keyed by a hash of
the source and the flags, under ``build/repro_torch/`` at the repository
root; ``ctypes`` loads it. A failed build raises with the compiler's
output.

Contract of every wrapper here: CUDA tensors only (``backend="torch"`` is
how the CPU is asked for), ``torch.float32`` or ``torch.float64``; the
output is allocated with ``torch.empty``; the kernel is enqueued on
``torch.cuda.current_stream()`` and nothing synchronises; a non-zero
``cudaGetLastError()`` after the launch raises. There is no fallback to
the plain version. Each wrapper adds one to its entry in the launch
counts where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import _nvcc
from repro_torch.fabric.backend import KernelType, register_kernel
from repro_torch.fabric.backend.torch_kernels import (check_demands_launch,
                                                      filled_slots,
                                                      priority_classes)

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "fabric_kernels.cu"
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
MAX_FLOWS = 32                    # compile-time bound in the source

_LAUNCHES: Dict[str, int] = {"maxmin_shares": 0, "wfq_shares": 0,
                             "strict_priority_shares": 0,
                             "segment_overlap": 0}
_LIB: Optional[ctypes.CDLL] = None
_MASKS: Dict[tuple, torch.Tensor] = {}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset (a copy)."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# build + load
# ---------------------------------------------------------------------------


# after a build, its ptxas report is in LIBRARY.ptxas_log
LIBRARY = _nvcc.NvccLibrary(SOURCE, NVCC_FLAGS, "fabric_kernels")


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = LIBRARY.load()
        p, i, ll, dbl = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_double)
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"fabric_waterfill_{sfx}")
            fn.argtypes = [p, p, p, dbl, p, ll, i, ll, p]
            fn.restype = i
            fn = getattr(lib, f"fabric_strict_priority_{sfx}")
            fn.argtypes = [p, p, p, dbl, p, ll, i, i, p]
            fn.restype = i
            fn = getattr(lib, f"fabric_segment_overlap_{sfx}")
            fn.argtypes = [p, p, ll, ll, ll, ll, p, p, p, i, i, ll, i, p, ll,
                           p]
            fn.restype = i
        lib.fabric_max_flows.restype = i
        lib.fabric_error_string.argtypes = [i]
        lib.fabric_error_string.restype = ctypes.c_char_p
        if lib.fabric_max_flows() != MAX_FLOWS:
            raise RuntimeError(
                f"fabric_kernels.cu was built for {lib.fabric_max_flows()} "
                f"flows, the wrappers expect {MAX_FLOWS}")
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# argument checks shared by the wrappers
# ---------------------------------------------------------------------------


def _require_cuda(name: str, x, what: str) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        where = x.device if isinstance(x, torch.Tensor) else type(x).__name__
        raise ValueError(
            f"cuda kernel {name!r} takes CUDA tensors; {what} is on "
            f"{where}. backend='torch' is the plain version and runs on "
            f"the CPU")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(
            f"cuda kernel {name!r} takes torch.float32 or torch.float64; "
            f"{what} is {x.dtype}")
    return x


def _suffix(dtype: torch.dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"


def _rows(batch: Tuple[int, ...]) -> int:
    return int(np.prod(batch, dtype=np.int64)) if batch else 1


def _group_layout(shape: Tuple[int, ...], batch: Tuple[int, ...],
                  tail: Tuple[int, ...]
                  ) -> Tuple[Tuple[int, ...], int, bool]:
    """How an operand of ``shape`` that broadcasts against
    ``batch + tail`` reaches a kernel that reads it as
    ``x[row // rows_per]``. Returns ``(aligned_shape, rows_per, expand)``:
    an operand whose trailing batch dimensions are 1 (one vector per
    group of rows) is passed as it is with ``rows_per`` = the size of
    those dimensions; any other broadcast has to be expanded to one
    vector per row (``expand`` is true and ``rows_per`` is 1)."""
    full = tuple(batch) + tuple(tail)
    aligned = (1,) * (len(full) - len(shape)) + tuple(shape)
    if len(aligned) != len(full) or aligned[len(batch):] != tuple(tail) \
            or any(a not in (1, f) for a, f in zip(aligned, full)):
        raise ValueError(
            f"shape {tuple(shape)} does not broadcast against {full}")
    lead = 0                      # leading batch dims the operand spans
    for k in range(len(batch)):
        if aligned[k] != 1:
            lead = k + 1
    if aligned[:lead] == tuple(batch[:lead]):
        return aligned, _rows(batch[lead:]), False
    return aligned, 1, True


def _grouped(name: str, x: torch.Tensor, ref: torch.Tensor, batch, tail,
             what: str) -> Tuple[torch.Tensor, int]:
    """Lay ``x`` out for a kernel that reads it as ``x[row // rows_per]``
    (see :func:`_group_layout`)."""
    x = _require_cuda(name, x, what)
    if x.dtype != ref.dtype or x.device != ref.device:
        raise ValueError(
            f"cuda kernel {name!r}: {what} is {x.dtype} on {x.device}, "
            f"expected {ref.dtype} on {ref.device}")
    try:
        aligned, rows_per, expand = _group_layout(tuple(x.shape), batch, tail)
    except ValueError as e:
        raise ValueError(f"cuda kernel {name!r}: {what}: {e}") from None
    x = x.reshape(aligned)
    if expand:
        x = x.expand(tuple(batch) + tuple(tail))
    return x.contiguous(), rows_per


def _capacity(name: str, capacity, d: torch.Tensor, batch):
    """Capacity as ``(pointer-or-None, scalar, keepalive)``."""
    if isinstance(capacity, torch.Tensor):
        cap = _require_cuda(name, capacity, "capacity")
        if cap.dtype != d.dtype or cap.device != d.device:
            raise ValueError(
                f"cuda kernel {name!r}: capacity is {cap.dtype} on "
                f"{cap.device}, expected {d.dtype} on {d.device}")
        cap = cap.broadcast_to(batch).contiguous()
        return cap.data_ptr(), 0.0, cap
    return None, float(capacity), None


def _check(name: str, lib, code: int) -> None:
    if code != 0:
        raise RuntimeError(
            f"cuda kernel {name!r} failed to launch: "
            f"{lib.fabric_error_string(code).decode()} (cudaError {code})")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _demands(name: str, demands) -> torch.Tensor:
    d = _require_cuda(name, demands, "demands").contiguous()
    if d.dim() < 1:
        raise ValueError(f"cuda kernel {name!r}: demands need a flow axis")
    if d.shape[-1] > MAX_FLOWS:
        raise ValueError(
            f"cuda kernel {name!r} handles at most {MAX_FLOWS} flows per "
            f"row, got {d.shape[-1]}")
    return d


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _waterfill(name: str, d: torch.Tensor, weights, capacity
               ) -> torch.Tensor:
    batch, n = tuple(d.shape[:-1]), d.shape[-1]
    out = torch.empty_like(d)
    rows = _rows(batch)
    if n == 0 or rows == 0:
        return out
    if weights is None:
        w, w_ptr, rows_per_w = None, None, 1
    else:
        w, rows_per_w = _grouped(name, weights, d, batch, (n,), "weights")
        w_ptr = w.data_ptr()
    cap_ptr, cap_scalar, cap = _capacity(name, capacity, d, batch)
    lib = _library()
    with torch.cuda.device(d.device):
        code = getattr(lib, f"fabric_waterfill_{_suffix(d.dtype)}")(
            d.data_ptr(), w_ptr, cap_ptr, cap_scalar, out.data_ptr(), rows,
            n, rows_per_w, _stream(d))
    _check(name, lib, code)
    _LAUNCHES[name] += 1
    return out


@register_kernel("maxmin_shares", KernelType.CUDA)
def maxmin_shares(demands, capacity=1.0, *, validate: bool = True
                  ) -> torch.Tensor:
    """Progressive-filling max-min allocator on the card: the unit-weight
    instance of the waterfill kernel (``x * 1.0`` is exact and the weight
    carry stays a small integer, so the arithmetic is
    operation-for-operation the unweighted reference). ``demands``:
    ``(..., n)`` CUDA tensor; ``capacity``: a number or a tensor that
    broadcasts against ``(...)``."""
    if validate:
        check_demands_launch(demands, capacity)
    return _waterfill("maxmin_shares", _demands("maxmin_shares", demands),
                      None, capacity)


@register_kernel("wfq_shares", KernelType.CUDA)
def wfq_shares(demands, weights=None, capacity=1.0, *,
               validate: bool = True) -> torch.Tensor:
    """Weighted progressive filling (WFQ steady state) on the card: the
    waterfill kernel with real weights — normalized-demand stable rank,
    ``remaining * w / w_left`` fill, left-to-right weight total.
    ``weights`` broadcasts against ``demands``; one weight vector per
    group of rows (``(V, 1, n)`` against ``(V, L, n)``) is read in place,
    not expanded."""
    if validate:
        check_demands_launch(demands, capacity)
    return _waterfill("wfq_shares", _demands("wfq_shares", demands),
                      weights, capacity)


@register_kernel("strict_priority_shares", KernelType.CUDA)
def strict_priority_shares(demands, priorities, capacity=1.0, *,
                           validate: bool = True) -> torch.Tensor:
    """Strict-priority allocation on the card: ``priorities`` must be
    concrete (host) — the class partition is structural — and becomes a
    static descending class-mask matrix, kept on the device per distinct
    priority vector; the kernel runs the shared fill once per class
    inside the thread."""
    name = "strict_priority_shares"
    if validate:
        check_demands_launch(demands, capacity)
    d = _demands(name, demands)
    batch, n = tuple(d.shape[:-1]), d.shape[-1]
    key = (tuple(np.asarray(priorities).reshape(-1).tolist()), n, d.device)
    m = _MASKS.get(key)
    if m is None:
        masks = priority_classes(priorities, n)       # raises on a mismatch
        m = _MASKS[key] = torch.as_tensor(
            masks.astype(np.uint8), device=d.device).contiguous()
    out = torch.empty_like(d)
    rows = _rows(batch)
    if n == 0 or rows == 0:
        return out
    cap_ptr, cap_scalar, cap = _capacity(name, capacity, d, batch)
    lib = _library()
    with torch.cuda.device(d.device):
        code = getattr(lib, f"fabric_strict_priority_{_suffix(d.dtype)}")(
            d.data_ptr(), m.data_ptr(), cap_ptr, cap_scalar, out.data_ptr(),
            rows, n, m.shape[0], _stream(d))
    _check(name, lib, code)
    _LAUNCHES[name] += 1
    return out


def _window(name: str, x, ref: torch.Tensor, batch, what: str
            ) -> Tuple[torch.Tensor, int, int]:
    """A window operand (``s_i`` or ``e_i``) as the overlap kernel reads
    it: ``(tensor, rows_per, stride)`` with row r's value at
    ``tensor[(r // rows_per) * stride]``. One window per group of rows
    (the runner's ``(V, 1)`` column of its ``(V, J)`` windows) is read in
    place through its stride; any other broadcast is expanded to one
    value per row."""
    x = _require_cuda(name, x, what)
    if x.dtype != ref.dtype or x.device != ref.device:
        raise ValueError(
            f"cuda kernel {name!r}: {what} is {x.dtype} on {x.device}, "
            f"expected {ref.dtype} on {ref.device}")
    try:
        aligned, rows_per, expand = _group_layout(tuple(x.shape), batch, ())
    except ValueError as e:
        raise ValueError(f"cuda kernel {name!r}: {what}: {e}") from None
    if expand:
        return x.reshape(aligned).expand(batch).contiguous(), 1, 1
    flat = x.reshape(aligned).reshape(-1)
    return flat, rows_per, flat.stride(0) if flat.numel() > 1 else 0


@register_kernel("segment_overlap", KernelType.CUDA)
def segment_overlap(s_i, e_i, starts, ends, *, n_filled=None, co=None
                    ) -> torch.Tensor:
    """Aggregated busy-segment overlap of the window ``[s_i, e_i)`` with
    segments ``(starts, ends)`` along the last axis — clamped overlaps
    accumulated left to right, the reference's encounter order. Empty
    slots (``end = -inf``) contribute a clamped ``0.0``.

    ``n_filled`` (keyword, default all): the kernel reads only the first
    ``n_filled`` slots of each row; the rest must be empty. ``co``
    (keyword): an int32 CUDA index tensor into the second-to-last axis of
    ``starts``/``ends``; the kernel reads those rows where they lie, and
    the result is ``(..., len(co))``. Its values must be in range: they
    are not checked on the host. ``s_i`` and ``e_i`` broadcast against the
    result; one window per group of rows (``(V, 1)``, also a strided
    column of a ``(V, J)`` tensor) is read in place."""
    name = "segment_overlap"
    s = _require_cuda(name, starts, "starts").contiguous()
    e = _require_cuda(name, ends, "ends")
    if e.dtype != s.dtype or e.device != s.device:
        raise ValueError(
            f"cuda kernel {name!r}: ends is {e.dtype} on {e.device}, "
            f"expected {s.dtype} on {s.device}")
    if s.dim() < 1:
        raise ValueError(f"cuda kernel {name!r}: starts need a slot axis")
    e = e.broadcast_to(s.shape).contiguous()
    S = s.shape[-1]
    n = filled_slots(n_filled, S)
    if co is None:
        batch, co_ptr, n_co, J = tuple(s.shape[:-1]), None, 1, 1
    else:
        if not isinstance(co, torch.Tensor) or co.dtype != torch.int32 \
                or co.device != s.device or co.dim() != 1 or s.dim() < 2:
            raise ValueError(
                f"cuda kernel {name!r}: co must be a 1-D torch.int32 tensor "
                f"on {s.device} indexing the second-to-last axis of a "
                f"store of at least two dimensions")
        co = co.contiguous()
        n_co, J = co.shape[0], s.shape[-2]
        batch, co_ptr = tuple(s.shape[:-2]) + (n_co,), co.data_ptr()
    out = torch.empty(batch, dtype=s.dtype, device=s.device)
    rows = _rows(batch)
    if rows == 0:
        return out
    si, per_s, stride_s = _window(name, s_i, s, batch, "s_i")
    ei, per_e, stride_e = _window(name, e_i, s, batch, "e_i")
    lib = _library()
    with torch.cuda.device(s.device):
        code = getattr(lib, f"fabric_segment_overlap_{_suffix(s.dtype)}")(
            si.data_ptr(), ei.data_ptr(), per_s, stride_s, per_e, stride_e,
            s.data_ptr(), e.data_ptr(), co_ptr, n_co, J, S, n,
            out.data_ptr(), rows, _stream(s))
    _check(name, lib, code)
    _LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# whole-scenario front door: the batched runner with the CUDA kernels
# ---------------------------------------------------------------------------


@register_kernel("scenario", KernelType.CUDA)
def run_scenario(scenario, topo=None, device=None, dtype=None):
    """``Scenario.run(backend="cuda")``: the batched runner
    (:mod:`repro_torch.fabric.backend.torch_engine`) with its allocator
    and segment-overlap calls dispatched to the kernels above."""
    from repro_torch.fabric.backend.torch_engine import run_scenarios
    return run_scenarios([(scenario, topo)], kernels=KernelType.CUDA,
                         device=device, dtype=dtype)[0]
