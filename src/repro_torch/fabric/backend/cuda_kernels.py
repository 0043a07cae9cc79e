"""Hand-written CUDA kernels for the fabric hot paths — the
``KernelType.CUDA`` registrations.

Three kernels, in ``repro_torch/csrc/fabric_kernels.cu``, carry the sweep
runner's per-step contention arithmetic:

  * the **waterfilling allocator** — one kernel serves ``maxmin_shares``
    (unit weights, a template flag) and ``wfq_shares`` (real weights);
  * the **strict-priority allocator** — the same fill once per descending
    priority class, over that class's members only, with the per-class
    capacity carry kept inside the thread; the class partition comes as
    one member bit mask per class, by value in the launch's arguments;
  * the **busy-segment overlap reduction** — window-vs-segment clamped
    overlaps, summed left to right per row.

The allocators are one thread per row, the row held in registers for up
to :data:`MAX_FIXED_FLOWS` flows (the flow count a template argument);
the overlap reduction stages tiles of 32 rows through shared memory and
sums each row in one lane (see the notes in the source). Bit-exactness
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
output is allocated with ``torch.empty``; the kernel is enqueued on the
current stream of the tensors' device and nothing synchronises; a non-zero
``cudaGetLastError()`` after the launch raises. There is no fallback to
the plain version. Each wrapper adds one to its entry in the launch
counts where it launches its kernel, and nowhere else.

The host path is most of what a call costs the sweep's loop, so the
wrappers resolve each launcher once per dtype, switch the current device
only when the tensors lie on another, read the stream's handle without
building a ``torch.cuda.Stream``, and do no numpy work per call.
"""
from __future__ import annotations

import ctypes
import functools
import math
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
# flow counts with a kernel of their own (the row in registers); more
# flows take the kernels' runtime-n form
MAX_FIXED_FLOWS = 8
# torch release on which the private stream getter below was checked
STREAM_GETTER_CHECKED_ON = "2.11.0"

_LAUNCHES: Dict[str, int] = {"maxmin_shares": 0, "wfq_shares": 0,
                             "strict_priority_shares": 0,
                             "segment_overlap": 0}
_LIB: Optional["_Bound"] = None
# per priority vector: (member masks as a ctypes array, its address,
# the number of classes)
_CLASSES: Dict[tuple, Tuple[ctypes.Array, int, int]] = {}


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


class _Bound:
    """The loaded library's launchers, each resolved once, by dtype."""

    def __init__(self, lib: ctypes.CDLL):
        p, i, ll, dbl = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_double)
        self.waterfill, self.strict_priority, self.segment_overlap = \
            {}, {}, {}
        for sfx, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            fn = getattr(lib, f"fabric_waterfill_{sfx}")
            fn.argtypes = [p, p, p, dbl, p, ll, i, ll, p]
            fn.restype = i
            self.waterfill[dtype] = fn
            fn = getattr(lib, f"fabric_strict_priority_{sfx}")
            fn.argtypes = [p, p, i, p, dbl, p, ll, i, p]
            fn.restype = i
            self.strict_priority[dtype] = fn
            fn = getattr(lib, f"fabric_segment_overlap_{sfx}")
            fn.argtypes = [p, p, ll, ll, ll, ll, p, p, p, i, i, ll, i, p, ll,
                           p]
            fn.restype = i
            self.segment_overlap[dtype] = fn
        self.launch_floor = lib.fabric_launch_floor
        self.launch_floor.argtypes = [ll, p]
        self.launch_floor.restype = i
        lib.fabric_max_flows.restype = i
        self.error_string = lib.fabric_error_string
        self.error_string.argtypes = [i]
        self.error_string.restype = ctypes.c_char_p
        if lib.fabric_max_flows() != MAX_FLOWS:
            raise RuntimeError(
                f"fabric_kernels.cu was built for {lib.fabric_max_flows()} "
                f"flows, the wrappers expect {MAX_FLOWS}")
        self.raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream",
                                  None)
        if self.raw_stream is None:
            raise RuntimeError(
                f"torch {torch.__version__} has no "
                f"torch._C._cuda_getCurrentRawStream, which the fabric "
                f"wrappers read the current stream with (checked on torch "
                f"{STREAM_GETTER_CHECKED_ON})")


def _library() -> _Bound:
    global _LIB
    if _LIB is None:
        _LIB = _Bound(LIBRARY.load())
    return _LIB


# ---------------------------------------------------------------------------
# the host path shared by the wrappers
# ---------------------------------------------------------------------------


def _require_cuda(name: str, x, what: str) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or not x.is_cuda:
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


def _stream(index: int) -> int:
    """The handle of the current stream of device ``index``, without
    building a ``torch.cuda.Stream``: the private getter that PyTorch's
    own generated kernels call, checked on torch
    :data:`STREAM_GETTER_CHECKED_ON`. Loading the library raises where a
    torch release lacks it. The public
    ``torch.cuda.current_stream(index).cuda_stream`` builds a ``Stream``
    object on every call."""
    return _LIB.raw_stream(index)


def _launch(name: str, fn, x: torch.Tensor, *args) -> None:
    """Call the launcher ``fn`` with ``args`` and the current stream of
    ``x``'s device, made the current device only when it is not already;
    raise on a non-zero ``cudaGetLastError()``; count the launch."""
    index = x.get_device()
    if index == torch.cuda.current_device():
        code = fn(*args, _stream(index))
    else:
        with torch.cuda.device(index):
            code = fn(*args, _stream(index))
    if code:
        raise RuntimeError(
            f"cuda kernel {name!r} failed to launch: "
            f"{_LIB.error_string(code).decode()} (cudaError {code})")
    _LAUNCHES[name] += 1


@functools.lru_cache(maxsize=256)
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
        return aligned, math.prod(batch[lead:]), False
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
    if x.shape != aligned:              # reshape costs microseconds
        x = x.reshape(aligned)
    if expand:
        x = x.expand(tuple(batch) + tuple(tail))
    return x.contiguous(), rows_per


def _capacity(name: str, capacity, d: torch.Tensor):
    """Capacity as ``(pointer-or-None, scalar, keepalive)``: a tensor
    broadcast against ``d``'s rows, or one number."""
    if isinstance(capacity, torch.Tensor):
        cap = _require_cuda(name, capacity, "capacity")
        if cap.dtype != d.dtype or cap.device != d.device:
            raise ValueError(
                f"cuda kernel {name!r}: capacity is {cap.dtype} on "
                f"{cap.device}, expected {d.dtype} on {d.device}")
        cap = cap.broadcast_to(d.shape[:-1]).contiguous()
        return cap.data_ptr(), 0.0, cap
    return None, float(capacity), None


def _demands(name: str, demands) -> torch.Tensor:
    d = _require_cuda(name, demands, "demands").contiguous()
    if d.dim() < 1:
        raise ValueError(f"cuda kernel {name!r}: demands need a flow axis")
    if d.shape[-1] > MAX_FLOWS:
        raise ValueError(
            f"cuda kernel {name!r} handles at most {MAX_FLOWS} flows per "
            f"row, got {d.shape[-1]}")
    return d


def class_masks(priorities, n: int) -> Tuple[int, ...]:
    """The strict-priority class partition as the kernel takes it: one
    member mask per class, in descending priority order, with bit ``k``
    set where flow ``k`` is in the class (:func:`priority_classes`'s rows
    as integers). Raises as :func:`priority_classes` does."""
    return tuple(sum(1 << int(k) for k in np.flatnonzero(row))
                 for row in priority_classes(priorities, n))


def _classes(priorities, n: int) -> Tuple[ctypes.Array, int, int]:
    """:func:`class_masks` as a ``uint32`` array for the launcher, kept
    per priority vector. The runner passes the same numpy array on every
    step, so the key is read from its bytes."""
    p = priorities if isinstance(priorities, np.ndarray) \
        else np.asarray(priorities)
    key = (n, p.dtype.str, p.shape, p.tobytes())
    hit = _CLASSES.get(key)
    if hit is None:
        masks = class_masks(p, n)
        arr = (ctypes.c_uint32 * max(len(masks), 1))(*masks)
        hit = _CLASSES[key] = (arr, ctypes.addressof(arr), len(masks))
    return hit


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _waterfill(name: str, d: torch.Tensor, weights, capacity
               ) -> torch.Tensor:
    out = torch.empty_like(d)
    n = d.shape[-1]
    rows = d.numel() // n if n else 0
    if rows == 0:
        return out
    if weights is None:
        w, w_ptr, rows_per_w = None, None, 1
    else:
        w, rows_per_w = _grouped(name, weights, d, d.shape[:-1], (n,),
                                 "weights")
        w_ptr = w.data_ptr()
    cap_ptr, cap_scalar, cap = _capacity(name, capacity, d)
    _launch(name, _library().waterfill[d.dtype], d, d.data_ptr(), w_ptr,
            cap_ptr, cap_scalar, out.data_ptr(), rows, n, rows_per_w)
    return out


@register_kernel("maxmin_shares", KernelType.CUDA)
def maxmin_shares(demands, capacity=1.0, *, validate: bool = True
                  ) -> torch.Tensor:
    """Progressive-filling max-min allocator on the card: the unit-weight
    instance of the waterfill kernel (a template flag: the fill divides
    by the count of flows left, which is what ``remaining * 1.0 /
    w_left`` gives bit for bit, so the arithmetic is operation-for-operation
    the unweighted reference). ``demands``: ``(..., n)`` CUDA tensor;
    ``capacity``: a number or a tensor that broadcasts against ``(...)``."""
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


def _strict_priority(d: torch.Tensor, priorities, capacity
                     ) -> torch.Tensor:
    name = "strict_priority_shares"
    n = d.shape[-1]
    _, masks_ptr, n_classes = _classes(priorities, n)  # raises on mismatch
    out = torch.empty_like(d)
    rows = d.numel() // n if n else 0
    if rows == 0:
        return out
    cap_ptr, cap_scalar, cap = _capacity(name, capacity, d)
    _launch(name, _library().strict_priority[d.dtype], d, d.data_ptr(),
            masks_ptr, n_classes, cap_ptr, cap_scalar, out.data_ptr(), rows,
            n)
    return out


@register_kernel("strict_priority_shares", KernelType.CUDA)
def strict_priority_shares(demands, priorities, capacity=1.0, *,
                           validate: bool = True) -> torch.Tensor:
    """Strict-priority allocation on the card: ``priorities`` must be
    concrete (host) — the class partition is structural — and becomes one
    member mask per descending class (:func:`class_masks`), kept per
    priority vector and passed by value in the launch's arguments; the
    kernel fills each class over its members only, inside the thread."""
    if validate:
        check_demands_launch(demands, capacity)
    return _strict_priority(_demands("strict_priority_shares", demands),
                            priorities, capacity)


def launch_floor(x: torch.Tensor, rows: int) -> None:
    """Launch the source's empty kernel with an allocator's grid and block
    for ``rows`` rows, on the current stream of ``x``'s device: the least
    device time a launch of that shape takes, which ``chip_smoke.py``
    reports beside the allocators. Not counted: it computes nothing."""
    lib = _library()
    with torch.cuda.device(x.get_device()):
        code = lib.launch_floor(rows, _stream(x.get_device()))
    if code:
        raise RuntimeError(f"launch_floor failed to launch: "
                           f"{_LIB.error_string(code).decode()}")


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
    # the dimensions longer than 1 are the leading batch dimensions the
    # operand spans; read in place when they collapse to one stride (a
    # view costs microseconds), else flattened into a copy
    long_dims = [k for k, size in enumerate(x.shape) if size != 1]
    if not long_dims:
        return x, rows_per, 0
    st = x.stride()
    if all(st[i] == st[j] * x.shape[j]
           for i, j in zip(long_dims, long_dims[1:])):
        return x, rows_per, st[long_dims[-1]]
    return x.reshape(-1), rows_per, 1


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
    if e.shape != s.shape:
        e = e.broadcast_to(s.shape)
    e = e.contiguous()
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
    rows = out.numel()
    if rows == 0:
        return out
    si, per_s, stride_s = _window(name, s_i, s, batch, "s_i")
    ei, per_e, stride_e = _window(name, e_i, s, batch, "e_i")
    _launch(name, _library().segment_overlap[s.dtype], s, si.data_ptr(),
            ei.data_ptr(), per_s, stride_s, per_e, stride_e, s.data_ptr(),
            e.data_ptr(), co_ptr, n_co, J, S, n, out.data_ptr(), rows)
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
