"""Plain PyTorch kernels for the allocator/pacing/contention hot paths —
the ``KernelType.TORCH`` registrations, and the plain version that stands
beside every hand-written CUDA kernel in
:mod:`repro_torch.fabric.backend.cuda_kernels`.

Design rule: replicate the reference *operation sequence*, not just the
formula. Progressive filling is a sorted sequential fill, so each kernel
sorts with a stable ``argsort`` (Python's ``sorted`` is stable) and runs
the fill as a Python loop over the short flow axis whose per-position
arithmetic is operand-for-operand the reference loop. Where the reference
accumulates left to right (WFQ's weight total, window sums, overlap
totals), the kernel accumulates left to right too, as an explicit loop —
``torch.sum`` and ``torch.cumsum`` reduce pairwise or in blocks and would
break bit-equality. Under float64 the allocators are **bit-identical** to
the Python loops, batch dimension and all (the ``exact`` tier in
:data:`repro_torch.fabric.backend.EQUIVALENCE_TIERS`). Eager PyTorch runs
one kernel per operation, so no multiply is ever fused into a following
add or divide.

Two kernels declare looser tiers against the Python engine:
``pacing_decide`` (``sqrt``/division chains whose window bookkeeping
differs from the deque) and ``segment_overlap`` (the reference interleaves
same-round and recorded segments in encounter order; the batched kernel
sums each group separately).

Batching: every kernel accepts leading batch dimensions on its float
inputs. Structural arguments (flow counts, priorities, window length) are
static.

Devices and types: a tensor argument is computed where it lies and in its
own type (``torch.float32`` or ``torch.float64``). Array-like arguments
are placed by ``device=`` and ``dtype=``: ``device=None`` is the card and
raises without one, ``dtype=None`` is ``torch.float32``.

Zero-demand padding is the batching device for ragged flow counts: a
padded zero-demand flow sorts first (stable, zeros before positives),
receives exactly ``0.0``, and leaves ``remaining`` untouched, so the
arithmetic seen by real flows is bit-identical to running the unpadded
allocator.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.fabric.backend import (KernelType, register_kernel,
                                        resolve_device, resolve_dtype)
from repro_torch.fabric.congestion import RESIDUAL_SHARE

_FLOATS = (torch.float32, torch.float64)


def as_float_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """``x`` as a float tensor. A tensor keeps its device and type unless
    ``device``/``dtype`` say otherwise; anything else is placed by
    :func:`resolve_device` / :func:`resolve_dtype` (the card and
    ``torch.float32`` by default)."""
    if isinstance(x, torch.Tensor):
        dt = x.dtype if dtype is None else resolve_dtype(dtype)
        if dt not in _FLOATS:
            raise ValueError(
                f"expected a torch.float32 or torch.float64 tensor, got "
                f"{x.dtype}; pass dtype= to convert")
        dev = x.device if device is None else resolve_device(device)
        return x.to(device=dev, dtype=dt)
    return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(
        device=resolve_device(device), dtype=resolve_dtype(dtype))


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    """``x`` on ``ref``'s device in ``ref``'s type."""
    if isinstance(x, torch.Tensor):
        return x.to(device=ref.device, dtype=ref.dtype)
    return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(
        device=ref.device, dtype=ref.dtype)


def _leftright_sum(a: torch.Tensor) -> torch.Tensor:
    """Strict left-to-right accumulation along the last axis (Python
    ``sum()`` order) — never a pairwise reduction, so float results match
    the reference loops."""
    total = torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
    for k in range(a.shape[-1]):
        total = total + a[..., k]
    return total


def _host_flat(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64).reshape(-1)


def check_demands_launch(demands, capacity) -> None:
    """The allocator rejection contract, shared by the torch and cuda
    backends: NaN/negative demands or capacity raise *before* any kernel
    launch, with text identical to the reference boundary check
    (:func:`repro_torch.fabric.congestion._check_demands`). Reading a
    CUDA tensor here waits for the device, so the batched runner checks
    its scenario's concrete inputs once and then calls the kernels with
    ``validate=False``."""
    c = _host_flat(capacity)
    bad = ~(c >= 0.0)
    if bad.any():
        raise ValueError(
            f"capacity must be >= 0, got {float(c[np.argmax(bad)])!r}")
    d = _host_flat(demands)
    bad = ~(d >= 0.0)
    if bad.any():
        raise ValueError(
            f"demands must be >= 0, got {float(d[np.argmax(bad)])!r}")


def _fill_sorted(ds, ws, cap, w_total, n):
    """The sequential fill over sorted positions. ``ws=None`` is the
    unweighted fill (``remaining / flows_left``). The divisor is a tensor
    on the device, never a Python number: PyTorch divides a CUDA tensor
    by a host scalar as a multiplication by its reciprocal, which rounds
    differently from the reference's division."""
    remaining = cap
    w_left = w_total
    gives = []
    if ws is None:
        flows_left = torch.arange(n, 0, -1, dtype=ds.dtype,
                                  device=ds.device)
    for pos in range(n):
        dj = ds[..., pos]
        if ws is None:
            fair = remaining / flows_left[pos]
        else:
            wj = ws[..., pos]
            fair = torch.where(w_left > 0.0, remaining * wj / w_left,
                               remaining)
        give = torch.where(dj < fair, dj, fair)
        remaining = remaining - give
        if ws is not None:
            w_left = w_left - wj
        gives.append(give)
    return torch.stack(gives, dim=-1)


@register_kernel("maxmin_shares", KernelType.TORCH)
def maxmin_shares(demands, capacity=1.0, *, dtype=None, device=None,
                  validate: bool = True) -> torch.Tensor:
    """Batched progressive-filling max-min allocator.

    ``demands``: ``(..., n)``; ``capacity``: scalar or ``(...)``. Returns
    allocations shaped like ``demands``. Bit-identical to the reference
    under float64: stable ascending sort, then the same
    ``min(demand, remaining / flows_left)`` fill per position.
    """
    if validate:
        check_demands_launch(demands, capacity)
    d = as_float_tensor(demands, dtype, device)
    n = d.shape[-1]
    if n == 0:
        return torch.zeros_like(d)
    cap = _like(capacity, d).broadcast_to(d.shape[:-1])
    order = torch.argsort(d, dim=-1, stable=True)
    ds = torch.gather(d, -1, order)
    alloc_sorted = _fill_sorted(ds, None, cap, None, n)
    return torch.empty_like(d).scatter_(-1, order, alloc_sorted)


@register_kernel("wfq_shares", KernelType.TORCH)
def wfq_shares(demands, weights=None, capacity=1.0, *, dtype=None,
               device=None, validate: bool = True) -> torch.Tensor:
    """Batched weighted progressive filling (WFQ steady state).

    Stable sort by normalized demand ``d / w``; the fill carries
    ``(remaining, weight_left)`` exactly as the reference, with
    ``weight_left`` initialized by left-to-right accumulation in original
    flow order — the same float the Python loop's running sum produces.
    ``weights=None`` falls through to :func:`maxmin_shares`.
    """
    if validate:
        check_demands_launch(demands, capacity)
    d = as_float_tensor(demands, dtype, device)
    if weights is None:
        return maxmin_shares(d, capacity, validate=False)
    n = d.shape[-1]
    if n == 0:
        return torch.zeros_like(d)
    w = _like(weights, d).broadcast_to(d.shape)
    cap = _like(capacity, d).broadcast_to(d.shape[:-1])
    w_total = _leftright_sum(w)
    order = torch.argsort(d / w, dim=-1, stable=True)
    ds = torch.gather(d, -1, order)
    ws = torch.gather(w, -1, order)
    alloc_sorted = _fill_sorted(ds, ws, cap, w_total, n)
    return torch.empty_like(d).scatter_(-1, order, alloc_sorted)


def priority_classes(priorities, n: int) -> np.ndarray:
    """The static descending class-mask matrix ``(C, n)`` of a concrete
    priority vector (``True`` where flow ``k`` is in class ``c``)."""
    pr = np.asarray(priorities)
    if pr.ndim != 1 or pr.shape[0] != n:
        raise ValueError(f"{n} demands but {pr.size} priorities "
                         f"(must be a concrete 1-D array)")
    classes = sorted(set(pr.tolist()), reverse=True)
    return np.stack([pr == prio for prio in classes]) if classes \
        else np.zeros((0, n), dtype=bool)


@register_kernel("strict_priority_shares", KernelType.TORCH)
def strict_priority_shares(demands, priorities, capacity=1.0, *,
                           dtype=None, device=None,
                           validate: bool = True) -> torch.Tensor:
    """Batched strict-priority allocation.

    ``priorities`` must be a concrete (host) 1-D array — the class
    partition is structural; ``demands`` may carry leading batch
    dimensions. Each class runs the masked max-min fill over the *full*
    flow vector (zero-demand padding for non-class flows — exact, see
    module docstring), and the leftover capacity is re-derived by
    subtracting the class's allocations in index order with the
    reference's post-class clamp, so even the rounding of ``remaining``
    matches the Python loop.
    """
    if validate:
        check_demands_launch(demands, capacity)
    d = as_float_tensor(demands, dtype, device)
    n = d.shape[-1]
    masks = priority_classes(priorities, n)
    remaining = _like(capacity, d).broadcast_to(d.shape[:-1])
    alloc = torch.zeros_like(d)
    for row in masks:
        mask = torch.as_tensor(row, device=d.device)
        sub = maxmin_shares(torch.where(mask, d, 0.0), remaining,
                            validate=False)
        sub = torch.where(mask, sub, 0.0)
        alloc = alloc + sub
        for k in range(n):
            remaining = remaining - sub[..., k]
        remaining = torch.where(remaining < 0.0, 0.0, remaining)
    return alloc


@register_kernel("drr_shares", KernelType.TORCH)
def drr_shares(demands, weights=None, capacity=1.0, rounds: int = 64, *,
               dtype=None, device=None,
               validate: bool = True) -> torch.Tensor:
    """Batched deficit round robin.

    The quantized drain is data-dependent, so the rounds run as a masked
    loop until every batch lane has drained (a lane whose link is full or
    whose flows are all served keeps its state while the others go on).
    Within a round the flows are visited in ring order as a Python loop
    over the short flow axis, with the reference's per-flow arithmetic —
    deficit top-up, backlog and remaining caps, the early stop once the
    link saturates mid-round — operand for operand, so float64 is
    bit-identical to :func:`repro_torch.fabric.congestion.drr_shares`.
    Reading each round's lane mask back ends the loop, so a call waits
    for its device once per round.
    """
    if validate:
        check_demands_launch(demands, capacity)
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    d = as_float_tensor(demands, dtype, device)
    n = d.shape[-1]
    if n == 0:
        return torch.zeros_like(d)
    if weights is None:
        w = torch.ones_like(d)
    else:
        w = _like(weights, d).broadcast_to(d.shape)
        if validate and not bool((w > 0.0).all()):
            raise ValueError(f"weights must be positive, got "
                             f"{float(w[~(w > 0.0)][0])!r}")
    batch = d.shape[:-1]
    D = d.reshape(-1, n)
    W = w.reshape(-1, n)
    cap = _like(capacity, d).broadcast_to(batch).reshape(-1)
    # capacity / rounds / w_min, each a true division by a device tensor
    unit = cap / torch.full_like(cap, float(rounds)) / W.amin(dim=-1)
    floor = 1e-15 * cap
    alloc = torch.zeros_like(D)
    deficit = torch.zeros_like(D)
    active = D > 0.0
    remaining = cap.clone()
    while True:
        lane = (remaining > floor) & active.any(dim=-1)
        if not bool(lane.any()):
            break
        stopped = torch.zeros_like(lane)
        still = torch.zeros_like(active)
        for j in range(n):
            act = lane & active[:, j] & ~stopped
            dj = D[:, j]
            new_def = deficit[:, j] + unit * W[:, j]
            send = new_def
            backlog = dj - alloc[:, j]
            send = torch.where(backlog < send, backlog, send)
            send = torch.where(remaining < send, remaining, send)
            send = torch.where(act, send, 0.0)
            new_aj = alloc[:, j] + send
            alloc[:, j] = torch.where(act, new_aj, alloc[:, j])
            deficit[:, j] = torch.where(act, new_def - send, deficit[:, j])
            remaining = remaining - send
            still[:, j] = act & (new_aj < dj)
            stopped = stopped | (act & (remaining <= 0.0))
        active = torch.where(lane[:, None], still, active)
    return alloc.reshape(d.shape)


@register_kernel("offered_share", KernelType.TORCH)
def offered_share(own_bytes, d_i, overlaps, flow_bytes, mask=None, *,
                  dtype=None, device=None) -> torch.Tensor:
    """Batched offered-bytes proportional share with the
    :data:`~repro_torch.fabric.congestion.RESIDUAL_SHARE` floor.

    ``overlaps``/``flow_bytes``: ``(..., F)`` co-tenant flows; ``mask``
    zeroes padded flow slots (adding ``0.0`` is exact, so padded and
    unpadded totals are the same float). The total accumulates left to
    right from ``own_bytes``, as the reference loop does, so float64 is
    bit-identical to :func:`repro_torch.fabric.congestion.offered_share`.
    """
    ov = as_float_tensor(overlaps, dtype, device)
    b = _like(flow_bytes, ov).broadcast_to(ov.shape)
    own = _like(own_bytes, ov).broadcast_to(ov.shape[:-1])
    di = _like(d_i, ov).broadcast_to(ov.shape[:-1])[..., None]
    contrib = torch.where(ov >= di, b, (ov / di) * b)
    if mask is not None:
        contrib = torch.where(torch.as_tensor(mask, device=ov.device),
                              contrib, 0.0)
    total = own
    for k in range(ov.shape[-1]):
        total = total + contrib[..., k]
    share = torch.where(total > own, own / total, 1.0)
    return torch.where(share > RESIDUAL_SHARE, share, RESIDUAL_SHARE)


def filled_slots(n_filled, S: int) -> int:
    """``n_filled`` checked against a store of ``S`` slots per row: a
    Python int in ``0 .. S``; ``None`` means all ``S``."""
    if n_filled is None:
        return S
    if isinstance(n_filled, bool) or not isinstance(n_filled,
                                                    (int, np.integer)):
        raise TypeError(f"n_filled must be an int, got "
                        f"{type(n_filled).__name__}")
    if not 0 <= n_filled <= S:
        raise ValueError(f"n_filled = {n_filled} is not in 0 .. {S}")
    return int(n_filled)


@register_kernel("segment_overlap", KernelType.TORCH)
def segment_overlap(s_i, e_i, starts, ends, *, n_filled=None, co=None,
                    dtype=None, device=None) -> torch.Tensor:
    """Aggregated busy-segment overlap of the window ``[s_i, e_i)`` with
    segments ``(starts, ends)`` along the last axis. Dead or padded
    segments need no pruning or mask: any segment with
    ``end <= window start`` (use ``end = -inf`` for empty slots)
    contributes a clamped ``0.0``, exactly as the reference's
    ``ov > 0.0`` guard skips it.

    ``n_filled`` (keyword): read only the first ``n_filled`` slots of each
    row (default: all). The slots after them must be empty: each would add
    ``+0.0`` to a non-negative total, so leaving them out changes no bit.
    ``co`` (keyword): an integer index tensor into the store's
    second-to-last axis; the rows read are ``starts[..., co, :]``, so the
    result is ``(..., len(co))``. The runner passes its whole ``(V, J, S)``
    store with an owner's co-tenants and the step's count of filled slots.
    """
    s = as_float_tensor(starts, dtype, device)
    e = _like(ends, s).broadcast_to(s.shape)
    n = filled_slots(n_filled, s.shape[-1])
    if co is not None:
        idx = torch.as_tensor(co, device=s.device)
        s, e = s.index_select(-2, idx), e.index_select(-2, idx)
    s, e = s[..., :n], e[..., :n]
    si = _like(s_i, s).unsqueeze(-1)
    ei = _like(e_i, s).unsqueeze(-1)
    ov = torch.minimum(ei, e) - torch.maximum(si, s)
    return _leftright_sum(torch.where(ov > 0.0, ov, 0.0))


# ---------------------------------------------------------------------------
# pacing
# ---------------------------------------------------------------------------


def bank_decide(waits, steps, early, delay, pos: int, count: int,
                seen: int, *, enabled: bool, warmup_iters, cv_threshold,
                skew_threshold, gain, decay, max_delay_frac
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One :class:`~repro_torch.core.pacing.PacingBank` decision on
    ring-buffer window state — the batched engine's per-iteration pacing
    step and the body of the registered ``pacing_decide`` kernel.

    ``waits``/``steps``/``early``: ``(..., n, w)`` ring-buffer tensors (write
    cursor ``pos``, ``count`` filled columns); ``delay``: ``(..., n)``,
    the unbounded internal per-rank delay state; ``seen``: observations
    so far. The controller's parameters are floats or tensors that
    broadcast against ``(..., n)``. Returns
    ``(bounded_delays, new_internal_delay)``. Mirrors the bank's
    arithmetic: left-to-right window sums in deque order, sorted-row
    medians, the decay-to-zero cutoff, and the ``max_delay_frac`` bound.

    ``pos``, ``count`` and ``seen`` are Python ints (the engine's loop
    counter is one), so the window's valid columns are gathered in deque
    order by a static index instead of being masked: dropping a masked
    ``+ 0.0`` term, or an ``inf`` pad that sorts last, changes no bit.
    """
    w = waits.shape[-1]
    delay = _like(delay, waits)
    zero = torch.zeros(waits.shape[:-1], dtype=waits.dtype,
                       device=waits.device)
    if not enabled or w < 2 or count < 2:
        return zero, delay
    steps_b = _like(steps, waits)
    early_b = _like(early, waits)

    # deque order: oldest -> newest. While filling (count < w) the valid
    # columns are 0..count-1; once full the oldest sits at the cursor.
    shift = 0 if count < w else pos
    idx = [(k + shift) % w for k in range(count)]
    wait_o = waits[..., idx]
    step_o = steps_b[..., idx]
    early_o = early_b[..., idx]

    # a device tensor, not a Python number: see _fill_sorted
    cnt = torch.full((), float(count), dtype=waits.dtype,
                     device=waits.device)
    mean = _leftright_sum(wait_o) / cnt
    dev = wait_o - mean.unsqueeze(-1)
    var = _leftright_sum(dev * dev) / cnt
    mean_pos = mean > 0
    cv_wait = torch.where(
        mean_pos, torch.sqrt(var) / torch.where(mean_pos, mean, 1.0), 0.0)

    def rowmedian(buf):
        srt = torch.sort(buf, dim=-1).values
        hi = srt[..., count // 2]
        if count % 2 == 1:
            return hi
        lo = srt[..., max(count // 2 - 1, 0)]
        return 0.5 * (lo + hi)

    med_wait = rowmedian(wait_o)
    med_step = rowmedian(step_o)
    own_wait = waits[..., (pos - 1) % w]     # newest observation
    min_early = early_o.amin(dim=-1)

    step_pos = med_step > 0
    safe = torch.where(step_pos, med_step, 1.0)
    rel_med = torch.where(step_pos, med_wait / safe, 0.0)
    rel_last = torch.where(step_pos, own_wait / safe, 0.0)
    imbalanced = (rel_med > skew_threshold) | \
        ((cv_wait > cv_threshold) & (rel_last > skew_threshold))
    active = imbalanced & (min_early > 0)

    decayed = delay * decay
    decayed = torch.where(
        decayed < 1e-6 * torch.clamp_min(med_step, 1e-9), 0.0, decayed)
    new_delay = torch.where(active, gain * min_early, decayed)
    bounded = torch.minimum(new_delay, max_delay_frac * med_step)

    gate = seen >= warmup_iters
    if isinstance(gate, torch.Tensor):
        return (torch.where(gate, bounded, 0.0),
                torch.where(gate, new_delay, delay))
    return (bounded, new_delay) if gate else (zero, delay)


@register_kernel("pacing_decide", KernelType.TORCH)
def pacing_decide(waits, steps, early, delay, seen, cfg, *, dtype=None,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel-registry entry: decide on full ``(n, c)`` windows already
    in deque order (cursor 0, all columns filled) under a
    :class:`~repro_torch.configs.base.PacingConfig`."""
    waits = as_float_tensor(waits, dtype, device)
    c = waits.shape[-1]
    return bank_decide(
        waits, steps, early, delay, pos=0, count=c, seen=int(seen),
        enabled=cfg.enabled, warmup_iters=cfg.warmup_iters,
        cv_threshold=cfg.cv_threshold, skew_threshold=cfg.skew_threshold,
        gain=cfg.gain, decay=cfg.decay,
        max_delay_frac=cfg.max_delay_frac)
