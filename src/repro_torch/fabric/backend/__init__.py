"""Kernel-registry backend dispatch for the simulator's hot paths.

A dense :class:`~repro_torch.fabric.scenario.ScenarioGrid` run through the
Python engine pays the interpreter once per variant per iteration. The hot
arithmetic lives in three places — the progressive-filling allocators
(:mod:`repro_torch.fabric.congestion`), the vectorized pacing bank
(:mod:`repro_torch.core.pacing`), and the busy-segment contention
accounting (:mod:`repro_torch.fabric.engine`) — and each is a pure function
of floats, so it is routed through a backend enum:

  * ``KernelType.REFERENCE`` — the Python/loop code, registered as-is.
    This backend *is* the executable spec; it runs on the host and takes
    no device or dtype.
  * ``KernelType.TORCH`` — the plain PyTorch version of every kernel
    (:mod:`repro_torch.fabric.backend.torch_kernels`) plus the batched
    whole-scenario runner (:mod:`repro_torch.fabric.backend.torch_engine`)
    that executes every variant of a grid sweep with a leading variant
    dimension. Runs on whatever device its tensors lie on.
  * ``KernelType.CUDA`` — hand-written CUDA C++ kernels
    (:mod:`repro_torch.fabric.backend.cuda_kernels`, sources under
    ``repro_torch/csrc/``) for the hot paths of dense sweeps: the
    waterfilling allocator family (``maxmin``/``wfq`` through one kernel,
    ``strict_priority`` through a second that shares its fill) and the
    busy-segment overlap reduction. The ``scenario`` kernel is the same
    batched runner with its allocator/overlap calls dispatched to them.
    They take CUDA tensors only; kernels outside :data:`CUDA_KERNELS`
    raise :class:`BackendError` naming the nearest supported backend.

Selection surfaces: ``Scenario.run(backend=, device=, dtype=)``,
``ScenarioGrid.run(backend=, device=, dtype=)``, and the
``Policies.backend`` field as the declarative default. Kernel-level access
for tests and benchmarks is ``get_kernel(name, backend)``.

Devices: ``device=None`` means the card (``cuda``) and raises
``RuntimeError`` when there is none; only an explicit ``device="cpu"``
runs the batched runner on the CPU. Nothing picks the CPU quietly.

Equivalence is *tiered per kernel*: every entry in
:data:`EQUIVALENCE_TIERS` declares how close a fast backend must track the
reference — ``exact`` (bit-identical under float64), ``ulp`` (a few ULPs,
where summation order legitimately differs), or ``rtol`` (relative
tolerance, for whole-engine series where rounding differences feed back
through the simulation).
"""
from __future__ import annotations

import enum
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch._device import resolve_device  # noqa: F401


class BackendError(RuntimeError):
    """A kernel/scenario was requested on a backend that cannot run it
    (unregistered kernel/backend combination or an unsupported scenario
    feature); the message names the offending feature and the nearest
    backend that supports it."""


class KernelType(enum.Enum):
    """Which implementation family executes a hot-path kernel."""

    REFERENCE = "reference"       # Python loops on the host — the spec
    TORCH = "torch"               # plain PyTorch, batched, any device
    CUDA = "cuda"                 # hand-written CUDA C++ (CUDA_KERNELS)

    @classmethod
    def parse(cls, spec: Union[str, "KernelType", None],
              default: "KernelType" = None) -> "KernelType":
        if spec is None:
            return default if default is not None else cls.REFERENCE
        if isinstance(spec, cls):
            return spec
        try:
            return cls(str(spec).lower())
        except ValueError:
            raise BackendError(
                f"unknown backend {spec!r}; one of "
                f"{tuple(k.value for k in cls)}") from None


BACKENDS: Tuple[str, ...] = tuple(k.value for k in KernelType)

# Fairness modes the batched whole-scenario runner can batch (the owner-
# aggregated share models; see repro_torch.fabric.backend.torch_engine).
# Both batched backends share the runner and therefore this envelope.
BATCHED_SCENARIO_FAIRNESS: Tuple[str, ...] = ("maxmin", "wfq",
                                              "strict_priority")

# Backends the batched scenario runner serves (eagerly validated by
# Scenario; the runner itself dispatches per-kernel).
BATCHED_SCENARIO_BACKENDS: Tuple[str, ...] = ("torch", "cuda")

# The kernel catalogue. Every name is registered for REFERENCE (the
# executable spec); TORCH_KERNELS and CUDA_KERNELS below are the subsets
# the batched backends register.
KERNELS: Tuple[str, ...] = (
    "maxmin_shares",              # progressive-filling max-min allocator
    "wfq_shares",                 # weighted progressive filling
    "strict_priority_shares",     # descending priority classes
    "drr_shares",                 # deficit round robin
    "offered_share",              # offered-bytes proportional share
    "pacing_decide",              # PacingBank window -> bounded delays
    "segment_overlap",            # busy-segment contention accounting
    "scenario",                   # whole-scenario runner (engine loop)
)

# name -> (tier, tolerance) — how close a fast backend must track the
# reference:
#   exact : bit-identical under float64 (same op sequence, stable sort)
#   ulp   : within `tol` ULPs under float64 (summation order differs)
#   rtol  : within relative `tol` (feedback loops amplify rounding; the
#           float32 production dtype is asserted at a looser 1e-3)
EQUIVALENCE_TIERS: Dict[str, Tuple[str, float]] = {
    "maxmin_shares": ("exact", 0.0),
    "wfq_shares": ("exact", 0.0),
    "strict_priority_shares": ("exact", 0.0),
    "drr_shares": ("exact", 0.0),
    "offered_share": ("exact", 0.0),
    "pacing_decide": ("ulp", 4.0),
    "segment_overlap": ("ulp", 8.0),
    "scenario": ("rtol", 1e-9),
}

# Kernels with a plain PyTorch registration. ``drr_shares`` and
# ``offered_share`` are not on the batched runner's path (it rejects those
# fairness modes) and have no hand-written CUDA kernel.
TORCH_KERNELS: Tuple[str, ...] = (
    "maxmin_shares",
    "wfq_shares",
    "strict_priority_shares",
    "drr_shares",
    "offered_share",
    "pacing_decide",
    "segment_overlap",
    "scenario",
)

# Kernels with a hand-written CUDA registration (the waterfill family,
# the overlap reduction, and the scenario runner they feed).
CUDA_KERNELS: Tuple[str, ...] = (
    "maxmin_shares",
    "wfq_shares",
    "strict_priority_shares",
    "segment_overlap",
    "scenario",
)

_REGISTRY: Dict[Tuple[str, KernelType], Callable] = {}
_LOADED: set = set()


def resolve_dtype(dtype: Optional[torch.dtype]) -> torch.dtype:
    """``None`` means ``torch.float32`` (the production default);
    ``torch.float64`` by argument. Nothing else is taken."""
    if dtype is None:
        return torch.float32
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(
            f"dtype must be torch.float32 or torch.float64, got {dtype!r}")
    return dtype


def register_kernel(name: str, backend: KernelType,
                    fn: Callable = None) -> Callable:
    """``register_kernel(name, backend, fn)`` directly or
    ``@register_kernel(name, backend)`` as a decorator. Re-registering a
    taken (name, backend) slot raises."""
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}; one of {KERNELS}")

    def _add(f: Callable) -> Callable:
        key = (name, backend)
        if key in _REGISTRY:
            raise ValueError(
                f"kernel {name!r} already registered for backend "
                f"{backend.value!r}")
        _REGISTRY[key] = f
        return f

    return _add(fn) if fn is not None else _add


def _ensure_loaded(backend: KernelType) -> None:
    """Import the backend's kernel module on first use."""
    if backend in _LOADED:
        return
    _LOADED.add(backend)
    if backend is KernelType.REFERENCE:
        from repro_torch.fabric.backend import reference  # noqa: F401
    elif backend is KernelType.TORCH:
        from repro_torch.fabric.backend import torch_engine  # noqa: F401
        from repro_torch.fabric.backend import torch_kernels  # noqa: F401
    elif backend is KernelType.CUDA:
        from repro_torch.fabric.backend import cuda_kernels  # noqa: F401


def nearest_backend(name: str, requested: KernelType) -> Union[str, None]:
    """The closest registered stand-in for ``name`` when ``requested``
    has no implementation: the fastest backend below the requested one
    (``cuda -> torch -> reference``), or ``None`` for unknown kernels."""
    avail = available_backends(name)
    for candidate in ("torch", "reference"):
        if candidate != requested.value and candidate in avail:
            return candidate
    return None


def get_kernel(name: str, backend: Union[str, KernelType]) -> Callable:
    """The registered implementation of ``name`` on ``backend``."""
    bk = KernelType.parse(backend)
    _ensure_loaded(bk)
    try:
        return _REGISTRY[(name, bk)]
    except KeyError:
        if name not in KERNELS:
            raise BackendError(
                f"unknown kernel {name!r}; one of {KERNELS}") from None
        avail = tuple(b.value for (n, b) in _REGISTRY if n == name)
        near = nearest_backend(name, bk)
        hint = f"; nearest supported backend: {near!r}" if near else ""
        raise BackendError(
            f"kernel {name!r} has no {bk.value!r} implementation "
            f"(registered backends: {avail or '()'}){hint}") from None


def available_backends(name: str) -> Tuple[str, ...]:
    """Backends that implement ``name`` (loads the lazy modules)."""
    for bk in KernelType:
        _ensure_loaded(bk)
    return tuple(b.value for (n, b) in _REGISTRY if n == name)


def counterfactual_sweep(scenarios, backend: Union[str, KernelType] = "cuda",
                         device=None, dtype=None) -> list:
    """Run an arbitrary scenario list for the what-if advisor
    (:mod:`repro_torch.fabric.advisor`): every variant the batched runner
    can take (static jobs, fairness inside
    :data:`BATCHED_SCENARIO_FAIRNESS`, static routing) runs through it on
    ``backend``, ``device`` and ``dtype``, one program per structural
    group; the others (event timelines, exotic fairness, adaptive routing)
    run on the reference engine. Which variant goes where is decided
    before anything runs, by the runner's own test
    (:func:`~repro_torch.fabric.backend.torch_engine.batched_refusal`).
    There is no quiet stand-in: an error of the batched run (no card, a
    failed build or launch, a store that does not fit) ends the call.
    Returns ``(result, backend_name)`` pairs in input order, so the
    advisor can grade each prediction's confidence by the equivalence
    tier of the backend that produced it.
    """
    kind = KernelType.parse(backend, default=KernelType.CUDA)
    out: list = [None] * len(scenarios)
    eligible: list = []
    if kind in (KernelType.TORCH, KernelType.CUDA):
        from repro_torch.fabric.backend.torch_engine import (batched_refusal,
                                                             run_scenarios)
        eligible = [i for i, s in enumerate(scenarios)
                    if batched_refusal(s.jobs is not None,
                                       s.policies.fairness,
                                       s.policies.routing) is None]
        if eligible:
            results = run_scenarios(
                [(scenarios[i], None) for i in eligible], kernels=kind,
                device=device, dtype=dtype)
            for i, res in zip(eligible, results):
                out[i] = (res, kind.value)
    for i, s in enumerate(scenarios):
        if out[i] is None:
            out[i] = (s.run(backend="reference"), "reference")
    return out
