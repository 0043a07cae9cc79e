"""Logical-axis sharding: models name tensor dims with logical axis names;
the launcher binds those names to physical mesh axes (MaxText-style rules).

The counterpart of ``repro.launch.sharding`` for the rules and their
resolution: ``DEFAULT_RULES``, ``axis_rules``, ``active_mesh``,
``fallbacks``, ``resolve_spec`` and ``named_sharding``. A spec is a tuple
with the reference's ``PartitionSpec`` entries: ``None``, a mesh axis
name, or a tuple of names. Resolution applies the same **divisibility
fallback**: when a dim is not divisible by the product of its mapped axes'
sizes, trailing axes are dropped until it is (else it replicates), and
every fallback is recorded as ``(logical name, dim, divisor)``.
``resolve_spec`` reads only the mesh's axis sizes, so the bound mesh may
be a ``DeviceMesh`` or anything with an ordered ``shape`` mapping (the
production sizes, with no ranks behind them).

``logical(x, *spec)`` keeps the reference's rank check and is otherwise
the identity: on a data-parallel mesh each rank already holds its local
slice, and the port has no compiler to take a sharding constraint.
``named_sharding`` gives DTensor placements (``Shard(dim)`` or
``Replicate()`` per mesh axis). ``tp_row_matmul``, ``manual_axes`` and
``shard_map_mesh`` come with the tensor-parallel slice.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch.mesh import mesh_shape

LogicalSpec = Sequence[Union[str, None, Tuple[str, ...]]]
Spec = Tuple[Union[str, None, Tuple[str, ...]], ...]

# Default logical -> physical rules for the production meshes. "batch" spans
# the pure-DP axes; "model-ish" names map to the TP axis.
DEFAULT_RULES: Dict[str, Union[str, Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "ddp": ("pod", "data"),        # optimizer-state (ZeRO-1) sharding axis
    "model": "model",
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "embed": None,                 # d_model stays unsharded in activations
    "seq": None,                   # context parallelism binds this (hillclimb)
    "expert": None,                # EP binds this (hillclimb); baseline: F-shard
    "state": None,
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Optional[Dict[str, Union[str, Tuple[str, ...]]]] = None
        self.fallbacks: List[Tuple[str, int, int]] = []


_ctx = _Ctx()


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[Dict] = None):
    """Bind logical axis names to *mesh* for the duration of the context."""
    prev = (_ctx.mesh, _ctx.rules)
    _ctx.mesh = mesh
    _ctx.rules = dict(DEFAULT_RULES, **(rules or {}))
    _ctx.fallbacks = []
    try:
        yield
    finally:
        _ctx.mesh, _ctx.rules = prev


def active_mesh():
    return _ctx.mesh


def fallbacks() -> List[Tuple[str, int, int]]:
    """(logical_name, dim_size, required_divisor) replication fallbacks seen."""
    return list(_ctx.fallbacks)


def _mesh_axes_for(name: Optional[str], shape: Dict[str, int]
                   ) -> Tuple[str, ...]:
    if name is None:
        return ()
    rule = _ctx.rules.get(name, None)
    if rule is None:
        return ()
    axes = (rule,) if isinstance(rule, str) else tuple(rule)
    # drop axes not present in the active mesh (e.g. "pod" on single-pod)
    return tuple(a for a in axes if a in shape)


def resolve_spec(shape: Sequence[int], spec: LogicalSpec) -> Spec:
    """Logical spec -> physical spec with divisibility fallback."""
    if _ctx.mesh is None:
        raise RuntimeError("resolve_spec needs a mesh bound by axis_rules")
    sizes = mesh_shape(_ctx.mesh)
    out: List = []
    for dim, names in zip(shape, spec):
        if names is None:
            out.append(None)
            continue
        logical_names = (names,) if isinstance(names, str) else tuple(names)
        phys: List[str] = []
        for nm in logical_names:
            phys.extend(_mesh_axes_for(nm, sizes))
        if not phys:
            out.append(None)
            continue
        div = 1
        for a in phys:
            div *= sizes[a]
        if dim % div != 0:
            # Try dropping trailing physical axes until divisible (partial
            # sharding beats full replication), else replicate.
            while phys and dim % div != 0:
                dropped = phys.pop()
                div //= sizes[dropped]
            _ctx.fallbacks.append(
                ("/".join(map(str, logical_names)), dim, div))
        if not phys:
            out.append(None)
        elif len(phys) == 1:
            out.append(phys[0])
        else:
            out.append(tuple(phys))
    return tuple(out)


def logical(x: torch.Tensor, *spec: Union[str, None, Tuple[str, ...]]):
    """The reference's sharding constraint: the rank check, then the
    identity (see the module's docstring)."""
    if _ctx.mesh is None:
        return x
    if len(spec) != x.dim():
        raise ValueError(f"spec {spec} rank != array rank {x.dim()}")
    return x


def named_sharding(shape: Sequence[int], spec: LogicalSpec):
    """DTensor placements for the resolved spec: per mesh axis,
    ``Shard(d)`` for the tensor dim it shards, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    if _ctx.mesh is None:
        raise RuntimeError("named_sharding needs a mesh bound by axis_rules")
    phys = resolve_spec(shape, spec)
    by_axis = {}
    for d, e in enumerate(phys):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            by_axis[a] = d
    return tuple(Shard(by_axis[a]) if a in by_axis else Replicate()
                 for a in mesh_shape(_ctx.mesh))
