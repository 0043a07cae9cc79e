"""Mesh construction, over ``torch.distributed.device_mesh``.

The counterpart of ``repro.launch.mesh``. Defined as functions, so that
importing this module touches no process group. A mesh spans the
process group that is running (``torch.distributed.init_process_group``,
started by the caller: ``torchrun`` sets the rank and world size; NCCL
on cards, ``gloo`` on the CPU); nothing here starts one, and nothing runs
as one process in its stead.

Axes:
  * ``data``  -- pure data parallelism (gradient all-reduce tier; intra-pod)
  * ``model`` -- tensor parallelism (heads / ff / vocab sharding)
  * ``pod``   -- the cross-pod tier (multi-pod only): the oversubscribed
    fabric tier from the paper's study, and the axis the int8 gradient
    ring targets.

A ``model`` axis larger than 1 is tensor parallelism: every layer kind
has a tensor-parallel path, what the axis does not divide runs whole on
every rank, and only a MoE's expert widths that it does not divide are
refused, as the reference refuses them
(``models.transformer.require_supported``). Meshes are made on
``"cuda"`` unless the caller names ``"cpu"``. :func:`axes_group` gives the
process group over any subset of the axes. :func:`all_reduce` and
:func:`all_gather` are the collectives the port's layers, gradient
reduction and ZeRO-1 issue; :func:`collective_counts` counts every
collective the port issues (by kind), for the launch counts a step
reports, and :func:`collective_bytes` the operand bytes each sent, by
the reference's op kinds (``all-reduce``, ``all-gather`` and, for the
int8 ring's sends, ``collective-permute``: what
``repro.launch.roofline.parse_collective_bytes`` sums from the HLO, an
all-gather's operand and not its result); :func:`time_collectives` turns
on a timer of the host's
time inside :func:`all_reduce` and :func:`all_gather`
(:func:`collective_seconds`), off by default: each timed call first waits
for the device, so a timed step is slower than an untimed one.
"""
from __future__ import annotations

import itertools
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import MeshConfig

# the reference's collective op kinds (HLO opcode names)
COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "collective-permute")

_COUNTS: Counter = Counter()
_BYTES: Counter = Counter()
_GROUP_COUNTS: Dict[object, Counter] = {}
_TIMER = {"on": False, "s": 0.0}


def count(kind: str, n: int = 1, *, op: Optional[str] = None,
          nbytes: int = 0, group=None) -> None:
    """Count ``n`` collectives of ``kind`` (over ``group`` too, when it is
    given); with ``op`` (one of :data:`COLLECTIVE_OPS`) add the
    ``nbytes`` of operand they sent to :func:`collective_bytes`."""
    _COUNTS[kind] += n
    if group is not None:
        _GROUP_COUNTS.setdefault(group, Counter())[kind] += n
    if op is not None:
        if op not in COLLECTIVE_OPS:
            raise ValueError(f"unknown collective op {op!r}")
        _BYTES[op] += nbytes


def nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def time_collectives(on: bool) -> None:
    """Turn the collectives' timer on or off (and zero it when turned
    on): a timed :func:`all_reduce` or :func:`all_gather` adds the host's
    time inside it to :func:`collective_seconds`, the device synchronised
    before and after it for a CUDA tensor."""
    _TIMER["on"] = on
    if on:
        _TIMER["s"] = 0.0


def collective_seconds() -> float:
    """The host's seconds inside the collectives timed since
    :func:`time_collectives` turned the timer on."""
    return _TIMER["s"]


class _Timed:
    def __init__(self, x: torch.Tensor):
        self.on, self.cuda = _TIMER["on"], x.is_cuda

    def __enter__(self):
        if self.on:
            if self.cuda:
                torch.cuda.synchronize()
            self.t = time.perf_counter()

    def __exit__(self, *exc):
        if self.on:
            if self.cuda:
                torch.cuda.synchronize()
            _TIMER["s"] += time.perf_counter() - self.t


def collective_counts(group=None) -> Dict[str, int]:
    """Collectives issued by this process since
    :func:`reset_collective_counts`: ``all_reduce``, ``all_gather``,
    ``p2p`` (sends and receives) and ``barrier``; with ``group``, the
    :func:`all_reduce` and :func:`all_gather` calls over that group."""
    return dict(_COUNTS if group is None else
                _GROUP_COUNTS.get(group, Counter()))


def collective_bytes() -> Dict[str, int]:
    """The operand bytes of the collectives counted since
    :func:`reset_collective_counts`, by op kind (every kind of
    :data:`COLLECTIVE_OPS`, 0 where none was issued)."""
    return {op: _BYTES[op] for op in COLLECTIVE_OPS}


def reset_collective_counts() -> None:
    _COUNTS.clear()
    _BYTES.clear()
    _GROUP_COUNTS.clear()


def _init_device_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
                      device_type: str):
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no process group is running: start one first, e.g. "
            "torchrun --nproc-per-node=N (NCCL on cards: "
            "torch.distributed.init_process_group('nccl') after "
            "torch.cuda.set_device(local_rank); gloo on the CPU: "
            "init_process_group('gloo', init_method='tcp://127.0.0.1:<port>', "
            "world_size=N, rank=r))")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The 16 x 16 mesh (256 ranks) or the 2 x 16 x 16 one (512) over the
    running process group, whatever its backend: NCCL over that many
    cards, or the fake backend of the dry run
    (``torch.testing._internal.distributed.fake_pg``, ``device_type=
    "cpu"``), where every rank's collectives return at once."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _init_device_mesh(shape, axes, device_type)


def make_mesh(cfg: MeshConfig, *, device_type: str = "cuda"):
    return _init_device_mesh(tuple(cfg.shape), tuple(cfg.axes), device_type)


def make_local_mesh(model_parallel: Optional[int] = None, *,
                    device_type: str = "cuda"):
    """A ``(data, model)`` mesh over the running process group's world."""
    if not (dist.is_available() and dist.is_initialized()):
        _init_device_mesh((), (), device_type)          # raises with the how
    n = dist.get_world_size()
    mp = model_parallel or 1
    return _init_device_mesh((n // mp, mp), ("data", "model"), device_type)


def mesh_from_torchrun(device, model_parallel: int = 1):
    """Under ``torchrun`` (``WORLD_SIZE`` above 1): start the process
    group (gloo for ``device="cpu"``, else NCCL on ``LOCAL_RANK``'s card)
    and return (a ``(data, model_parallel)`` mesh of the ranks, the
    device); otherwise (``None``, ``device``)."""
    import os
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None, device
    cpu = device == "cpu"
    if not cpu:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        device = f"cuda:{local}"
    dist.init_process_group("gloo" if cpu else "nccl")
    return make_local_mesh(model_parallel,
                           device_type="cpu" if cpu else "cuda"), device


def mesh_shape(mesh) -> Dict[str, int]:
    """The mesh's axis sizes by name, in mesh order. Takes a
    ``DeviceMesh`` or anything with an ordered ``shape`` mapping (a
    stand-in with the production sizes, for the specs)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def mesh_config_for(mesh) -> MeshConfig:
    shape = mesh_shape(mesh)
    return MeshConfig(tuple(shape.values()), tuple(shape))


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))


def dp_size(mesh) -> int:
    shape = mesh_shape(mesh)
    n = 1
    for a in batch_axes(mesh):
        n *= shape[a]
    return n


def model_size(mesh) -> int:
    return mesh_shape(mesh).get("model", 1)


def coordinate(mesh, axes: Sequence[str]) -> int:
    """This rank's flat index over ``axes`` (in mesh order, the first
    major), as a ``P(("pod", "data"))`` sharding numbers its shards."""
    shape = mesh_shape(mesh)
    coords = dict(zip(shape, mesh.get_coordinate()))
    idx = 0
    for a in shape:
        if a in axes:
            idx = idx * shape[a] + coords[a]
    return idx


def axes_group(mesh, axes: Sequence[str]):
    """The process group over ``axes`` of the mesh: the ranks that share
    this rank's coordinates on every other axis, numbered as
    :func:`coordinate` numbers them. One axis's group is the mesh's own;
    for several axes, the whole world when every other axis has size 1,
    else one ``dist.new_group`` per set of ranks sharing the other axes'
    coordinates, made on every rank in the same order (the first call
    for these axes must be made on every rank) and kept on the mesh."""
    axes = tuple(a for a in mesh_shape(mesh) if a in tuple(axes))
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    shape = mesh_shape(mesh)
    ranks = mesh.mesh.flatten().tolist()
    if all(shape[a] == 1 for a in shape if a not in axes) and \
            ranks == list(range(dist.get_world_size())):
        return dist.group.WORLD
    cache = mesh.__dict__.setdefault("_repro_groups", {})
    if axes not in cache:
        names = list(shape)
        grid = mesh.mesh.reshape(tuple(shape.values()))
        others = [a for a in names if a not in axes]
        me = dist.get_rank()
        for fixed in itertools.product(*(range(shape[a]) for a in others)):
            index = tuple(fixed[others.index(a)] if a in others
                          else slice(None) for a in names)
            members = grid[index].flatten().tolist()
            group = dist.new_group(members)
            if me in members:
                cache[axes] = group
    return cache[axes]


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` summed (or its elementwise maximum, ``op="max"``) over
    ``group``, in place; counted as an ``all_reduce``. A tensor on the
    meta device (the dry run's trace) has no values: it is counted, and
    nothing is sent."""
    with _Timed(x):
        if not x.is_meta:
            dist.all_reduce(x, op=dist.ReduceOp.SUM if op == "sum"
                            else dist.ReduceOp.MAX, group=group)
    count("all_reduce", op="all-reduce", nbytes=nbytes(x), group=group)
    return x


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated along ``dim`` in the
    group's rank order; counted as an ``all_gather`` (on the meta device,
    shaped and counted, nothing sent: :func:`all_reduce`)."""
    x = x.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(x)
                                 for _ in range(dist.get_world_size(group))]
    with _Timed(x):
        if not x.is_meta:
            dist.all_gather(parts, x, group=group)
    count("all_gather", op="all-gather", nbytes=nbytes(x), group=group)
    return torch.cat(parts, dim=dim)
