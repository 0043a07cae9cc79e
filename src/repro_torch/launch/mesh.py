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

The port runs data parallelism only: a mesh whose ``model`` axis is
larger than 1 is refused by the step factories
(:func:`require_data_parallel`). Meshes are made on ``"cuda"`` unless the
caller names ``"cpu"``. :func:`collective_counts` counts the collectives
the port issues (by kind), for the launch counts a step reports.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist

from repro_torch.configs.base import MeshConfig

TP_ITEM = ("ROADMAP.md Queue 1 item 11, its tensor-parallel half (a "
           "'model' axis larger than 1)")

_COUNTS: Counter = Counter()


def count(kind: str, n: int = 1) -> None:
    _COUNTS[kind] += n


def collective_counts() -> Dict[str, int]:
    """Collectives issued by this process since
    :func:`reset_collective_counts`: ``all_reduce``, ``all_gather``,
    ``p2p`` (sends and receives) and ``barrier``."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    _COUNTS.clear()


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


def require_data_parallel(mesh) -> None:
    """Raise ``NotImplementedError`` for a ``model`` axis larger than 1."""
    if mesh_shape(mesh).get("model", 1) > 1:
        raise NotImplementedError(
            f"a mesh whose 'model' axis is {mesh_shape(mesh)['model']}: the "
            f"port runs data parallelism only until {TP_ITEM} is ported")


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
    """The process group over ``axes`` of the mesh: one axis's group, or,
    for several axes when every other axis has size 1, the whole world
    (whose rank order is then the flat index over ``axes``)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    shape = mesh_shape(mesh)
    ranks = mesh.mesh.flatten().tolist()
    if all(shape[a] == 1 for a in shape if a not in axes) and \
            ranks == list(range(dist.get_world_size())):
        return dist.group.WORLD
    raise NotImplementedError(
        f"a process group over {axes} of a mesh {shape}: the port builds "
        f"one only when the other axes have size 1 ({TP_ITEM})")
