"""Atomic, async checkpointing with elastic restore, over torch tensors.

The counterpart of ``repro.ckpt.checkpoint`` with the reference's on-disk
layout, so that a checkpoint written by either package restores in the
other: ``<dir>/step_<n>/`` holding one ``.npy`` per tree leaf, named by its
path (``/0/body/0/mixer/wq`` is ``0.body.0.mixer.wq.npy``), and
``manifest.json`` (``step``, each leaf's ``shape`` and ``dtype`` name,
the caller's ``user`` metadata). A save is written to ``step_<n>.tmp``
and renamed only after its files are on the disk, so a crashed save never
shadows a good checkpoint; ``keep`` steps are retained, and one save is in
flight at a time. bfloat16 is stored as its raw bytes (``uint8``, the
last axis twice as long) with ``"bfloat16"`` in the manifest, as the
reference stores it: the bytes are taken with ``tensor.view(torch.uint8)``
and read back with ``.view(torch.bfloat16)``, so no ``ml_dtypes`` is needed.

A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or :class:`Stacked` leaves (per-layer tensors that the file holds
stacked on a leading axis: ``models.convert.train_state_tree`` builds the
reference's tree from the port's per-layer parameters with them). A part
of a :class:`Stacked` leaf may also be a function returning the tensor
(a ZeRO-1 moment gathered from its shards when the snapshot reaches it).

``save`` snapshots to host memory before it returns and writes in a
background thread. The snapshot is a copy: on the CPU every leaf is
cloned (a ``.numpy()`` view would share the parameter's storage, which
the optimizer writes in place, and an async save would write a later
step's values); a CUDA leaf is copied into pinned host memory and the
device synchronised once. ``last_save`` holds the snapshot's seconds
(``pin_s`` of them allocating pinned memory), the write's and the bytes.
Departure from the reference: every file is ``fsync``-ed before the
rename (the reference syncs the manifest only).

``restore(step, like, device=, placement_fn=)`` writes into the tensors of
``like`` in place (a model's ``nn.Parameter`` objects are kept), and
returns new tensors on ``device`` where ``like`` holds no tensor.
``placement_fn(path, host)`` stands where the reference's ``sharding_fn``
does: it returns the part of the full host leaf that this rank keeps
under the current mesh (a ZeRO-1 slice, a tensor-parallel shard), so a
checkpoint written at one ``(data, model)`` restores at another. For a :class:`Stacked` leaf it is called
per layer, with ``path[t]``. A leaf of the file with no place in ``like``,
a place with no leaf, or a shape or dtype that differs raises
``ValueError``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

Tree = Any


class Stacked(list):
    """Per-layer tensors (or functions returning them) that the checkpoint
    holds as one leaf, stacked on a new leading axis."""


def _flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten_with_paths(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Stacked):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten_with_paths(v, f"{prefix}/{i}"))
        return out
    return [(prefix, tree)]


def _unflatten_like(ref: Any, values: Dict[str, Any], prefix: str = ""):
    if isinstance(ref, dict):
        return {k: _unflatten_like(ref[k], values, f"{prefix}/{k}")
                for k in ref}
    if isinstance(ref, (list, tuple)) and not isinstance(ref, Stacked):
        vals = [_unflatten_like(v, values, f"{prefix}/{i}")
                for i, v in enumerate(ref)]
        if isinstance(ref, list):
            return vals
        return type(ref)(*vals) if hasattr(ref, "_fields") else tuple(vals)
    return values[prefix]


def _path_to_fname(path: str) -> str:
    return path.strip("/").replace("/", ".") + ".npy"


def dtype_name(dtype: torch.dtype) -> str:
    """The manifest's name of a torch dtype (numpy's: ``float32``,
    ``bfloat16``, ``int32``)."""
    return str(dtype).replace("torch.", "")


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"the checkpoint holds dtype {name!r}, which torch "
                         f"does not know")
    return dt


def _to_savable(t: torch.Tensor) -> np.ndarray:
    """The array ``np.save`` writes: the tensor's own, or its raw bytes
    for a dtype numpy does not have (bfloat16, float8)."""
    try:
        return t.numpy()
    except TypeError:
        return (t.reshape(1) if t.dim() == 0 else t).view(torch.uint8).numpy()


def _from_savable(raw: np.ndarray, shape, name: str) -> torch.Tensor:
    dt = _torch_dtype(name)
    t = torch.from_numpy(np.ascontiguousarray(raw))
    if t.dtype == torch.uint8 and dt != torch.uint8:
        t = t.view(dt)
    return t.reshape(tuple(shape))


def _tensor(x) -> torch.Tensor:
    x = x() if callable(x) else x
    return torch.from_numpy(np.asarray(x)) if isinstance(x, np.ndarray) \
        else x.detach()


class CheckpointManager:
    """``write=False`` (the ranks other than 0 under a mesh) snapshots
    nothing and writes nothing, but still calls the functions among the
    leaves' parts, which may be collectives every rank must join."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True, write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self.write = write
        self.last_save: Dict[str, float] = {}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ----------------------------------------------------------------
    def _host_buffer(self, shape, t: torch.Tensor) -> torch.Tensor:
        """An empty host tensor for ``t``'s values: pinned for a CUDA
        tensor (the seconds spent pinning are counted)."""
        t0 = time.perf_counter()
        host = torch.empty(shape, dtype=t.dtype,
                           pin_memory=t.device.type == "cuda")
        self._pin_s += time.perf_counter() - t0
        return host

    def _snapshot(self, leaf) -> Optional[torch.Tensor]:
        """A host copy of ``leaf`` that nothing else writes."""
        parts = leaf if isinstance(leaf, Stacked) else [leaf]
        host = None
        for i, part in enumerate(parts):
            t = _tensor(part)
            if not self.write:
                continue
            if host is None:
                host = self._host_buffer(
                    ((len(parts),) if isinstance(leaf, Stacked) else ())
                    + tuple(t.shape), t)
            (host[i] if isinstance(leaf, Stacked) else host).copy_(
                t, non_blocking=True)
        return host

    def save(self, step: int, tree: Tree, metadata: Optional[Dict] = None,
             *, block: bool = False) -> None:
        """Snapshot to host memory now, write in the background (unless
        ``block`` or ``async_save=False``)."""
        t0 = time.perf_counter()
        self._pin_s = 0.0
        host = [(p, self._snapshot(v)) for p, v in _flatten_with_paths(tree)]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        snap_s = time.perf_counter() - t0
        if not self.write:
            return
        meta = {
            "step": step,
            "leaves": {p: {"shape": list(v.shape), "dtype": dtype_name(v.dtype)}
                       for p, v in host},
            "user": metadata or {},
        }
        self.wait()                    # one in-flight save at a time
        self.last_save = {"step": step, "snapshot_s": snap_s,
                          "pin_s": self._pin_s,
                          "bytes": sum(v.numel() * v.element_size()
                                       for _, v in host)}
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host, meta),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host, meta)

    def _write_guarded(self, step, host, meta) -> None:
        try:
            self._write(step, host, meta)
        except BaseException as e:     # re-raised by wait()
            self._error = e

    def _write(self, step: int, host, meta) -> None:
        t0 = time.perf_counter()
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for p, v in host:
            with open(os.path.join(tmp, _path_to_fname(p)), "wb") as f:
                np.save(f, _to_savable(v))
                f.flush()
                os.fsync(f.fileno())
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        self.last_save["write_s"] = time.perf_counter() - t0

    def wait(self) -> None:
        """Wait for the save in flight; raise what its write raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("the background checkpoint write failed") \
                from err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(
        self,
        step: int,
        like: Tree,
        *,
        device=None,
        placement_fn: Optional[Callable[[str, torch.Tensor],
                                        torch.Tensor]] = None,
    ) -> Tuple[Tree, Dict]:
        """Restore into the structure of ``like`` (see the module's
        docstring). Returns (the tree, the user metadata)."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            meta = json.load(f)
        places = dict(_flatten_with_paths(like))
        extra = sorted(set(meta["leaves"]) - set(places))
        missing = sorted(set(places) - set(meta["leaves"]))
        if extra or missing:
            raise ValueError(f"step {step}: leaves with no place in the tree "
                             f"{extra}, places with no leaf {missing}")
        place = placement_fn or (lambda path, host: host)
        values = {}
        for path, info in meta["leaves"].items():
            raw = np.load(os.path.join(d, _path_to_fname(path)))
            host = _from_savable(raw, info["shape"], info["dtype"])
            del raw
            dst = places[path]
            if isinstance(dst, Stacked):
                if host.shape[0] != len(dst):
                    raise ValueError(f"{path}: leading axis {host.shape[0]}, "
                                     f"the tree stacks {len(dst)}")
                for t, part in enumerate(dst):
                    _copy_into(f"{path}[{t}]", part,
                               place(f"{path}[{t}]", host[t]))
                values[path] = dst
            elif isinstance(dst, torch.Tensor):
                _copy_into(path, dst, place(path, host))
                values[path] = dst
            else:
                values[path] = place(path, host).to(
                    device if device is not None else "cpu")
        return _unflatten_like(like, values), meta["user"]


def _copy_into(path: str, dst: torch.Tensor, src: torch.Tensor) -> None:
    if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
        raise ValueError(f"{path}: the checkpoint's {tuple(src.shape)} "
                         f"{dtype_name(src.dtype)}, the tree's "
                         f"{tuple(dst.shape)} {dtype_name(dst.dtype)}")
    with torch.no_grad():
        dst.copy_(src)
