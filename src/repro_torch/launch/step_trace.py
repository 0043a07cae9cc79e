"""One rank's step traced on the meta device: the dry run's counterpart of
XLA's ``cost_analysis()`` and ``memory_analysis()``.

The reference lowers and compiles a step for the production mesh and
reads per-device FLOPs, "bytes accessed" and buffer sizes from the
compiled module. The port has no compiler: it runs one rank's step with
every tensor on the meta device (shapes and dtypes, no values), the
collectives going to the running process group (the fake backend of
``torch.testing._internal.distributed.fake_pg`` in the dry run, where
they return at once), and counts as it goes:

  * **FLOPs**: the formulas of ``torch.utils.flop_counter``'s registry,
    those ``FlopCounterMode`` applies (matmuls, batched matmuls,
    convolutions, attention), applied op by op as the ops run;
    elementwise work is not counted, where XLA counts some of it;
  * **bytes accessed**: every op's tensor operands and results summed
    (:class:`_Tracer`), the unfused traffic XLA's "bytes accessed" sums;
    views, allocations without a fill and the collectives (counted
    apart) move none;
  * **collectives**: the counts and operand bytes that
    ``launch.mesh.collective_counts`` / ``collective_bytes`` record;
  * **memory**: the argument bytes (what the step is handed and keeps:
    this rank's parameters, optimizer state and its slice of the batch,
    or its cache), the output bytes (what the step returns or writes in
    place; ``alias`` the part written in place), and the peak of live
    bytes during the step, each storage counted from its allocation until
    it is freed (``weakref.finalize`` on the storage).

The Python layer loop runs every layer, so nothing is extrapolated. The
kernel backend is ``"torch"``: no kernel launches on meta. Where a plain
version needs values (the MoE's group sizes, which go to the host) or
would take minutes of dispatch (the scans one token at a time), the meta
device takes the reference's cost-mode or chunked form instead
(``models.mlp``, ``kernels.ops``).
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, Iterable, Set

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import mesh as mesh_lib

# ops that read and write no element: allocations without a fill
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "lift_fresh", "alias"}


def _tensors(tree) -> Iterable[torch.Tensor]:
    """The tensors of an op's arguments or results: a tensor, or a list,
    tuple or dict of them (one level, as aten's schemas nest them)."""
    if isinstance(tree, torch.Tensor):
        return (tree,)
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return ()
    out = []
    for t in tree:
        if isinstance(t, torch.Tensor):
            out.append(t)
        elif isinstance(t, (list, tuple)):
            out.extend(u for u in t if isinstance(u, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Tracer(TorchDispatchMode):
    """Counts every op's FLOPs, sums its operand and result bytes, and
    tracks the bytes of the storages alive."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen: Set[int] = set()

    def hold(self, tensors: Iterable[torch.Tensor]) -> int:
        """Count the storages of ``tensors`` alive from now on (once
        each); returns the bytes added."""
        added = 0
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            self._seen.add(key)
            n = st.nbytes()
            added += n
            weakref.finalize(st, self._free, key, n)
        self.live += added
        self.peak = max(self.peak, self.live)
        return added

    def keep(self, tensors: Iterable[torch.Tensor], nbytes: int) -> None:
        """Count ``nbytes`` alive for the storages of ``tensors`` (the
        part of them this rank keeps), for good."""
        for t in tensors:
            self._seen.add(t.untyped_storage()._cdata)
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if not func.is_view and \
                func.namespace not in ("c10d", "_c10d_functional") \
                and func._opname not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(t) for t in _tensors(args))
            self.bytes += sum(_nbytes(t) for t in _tensors(kwargs))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        self.hold(_tensors(out))
        return out


@dataclasses.dataclass
class StepTrace:
    """What a traced step counted, for one rank."""
    flops: float
    bytes_accessed: float
    collectives: Dict[str, Any]        # total_bytes, bytes_by_op, counts
    memory: Dict[str, int]
    trace_s: float

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def trace_step(run: Callable[[], Any], args: Iterable[torch.Tensor],
               kept: Iterable[torch.Tensor] = (), kept_bytes: int = 0
               ) -> StepTrace:
    """Run ``run()`` (one step on meta tensors) under the counters.
    ``args`` are the tensors the step is handed whole (its parameters,
    state, cache); ``kept`` the tensors of which it keeps ``kept_bytes``
    only (the global batch, of which a rank keeps its slice). The step's
    return value and ``args`` (written in place) are its outputs."""
    args = list(args)
    mesh_lib.reset_collective_counts()
    tracer = _Tracer()
    t0 = time.perf_counter()
    arg_bytes = tracer.hold(args)
    tracer.keep(kept, kept_bytes)
    arg_bytes += kept_bytes
    with tracer:
        result = run()
    arg_keys = {t.untyped_storage()._cdata for t in args}
    outs: Dict[int, int] = {}
    for t in [t for t in tree_leaves(result)
              if isinstance(t, torch.Tensor)] + args:
        st = t.untyped_storage()
        outs[st._cdata] = st.nbytes()
    alias = sum(n for k, n in outs.items() if k in arg_keys)
    by_op = mesh_lib.collective_bytes()
    counts = mesh_lib.collective_counts()
    return StepTrace(
        flops=float(tracer.flops),
        bytes_accessed=float(tracer.bytes),
        collectives={"total_bytes": sum(by_op.values()),
                     "bytes_by_op": by_op, "counts": counts},
        memory={"argument_size_in_bytes": arg_bytes,
                "output_size_in_bytes": sum(outs.values()),
                "alias_size_in_bytes": alias,
                "peak_size_in_bytes": tracer.peak,
                "temp_size_in_bytes": tracer.peak - arg_bytes},
        trace_s=time.perf_counter() - t0)
