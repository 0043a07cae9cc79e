"""Rank -> node placement policies (paper §3.3, "locality-driven variance").

The paper's production traces show the *same* job, same fabric, scaling
differently run-to-run because the scheduler handed it different node sets:
a job packed under one leaf rides non-blocking links, a job scattered across
leaves pays the oversubscribed tier on every ring hop. These policies turn
that into a first-class experimental axis for the shared-fabric engine:

  * ``compact``    — lowest-index free nodes, contiguous (best locality);
  * ``scattered``  — round-robin one node per leaf/pod (worst locality: every
    hop crosses the shared tier);
  * ``striped``    — fixed-stride selection over the free list (the classic
    "rank i on node i*stride" allocation that schedulers produce under
    fragmentation);
  * ``random``     — seeded shuffle of the free nodes (run-to-run variance);
  * ``slo_aware``  — SLO-aware placement for latency-bound tenants: a spec
    carrying ``slo_p99_s`` has each replica chunk packed whole into the
    *best-fit* leaf (smallest free-node count that still fits), so
    latency-bound collectives stay at leaf span 1 and the big contiguous
    holes — and the oversubscribed tier — are left for trainers to absorb.
    Falls back per chunk to compact packing over the remaining free nodes
    when no single leaf fits, and behaves exactly like ``compact`` for
    specs without an SLO (trainers).

Every policy returns a bijective rank -> node mapping: ``len(nodes) == n``
distinct node ids, ``nodes[r]`` hosting rank ``r``.

Policies receive the placed tenant's spec via the optional ``spec=``
keyword (``place()`` only forwards it to policies that accept it, so
pre-existing third-party registrations keep working); ``slo_aware`` is the
first policy that reads it — ``slo_p99_s`` marks the tenant latency-bound
and ``n_ranks`` gives the per-replica chunk size for multi-replica fleets.
"""
from __future__ import annotations

import inspect
import random
from typing import Iterable, List, Optional, Sequence

from repro_torch.fabric.policies import PLACEMENTS
from repro_torch.fabric.topology import Topology


def group_size(topo: Topology) -> int:
    """Nodes per locality group (leaf for fat-tree and multi-pod, pod for
    TPU, NVLink node for rail-optimized)."""
    size = getattr(topo, "nodes_per_leaf", None) \
        or getattr(topo, "gpus_per_node", None) \
        or getattr(topo, "ranks_per_pod", None)
    return int(size) if size else topo.n_ranks


def group_of(topo: Topology, node: int) -> int:
    return node // group_size(topo)


def _free_nodes(topo: Topology, taken: Iterable[int]) -> List[int]:
    taken = set(taken)
    return [i for i in range(topo.n_ranks) if i not in taken]


def compact(topo: Topology, n: int, free: Sequence[int]) -> List[int]:
    return list(free[:n])


def scattered(topo: Topology, n: int, free: Sequence[int]) -> List[int]:
    by_group: dict = {}
    for node in free:
        by_group.setdefault(group_of(topo, node), []).append(node)
    queues = [by_group[g] for g in sorted(by_group)]
    out: List[int] = []
    while len(out) < n:
        progressed = False
        for q in queues:
            if q and len(out) < n:
                out.append(q.pop(0))
                progressed = True
        if not progressed:
            break
    return out


def striped(topo: Topology, n: int, free: Sequence[int],
            stride: int = 0) -> List[int]:
    stride = stride or group_size(topo)
    pool = list(free)
    out: List[int] = []
    offset = 0
    while len(out) < n and pool:
        picked = pool[offset::stride]
        for node in picked:
            if len(out) == n:
                break
            out.append(node)
            pool.remove(node)
        offset = (offset + 1) % max(1, stride)
    return out


def random_placement(topo: Topology, n: int, free: Sequence[int],
                     seed: int = 0) -> List[int]:
    pool = list(free)
    random.Random(seed).shuffle(pool)
    return pool[:n]


def slo_aware(topo: Topology, n: int, free: Sequence[int],
              spec: Optional[object] = None) -> List[int]:
    """SLO-aware placement (see module docstring).

    Latency-bound tenants (``spec.slo_p99_s`` set) are packed one replica
    chunk per leaf, best-fit; anything else — trainers, SLO-less fleets,
    or a call without a spec — degrades to :func:`compact`. The fallback
    when no leaf can host a whole chunk is compact packing of that chunk
    over whatever free nodes remain (graceful, never a failure as long as
    ``n`` nodes are free)."""
    if spec is None or getattr(spec, "slo_p99_s", None) is None:
        return compact(topo, n, free)
    chunk = int(getattr(spec, "n_ranks", n) or n)
    if chunk <= 0 or chunk > n:
        chunk = n
    by_group: dict = {}
    for node in free:
        by_group.setdefault(group_of(topo, node), []).append(node)
    out: List[int] = []
    placed = 0
    while placed < n:
        want = min(chunk, n - placed)
        # best-fit: the leaf with the fewest free nodes that still hosts
        # the whole chunk keeps large holes (and the shared tier) free for
        # trainers; lowest group index among ties for determinism
        fit = [g for g, q in by_group.items() if len(q) >= want]
        if fit:
            g = min(fit, key=lambda g: (len(by_group[g]), g))
            take, by_group[g] = by_group[g][:want], by_group[g][want:]
        else:
            # no low-span leaf fits this chunk: fall back to compact over
            # the remaining free nodes (the chunk pays the shared tier)
            rest = sorted(nd for q in by_group.values() for nd in q)
            take = rest[:want]
            taken = set(take)
            for g in by_group:
                by_group[g] = [nd for nd in by_group[g] if nd not in taken]
        out.extend(take)
        placed += want
    return out


# Registry entries share one signature: fn(topo, n, free, *, seed) -> nodes,
# optionally accepting spec= (the placed tenant's spec) — place() inspects
# the policy and only forwards spec to entries that declare it, so
# third-party policies register the same way and become available to
# JobSpec(placement=...) and Scenario policy blocks without engine changes.
PLACEMENTS.register("compact", lambda topo, n, free, *, seed=0:
                    compact(topo, n, free))
PLACEMENTS.register("scattered", lambda topo, n, free, *, seed=0:
                    scattered(topo, n, free))
PLACEMENTS.register("striped", lambda topo, n, free, *, seed=0:
                    striped(topo, n, free))
PLACEMENTS.register("random", lambda topo, n, free, *, seed=0:
                    random_placement(topo, n, free, seed=seed))

# registration-order snapshot, kept for the existing sweep loops over the
# four locality policies; the registry is the live source of truth for
# later registrations (slo_aware below, third-party entries)
POLICIES = PLACEMENTS.names()

PLACEMENTS.register("slo_aware", lambda topo, n, free, *, seed=0, spec=None:
                    slo_aware(topo, n, free, spec=spec))


def _accepts_spec(fn) -> bool:
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    return "spec" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


def place(policy: str, topo: Topology, n: int, *,
          taken: Iterable[int] = (), seed: int = 0,
          spec: Optional[object] = None) -> List[int]:
    """Map ``n`` ranks onto distinct free nodes of ``topo``.

    ``policy`` is resolved through the :data:`~repro_torch.fabric.policies.
    PLACEMENTS` registry. ``taken`` holds node ids already owned by
    co-tenant jobs; ``spec`` is the placed tenant's spec, forwarded to
    policies that accept it (``slo_aware`` reads ``slo_p99_s`` and the
    per-replica chunk size from it). Raises if the fabric cannot host
    ``n`` more ranks or the policy is unknown.
    """
    fn = PLACEMENTS.get(policy)
    free = _free_nodes(topo, taken)
    if n > len(free):
        raise ValueError(
            f"placement {policy!r}: need {n} nodes, only {len(free)} free "
            f"on {topo.name}")
    if spec is not None and _accepts_spec(fn):
        nodes = fn(topo, n, free, seed=seed, spec=spec)
    else:
        nodes = fn(topo, n, free, seed=seed)
    assert len(nodes) == n and len(set(nodes)) == n
    return nodes


def spanning_groups(topo: Topology, nodes: Sequence[int]) -> int:
    """Distinct leaves/pods a node set touches (ECMP spread of the job)."""
    return max(1, len({group_of(topo, nd) for nd in nodes}))
