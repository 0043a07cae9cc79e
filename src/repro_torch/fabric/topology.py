"""Network/fabric topology models (paper §3.1).

Four families, matching the paper's GPU clusters, our TPU adaptation, and
the giga-scale fabrics of arXiv:2605.21187:

  * :func:`fat_tree` — hierarchical leaf/spine Ethernet-or-IB fabric with
    configurable oversubscription (the paper's production clusters);
  * :func:`tpu_pod`  — 2-D ICI torus inside a pod plus an oversubscribed
    DCN tier across pods (the hardware this framework targets; the "pod"
    mesh axis in launch/mesh.py is exactly the DCN tier);
  * :func:`rail_optimized` — GPUs fully connected in-node (NVLink-class)
    with one NIC per GPU wired to a per-rail switch, so same-rail traffic
    never crosses the spine;
  * :func:`multi_pod` — dragonfly-style pod graph: leaf/spine inside each
    pod plus ``inter_pod_links`` parallel global links per pod pair.

The topology exposes, for a set of communicating ranks, which *links* each
ring hop crosses, so collective cost models can find the bottleneck link and
account for flows sharing it — the paper's "traffic concentrates on specific
links or switches" effect (§3.2) falls out structurally instead of being a
fudge factor.

Representation contracts:

  * ``fat_tree`` / ``tpu_pod`` materialize every link eagerly — their
    ``links`` dict is dense, and the congestion model tracks all shared
    links from step 0 (this ordering is pinned bit-exactly by the golden
    fixtures and fingerprint baselines).
  * ``rail_optimized`` / ``multi_pod`` set ``sparse_links = True`` and
    materialize links lazily on first :meth:`Topology.link` access, so
    memory and per-step cost scale with the links *active tenants*
    actually occupy — the 100k+-rank regime of the giga-scale roadmap
    item. Sparse link parameters are pure functions of the link name, so
    lazy and eager materialization are bit-identical (property-tested).
  * A hop may name a *routing group* instead of a single link, spelled
    ``@<group>#<salt>`` (see :func:`is_route_token`).  The ``ROUTING``
    policy registry (``repro_torch.fabric.policies``) decides how collective
    schedules map the token onto the group's parallel member links:
    ``ecmp_static`` (default, bit-compat — salt picks one member) or
    ``adaptive_spray`` (bytes re-split across all members each iteration
    from observed utilization).  Only ``multi_pod`` emits tokens today.
  * ``sharp_capacity_bytes`` (> 0 on topologies whose switches aggregate)
    opts the topology into the ``sharp`` in-network allreduce algo; the
    reference backend is the executable spec for its cost model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Link:
    name: str
    bw_gbps: float                    # GB/s (bytes, not bits)
    latency_s: float
    shared: bool = False              # crosses an oversubscribed tier


# hop entries starting with this prefix are routing-group tokens, not link
# names: "@<group>#<salt>" — resolved by the ROUTING policy at schedule
# compile time (ecmp_static) or at cost-evaluation time (adaptive_spray)
ROUTE_PREFIX = "@"


def is_route_token(name: str) -> bool:
    """True when a hop entry names a routing group, not a single link."""
    return name.startswith(ROUTE_PREFIX)


def parse_route_token(token: str) -> Tuple[str, int]:
    """Split ``"@pp0-1#3"`` into ``("pp0-1", 3)`` (group name, flow salt)."""
    group, _, salt = token[1:].partition("#")
    return group, int(salt or 0)


@dataclasses.dataclass
class Topology:
    """A set of named links plus a mapping rank-pair -> links crossed."""
    name: str
    n_ranks: int
    links: Dict[str, Link]
    kind: str = "fat_tree"
    # static per-rank locality multiplier on NIC-path efficiency (paper's
    # "GPU locality and intra-node effects": non-uniform PCIe/NUMA paths).
    nic_efficiency: Tuple[float, ...] = ()

    # dense by default: every link exists in `links` from construction.
    # Sparse subclasses flip this and materialize via `_make_link` on
    # first access, so the congestion model knows to track lazily.
    sparse_links = False
    # > 0 opts into the `sharp` in-network allreduce algo: the switch tier
    # can aggregate payloads up to this many bytes in-network.
    sharp_capacity_bytes = 0.0

    # -- construction helpers ----------------------------------------------
    def link(self, name: str) -> Link:
        return self.links[name]

    def has_link(self, name: str) -> bool:
        """True when `name` denotes a link this topology can materialize
        (used by event validation for LinkFlap/LinkDegrade targets)."""
        if name in self.links:
            return True
        if not self.sparse_links:
            return False
        try:
            self.link(name)
        except KeyError:
            return False
        return True

    def path_group(self, group: str) -> List[str]:
        """Member link names of a routing group (parallel equal-cost
        paths). Only topologies that emit route tokens implement this."""
        raise KeyError(f"topology {self.name!r} has no routing group "
                       f"{group!r}")

    def hop_links(self, a: int, b: int) -> List[str]:
        """Links crossed by one unidirectional transfer rank a -> rank b."""
        raise NotImplementedError

    def ring_hops(self, ranks: Sequence[int]) -> List[List[str]]:
        """Per ring hop (i -> i+1), the links crossed."""
        n = len(ranks)
        return [self.hop_links(ranks[i], ranks[(i + 1) % n])
                for i in range(n)]


class _SparseTopology(Topology):
    """Mixin-style base for lazily materialized topologies: `links` holds
    only what has been touched; `link()` builds missing entries from the
    name alone, so sparse and dense materialization are bit-identical."""

    sparse_links = True

    def link(self, name: str) -> Link:
        hit = self.links.get(name)
        if hit is None:
            try:
                hit = self._make_link(name)
            except ValueError:
                raise KeyError(name) from None
            self.links[name] = hit
        return hit

    def _make_link(self, name: str) -> Link:
        raise NotImplementedError


@dataclasses.dataclass
class FatTree(Topology):
    nodes_per_leaf: int = 8

    def hop_links(self, a: int, b: int) -> List[str]:
        la, lb = a // self.nodes_per_leaf, b // self.nodes_per_leaf
        if la == lb:
            return [f"leaf{la}"]
        # up from leaf la through spine, down to leaf lb
        return [f"up{la}", "spine", f"up{lb}"]


@dataclasses.dataclass
class TpuPod(Topology):
    ranks_per_pod: int = 256

    def hop_links(self, a: int, b: int) -> List[str]:
        pa, pb = a // self.ranks_per_pod, b // self.ranks_per_pod
        if pa == pb:
            return [f"ici{pa}"]
        return [f"dcn{pa}", "dcn_core", f"dcn{pb}"]


@dataclasses.dataclass
class RailOptimized(_SparseTopology):
    """Rail-optimized GPU fabric (arXiv:2605.21187 §rail): ranks are GPUs;
    GPUs inside a node share an NVLink-class all-to-all (``nv{node}``,
    unshared), and GPU ``r = rank % gpus_per_node`` of every node hangs
    off rail switch ``rail{r}`` — same-rail traffic stays one switch away
    and only cross-rail traffic pays the shared ``railspine`` tier."""
    gpus_per_node: int = 8
    oversubscription: float = 1.0
    nv_bw: float = 400.0              # GB/s intra-node (NVLink-class)
    rail_bw: float = 50.0             # GB/s per-GPU NIC into its rail
    latency_s: float = 5e-6
    nv_latency_s: float = 1e-6

    # the in-node NVLink domain is the locality group (placement /
    # hierarchical-collective group size, see placement.group_size)
    @property
    def ranks_per_leaf(self) -> int:
        return self.gpus_per_node

    @property
    def n_nodes(self) -> int:
        return self.n_ranks // self.gpus_per_node

    def hop_links(self, a: int, b: int) -> List[str]:
        na, nb = a // self.gpus_per_node, b // self.gpus_per_node
        if na == nb:
            return [f"nv{na}"]
        ra, rb = a % self.gpus_per_node, b % self.gpus_per_node
        if ra == rb:
            return [f"rail{ra}"]
        return [f"rail{ra}", "railspine", f"rail{rb}"]

    def _make_link(self, name: str) -> Link:
        if name.startswith("nv"):
            if not 0 <= int(name[2:]) < self.n_nodes:
                raise ValueError(name)
            return Link(name, self.nv_bw, self.nv_latency_s)
        if name.startswith("railspine"):
            if name != "railspine":
                raise KeyError(name)
            return Link(name, self.rail_bw * self.n_ranks
                        / self.oversubscription, 2 * self.latency_s,
                        shared=True)
        if name.startswith("rail"):
            if not 0 <= int(name[4:]) < self.gpus_per_node:
                raise ValueError(name)
            return Link(name, self.rail_bw * self.n_nodes
                        / self.oversubscription, self.latency_s,
                        shared=True)
        raise KeyError(name)


@dataclasses.dataclass
class MultiPod(_SparseTopology):
    """Dragonfly-style multi-pod fabric (arXiv:2605.21187 §multi-pod):
    leaf/spine inside each pod, plus ``inter_pod_links`` parallel global
    links per pod pair. Cross-pod hops emit a ``@pp{i}-{j}#{salt}``
    routing token whose resolution (one static member vs. a spray across
    all members) is the ROUTING policy's decision."""
    n_pods: int = 4
    ranks_per_pod: int = 1024
    nodes_per_leaf: int = 8
    inter_pod_links: int = 4
    oversubscription: float = 2.0
    leaf_bw: float = 50.0
    global_bw: float = 25.0           # GB/s per parallel inter-pod link
    latency_s: float = 5e-6
    global_latency_s: float = 20e-6
    sharp_capacity_bytes: float = 0.0

    def _pod_leaf(self, rank: int) -> Tuple[int, int]:
        pod = rank // self.ranks_per_pod
        return pod, (rank % self.ranks_per_pod) // self.nodes_per_leaf

    def hop_links(self, a: int, b: int) -> List[str]:
        pa, la = self._pod_leaf(a)
        pb, lb = self._pod_leaf(b)
        if pa == pb:
            if la == lb:
                return [f"leaf{pa}.{la}"]
            return [f"up{pa}.{la}", f"pspine{pa}", f"up{pa}.{lb}"]
        i, j = (pa, pb) if pa < pb else (pb, pa)
        # deterministic per-directed-pair hash spreads flows across the
        # parallel global links, the fabric's ECMP hashing
        salt = (a * 2654435761 + b) % self.inter_pod_links
        return [f"up{pa}.{la}", f"pspine{pa}", f"@pp{i}-{j}#{salt}",
                f"pspine{pb}", f"up{pb}.{lb}"]

    def path_group(self, group: str) -> List[str]:
        if not group.startswith("pp"):
            raise KeyError(f"topology {self.name!r} has no routing group "
                           f"{group!r}")
        return [f"{group}.{k}" for k in range(self.inter_pod_links)]

    @staticmethod
    def _idx(s: str, hi: int) -> int:
        i = int(s)
        if not 0 <= i < hi:
            raise ValueError(s)
        return i

    def _make_link(self, name: str) -> Link:
        leaves = self.ranks_per_pod // self.nodes_per_leaf
        if name.startswith("leaf"):
            pod, _, leaf = name[4:].partition(".")
            self._idx(pod, self.n_pods), self._idx(leaf, leaves)
            return Link(name, self.leaf_bw, self.latency_s)
        if name.startswith("up"):
            pod, _, leaf = name[2:].partition(".")
            self._idx(pod, self.n_pods), self._idx(leaf, leaves)
            return Link(name, self.leaf_bw * self.nodes_per_leaf
                        / self.oversubscription, self.latency_s,
                        shared=True)
        if name.startswith("pspine"):
            self._idx(name[6:], self.n_pods)
            return Link(name, self.leaf_bw * self.ranks_per_pod
                        / self.oversubscription, 2 * self.latency_s,
                        shared=True)
        if name.startswith("pp"):
            pair, _, k = name[2:].partition(".")
            i, _, j = pair.partition("-")
            if self._idx(i, self.n_pods) >= self._idx(j, self.n_pods):
                raise ValueError(name)      # canonical pairs are i < j
            self._idx(k, self.inter_pod_links)
            return Link(name, self.global_bw, self.global_latency_s,
                        shared=True)
        raise KeyError(name)


def fat_tree(
    n_nodes: int,
    *,
    nodes_per_leaf: int = 8,
    oversubscription: float = 2.0,
    leaf_bw: float = 50.0,            # GB/s node-to-leaf (e.g. 4x100GbE)
    latency_s: float = 5e-6,
    nic_spread: float = 0.0,          # +/- fraction of per-node NIC efficiency
    seed: int = 0,
) -> FatTree:
    """Hierarchical leaf/spine with `oversubscription`:1 on the up-links."""
    import random
    n_leaves = (n_nodes + nodes_per_leaf - 1) // nodes_per_leaf
    links: Dict[str, Link] = {}
    for l in range(n_leaves):
        links[f"leaf{l}"] = Link(f"leaf{l}", leaf_bw, latency_s)
        # aggregate up-link capacity for the leaf, divided by oversubscription
        links[f"up{l}"] = Link(
            f"up{l}", leaf_bw * nodes_per_leaf / oversubscription,
            latency_s, shared=True)
    links["spine"] = Link(
        "spine", leaf_bw * n_nodes / oversubscription, 2 * latency_s,
        shared=True)
    rng = random.Random(seed)
    nic = tuple(1.0 - nic_spread * rng.random() for _ in range(n_nodes))
    return FatTree(name=f"fat_tree_{n_nodes}x{nodes_per_leaf}",
                   n_ranks=n_nodes, links=links, kind="fat_tree",
                   nic_efficiency=nic, nodes_per_leaf=nodes_per_leaf)


def tpu_pod(
    n_pods: int = 2,
    ranks_per_pod: int = 256,
    *,
    ici_bw: float = 50.0,             # GB/s per ICI link (v5e ballpark)
    dcn_bw: float = 6.25,             # GB/s per host NIC (50 Gb/s)
    ici_latency: float = 1e-6,
    dcn_latency: float = 10e-6,
    seed: int = 0,
) -> TpuPod:
    """Pods of ICI-torus chips bridged by an oversubscribed DCN tier."""
    links: Dict[str, Link] = {}
    for p in range(n_pods):
        links[f"ici{p}"] = Link(f"ici{p}", ici_bw, ici_latency)
        links[f"dcn{p}"] = Link(f"dcn{p}", dcn_bw * ranks_per_pod / 4,
                                dcn_latency, shared=True)
    links["dcn_core"] = Link("dcn_core", dcn_bw * n_pods * ranks_per_pod / 8,
                             2 * dcn_latency, shared=True)
    return TpuPod(name=f"tpu_{n_pods}pods", n_ranks=n_pods * ranks_per_pod,
                  links=links, kind="tpu_pod", nic_efficiency=(),
                  ranks_per_pod=ranks_per_pod)


def rail_optimized(
    n_gpus: int,
    *,
    gpus_per_node: int = 8,
    oversubscription: float = 1.0,
    nv_bw: float = 400.0,
    rail_bw: float = 50.0,
    latency_s: float = 5e-6,
    nv_latency_s: float = 1e-6,
) -> RailOptimized:
    """Rail-optimized fabric: links materialize lazily (sparse)."""
    if n_gpus % gpus_per_node:
        raise ValueError(f"n_gpus={n_gpus} not divisible by "
                         f"gpus_per_node={gpus_per_node}")
    return RailOptimized(
        name=f"rail_{n_gpus}x{gpus_per_node}", n_ranks=n_gpus, links={},
        kind="rail_optimized", nic_efficiency=(),
        gpus_per_node=gpus_per_node, oversubscription=oversubscription,
        nv_bw=nv_bw, rail_bw=rail_bw, latency_s=latency_s,
        nv_latency_s=nv_latency_s)


def multi_pod(
    n_pods: int = 4,
    ranks_per_pod: int = 1024,
    *,
    nodes_per_leaf: int = 8,
    inter_pod_links: int = 4,
    oversubscription: float = 2.0,
    leaf_bw: float = 50.0,
    global_bw: float = 25.0,
    latency_s: float = 5e-6,
    global_latency_s: float = 20e-6,
    sharp_capacity_bytes: float = 0.0,
) -> MultiPod:
    """Dragonfly-style multi-pod fabric: links materialize lazily
    (sparse), so a 100k+-rank instance costs memory proportional to the
    leaves/pods active tenants actually occupy."""
    if ranks_per_pod % nodes_per_leaf:
        raise ValueError(f"ranks_per_pod={ranks_per_pod} not divisible by "
                         f"nodes_per_leaf={nodes_per_leaf}")
    if inter_pod_links < 1:
        raise ValueError("inter_pod_links must be >= 1")
    return MultiPod(
        name=f"multi_pod_{n_pods}x{ranks_per_pod}",
        n_ranks=n_pods * ranks_per_pod, links={}, kind="multi_pod",
        nic_efficiency=(), n_pods=n_pods, ranks_per_pod=ranks_per_pod,
        nodes_per_leaf=nodes_per_leaf, inter_pod_links=inter_pod_links,
        oversubscription=oversubscription, leaf_bw=leaf_bw,
        global_bw=global_bw, latency_s=latency_s,
        global_latency_s=global_latency_s,
        sharp_capacity_bytes=sharp_capacity_bytes)
