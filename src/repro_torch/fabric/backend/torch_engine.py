"""Whole-scenario batched runner: every grid variant in one tensor program.

The reference engine steps one scenario at a time in Python; a dense
:class:`~repro_torch.fabric.scenario.ScenarioGrid` therefore pays the
interpreter once per variant per iteration. This module writes the
engine's iteration loop once over tensors with a leading *variant*
dimension, so a sweep of thousands of variants pays the interpreter once
per iteration per structural group, and the arithmetic runs on the card.

The key structural fact that makes this possible: **every random stream
the engine consumes is feedback-free.** Compute samples
(:class:`~repro_torch.fabric.stragglers.ComputeModel`) and the congestion
AR(1) gaussians depend only on their seeds — never on simulation state —
so both are pregenerated bit-identically in Python (and cached per seed,
amortizing the host cost across grid variants that share streams) and
the loop body is pure float arithmetic.

What runs where:

  * **Python prep on the host (per variant, cached):** topology build,
    placement, schedule compilation (reusing ``FabricEngine.__init__`` so
    the node sets, seeds, and compiled schedules are exactly the
    reference engine's), stream pregeneration, and schedule encoding into
    ``(stage, entry)`` coefficient matrices. Pure numpy.
  * **One copy to the device per group** (:func:`load_prep`): the
    group's stacked arrays in the requested dtype, and the static index
    arrays as index tensors.
  * **The loop on the device (per iteration)** (:func:`run_loaded`):
    arrival windows, the AR(1) update, per-link efficiencies,
    compiled-schedule evaluation, co-tenant contention (same-round spans
    + a busy-segment store, shares via the batched allocators),
    congestion kick, BSP finish/step bookkeeping, and the pacing bank.
    The iteration counter is a Python int, so ring cursors and window
    counts are static; nothing in the loop reads a tensor back to the
    host.
  * **One copy back** of the ``(variants, iters, jobs)`` step series.

Deliberate deviations from the reference (why ``scenario`` sits in the
``rtol`` equivalence tier, not ``exact``):

  * ``torch.float32`` by default (``torch.float64`` by argument);
  * the segment store is unpruned and holds one slot per iteration and
    owner — lossless: a stale segment overlaps a later window by <= 0
    and clamps to zero, which is the bound the reference's pruning
    threshold proves. Tenants' clocks drift apart (a fast tenant's
    window can lie hundreds of iterations behind a slow co-tenant's
    newest segment), so a ring shorter than the run would forget
    segments that a window still overlaps. The store holds
    ``2 x variants x jobs x iters`` values (:func:`segment_store_bytes`;
    a group whose store does not fit the device's free memory is refused
    before the loop), and each overlap call reads ``iters`` slots per
    co-tenant, so the contention block's work grows with ``iters**2``;
  * per-link byte totals are ``iters x bytes_per_call(None)`` — exact
    for ring/tree (static bytes; the reference's repeated adds differ
    only in accumulation rounding), the uncongested-winner approximation
    for hierarchical;
  * per-rank iteration records are not materialized (``trace`` is empty).

Unsupported scenario features raise :class:`BackendError` eagerly:
event/lifecycle timelines, and the ``offered`` / ``drr`` fairness modes
(byte-weighted flows and the data-dependent quantized drain do not
vectorize into the per-owner share call this runner batches). The error
names the offending feature and the nearest backend that supports it.

Per-kernel dispatch: the loop does not hardcode its kernels — the
allocator family and the segment-overlap reduction are fetched from the
kernel registry for the requested backend (``kernels=`` on
:func:`run_scenarios`), so the same runner serves ``backend="torch"``
(:mod:`repro_torch.fabric.backend.torch_kernels`) and ``backend="cuda"``
(:mod:`repro_torch.fabric.backend.cuda_kernels`). The pacing bank has no
hand-written kernel and stays on the plain ``bank_decide`` for both.
"""
from __future__ import annotations

import math
import random
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.fabric import _deprecation
from repro_torch.fabric.backend import (BATCHED_SCENARIO_FAIRNESS,
                                        BackendError, KernelType,
                                        get_kernel, register_kernel,
                                        resolve_device, resolve_dtype)
from repro_torch.fabric.backend import torch_kernels as K
from repro_torch.fabric.congestion import RESIDUAL_SHARE, CongestionConfig
from repro_torch.fabric.engine import EngineResult, FabricEngine, JobResult
from repro_torch.fabric.stragglers import ComputeModel

SUPPORTED_FAIRNESS = BATCHED_SCENARIO_FAIRNESS

# -- pregenerated random streams (feedback-free, cached per seed) -----------

_COMPUTE_CACHE: Dict[tuple, np.ndarray] = {}
_GAUSS_CACHE: Dict[tuple, np.ndarray] = {}


def _compute_stream(cfg, n: int, seed: int, iters: int) -> np.ndarray:
    """Replay ``ComputeModel.sample`` for ``iters`` iterations —
    bit-identical to the stream the reference engine consumes (the model
    holds no engine-fed state). Cached by (config, n, seed); the stream
    is prefix-stable, so a longer request regenerates once."""
    key = (cfg, n, seed)
    hit = _COMPUTE_CACHE.get(key)
    if hit is None or hit.shape[0] < iters:
        cm = ComputeModel(cfg, n, seed=seed)
        hit = np.array([cm.sample() for _ in range(iters)],
                       dtype=np.float64)
        _COMPUTE_CACHE[key] = hit
    return hit[:iters]


def _gauss_stream(seed: int, count: int) -> np.ndarray:
    """The congestion AR(1) innovation stream: the engine's inlined
    Box-Muller draws (``CongestionModel.advance``) replayed verbatim,
    including the sin/cos pair cache carried across ``advance()`` calls —
    bit-identical regardless of how the stream splits across iterations
    or how ``random.gauss`` evolves between Python versions."""
    key = (seed,)
    hit = _GAUSS_CACHE.get(key)
    if hit is None or hit.shape[0] < count:
        rnd = random.Random(seed).random
        cos, sin, log, sqrt = math.cos, math.sin, math.log, math.sqrt
        twopi = 2.0 * math.pi
        out = np.empty(count, dtype=np.float64)
        g_next = None
        for i in range(count):
            z = g_next
            if z is None:
                x2pi = rnd() * twopi
                g2rad = sqrt(-2.0 * log(1.0 - rnd()))
                z = cos(x2pi) * g2rad
                g_next = sin(x2pi) * g2rad
            else:
                g_next = None
            out[i] = z
        _GAUSS_CACHE[key] = hit = out
    return hit[:count]


# -- schedule encoding ------------------------------------------------------


def _encode_schedule(sched, lidx: Dict[str, int], L: int):
    """Freeze a CompiledSchedule into coefficient matrices.

    ``total_s(eff)`` decomposes into stage maxima combined by sum/max
    groups: ring = ``steps * max(entries)``; tree = ``sum_levels
    2 * max(entries)`` (scaling by 2 distributes exactly over the sum);
    hierarchical = ``max_intra_rings(steps_r * max_r) + inter``. Entry
    time is ``num / (bw * eff[link]) + lat`` with unshared links mapped
    to the constant-1.0 efficiency slot ``L``.

    Returns ``(struct, arrays)`` — ``struct`` is the hashable group
    signature (static); ``arrays`` the per-variant float coefficients.
    """
    from repro_torch.fabric.collectives import (_HierSchedule, _RingSchedule,
                                          _SharpSchedule, _TreeSchedule,
                                          _ZeroSchedule)
    stages: List[tuple] = []    # (m:int, entries:[(idx, num, bw, lat)])
    groups: List[Tuple[str, Tuple[int, ...]]] = []

    def add_stage(m: int, plan) -> int:
        if getattr(plan, "spray", ()):
            raise BackendError(
                "batched backend cannot encode adaptive-spray step plans; "
                "nearest supported backend: 'reference'")
        entries = [(lidx.get(ln, L), num, bw, lat)
                   for (ln, num, bw, lat) in plan.entries]
        stages.append((m, entries))
        return len(stages) - 1

    def add(sched) -> None:
        if isinstance(sched, _ZeroSchedule):
            return
        if isinstance(sched, (_RingSchedule, _SharpSchedule)):
            groups.append(("sum", (add_stage(sched.steps, sched.plan),)))
        elif isinstance(sched, _TreeSchedule):
            groups.append(("sum", tuple(add_stage(2, plan)
                                        for plan in sched.levels)))
        elif isinstance(sched, _HierSchedule):
            if sched.intra:
                groups.append(("max", tuple(
                    add_stage(r.steps, r.plan) for r in sched.intra)))
            add(sched.inter)
        else:
            raise BackendError(
                f"batched backend cannot encode schedule "
                f"{type(sched).__name__}")

    add(sched)
    S = len(stages)
    E = max((len(e) for _, e in stages), default=0)
    sidx = np.full((S, E), L, dtype=np.int32)
    mask = np.zeros((S, E), dtype=bool)
    num = np.zeros((S, E))
    bw = np.ones((S, E))
    lat = np.zeros((S, E))
    m = np.zeros((S,))
    for s, (mult, entries) in enumerate(stages):
        m[s] = float(mult)
        for e, (li, nm, b, lt) in enumerate(entries):
            sidx[s, e], num[s, e], bw[s, e], lat[s, e] = li, nm, b, lt
            mask[s, e] = True
    struct = (tuple(groups), tuple(tuple(r) for r in sidx), E)
    static = {"sidx": sidx, "mask": mask, "m": m, "groups": groups}
    arrays = {"num": num, "bw": bw, "lat": lat}
    return struct, static, arrays


# -- per-variant prep -------------------------------------------------------


class _Prep:
    __slots__ = ("sig", "static", "data", "scenario", "topo", "jobs",
                 "warmup")


_ENGINE_CACHE: Dict[tuple, tuple] = {}


def _build_jobs(scenario, topo):
    """Topology + placed/compiled job runtimes for a scenario.

    Cached on everything the build actually reads — topology spec, job
    specs, fairness, base_seed (all frozen, hashable dataclasses) — and
    NOT the congestion block, so a grid sweeping congestion floats (the
    common dense sweep) builds its engine exactly once. The cached
    ``_JobRuntime`` objects are never stepped — only their static fields
    (spec, nodes, schedule, spanning, floor_denom, shared_demand) are
    read — so sharing them across variants is safe."""
    if topo is not None:            # hand-built topology: no spec key
        with _deprecation.scenario_scope():
            eng = FabricEngine(topo, list(scenario.jobs),
                               congestion=scenario.congestion,
                               base_seed=scenario.base_seed,
                               fairness=scenario.policies.fairness,
                               routing=scenario.policies.routing)
        return topo, eng._jobs
    key = (scenario.topology, scenario.jobs, scenario.policies.fairness,
           scenario.policies.routing, scenario.base_seed)
    hit = _ENGINE_CACHE.get(key)
    if hit is None:
        topo = scenario.topology.build()
        with _deprecation.scenario_scope():
            eng = FabricEngine(topo, list(scenario.jobs),
                               congestion=scenario.congestion,
                               base_seed=scenario.base_seed,
                               fairness=scenario.policies.fairness,
                               routing=scenario.policies.routing)
        hit = _ENGINE_CACHE[key] = (topo, eng._jobs)
    return hit


def batched_refusal(static: bool, fairness: str, routing: str,
                    backend: str = "torch") -> Optional[str]:
    """Why the batched runner cannot take a scenario of this shape (a
    static ``jobs`` population or not, its fairness mode and routing
    policy), as the text of the :class:`BackendError` it raises, or
    ``None`` when it can. This is the one test of eligibility: :func:`_prep`
    raises with it, and callers that route scenarios between backends
    decide with it before anything runs."""
    if not static:
        return (f"backend={backend!r} runs static-jobs scenarios only; "
                f"unsupported feature: events= (lifecycle timeline); "
                f"nearest supported backend: 'reference'")
    if fairness not in SUPPORTED_FAIRNESS:
        return (f"backend={backend!r} supports fairness "
                f"{SUPPORTED_FAIRNESS}; unsupported feature: "
                f"fairness={fairness!r}; nearest supported backend: "
                f"'reference'")
    from repro_torch.fabric.policies import ROUTING
    # an unknown name is not the runner's to refuse: validation names it
    if routing in ROUTING and ROUTING.get(routing).adaptive:
        return (f"backend={backend!r} runs static-jobs scenarios only; "
                f"unsupported feature: routing={routing!r} "
                f"(per-iteration byte re-split); nearest supported "
                f"backend: 'reference'")
    return None


def _prep(scenario, topo=None, backend: str = "torch") -> _Prep:
    refusal = batched_refusal(scenario.jobs is not None,
                              scenario.policies.fairness,
                              scenario.policies.routing, backend)
    if refusal is not None:
        raise BackendError(refusal)
    fairness = scenario.policies.fairness
    topo, jobs = _build_jobs(scenario, topo)
    J = len(jobs)
    iters = scenario.iters
    if topo.sparse_links:
        # match the reference engine's tracked-link insertion order
        # (CongestionModel.track per job) so the gauss stream lines up
        shared = list(dict.fromkeys(
            ln for jr in jobs for ln in jr.shared_demand))
    else:
        shared = [ln for ln, link in topo.links.items() if link.shared]
    lidx = {ln: i for i, ln in enumerate(shared)}
    L = len(shared)
    cc = scenario.congestion if scenario.congestion is not None \
        else CongestionConfig()

    data: Dict[str, np.ndarray] = {}
    sig_jobs = []
    static_jobs = []
    dem = np.zeros((J, L))
    weights = np.zeros(J)
    priorities = np.zeros(J)
    floor = np.zeros(J)
    ecmp = np.zeros(J)
    for j, jr in enumerate(jobs):
        # the engine's compute-seed formula (ComputeModel does not keep it)
        cseed = jr.spec.seed if jr.spec.seed is not None \
            else scenario.base_seed + 1 + 1009 * j
        struct, sstat, sarr = _encode_schedule(jr.schedule, lidx, L)
        data[f"num{j}"] = sarr["num"]
        data[f"bw{j}"] = sarr["bw"]
        data[f"lat{j}"] = sarr["lat"]
        own = tuple(sorted(lidx[ln] for ln in jr.shared_demand))
        for ln, b in jr.shared_demand.items():
            dem[j, lidx[ln]] = b
        weights[j] = jr.spec.weight
        priorities[j] = float(jr.spec.priority)
        floor[j] = jr.floor_denom
        ecmp[j] = 1.0 + cc.ecmp_k * max(0, jr.spanning - 1)
        pc = jr.spec.pacing
        if jr.bank is not None:
            data[f"comp{j}"] = _compute_stream(
                jr.spec.stragglers, jr.n, cseed, iters)
            data[f"pp{j}"] = np.array([
                float(pc.warmup_iters), pc.cv_threshold,
                pc.skew_threshold, pc.gain, pc.decay, pc.max_delay_frac])
            pace_sig = (jr.n, pc.window, bool(pc.enabled))
        else:
            comp = _compute_stream(jr.spec.stragglers, jr.n, cseed, iters)
            data[f"minc{j}"] = comp.min(axis=1)
            data[f"maxc{j}"] = comp.max(axis=1)
            pace_sig = None
        sig_jobs.append((struct, own, pace_sig))
        static_jobs.append({"sched": sstat, "own": np.array(own, np.int32),
                            "pace": pace_sig, "n": jr.n})
    data["dem"] = dem
    data["w"] = weights
    data["floor"] = floor
    data["ecmp"] = ecmp
    data["z"] = _gauss_stream(scenario.base_seed + 2,
                              iters * L).reshape(iters, L) \
        if L else np.zeros((iters, 0))
    data["u0"] = np.full(L, cc.u_mean)
    rho = cc.u_rho
    data["cong"] = np.array([
        rho, (1 - rho) * cc.u_mean, (1 - rho) ** 0.5, cc.u_sigma,
        cc.u_max, cc.k_burst, cc.k_kick])

    prep = _Prep()
    prep.sig = (iters, J, L, fairness, tuple(sig_jobs),
                tuple(priorities.tolist()) if fairness == "strict_priority"
                else None,
                tuple(tuple(row) for row in dem > 0.0))
    prep.static = {"J": J, "L": L, "iters": iters, "fairness": fairness,
                   "jobs": static_jobs, "priorities": priorities,
                   "used": dem > 0.0}
    prep.data = data
    prep.scenario = scenario
    prep.topo = topo
    prep.jobs = jobs
    prep.warmup = scenario.warmup
    return prep


# -- the batched runner -----------------------------------------------------


def load_prep(static, data: Dict[str, np.ndarray], device, dtype
              ) -> Dict[str, object]:
    """Turn one group's prepped state into tensors on ``device``.

    ``static`` is the structural dict and ``data`` the dict of numpy
    arrays that :func:`_prep` returns (``prep.static`` / ``prep.data``),
    with every array of ``data`` stacked along a leading variant axis.
    The JAX package's ``jnp_engine._prep`` yields the same two dicts, so
    one prepped sweep can be pushed through both runners. Float arrays
    are cast to ``dtype``; the static numpy index arrays (schedule link
    indices, owned links, co-tenant lists, link-use masks) become index
    tensors here, once per group, not once per step.
    """
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    J = static["J"]
    used = np.asarray(static["used"])
    tensors = {k: torch.as_tensor(np.ascontiguousarray(v)).to(
        device=device, dtype=dtype) for k, v in data.items()}
    jobs = []
    for i, sj in enumerate(static["jobs"]):
        sd = sj["sched"]
        own = np.asarray(sj["own"], dtype=np.int64)
        co = [k for k in range(J) if k != i]
        co_use = used[np.array(co, dtype=np.int64)][:, own] if co \
            else np.zeros((0, own.size), dtype=bool)    # (J-1, Lo)
        jobs.append({
            "groups": sd["groups"],
            "sidx": torch.as_tensor(np.asarray(sd["sidx"], dtype=np.int64),
                                    device=device),
            "mask": torch.as_tensor(np.asarray(sd["mask"], dtype=bool),
                                    device=device),
            "m": torch.as_tensor(np.asarray(sd["m"], dtype=np.float64)).to(
                device=device, dtype=dtype),
            "own": torch.as_tensor(own, device=device),
            "n_own": int(own.size),
            "co": torch.as_tensor(np.array(co, dtype=np.int64),
                                  device=device),
            "co_list": co,
            # the overlap kernels' form of `co`: they read the store's
            # co-tenant rows where they lie
            "co_idx": torch.as_tensor(np.array(co, dtype=np.int32),
                                      device=device),
            "contended": bool(own.size and co_use.any()),
            "co_use_t": torch.as_tensor(np.ascontiguousarray(co_use.T),
                                        device=device),  # (Lo, J-1)
            "pace": sj["pace"],
        })
    return {"static": static, "data": tensors, "jobs": jobs,
            "device": device, "dtype": dtype}


def _relu(x):
    return torch.where(x > 0.0, x, 0.0)


def segment_store_bytes(loaded) -> int:
    """Bytes of one loaded group's busy-segment store: a start and an end
    per variant, job and iteration (nothing for a single job, which has
    no contention block)."""
    static = loaded["static"]
    if static["J"] < 2:
        return 0
    V = loaded["data"]["cong"].shape[0]
    esz = torch.empty((), dtype=loaded["dtype"]).element_size()
    return 2 * V * static["J"] * static["iters"] * esz


def run_loaded(loaded, kernels: KernelType = KernelType.TORCH
               ) -> torch.Tensor:
    """Step one loaded group for ``iters`` iterations; returns the
    ``(variants, iters, jobs)`` step series on the group's device.

    The variant dimension is written out as the leading axis of every
    tensor and the iteration loop is a Python loop with ``t`` a Python
    int. Carried state (the busy-segment store, the pacing windows) is
    updated **in place**: each write below comes after every read of the
    old value in that step, which is what keeps the in-place form equal
    to the functional one it was derived from.
    """
    kernels = KernelType.parse(kernels, default=KernelType.TORCH)
    static, data, jobs = loaded["static"], loaded["data"], loaded["jobs"]
    device, dtype = loaded["device"], loaded["dtype"]
    J = static["J"]
    iters = static["iters"]
    fairness = static["fairness"]
    priorities = np.asarray(static["priorities"])
    multi = J > 1
    S = iters                         # busy segments kept per owner: all
    V = data["cong"].shape[0]
    # registry dispatch: allocators + overlap come from the requested
    # backend (torch or cuda); the pacing bank stays on the plain kernel.
    maxmin_k = get_kernel("maxmin_shares", kernels)
    wfq_k = get_kernel("wfq_shares", kernels)
    sp_k = get_kernel("strict_priority_shares", kernels)
    overlap_k = get_kernel("segment_overlap", kernels)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    # the allocator rejection contract, once per group on the host-side
    # scenario inputs: the loop's own demands are clamped activity ratios
    # in [0, 1] and unit capacity, so the kernels run with validate=False
    # (a per-call check would read a device tensor back every step)
    K.check_demands_launch(data["dem"], 1.0)

    # the segment store grows with the horizon; refuse a group that
    # cannot hold it rather than fail partway through the loop
    store = segment_store_bytes(loaded)
    if device.type == "cuda" and \
            store > torch.cuda.mem_get_info(device)[0]:
        raise BackendError(
            f"the busy-segment store of {V} variants x {J} jobs x {iters} "
            f"iterations needs {store} bytes, more than {device} has "
            f"free; run fewer variants per grid or a shorter horizon")

    def sched_total(j, eff_full):
        jb = jobs[j]
        if not jb["groups"]:
            return zeros(V)
        t = data[f"num{j}"] / (data[f"bw{j}"] * eff_full[:, jb["sidx"]]) \
            + data[f"lat{j}"]
        t = torch.where(jb["mask"], t, -math.inf)
        smax = torch.clamp_min(t.amax(dim=2), 0.0) * jb["m"]     # (V, S)
        total = None
        for kind, idxs in jb["groups"]:
            if kind == "sum":
                g = smax[:, idxs[0]]
                for i in idxs[1:]:
                    g = g + smax[:, i]
            else:                     # max group: first-larger wins
                g = zeros(V)
                for i in idxs:
                    g = torch.where(smax[:, i] > g, smax[:, i], g)
            total = g if total is None else total + g
        return total

    # per-owner weight and priority vectors (owner first, then its
    # co-tenants). Weights are one vector per variant, (V, 1, J), which
    # the kernels broadcast over the owner's links; priorities are static.
    w_all = data["w"]                                            # (V, J)
    wvecs = [torch.cat([w_all[:, i:i + 1], w_all[:, jobs[i]["co"]]],
                       dim=1).unsqueeze(1).contiguous() for i in range(J)]
    pvecs = [priorities[[i] + jobs[i]["co_list"]] for i in range(J)]

    def owner_shares(demands, i):
        """Job i's allocator share on each of its links: ``demands`` is
        ``(V, Lo, J)`` with slot 0 = the owner's unit demand."""
        if fairness == "wfq":
            return wfq_k(demands, wvecs[i], validate=False)[..., 0]
        if fairness == "strict_priority":
            share = sp_k(demands, pvecs[i], validate=False)[..., 0]
            # the policy's starved-class floor (StrictPriorityFairness)
            return torch.where(share > RESIDUAL_SHARE, share,
                               RESIDUAL_SHARE)
        return maxmin_k(demands, validate=False)[..., 0]

    cong = data["cong"]
    rho, drift, iscale, sigma = (cong[:, k:k + 1] for k in range(4))
    u_max, k_burst, k_kick = (cong[:, k:k + 1] for k in range(4, 7))
    kick_on = k_kick > 0.0                                       # (V, 1)
    floor, ecmp = data["floor"], data["ecmp"]
    z = data["z"]                                                # (V, T, L)
    pp = [data.get(f"pp{j}") for j in range(J)]

    # carried state
    pace: List[object] = []
    for j in range(J):
        if jobs[j]["pace"] is not None:
            n, w, _ = jobs[j]["pace"]
            pace.append([zeros(V, n, w), zeros(V, n, w), zeros(V, n, w),
                         zeros(V, n), zeros(V, n)])
        else:
            pace.append(zeros(V))      # scalar release clock
    u = data["u0"].clone()                                       # (V, L)
    prev_fin = [zeros(V) for _ in range(J)]
    seg_s = zeros(V, J, S)
    seg_e = torch.full((V, J, S), -math.inf, dtype=dtype, device=device)
    ones_col = torch.ones((V, 1), dtype=dtype, device=device)
    out = torch.empty((V, iters, J), dtype=dtype, device=device)

    for t in range(iters):
        # 1. arrival windows
        last, skew, arrivals = [], [], []
        for j in range(J):
            if jobs[j]["pace"] is not None:
                rel_arr = pace[j][4]
                arr = rel_arr + data[f"comp{j}"][:, t]
                arrivals.append(arr)
                fj, lj = arr.amin(dim=1), arr.amax(dim=1)
            else:
                rel = pace[j]
                arrivals.append(None)
                fj = rel + data[f"minc{j}"][:, t]
                lj = rel + data[f"maxc{j}"][:, t]
            last.append(lj)
            skew.append((lj - fj) / floor[:, j])

        # 2. AR(1) background congestion
        u = rho * u + drift + iscale * (z[:, t] * sigma)
        u = torch.minimum(torch.clamp_min(u, 0.0), u_max)

        # 3. per-job efficiencies, tentative durations, contention
        effs = []
        for j in range(J):
            burst = 1.0 + k_burst[:, 0] * _relu(skew[j])
            denom = burst * ecmp[:, j]
            eff = torch.clamp_min((1.0 - u) / denom.unsqueeze(1), 1e-3)
            effs.append(torch.cat([eff, ones_col], dim=1))
        durs0 = [sched_total(j, effs[j]) for j in range(J)]

        if multi:
            s_v = torch.stack(last, dim=1)                       # (V, J)
            e_v = s_v + torch.stack(durs0, dim=1)
            new_effs = []
            for i in range(J):
                jb = jobs[i]
                if not jb["contended"]:
                    new_effs.append(effs[i])
                    continue
                co, own = jb["co"], jb["own"]
                d_i = durs0[i]
                s_i, e_i = s_v[:, i:i + 1], e_v[:, i:i + 1]      # (V, 1)
                same = _relu(torch.minimum(e_i, e_v[:, co])
                             - torch.maximum(s_i, s_v[:, co]))
                # slots t.. of the store are still empty (-inf ends)
                seg = overlap_k(s_i, e_i, seg_s, seg_e, n_filled=t,
                                co=jb["co_idx"])
                act = torch.where(jb["co_use_t"],
                                  (same + seg).unsqueeze(1), 0.0)
                d_safe = torch.where(d_i > 0.0, d_i, 1.0)
                dem_co = torch.clamp_max(act / d_safe[:, None, None], 1.0)
                demands = torch.cat(
                    [torch.ones((V, jb["n_own"], 1), dtype=dtype,
                                device=device), dem_co], dim=2)
                share = owner_shares(demands, i)                 # (V, Lo)
                active = (d_i > 0.0).unsqueeze(1) & (act > 0.0).any(dim=2)
                share = torch.where(active, share, 1.0)
                eff_i = effs[i].clone()
                eff_i[:, own] = effs[i][:, own] * share
                new_effs.append(eff_i)
            effs = new_effs
            durs = [sched_total(j, effs[j]) for j in range(J)]
            # record this round's busy segments (stale entries clamp to
            # zero overlap, no pruning needed). In place: every owner
            # above has already read the store for this step.
            seg_s[:, :, t] = s_v
            seg_e[:, :, t] = s_v + torch.stack(durs, dim=1)
        else:
            durs = durs0

        # 4. queue-buildup kick, sequential per job
        for j in range(J):
            kk = k_kick * skew[j].unsqueeze(1)
            u_k = u + kk * (1.0 - u)
            u_k = torch.where(u_k > u_max, u_max, u_k)
            u = torch.where(kick_on & (skew[j] > 0.0).unsqueeze(1), u_k, u)

        # 5. BSP finish, step series, pacing, release updates
        for j in range(J):
            finish = last[j] + durs[j]
            out[:, t, j] = finish - prev_fin[j] if t > 0 else finish
            prev_fin[j] = finish
            if jobs[j]["pace"] is None:
                pace[j] = finish
                continue
            n, w, enabled = jobs[j]["pace"]
            bw_, be_, bs_, delay, rel_arr = pace[j]
            col = t % w
            wt = _relu(last[j].unsqueeze(1) - arrivals[j])
            st = _relu(finish.unsqueeze(1) - rel_arr)
            # in place: `delay` and `rel_arr` above are this step's old
            # values, read before the window columns are overwritten
            bw_[:, :, col] = wt
            be_[:, :, col] = wt + delay
            bs_[:, :, col] = st
            ppj = pp[j]
            delays, delay = K.bank_decide(
                bw_, bs_, be_, delay, pos=(t + 1) % w,
                count=min(t + 1, w), seen=t + 1, enabled=enabled,
                warmup_iters=ppj[:, 0:1], cv_threshold=ppj[:, 1:2],
                skew_threshold=ppj[:, 2:3], gain=ppj[:, 3:4],
                decay=ppj[:, 4:5], max_delay_frac=ppj[:, 5:6])
            pace[j] = [bw_, be_, bs_, delay, finish.unsqueeze(1) + delays]

    return out                         # (V, iters, J)


# -- result assembly --------------------------------------------------------


def _wrap(prep: _Prep, steps: np.ndarray):
    """Build the standard Result shape from the scan output. Per-link
    byte totals are ``iters x bytes_per_call(None)`` (see module
    docstring); traces are empty (no per-rank record matrices)."""
    from repro_torch.fabric.scenario import Result
    iters = prep.scenario.iters
    job_results = []
    fabric: Dict[str, float] = {}
    for j, jr in enumerate(prep.jobs):
        series = [float(x) for x in steps[prep.warmup:, j]]
        link_bytes = {ln: iters * b for ln, b
                      in jr.schedule.bytes_per_call(None).items()}
        for ln, b in link_bytes.items():
            fabric[ln] = fabric.get(ln, 0.0) + b
        job_results.append(JobResult(jr.spec, jr.nodes, series,
                                     link_bytes, [], algo=jr.algo))
    raw = EngineResult(topo=prep.topo, jobs=job_results,
                       link_bytes=fabric)
    return Result(prep.scenario, raw, prep.topo)


def run_scenarios(items: Sequence[Tuple[object, Optional[object]]],
                  kernels: KernelType = KernelType.TORCH, device=None,
                  dtype=None, stats: Optional[dict] = None) -> List[object]:
    """Run ``(scenario, topo-or-None)`` pairs on the batched runner.

    Variants are grouped by structural signature (topology link
    structure, job count/placement/schedule shape, fairness, pacing
    windows, iteration count); each group is stacked, copied to the
    device once and stepped as one program. Results come back in input
    order. ``kernels`` picks which registry backend serves the allocator
    and segment-overlap calls inside the loop (``KernelType.TORCH`` or
    ``KernelType.CUDA``).

    ``device=None`` is the card (``RuntimeError`` without one);
    ``device="cpu"`` asks for the CPU, which only the ``torch`` kernels
    serve. ``dtype=None`` is ``torch.float32``. ``stats``, when given a
    dict, receives ``groups``, ``variants``, ``prep_s`` (host prep),
    ``device_s`` (load, loop and copy back, synchronised) and
    ``wrap_s`` (result assembly).
    """
    kernels = KernelType.parse(kernels, default=KernelType.TORCH)
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    if kernels is KernelType.CUDA and device.type != "cuda":
        raise BackendError(
            f"backend='cuda' runs on a CUDA device, got device="
            f"{str(device)!r}; nearest supported backend: 'torch'")
    t0 = time.perf_counter()
    preps = [_prep(s, t, backend=kernels.value) for s, t in items]
    groups: Dict[tuple, List[int]] = {}
    for i, p in enumerate(preps):
        groups.setdefault(p.sig, []).append(i)
    t_prep = time.perf_counter() - t0
    results: List[object] = [None] * len(preps)
    t_dev = t_wrap = 0.0
    for sig, idxs in groups.items():
        t0 = time.perf_counter()
        static = preps[idxs[0]].static
        data = {k: np.stack([preps[i].data[k] for i in idxs])
                for k in preps[idxs[0]].data}
        t1 = time.perf_counter()
        loaded = load_prep(static, data, device, dtype)
        steps = run_loaded(loaded, kernels).cpu().numpy()
        t2 = time.perf_counter()
        for b, i in enumerate(idxs):
            results[i] = _wrap(preps[i], steps[b])
        t_prep += t1 - t0
        t_dev += t2 - t1
        t_wrap += time.perf_counter() - t2
    if stats is not None:
        stats.update(groups=len(groups), variants=len(preps),
                     prep_s=t_prep, device_s=t_dev, wrap_s=t_wrap)
    return results


@register_kernel("scenario", KernelType.TORCH)
def run_scenario(scenario, topo=None, device=None, dtype=None):
    """Single-scenario front door (``Scenario.run(backend="torch")``)."""
    return run_scenarios([(scenario, topo)], device=device, dtype=dtype)[0]
