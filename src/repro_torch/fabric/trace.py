"""PRISM-style trace import/export, fitting, replay validation, calibration.

The simulator so far is *self-consistent*: goldens and fingerprint
baselines pin its arithmetic, but nothing connects it to observations
made outside it. PRISM (arXiv:2510.15596) shows that production trace
records — per-step timestamps, per-collective durations by kind,
arrival/departure/failure markers — carry enough signal to fit such a
model, and "Is Network the Bottleneck of Distributed Training?"
(arXiv:2006.10103) demonstrates the value of measured-vs-modeled
comparison for attributing scaling loss. This module closes the loop:

  * **schema** — :class:`Trace`: a plain-JSON record list over a
    declared :class:`~repro_torch.fabric.scenario.TopologySpec`. Record kinds:
    ``arrival`` (tenant marker with declared shape), ``step`` (training
    step finish + duration + per-collective time/byte mix),
    ``collective`` (inference prefill/decode collective), ``request``
    (inference request completion), ``failure``, ``departure``.
    Validation is eager and indexed: malformed records (missing fields,
    non-monotone timestamps, negative durations, undeclared tenants)
    raise :class:`TraceError` naming the offending record index.
  * **export** — :func:`result_to_trace` (surfaced as
    ``Result.to_trace()``) walks a reference-backend run's engine
    instrumentation into the schema, so every scenario doubles as a
    seeded trace generator (the bundled traces under ``tests/traces/``
    are produced this way and are bit-reproducible).
  * **fit** — :func:`fit_trace` (surfaced as ``Scenario.from_trace()``)
    fits arrival processes (:func:`fit_poisson_rate` — interarrival MLE
    + dispersion index), straggler distributions (:func:`fit_stragglers`
    — forward-simulated bisection on the jitter sigma matching the
    observed max-compute CV, then base-compute moment matching),
    per-collective byte mixes (exact from the records), and background
    congestion (bisection on ``u_mean`` so the replayed mean step time
    matches the observed one) into the existing
    ``TopologySpec``/``JobSpec``/``InferenceSpec``/events machinery.
  * **validate** — :func:`validate_result` (surfaced as
    ``Result.validate(trace)``): per-tenant predicted-vs-observed mean
    and p99 relative error plus series correlation, with an aggregate
    :meth:`TraceValidation.score` the calibration loop minimizes.
  * **calibrate** — :func:`calibrate`: a :class:`ScenarioGrid` sweep
    over congestion parameters around the fitted point (batched through
    ``backend="cuda"`` for static scenarios, so the sweep is one batched
    program on the card) that picks the cell minimizing trace error and
    returns the calibrated Scenario + per-cell error report.

Fitting is deterministic (fixed forward-simulation seeds, bisection on
a fixed lattice), so fitted scenarios and their error reports are
pinned by float-hex baseline fixtures like every other series.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import statistics
import warnings
from typing import (Any, Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

from repro_torch.fabric.congestion import CongestionConfig
from repro_torch.fabric.engine import JobSpec
from repro_torch.fabric.events import Arrival, Departure, NodeFailure
from repro_torch.fabric.scenario import (Policies, Result, Scenario,
                                   ScenarioError, ScenarioGrid,
                                   TopologySpec)
from repro_torch.fabric.stragglers import ComputeModel, StragglerConfig
from repro_torch.fabric.workloads import InferenceSpec

TRACE_VERSION = 1
RECORD_KINDS = ("arrival", "step", "collective", "request", "failure",
                "departure")
TENANT_KINDS = ("training", "inference")
COLLECTIVE_KINDS = ("prefill", "decode")


# index-of-dispersion (variance/mean of inter-arrivals) above which a
# Poisson replay misrepresents the request stream's burst structure
BURST_DISPERSION_THRESHOLD = 2.0


class BurstDispersionWarning(UserWarning):
    """A trace-fitted inference tenant's arrival stream is burstier than
    the Poisson replay model (index of dispersion above
    :data:`BURST_DISPERSION_THRESHOLD`): replayed tail latency will
    understate the observed tail, and what-if predictions for this
    tenant deserve discounted confidence (the advisor's ``bursty=``
    parameter). ``tenant`` / ``dispersion`` carry the offender so
    callers can filter programmatically."""

    def __init__(self, tenant: str, dispersion: float):
        self.tenant = tenant
        self.dispersion = dispersion
        super().__init__(
            f"tenant {tenant!r}: bursty arrivals (dispersion "
            f"{dispersion:.2f} > {BURST_DISPERSION_THRESHOLD}); the "
            f"Poisson rate fit is a mean-rate approximation and replayed "
            f"tails will understate the observed ones")


class TraceError(ValueError):
    """Trace validation/fit failure. ``index`` is the offending record's
    position in the record list (``None`` for trace-level problems); the
    message is prefixed with it so the bad record is findable."""

    def __init__(self, message: str, index: Optional[int] = None):
        if index is not None:
            message = f"record {index}: {message}"
        super().__init__(message)
        self.index = index


# ---------------------------------------------------------------------------
# per-record field validation helpers (all raise TraceError with the index)
# ---------------------------------------------------------------------------


def _field(rec: Mapping, i: int, name: str) -> Any:
    if name not in rec:
        raise TraceError(
            f"{rec.get('kind', '?')!r} record missing field {name!r}", i)
    return rec[name]


def _num(rec: Mapping, i: int, name: str, nonneg: bool = True) -> float:
    v = _field(rec, i, name)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise TraceError(f"field {name!r} must be a number, got {v!r}", i)
    v = float(v)
    if v != v:
        raise TraceError(f"field {name!r} is NaN", i)
    if nonneg and v < 0.0:
        raise TraceError(f"field {name!r} must be >= 0, got {v!r}", i)
    return v


def _int(rec: Mapping, i: int, name: str, minimum: int = 0) -> int:
    v = _field(rec, i, name)
    if isinstance(v, bool) or not isinstance(v, int):
        raise TraceError(f"field {name!r} must be an integer, got {v!r}", i)
    if v < minimum:
        raise TraceError(
            f"field {name!r} must be >= {minimum}, got {v!r}", i)
    return v


def _str(rec: Mapping, i: int, name: str) -> str:
    v = _field(rec, i, name)
    if not isinstance(v, str) or not v:
        raise TraceError(
            f"field {name!r} must be a non-empty string, got {v!r}", i)
    return v


# ---------------------------------------------------------------------------
# the trace itself
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Trace:
    """One validated trace: a time-ordered record list over a declared
    topology. ``horizon is None`` marks a static (lockstep fabric)
    trace; otherwise the trace covers an event timeline up to
    ``horizon`` seconds."""

    name: str
    topology: TopologySpec
    records: Tuple[Dict[str, Any], ...]
    policies: Dict[str, Any] = dataclasses.field(default_factory=dict)
    base_seed: int = 0
    horizon: Optional[float] = None
    version: int = TRACE_VERSION

    def __post_init__(self):
        object.__setattr__(self, "records",
                           tuple(dict(r) if isinstance(r, Mapping) else r
                                 for r in self.records))
        self.validate()

    # -- eager validation --------------------------------------------------
    def validate(self) -> None:
        if self.version != TRACE_VERSION:
            raise TraceError(f"unsupported trace version {self.version!r}; "
                             f"this reader speaks version {TRACE_VERSION}")
        if not isinstance(self.topology, TopologySpec):
            raise TraceError(
                f"topology must be a TopologySpec, got {self.topology!r}")
        try:
            self.topology.validate()
        except ScenarioError as e:
            raise TraceError(f"bad topology: {e}") from None
        if not isinstance(self.policies, Mapping):
            raise TraceError(
                f"policies must be a mapping, got {self.policies!r}")
        if self.horizon is not None and not float(self.horizon) > 0.0:
            raise TraceError(
                f"horizon must be positive or None, got {self.horizon!r}")
        if not self.records:
            raise TraceError("trace has no records")
        cap = self.topology.n_ranks
        declared: Dict[str, str] = {}
        prev_t: Optional[float] = None
        for i, rec in enumerate(self.records):
            if not isinstance(rec, Mapping):
                raise TraceError(f"record must be an object, got {rec!r}", i)
            kind = rec.get("kind")
            if kind not in RECORD_KINDS:
                raise TraceError(f"unknown record kind {kind!r}; one of "
                                 f"{RECORD_KINDS}", i)
            t = _num(rec, i, "t")
            if prev_t is not None and t < prev_t:
                raise TraceError(
                    f"non-monotone timestamp {t!r} after {prev_t!r}", i)
            prev_t = t
            if kind == "arrival":
                name = _str(rec, i, "tenant")
                tkind = _field(rec, i, "tenant_kind")
                if tkind not in TENANT_KINDS:
                    raise TraceError(f"unknown tenant_kind {tkind!r}; one "
                                     f"of {TENANT_KINDS}", i)
                if name in declared:
                    raise TraceError(
                        f"duplicate arrival for tenant {name!r}", i)
                _int(rec, i, "n_ranks", minimum=1)
                nodes = rec.get("nodes")
                if nodes is not None:
                    if not isinstance(nodes, (list, tuple)):
                        raise TraceError(
                            f"field 'nodes' must be a list or null, got "
                            f"{nodes!r}", i)
                    for nd in nodes:
                        if isinstance(nd, bool) or not isinstance(nd, int) \
                                or not 0 <= nd < cap:
                            raise TraceError(
                                f"node {nd!r} outside the {cap}-rank "
                                f"topology", i)
                declared[name] = tkind
            elif kind == "step":
                name = _str(rec, i, "tenant")
                if declared.get(name) != "training":
                    raise TraceError(
                        f"step record for undeclared training tenant "
                        f"{name!r}", i)
                _int(rec, i, "step", minimum=0)
                _num(rec, i, "dur_s")
                coll = _field(rec, i, "coll")
                if not isinstance(coll, Mapping) or not coll:
                    raise TraceError(
                        f"field 'coll' must be a non-empty mapping, got "
                        f"{coll!r}", i)
                for cname, c in coll.items():
                    if not isinstance(c, Mapping):
                        raise TraceError(
                            f"coll entry {cname!r} must be an object", i)
                    _num(c, i, "time_s")
                    _num(c, i, "bytes")
            elif kind == "collective":
                name = _str(rec, i, "tenant")
                if declared.get(name) != "inference":
                    raise TraceError(
                        f"collective record for undeclared inference "
                        f"tenant {name!r}", i)
                ck = _field(rec, i, "coll_kind")
                if ck not in COLLECTIVE_KINDS:
                    raise TraceError(f"unknown coll_kind {ck!r}; one of "
                                     f"{COLLECTIVE_KINDS}", i)
                _num(rec, i, "time_s")
                _num(rec, i, "bytes")
                _int(rec, i, "occupancy", minimum=1)
            elif kind == "request":
                name = _str(rec, i, "tenant")
                if declared.get(name) != "inference":
                    raise TraceError(
                        f"request record for undeclared inference tenant "
                        f"{name!r}", i)
                _num(rec, i, "arrival_s")
                _num(rec, i, "latency_s")
                _int(rec, i, "tokens", minimum=0)
            elif kind == "failure":
                node = _int(rec, i, "node")
                if node >= cap:
                    raise TraceError(
                        f"failure of node {node} outside the {cap}-rank "
                        f"topology", i)
            else:  # departure
                name = _str(rec, i, "tenant")
                if name not in declared:
                    raise TraceError(
                        f"departure of undeclared tenant {name!r}", i)
        if not declared:
            raise TraceError("trace declares no tenants (no arrival "
                             "records)")
        object.__setattr__(self, "_tenant_kinds", declared)

    # -- accessors ---------------------------------------------------------
    def tenant_kinds(self) -> Dict[str, str]:
        """tenant name -> ``"training"``/``"inference"``, arrival order."""
        return dict(self._tenant_kinds)

    def arrivals(self) -> List[Dict[str, Any]]:
        return [r for r in self.records if r["kind"] == "arrival"]

    def _for(self, tenant: str, kind: str) -> List[Dict[str, Any]]:
        return [r for r in self.records
                if r["kind"] == kind and r.get("tenant") == tenant]

    def steps(self, tenant: str) -> List[Dict[str, Any]]:
        return self._for(tenant, "step")

    def collectives(self, tenant: str) -> List[Dict[str, Any]]:
        return self._for(tenant, "collective")

    def requests(self, tenant: str) -> List[Dict[str, Any]]:
        return self._for(tenant, "request")

    def observed_series(self, tenant: str) -> List[float]:
        """The tenant's observed primary series in record order: step
        durations for training, request latencies for inference — the
        shape ``Result.series()`` predicts."""
        kind = self._tenant_kinds.get(tenant)
        if kind == "training":
            return [float(r["dur_s"]) for r in self.steps(tenant)]
        if kind == "inference":
            return [float(r["latency_s"]) for r in self.requests(tenant)]
        raise KeyError(tenant)

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "name": self.name,
            "base_seed": self.base_seed,
            "horizon": self.horizon,
            "topology": dataclasses.asdict(self.topology),
            "policies": dict(self.policies),
            "records": [dict(r) for r in self.records],
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Trace":
        if not isinstance(d, Mapping):
            raise TraceError(f"trace must be a JSON object, got {d!r}")
        if "records" not in d:
            raise TraceError("trace object has no 'records' list")
        try:
            topology = TopologySpec(**(d.get("topology") or {}))
        except TypeError as e:
            raise TraceError(f"bad topology block: {e}") from None
        horizon = d.get("horizon")
        return cls(
            name=str(d.get("name", "trace")),
            topology=topology,
            records=tuple(d["records"]),
            policies=dict(d.get("policies") or {}),
            base_seed=int(d.get("base_seed", 0)),
            horizon=float(horizon) if horizon is not None else None,
            version=int(d.get("version", TRACE_VERSION)),
        )

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    def save(self, path: Union[str, os.PathLike]) -> str:
        with open(path, "w") as f:
            f.write(self.to_json(indent=1))
            f.write("\n")
        return str(path)


def load_trace(path: Union[str, os.PathLike]) -> Trace:
    """Read and validate a plain-JSON trace file."""
    with open(path) as f:
        try:
            d = json.load(f)
        except json.JSONDecodeError as e:
            raise TraceError(f"unparseable trace file {path!s}: {e}") \
                from None
    return Trace.from_dict(d)


def as_trace(obj: Any, topology: Optional[TopologySpec] = None) -> Trace:
    """Coerce a :class:`Trace`, dict tree, file path, or bare record list
    (needs an explicit ``topology``) into a validated :class:`Trace`."""
    if isinstance(obj, Trace):
        return obj
    if isinstance(obj, (str, os.PathLike)):
        return load_trace(obj)
    if isinstance(obj, Mapping):
        return Trace.from_dict(obj)
    if isinstance(obj, Sequence):
        if topology is None:
            raise TraceError(
                "a bare record list needs an explicit topology= spec")
        return Trace(name="records", topology=topology,
                     records=tuple(obj))
    raise TraceError(f"cannot interpret {type(obj).__name__!r} as a trace")


# ---------------------------------------------------------------------------
# export: Result -> Trace
# ---------------------------------------------------------------------------


def _training_marker(t: float, spec: JobSpec,
                     nodes: Optional[Sequence[int]]) -> Dict[str, Any]:
    return {"kind": "arrival", "t": t, "tenant": spec.name,
            "tenant_kind": "training", "n_ranks": spec.n_ranks,
            "nodes": list(nodes) if nodes else None,
            "placement": spec.placement, "algo": spec.algo,
            "group": spec.group, "weight": spec.weight,
            "priority": spec.priority, "iters": spec.iters,
            "model_parallel": spec.model_parallel, "seed": spec.seed}


def _inference_marker(t: float, spec: InferenceSpec,
                      nodes: Optional[Sequence[int]]) -> Dict[str, Any]:
    return {"kind": "arrival", "t": t, "tenant": spec.name,
            "tenant_kind": "inference", "n_ranks": spec.n_ranks,
            "nodes": list(nodes) if nodes else None,
            "placement": spec.placement, "algo": spec.algo,
            "group": spec.group, "weight": spec.weight,
            "priority": spec.priority, "replicas": spec.replicas,
            "batching": spec.batching, "max_batch": spec.max_batch,
            "router": spec.router, "slo_p99_s": spec.slo_p99_s,
            "seed": spec.seed, "decode_tokens": spec.decode_tokens,
            "prefill_compute_s": spec.prefill_compute_s,
            "decode_compute_s": spec.decode_compute_s}


def result_to_trace(result: Result) -> Trace:
    """Export a reference-backend run as a validated :class:`Trace`.

    Static runs walk the engine's per-iteration trace rows (absolute
    finish timestamps, contended collective durations); lifecycle runs
    walk the tenants' step/collective/request instrumentation plus the
    scenario's own event timeline. Markers record each tenant's
    *declared* shape and its *actual* first placement, so a refit
    replays on the same nodes."""
    scn = result.scenario
    tagged: List[Tuple[float, int, int, Dict[str, Any]]] = []
    if result.kind == "fabric":
        for idx, jr in enumerate(result.raw.jobs):
            rows = getattr(jr, "_trace", None)
            if not rows:
                raise TraceError(
                    f"job {jr.name!r} has no engine trace rows to export; "
                    f"run the scenario on backend='reference'")
            spec = jr.spec
            tagged.append((0.0, 0, idx,
                           _training_marker(0.0, spec, jr.nodes)))
            prev = 0.0
            for s, (_compute, _last, finish, _rel, dur, _delays) \
                    in enumerate(rows):
                tagged.append((finish, 1, len(tagged), {
                    "kind": "step", "t": finish, "tenant": spec.name,
                    "step": s, "dur_s": finish - prev,
                    "coll": {"allreduce": {"time_s": dur,
                                           "bytes": spec.grad_bytes}}}))
                prev = finish
        horizon = None
    else:
        for ei, ev in enumerate(scn.events):
            if isinstance(ev, Arrival):
                spec = ev.spec
                try:
                    tenant = result.tenant(spec.name)
                except KeyError:
                    tenant = None
                nodes = list(tenant.placements[0][1]) \
                    if tenant is not None and tenant.placements \
                    else (list(spec.nodes) if spec.nodes else None)
                mk = _training_marker(ev.t, spec, nodes) \
                    if isinstance(spec, JobSpec) \
                    else _inference_marker(ev.t, spec, nodes)
                tagged.append((ev.t, 0, ei, mk))
            elif isinstance(ev, Departure):
                tagged.append((ev.t, 0, ei, {"kind": "departure",
                                             "t": ev.t, "tenant": ev.name}))
            else:
                tagged.append((ev.t, 0, ei, {"kind": "failure",
                                             "t": ev.t, "node": ev.node}))
        for t_obj in result.raw.tenants:
            if t_obj.kind == "training":
                finishes = getattr(t_obj, "step_finish", None)
                comms = getattr(t_obj, "comm_times", None)
                if finishes is None or comms is None \
                        or len(finishes) != len(t_obj.step_times):
                    raise TraceError(
                        f"tenant {t_obj.name!r} lacks step "
                        f"instrumentation; re-run on backend='reference'")
                gb = t_obj.spec.grad_bytes
                for s, (fin, comm, dur) in enumerate(
                        zip(finishes, comms, t_obj.step_times)):
                    tagged.append((fin, 1, len(tagged), {
                        "kind": "step", "t": fin, "tenant": t_obj.name,
                        "step": s, "dur_s": dur,
                        "coll": {"allreduce": {"time_s": comm,
                                               "bytes": gb}}}))
            else:
                for fin, ckind, dur, nbytes, occ in t_obj.collective_log:
                    tagged.append((fin, 1, len(tagged), {
                        "kind": "collective", "t": fin,
                        "tenant": t_obj.name, "coll_kind": ckind,
                        "time_s": dur, "bytes": nbytes,
                        "occupancy": occ}))
                toks = t_obj.spec.decode_tokens
                for arr, fin in t_obj.request_log:
                    tagged.append((fin, 1, len(tagged), {
                        "kind": "request", "t": fin, "tenant": t_obj.name,
                        "arrival_s": arr, "latency_s": fin - arr,
                        "tokens": toks}))
        horizon = scn.horizon
    tagged.sort(key=lambda x: (x[0], x[1], x[2]))
    policies = dataclasses.asdict(scn.policies)
    policies.pop("backend", None)
    return Trace(name=scn.name, topology=scn.topology,
                 records=tuple(r for _, _, _, r in tagged),
                 policies=policies, base_seed=scn.base_seed,
                 horizon=horizon)


# ---------------------------------------------------------------------------
# fitters
# ---------------------------------------------------------------------------


def fit_poisson_rate(arrivals: Sequence[float]) -> Tuple[float, float]:
    """Interarrival-MLE arrival rate plus dispersion index.

    Returns ``(rate, dispersion)``: ``rate`` is the maximum-likelihood
    Poisson rate ``(n - 1) / span`` and ``dispersion`` the squared
    coefficient of variation of the interarrival gaps — ~1.0 for a
    Poisson stream, > 1 for bursty arrivals (the burst diagnostic the
    fit notes surface)."""
    xs = sorted(float(x) for x in arrivals)
    if len(xs) < 2:
        raise TraceError(
            f"arrival-rate fit needs >= 2 arrivals, got {len(xs)}")
    span = xs[-1] - xs[0]
    if not span > 0.0:
        raise TraceError("arrival-rate fit needs a positive arrival span")
    gaps = [b - a for a, b in zip(xs, xs[1:])]
    rate = (len(xs) - 1) / span
    mean_gap = statistics.fmean(gaps)
    if len(gaps) < 2 or mean_gap <= 0.0:
        dispersion = 1.0
    else:
        dispersion = statistics.pvariance(gaps) / (mean_gap * mean_gap)
    return rate, dispersion


@dataclasses.dataclass(frozen=True)
class StragglerFit:
    """Fitted per-rank compute model plus the observed moments it was
    matched against. ``spread_s`` is the expected max-min arrival spread
    per step under the fitted config (the skew estimate downstream
    consumers use)."""
    config: StragglerConfig
    sigma: float
    base_compute_s: float
    spread_s: float
    obs_mean: float
    obs_cv: float
    n_samples: int
    n_trimmed: int


_FIT_SIM_ITERS = 240
_FIT_SIM_SEED = 1729
_SIGMA_MAX = 0.3
_FIT_MIN_SAMPLES = 4


@functools.lru_cache(maxsize=8192)
def _unit_max_stats(sigma: float, n_ranks: int, seed: int, iters: int
                    ) -> Tuple[float, float, float]:
    """(mean, cv, mean spread) of the per-step *max* compute across
    ``n_ranks`` ranks under a unit-base straggler config with jitter
    ``sigma`` — forward-simulated with a fixed seed, so the fit is
    deterministic and bisection on sigma sees a smooth monotone curve
    (common random numbers across sigma values)."""
    cm = ComputeModel(
        StragglerConfig(base_compute_s=1.0, jitter_sigma=sigma),
        n_ranks, seed=seed)
    maxes: List[float] = []
    spreads: List[float] = []
    for _ in range(iters):
        xs = cm.sample()
        hi = max(xs)
        maxes.append(hi)
        spreads.append(hi - min(xs))
    mean = statistics.fmean(maxes)
    cv = statistics.pstdev(maxes) / mean if mean > 0 else 0.0
    return mean, cv, statistics.fmean(spreads)


def fit_stragglers(samples: Sequence[float], n_ranks: int,
                   seed: Optional[int] = None,
                   iters: Optional[int] = None) -> StragglerFit:
    """Fit a :class:`StragglerConfig` to observed per-step max-compute
    seconds (``step duration - collective duration`` for a BSP job).

    The jitter sigma is found by bisection so the forward-simulated CV
    of the per-step max matches the observed CV; the base compute then
    moment-matches the observed mean. Samples beyond 5x the median
    (recovery stalls, replacement gaps) are trimmed first. Fewer than
    ``4`` usable samples fall back to the default sigma with
    mean-matched base.

    ``seed``/``iters`` pin the forward simulation's RNG stream and
    length; :func:`fit_trace` passes the *replay's own derived compute
    seed* and the observed step count, so the simulated locality draws
    and jitter sequence are exactly the ones the fitted scenario will
    replay — making the moment match nearly exact rather than merely
    consistent in expectation."""
    if n_ranks < 1:
        raise TraceError(f"straggler fit needs n_ranks >= 1, got {n_ranks}")
    sim_seed = _FIT_SIM_SEED if seed is None else int(seed)
    sim_iters = _FIT_SIM_ITERS if iters is None \
        else max(int(iters), _FIT_MIN_SAMPLES)
    xs = [float(x) for x in samples if float(x) > 0.0]
    if not xs:
        raise TraceError(
            "straggler fit needs at least one positive compute sample")
    med = statistics.median(xs)
    kept = [x for x in xs if x <= 5.0 * med] or xs
    obs_mean = statistics.fmean(kept)
    obs_cv = statistics.pstdev(kept) / obs_mean \
        if len(kept) > 1 and obs_mean > 0 else 0.0
    if len(kept) < _FIT_MIN_SAMPLES:
        sigma = StragglerConfig().jitter_sigma
    else:
        lo, hi = 0.0, _SIGMA_MAX
        if obs_cv <= _unit_max_stats(lo, n_ranks, sim_seed, sim_iters)[1]:
            sigma = lo
        elif obs_cv >= _unit_max_stats(hi, n_ranks, sim_seed,
                                       sim_iters)[1]:
            sigma = hi
        else:
            for _ in range(18):
                mid = 0.5 * (lo + hi)
                if _unit_max_stats(mid, n_ranks, sim_seed,
                                   sim_iters)[1] < obs_cv:
                    lo = mid
                else:
                    hi = mid
            sigma = 0.5 * (lo + hi)
    mean_max, _, mean_spread = _unit_max_stats(sigma, n_ranks, sim_seed,
                                               sim_iters)
    base = obs_mean / mean_max
    cfg = dataclasses.replace(StragglerConfig(), base_compute_s=base,
                              jitter_sigma=sigma)
    return StragglerFit(config=cfg, sigma=sigma, base_compute_s=base,
                        spread_s=base * mean_spread, obs_mean=obs_mean,
                        obs_cv=obs_cv, n_samples=len(xs),
                        n_trimmed=len(xs) - len(kept))


# ---------------------------------------------------------------------------
# replay validation
# ---------------------------------------------------------------------------


def _quantile(xs: Sequence[float], q: float) -> float:
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * len(s)))]


def _pearson(a: Sequence[float], b: Sequence[float]) -> float:
    n = min(len(a), len(b))
    if n < 2:
        return 0.0
    a, b = a[:n], b[:n]
    ma, mb = statistics.fmean(a), statistics.fmean(b)
    cov = va = vb = 0.0
    for x, y in zip(a, b):
        dx, dy = x - ma, y - mb
        cov += dx * dy
        va += dx * dx
        vb += dy * dy
    if va <= 0.0 or vb <= 0.0:
        return 0.0
    return cov / math.sqrt(va * vb)


def _rel_err(pred: float, obs: float) -> float:
    return abs(pred - obs) / max(abs(obs), 1e-12)


@dataclasses.dataclass(frozen=True)
class TenantValidation:
    """One tenant's predicted-vs-observed comparison."""
    tenant: str
    kind: str
    n_observed: int
    n_predicted: int
    observed_mean: float
    predicted_mean: float
    mean_rel_err: float
    observed_p99: float
    predicted_p99: float
    p99_rel_err: float
    correlation: float

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class TraceValidation:
    """Predicted-vs-observed error report over every traced tenant:
    per-tenant mean/p99 relative error and series correlation, plus the
    scalar :meth:`score` the calibration sweep minimizes."""

    def __init__(self, tenants: Dict[str, TenantValidation],
                 missing: Tuple[str, ...] = ()):
        self.tenants = dict(tenants)
        self.missing = tuple(missing)

    def overall(self) -> Dict[str, float]:
        """Worst-case errors across tenants (the acceptance gates)."""
        if not self.tenants:
            return {"mean_rel_err": math.inf if self.missing else 0.0,
                    "p99_rel_err": math.inf if self.missing else 0.0}
        return {
            "mean_rel_err": max(tv.mean_rel_err
                                for tv in self.tenants.values()),
            "p99_rel_err": max(tv.p99_rel_err
                               for tv in self.tenants.values()),
        }

    def score(self) -> float:
        """Aggregate error the calibration loop minimizes: mean over
        tenants of ``mean_rel_err + 0.5 * p99_rel_err``, plus a unit
        penalty per traced tenant the prediction is missing."""
        body = statistics.fmean(
            [tv.mean_rel_err + 0.5 * tv.p99_rel_err
             for tv in self.tenants.values()]) if self.tenants else 0.0
        return body + float(len(self.missing))

    def to_dict(self) -> Dict[str, Any]:
        return {"tenants": {n: tv.to_dict()
                            for n, tv in sorted(self.tenants.items())},
                "missing": list(self.missing),
                "overall": self.overall(),
                "score": self.score()}

    def __repr__(self) -> str:
        ov = self.overall()
        return (f"TraceValidation(tenants={len(self.tenants)}, "
                f"mean_rel_err={ov['mean_rel_err']:.4f}, "
                f"p99_rel_err={ov['p99_rel_err']:.4f}, "
                f"score={self.score():.4f})")


def validate_result(result: Result, trace: Any,
                    topology: Optional[TopologySpec] = None
                    ) -> TraceValidation:
    """Compare a replayed :class:`Result` against a trace's observed
    series (``Result.validate(trace)`` is the method form)."""
    tr = as_trace(trace, topology)
    names = set(result.names())
    tenants: Dict[str, TenantValidation] = {}
    missing: List[str] = []
    for name, kind in tr.tenant_kinds().items():
        obs = tr.observed_series(name)
        if not obs:
            continue
        pred = [float(x) for x in result.series(name)] \
            if name in names else []
        if not pred:
            missing.append(name)
            continue
        om, pm = statistics.fmean(obs), statistics.fmean(pred)
        op, pp = _quantile(obs, 0.99), _quantile(pred, 0.99)
        tenants[name] = TenantValidation(
            tenant=name, kind=kind, n_observed=len(obs),
            n_predicted=len(pred), observed_mean=om, predicted_mean=pm,
            mean_rel_err=_rel_err(pm, om), observed_p99=op,
            predicted_p99=pp, p99_rel_err=_rel_err(pp, op),
            correlation=_pearson(obs, pred))
    return TraceValidation(tenants, tuple(missing))


# ---------------------------------------------------------------------------
# fit: Trace -> Scenario
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceFit:
    """Outcome of :func:`fit_trace`: the validated trace, the fitted
    replayable scenario, the per-tenant fitter outputs, and any notes
    (fallbacks, clamps) the fit wants a human to see."""
    trace: Trace
    scenario: Scenario
    stragglers: Dict[str, StragglerFit]
    arrivals: Dict[str, Tuple[float, float]]
    congestion: CongestionConfig
    notes: Tuple[str, ...]


def _fit_training_spec(tr: Trace, marker: Mapping[str, Any], seq: int,
                       stragglers: Dict[str, StragglerFit],
                       notes: List[str]) -> JobSpec:
    name = marker["tenant"]
    steps = tr.steps(name)
    # the compute seed the replay will derive for this tenant (both
    # engines use base_seed + 1 + 1009 * admission order, unless the
    # spec pins one) — fitting against the replay's own RNG stream
    # makes the straggler moment match nearly exact
    fit_seed = marker.get("seed")
    if fit_seed is None:
        fit_seed = tr.base_seed + 1 + 1009 * seq
    grad_bytes = JobSpec.__dataclass_fields__["grad_bytes"].default
    cfg = StragglerConfig()
    if steps:
        byte_totals = [sum(float(c.get("bytes", 0.0))
                           for c in s["coll"].values()) for s in steps]
        if any(b > 0.0 for b in byte_totals):
            grad_bytes = statistics.fmean(byte_totals)
        cmaxes = []
        for s in steps:
            comm = sum(float(c.get("time_s", 0.0))
                       for c in s["coll"].values())
            cm = float(s["dur_s"]) - comm
            if cm > 0.0:
                cmaxes.append(cm)
        if cmaxes:
            fit = fit_stragglers(cmaxes, int(marker["n_ranks"]),
                                 seed=fit_seed, iters=len(steps))
            stragglers[name] = fit
            cfg = fit.config
            if fit.n_trimmed:
                notes.append(
                    f"tenant {name!r}: trimmed {fit.n_trimmed} outlier "
                    f"step(s) (> 5x median) from the straggler fit")
        else:
            notes.append(f"tenant {name!r}: no positive compute residuals; "
                         f"keeping the default compute model")
    else:
        notes.append(f"tenant {name!r}: no step records; keeping the "
                     f"default compute model")
    nodes = marker.get("nodes")
    return JobSpec(
        name=name, n_ranks=int(marker["n_ranks"]), grad_bytes=grad_bytes,
        algo=marker.get("algo", "auto"), group=int(marker.get("group", 0)),
        placement=marker.get("placement", "compact"),
        nodes=tuple(nodes) if nodes else None, stragglers=cfg,
        seed=marker.get("seed"), iters=marker.get("iters"),
        model_parallel=int(marker.get("model_parallel", 1)),
        weight=float(marker.get("weight", 1.0)),
        priority=int(marker.get("priority", 0)))


def _fit_inference_spec(tr: Trace, marker: Mapping[str, Any],
                        arrivals: Dict[str, Tuple[float, float]],
                        notes: List[str]) -> InferenceSpec:
    name = marker["tenant"]
    reqs = tr.requests(name)
    colls = tr.collectives(name)
    defaults = InferenceSpec(name="_", n_ranks=2)
    try:
        rate, dispersion = fit_poisson_rate(
            [float(r["arrival_s"]) for r in reqs])
        arrivals[name] = (rate, dispersion)
        if dispersion > BURST_DISPERSION_THRESHOLD:
            notes.append(
                f"tenant {name!r}: bursty arrivals (dispersion "
                f"{dispersion:.2f}); the Poisson rate fit is a mean-rate "
                f"approximation")
            warnings.warn(BurstDispersionWarning(name, dispersion),
                          stacklevel=2)
    except TraceError:
        rate = float(marker.get("rate_rps", defaults.rate_rps))
        notes.append(f"tenant {name!r}: fewer than 2 completed requests; "
                     f"arrival rate falls back to {rate}")
    tokens = [int(r["tokens"]) for r in reqs]
    decode_tokens = int(round(statistics.fmean(tokens))) if tokens \
        else int(marker.get("decode_tokens", defaults.decode_tokens))
    by_kind: Dict[str, List[float]] = {"prefill": [], "decode": []}
    for c in colls:
        by_kind[c["coll_kind"]].append(
            float(c["bytes"]) / max(int(c["occupancy"]), 1))
    prefill_bytes = statistics.fmean(by_kind["prefill"]) \
        if by_kind["prefill"] else defaults.prefill_bytes
    decode_bytes = statistics.fmean(by_kind["decode"]) \
        if by_kind["decode"] else defaults.decode_bytes
    if not by_kind["prefill"] or not by_kind["decode"]:
        notes.append(f"tenant {name!r}: missing collective records for "
                     f"some kinds; byte mix partly at defaults")
    nodes = marker.get("nodes")
    return InferenceSpec(
        name=name, n_ranks=int(marker["n_ranks"]), rate_rps=rate,
        prefill_bytes=prefill_bytes, decode_bytes=decode_bytes,
        decode_tokens=decode_tokens,
        prefill_compute_s=float(marker.get("prefill_compute_s",
                                           defaults.prefill_compute_s)),
        decode_compute_s=float(marker.get("decode_compute_s",
                                          defaults.decode_compute_s)),
        algo=marker.get("algo", "auto"), group=int(marker.get("group", 0)),
        placement=marker.get("placement", "compact"),
        nodes=tuple(nodes) if nodes else None,
        weight=float(marker.get("weight", 1.0)),
        priority=int(marker.get("priority", 0)),
        seed=marker.get("seed"), slo_p99_s=marker.get("slo_p99_s"),
        batching=marker.get("batching", "none"),
        max_batch=int(marker.get("max_batch", defaults.max_batch)),
        replicas=int(marker.get("replicas", 1)),
        router=marker.get("router", defaults.router))


_U_MAX_FIT = 0.85
_U_BISECT_ITERS = 7
_PROBE_ITERS = 60


def _weighted_mean(series_by_name: Dict[str, List[float]],
                   weights: List[Tuple[str, int]]) -> float:
    num = den = 0.0
    for name, w in weights:
        xs = series_by_name.get(name) or []
        if xs and w > 0:
            num += w * statistics.fmean(xs)
            den += w
    return num / den if den > 0 else 0.0


def fit_trace(obj: Any, topology: Optional[TopologySpec] = None
              ) -> TraceFit:
    """Fit a full replayable :class:`Scenario` to a trace.

    Tenant shapes come from the arrival markers; compute models,
    arrival rates, and byte mixes from the data records (see the module
    docstring for the individual fitters). Background congestion is
    fitted last by bisection on ``u_mean`` so a (short) replay's
    weighted mean step time matches the observed one — shared-link
    utilization is the one knob the records never expose directly, so
    it absorbs the residual; :func:`calibrate` then refines the
    second-moment parameters around this point."""
    tr = as_trace(obj, topology)
    notes: List[str] = []
    stragglers: Dict[str, StragglerFit] = {}
    arrivals: Dict[str, Tuple[float, float]] = {}
    specs: Dict[str, Union[JobSpec, InferenceSpec]] = {}
    for seq, marker in enumerate(tr.arrivals()):
        name = marker["tenant"]
        if marker["tenant_kind"] == "training":
            specs[name] = _fit_training_spec(tr, marker, seq, stragglers,
                                             notes)
        else:
            specs[name] = _fit_inference_spec(tr, marker, arrivals, notes)
    pol = dict(tr.policies)
    pol.pop("backend", None)
    try:
        policies = Policies(**pol)
    except TypeError as e:
        raise TraceError(f"bad policies block: {e}") from None

    static = tr.horizon is None
    # the port's default backend is the card's batched runner; a fit that
    # runner cannot take names the Python engine
    from repro_torch.fabric.backend.torch_engine import batched_refusal
    if batched_refusal(static, policies.fairness, policies.routing):
        policies = dataclasses.replace(policies, backend="reference")
    if static:
        step_counts = [len(tr.steps(n)) for n, k in
                       tr.tenant_kinds().items() if k == "training"]
        iters = max(step_counts) if step_counts else 0
        if iters < 1:
            raise TraceError("static trace has no step records to fit")

        def build(cfg: CongestionConfig, probe: bool = False) -> Scenario:
            try:
                return Scenario(
                    name=f"{tr.name}:fit", topology=tr.topology,
                    jobs=tuple(specs[m["tenant"]] for m in tr.arrivals()),
                    policies=policies, congestion=cfg,
                    base_seed=tr.base_seed,
                    iters=min(iters, _PROBE_ITERS) if probe else iters,
                    warmup=0)
            except ScenarioError as e:
                raise TraceError(f"fitted scenario is invalid: {e}") \
                    from None
    else:
        events: List[Any] = []
        for rec in tr.records:
            if rec["kind"] == "arrival":
                events.append(Arrival(float(rec["t"]),
                                      specs[rec["tenant"]]))
            elif rec["kind"] == "departure":
                events.append(Departure(float(rec["t"]), rec["tenant"]))
            elif rec["kind"] == "failure":
                events.append(NodeFailure(float(rec["t"]),
                                          int(rec["node"])))

        def build(cfg: CongestionConfig, probe: bool = False) -> Scenario:
            try:
                return Scenario(
                    name=f"{tr.name}:fit", topology=tr.topology,
                    events=tuple(events), policies=policies,
                    congestion=cfg, base_seed=tr.base_seed,
                    horizon=tr.horizon)
            except ScenarioError as e:
                raise TraceError(f"fitted scenario is invalid: {e}") \
                    from None

    # -- congestion: bisection on u_mean matching the observed mean -------
    weights = [(n, len(tr.steps(n))) for n, k in tr.tenant_kinds().items()
               if k == "training" and tr.steps(n)]
    if not weights:
        weights = [(n, len(tr.requests(n)))
                   for n, k in tr.tenant_kinds().items()
                   if k == "inference" and tr.requests(n)]
    observed = {n: tr.observed_series(n) for n, _ in weights}
    target = _weighted_mean(observed, weights)
    base_cfg = CongestionConfig()

    def measure(u: float) -> float:
        scn = build(dataclasses.replace(base_cfg, u_mean=u), probe=True)
        # the probe runs the Python engine by name, as the fit always has
        res = scn.run(backend="reference")
        return _weighted_mean(
            {n: [float(x) for x in res.series(n)] for n, _ in weights},
            weights)

    if not weights or target <= 0.0:
        u_fit = base_cfg.u_mean
        notes.append("no observed series to match; congestion left at "
                     "defaults")
    else:
        m_lo, m_hi = measure(0.0), measure(_U_MAX_FIT)
        if m_hi - m_lo <= 1e-9 * max(target, 1e-9):
            u_fit = base_cfg.u_mean
            notes.append("replay is insensitive to shared-link "
                         "utilization (no shared links?); congestion "
                         "left at defaults")
        elif target <= m_lo:
            u_fit = 0.0
            notes.append("observed mean at or below the zero-congestion "
                         "floor; u_mean clamped to 0")
        elif target >= m_hi:
            u_fit = _U_MAX_FIT
            notes.append(f"observed mean above the congestion ceiling; "
                         f"u_mean clamped to {_U_MAX_FIT}")
        else:
            lo, hi = 0.0, _U_MAX_FIT
            for _ in range(_U_BISECT_ITERS):
                mid = 0.5 * (lo + hi)
                if measure(mid) < target:
                    lo = mid
                else:
                    hi = mid
            u_fit = 0.5 * (lo + hi)
    congestion = dataclasses.replace(base_cfg, u_mean=u_fit)
    return TraceFit(trace=tr, scenario=build(congestion),
                    stragglers=stragglers, arrivals=arrivals,
                    congestion=congestion, notes=tuple(notes))


def scenario_from_trace(obj: Any,
                        topology: Optional[TopologySpec] = None
                        ) -> Scenario:
    """The fitted scenario alone (``Scenario.from_trace`` body)."""
    return fit_trace(obj, topology=topology).scenario


# ---------------------------------------------------------------------------
# calibration loop
# ---------------------------------------------------------------------------


def _get_path(tree: Any, path: str) -> Any:
    node = tree
    for k in path.split("."):
        node = node[int(k)] if k.lstrip("-").isdigit() else node[k]
    return node


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Outcome of :func:`calibrate`: the uncalibrated fit, the winning
    grid cell, and the per-cell error table."""
    fit: TraceFit
    backend: str
    axes: Dict[str, List[Any]]
    seed_validation: TraceValidation
    cells: Tuple[Tuple[Dict[str, Any], TraceValidation], ...]
    best_params: Dict[str, Any]
    best_validation: TraceValidation
    calibrated: Scenario

    @property
    def improved(self) -> bool:
        """Did some grid cell beat the uncalibrated fit's error?"""
        return self.best_validation.score() < self.seed_validation.score()

    def to_csv(self, path: Optional[str] = None) -> str:
        """Per-cell error table (the CI artifact): one row per grid
        cell plus the uncalibrated seed row, flagged in ``cell``."""
        import csv as _csv
        import io
        axes = list(self.axes)
        base = self.fit.scenario.to_dict()
        buf = io.StringIO()
        w = _csv.writer(buf, lineterminator="\n")
        w.writerow(["cell"] + axes
                   + ["score", "mean_rel_err", "p99_rel_err"])

        def row(tag: str, params: Mapping[str, Any], val: TraceValidation):
            ov = val.overall()
            w.writerow([tag] + [params[a] for a in axes]
                       + [val.score(), ov["mean_rel_err"],
                          ov["p99_rel_err"]])

        row("seed", {a: _get_path(base, a) for a in axes},
            self.seed_validation)
        for params, val in self.cells:
            row("best" if params == self.best_params else "grid",
                params, val)
        text = buf.getvalue()
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text


def calibrate(obj: Any, axes: Optional[Dict[str, Sequence[Any]]] = None,
              backend: Optional[str] = None,
              topology: Optional[TopologySpec] = None, device=None,
              dtype=None) -> Calibration:
    """Fit a trace, then sweep congestion parameters around the fitted
    point and keep the cell minimizing :meth:`TraceValidation.score`.

    ``axes`` follows :class:`ScenarioGrid` dotted-path syntax (default:
    ``congestion.u_mean`` x0.5/x1/x1.5 around the fit and
    ``congestion.u_sigma`` over 0.04/0.08/0.16 — both include the
    fitted value, so the seed cell is always in-grid). Static scenarios
    default to ``backend="cuda"`` (the whole sweep batches into one
    program on the card); event timelines run on the reference engine.
    ``device`` and ``dtype`` go to the batched runner (those of
    :meth:`Scenario.run`)."""
    fit = fit_trace(obj, topology=topology)
    tr, scn = fit.trace, fit.scenario
    static = scn.jobs is not None
    if backend is None:
        from repro_torch.fabric.backend import BATCHED_SCENARIO_FAIRNESS
        backend = "cuda" if static \
            and scn.policies.fairness in BATCHED_SCENARIO_FAIRNESS \
            else "reference"
    if axes is None:
        u = scn.congestion.u_mean if scn.congestion is not None \
            else CongestionConfig().u_mean
        u_vals = [0.0, 0.05, 0.10] if u <= 1e-9 \
            else sorted({u * 0.5, u, min(_U_MAX_FIT, u * 1.5)})
        axes = {"congestion.u_mean": u_vals,
                "congestion.u_sigma": [0.04, 0.08, 0.16]}
    axes = {k: list(v) for k, v in axes.items()}
    grid = ScenarioGrid(scn, axes)
    results = grid.run(backend=backend, device=device, dtype=dtype)
    cells = tuple((params, validate_result(res, tr))
                  for params, res in results)
    seed_validation = validate_result(
        scn.run(backend=backend, device=device, dtype=dtype), tr)
    best_params, best_validation = min(
        cells, key=lambda pv: pv[1].score())
    calibrated = next(variant for params, variant in grid
                      if params == best_params)
    return Calibration(fit=fit, backend=backend, axes=axes,
                       seed_validation=seed_validation, cells=cells,
                       best_params=dict(best_params),
                       best_validation=best_validation,
                       calibrated=calibrated)


# ---------------------------------------------------------------------------
# bundled synthetic traces (seeded generators; files under tests/traces/)
# ---------------------------------------------------------------------------

BUNDLED_TRACES = ("steady_trainers", "noisy_serving", "recovering_trainer")


def bundled_scenario(name: str) -> Scenario:
    """The seeded generator scenario behind a bundled trace. Re-running
    it through ``Result.to_trace()`` reproduces the committed file
    byte-identically (reference backend, fixed seeds)."""
    topo = TopologySpec(n_nodes=32, nodes_per_leaf=8)
    if name == "steady_trainers":
        return Scenario(
            name="steady_trainers", topology=topo,
            jobs=(
                JobSpec("alpha", 12, grad_bytes=1.2e9, algo="auto",
                        nodes=tuple(range(12)),
                        stragglers=StragglerConfig(base_compute_s=0.2,
                                                   jitter_sigma=0.03)),
                JobSpec("beta", 12, grad_bytes=2.4e9, algo="auto",
                        nodes=tuple(range(12, 24)),
                        stragglers=StragglerConfig(base_compute_s=0.26,
                                                   jitter_sigma=0.05)),
            ),
            congestion=CongestionConfig(u_mean=0.22, u_sigma=0.06),
            base_seed=7, iters=120, warmup=0)
    if name == "noisy_serving":
        return Scenario(
            name="noisy_serving", topology=topo,
            events=(
                Arrival(0.0, JobSpec("train", 12, grad_bytes=4e9,
                                     algo="auto",
                                     nodes=tuple(range(12)))),
                Arrival(1.0, InferenceSpec("serve", 8, rate_rps=5.0,
                                           nodes=tuple(range(16, 24)),
                                           weight=4.0, slo_p99_s=0.5,
                                           batching="continuous",
                                           max_batch=4)),
            ),
            # event timelines need the Python engine: named, not the
            # default (the export drops the backend from the policies)
            policies=Policies(fairness="wfq", backend="reference"),
            congestion=CongestionConfig(u_mean=0.25),
            base_seed=11, horizon=12.0)
    if name == "recovering_trainer":
        return Scenario(
            name="recovering_trainer", topology=topo,
            events=(
                Arrival(0.0, JobSpec("victim", 12, grad_bytes=2e9,
                                     algo="auto", model_parallel=2)),
                NodeFailure(6.0, 3),
            ),
            # event timelines need the Python engine: named, not the
            # default (the export drops the backend from the policies)
            policies=Policies(backend="reference"),
            congestion=CongestionConfig(u_mean=0.2),
            base_seed=3, horizon=16.0)
    raise TraceError(
        f"unknown bundled trace {name!r}; one of {BUNDLED_TRACES}")


def generate_bundled(name: str) -> Trace:
    """Run a bundled generator scenario on the reference backend and
    export the trace (the seeded, reproducible source of the files
    under ``tests/traces/``)."""
    result = bundled_scenario(name).run(backend="reference")
    return result_to_trace(result)


__all__ = [
    "BUNDLED_TRACES", "COLLECTIVE_KINDS", "Calibration", "RECORD_KINDS",
    "StragglerFit", "TENANT_KINDS", "TRACE_VERSION", "TenantValidation",
    "Trace", "TraceError", "TraceFit", "TraceValidation", "as_trace",
    "bundled_scenario", "calibrate", "fit_poisson_rate", "fit_stragglers",
    "fit_trace", "generate_bundled", "load_trace", "result_to_trace",
    "scenario_from_trace", "validate_result",
]
