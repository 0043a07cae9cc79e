"""Bottleneck attribution + counterfactual what-if advisor.

The paper's deliverable is a *diagnostic method*: fabric effects
(synchronization amplification, topology-induced contention, locality
variance) are invisible to per-host profilers and get misdiagnosed as
framework inefficiencies. This module turns the simulator into that
diagnostic tool in two layers:

**Attribution** — :func:`attribute` decomposes each tenant's mean and
p99 step-time overhead above its uncontended compute+comm floor into the
paper's failure-mode buckets:

  * ``synchronization`` — §3.1: BSP barrier wait from straggler spread,
    plus the arrival-burst bandwidth derate skewed entry causes;
  * ``contention`` — §3.2: background utilization on the shared tier
    plus the contended-share deficit taken by co-tenant collectives;
  * ``locality`` — §3.3: the placement penalty — what the tenant's
    collective costs *under its actual placement* versus compact-best on
    a quiet fabric (flow concentration and the extra ECMP span derate).

The comm-side split is *log-proportional*: the engine applies these
effects as multiplicative bandwidth derates, so each bucket receives the
measured comm overhead in proportion to ``ln`` of its factor. That keeps
buckets conservative (an effect the scenario does not exercise gets a
factor of 1 and thus exactly zero attribution) and makes every bucket
non-negative by construction. Whatever the analytic factors do not
explain (AR(1) fluctuation around the mean, pacing interactions,
lifecycle re-places) lands in an explicit signed ``residual`` such that
``sync + contention + locality + residual == overhead`` reconstructs the
measured overhead bit-exactly.

**Counterfactual advisor** — :func:`advise` generates alternate
scenarios only along axes the attribution implicates (placement swaps
for locality, fairness/weight/scheduler/routing changes for contention —
including the EASY-backfill scheduler and, on multi-pod fabrics with
parallel inter-pod paths still on ``ecmp_static``, the
``adaptive_spray`` routing policy — pacing and algo changes for
synchronization), executes them as one batched sweep
(:func:`repro_torch.fabric.backend.counterfactual_sweep`), optionally
re-verifies the best cells on the reference backend, and returns ranked
:class:`Recommendation` values with predicted deltas and a confidence
grade derived from the backend-equivalence tier.

Front doors on the result object::

    result = scenario.run()
    result.attribute().summary()       # where did the time go?
    result.advise()[0].summary()       # what should I change?

Attribution needs the reference backend's step instrumentation
(``comm_times``/``comm_solo``/``skews`` on each tenant); results from
the batched backends carry series only and raise :class:`AdvisorError`.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import PacingConfig
from repro_torch.fabric.collectives import (compile_schedule, shared_byte_fraction,
                                      uniform_shared_eff)
from repro_torch.fabric.congestion import CongestionConfig, derate_factors
from repro_torch.fabric.placement import place, spanning_groups
from repro_torch.fabric.topology import Topology

BUCKETS = ("synchronization", "contention", "locality")

# a bucket is "implicated" (and advised on) when it holds at least this
# share of the tenant's attributed overhead
IMPLICATION_SHARE = 0.15


class AdvisorError(RuntimeError):
    """Attribution/advice requested on inputs that cannot support it
    (missing step instrumentation, no training tenants, empty series)."""


# ---------------------------------------------------------------------------
# attribution result shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BucketBreakdown:
    """One decomposition of a measured per-step time: the uncontended
    floor plus the three failure-mode buckets plus a signed residual.
    All values are seconds per step; the buckets are non-negative and
    ``reconstruct() == overhead_s`` holds bit-exactly after
    :meth:`seal`."""
    measured_s: float
    floor_s: float
    synchronization_s: float = 0.0
    contention_s: float = 0.0
    locality_s: float = 0.0
    residual_s: float = 0.0

    @property
    def overhead_s(self) -> float:
        return self.measured_s - self.floor_s

    def reconstruct(self) -> float:
        """Left-to-right bucket sum — the quantity sealed against
        :attr:`overhead_s`."""
        return ((self.synchronization_s + self.contention_s)
                + self.locality_s) + self.residual_s

    def seal(self) -> "BucketBreakdown":
        """Fold the unexplained remainder into ``residual_s`` until the
        reconstruction is bit-exact (a couple of fix-up iterations absorb
        the float rounding of the re-sum)."""
        for _ in range(4):
            err = self.overhead_s - self.reconstruct()
            if err == 0.0:
                break
            self.residual_s += err
        return self

    def buckets(self) -> Dict[str, float]:
        return {"synchronization": self.synchronization_s,
                "contention": self.contention_s,
                "locality": self.locality_s}

    def ranked(self) -> List[Tuple[str, float]]:
        """Buckets sorted largest-first (stable on ties via bucket
        order, so ranking is deterministic)."""
        order = {b: i for i, b in enumerate(BUCKETS)}
        return sorted(self.buckets().items(),
                      key=lambda kv: (-kv[1], order[kv[0]]))

    @property
    def dominant(self) -> str:
        return self.ranked()[0][0]

    def share(self, bucket: str) -> float:
        """Bucket seconds as a fraction of the attributed overhead."""
        ov = self.overhead_s
        return self.buckets()[bucket] / ov if ov > 0.0 else 0.0

    def to_dict(self) -> Dict[str, float]:
        return {"measured_s": self.measured_s, "floor_s": self.floor_s,
                "synchronization_s": self.synchronization_s,
                "contention_s": self.contention_s,
                "locality_s": self.locality_s,
                "residual_s": self.residual_s,
                "overhead_s": self.overhead_s}


@dataclasses.dataclass
class TenantAttribution:
    """One tenant's attribution: the mean-step breakdown, the p99
    (tail-step) breakdown, and the analytic factors behind them."""
    tenant: str
    kind: str
    mean: BucketBreakdown
    p99: BucketBreakdown
    steps: int
    factors: Dict[str, float] = dataclasses.field(default_factory=dict)
    notes: Tuple[str, ...] = ()

    @property
    def dominant(self) -> str:
        return self.mean.dominant

    def implicated(self, threshold: float = IMPLICATION_SHARE
                   ) -> List[str]:
        """Buckets holding at least ``threshold`` of the mean overhead,
        largest first."""
        if self.mean.overhead_s <= 0.0:
            return []
        return [b for b, v in self.mean.ranked()
                if v >= threshold * self.mean.overhead_s and v > 0.0]

    def to_dict(self) -> Dict[str, Any]:
        return {"tenant": self.tenant, "kind": self.kind,
                "steps": self.steps, "mean": self.mean.to_dict(),
                "p99": self.p99.to_dict(),
                "factors": dict(self.factors),
                "notes": list(self.notes)}


class Attribution:
    """Per-tenant bottleneck attribution for one ``Scenario.run()``."""

    def __init__(self, scenario_name: str,
                 tenants: Dict[str, TenantAttribution]):
        self.scenario_name = scenario_name
        self.tenants = tenants

    def __getitem__(self, name: str) -> TenantAttribution:
        return self.tenants[name]

    def __iter__(self):
        return iter(self.tenants.values())

    def names(self) -> List[str]:
        return list(self.tenants)

    def dominant(self) -> Dict[str, str]:
        return {name: ta.dominant for name, ta in self.tenants.items()}

    def to_dict(self) -> Dict[str, Any]:
        return {"scenario": self.scenario_name,
                "tenants": {name: ta.to_dict()
                            for name, ta in self.tenants.items()}}

    def summary(self) -> str:
        """Human-readable report, one block per tenant."""
        lines = [f"bottleneck attribution — {self.scenario_name}"]
        for name, ta in self.tenants.items():
            b = ta.mean
            lines.append(
                f"  {name} ({ta.kind}, {ta.steps} steps): "
                f"{b.measured_s * 1e3:.2f} ms/step, floor "
                f"{b.floor_s * 1e3:.2f} ms, overhead "
                f"{b.overhead_s * 1e3:.2f} ms")
            for bucket, v in b.ranked():
                mark = " <- dominant" if bucket == b.dominant \
                    and v > 0.0 else ""
                lines.append(f"    {bucket:<16} {v * 1e3:8.2f} ms "
                             f"({b.share(bucket) * 100.0:5.1f}%){mark}")
            lines.append(f"    {'residual':<16} "
                         f"{b.residual_s * 1e3:8.2f} ms")
            for note in ta.notes:
                lines.append(f"    note: {note}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# attribution internals
# ---------------------------------------------------------------------------


def _ln_clamped(f: float) -> float:
    return math.log(f) if f > 1.0 else 0.0


def _comm_terms(topo: Topology, cfg: CongestionConfig, spec, nodes,
                algo: str, base_seed: int
                ) -> Tuple[float, float, float, Dict[str, float]]:
    """Per-tenant comm constants: the counterfactual floor ``F`` (the
    tenant's collective under compact-best placement on a quiet,
    unskewed fabric), the actual-placement quiet-fabric cost ``L``, and
    the locality factor ``f_loc = L / F``.

    The compact counterfactual re-places the tenant alone on the empty
    fabric, so ``F`` prices the *inherent* cost of moving ``grad_bytes``
    at this scale and ``f_loc`` only the placement excess (flow
    concentration on shared up-links plus the wider ECMP span derate) —
    not the collective itself."""
    algo = algo if algo != "auto" else "ring"
    sched = compile_schedule(topo, list(nodes), spec.grad_bytes,
                             algo=algo, group=spec.group)
    span_act = spec.spanning_override \
        if getattr(spec, "spanning_override", None) is not None \
        else spanning_groups(topo, nodes)
    best_nodes = place("compact", topo, len(nodes), taken=(),
                       seed=base_seed)
    best_sched = compile_schedule(topo, best_nodes, spec.grad_bytes,
                                  algo=algo, group=spec.group)
    span_best = spanning_groups(topo, best_nodes)
    e_act = derate_factors(cfg, 0.0, span_act)["ecmp"]
    e_best = derate_factors(cfg, 0.0, span_best)["ecmp"]
    F = best_sched.total_s(uniform_shared_eff(topo, 1.0 / e_best))
    L = sched.total_s(uniform_shared_eff(topo, 1.0 / e_act))
    F = max(F, 1e-12)
    f_loc = max(L / F, 1.0)
    factors = {"f_locality": f_loc, "span": float(span_act),
               "span_best": float(span_best),
               "shared_byte_frac": shared_byte_fraction(topo, sched),
               "comm_floor_s": F}
    return F, L, f_loc, factors


def _fabric_step_stats(jr) -> Tuple[List[float], List[float]]:
    """Per-reported-step mean BSP wait and mean compute for a
    :class:`~repro_torch.fabric.engine.JobResult`, read off the engine trace
    (the trace covers warmup too — align from the tail)."""
    trace = jr._trace
    off = len(trace) - len(jr.step_times)
    waits: List[float] = []
    comp_means: List[float] = []
    for t in range(len(jr.step_times)):
        compute, last, _finish, rel, _dur, _delays = trace[t + off]
        scalar = not isinstance(rel, tuple)
        n = len(compute)
        wsum = 0.0
        for r in range(n):
            rel_r = rel if scalar else rel[r]
            wsum += last - (rel_r + compute[r])
        waits.append(wsum / n)
        comp_means.append(statistics.fmean(compute))
    return waits, comp_means


def _tail_indices(measured: Sequence[float]) -> List[int]:
    """Steps at or above the p99 step time (the same nearest-rank
    quantile convention as ``latency_quantile``)."""
    s = sorted(measured)
    thresh = s[min(len(s) - 1, int(0.99 * len(s)))]
    return [i for i, m in enumerate(measured) if m >= thresh]


def _training_attribution(name: str, topo: Topology,
                          cfg: CongestionConfig, spec, nodes, algo: str,
                          base_seed: int, step_times: Sequence[float],
                          comm_times: Sequence[float],
                          comm_solo: Sequence[float],
                          skews: Sequence[float],
                          waits: Sequence[float],
                          comp_means: Sequence[float]
                          ) -> TenantAttribution:
    n = len(step_times)
    if n == 0:
        raise AdvisorError(f"tenant {name!r} completed no steps")
    if not (len(comm_times) == len(comm_solo) == len(skews) == n):
        raise AdvisorError(
            f"tenant {name!r} carries no step instrumentation "
            f"(comm_times/comm_solo/skews) — attribution needs a "
            f"reference-backend result; re-run with "
            f"backend='reference'")
    F, _L, f_loc, factors = _comm_terms(topo, cfg, spec, nodes, algo,
                                        base_seed)
    bg = derate_factors(cfg, 0.0)["background"]
    f_bg = 1.0 / max(bg, 1e-3)
    ln_loc = _ln_clamped(f_loc)
    ln_bg = _ln_clamped(f_bg)
    # per-step series of each decomposition term
    meas: List[float] = []
    floor: List[float] = []
    sync: List[float] = []
    cont: List[float] = []
    loc: List[float] = []
    for t in range(n):
        dur = comm_times[t]
        d0 = comm_solo[t]
        wait = max(waits[t], 0.0)
        floor_t = comp_means[t] + F
        comm_over = dur - F
        b_sync = wait
        b_cont = 0.0
        b_loc = 0.0
        if comm_over > 0.0:
            # log-proportional split of the comm overhead over the
            # multiplicative derates this step actually exercised
            f_burst = derate_factors(cfg, skews[t])["burst"]
            f_cot = dur / d0 if d0 > 0.0 else 1.0
            z = math.log(dur / F)
            ln_burst = _ln_clamped(f_burst)
            ln_cot = _ln_clamped(f_cot)
            total_ln = ln_burst + ln_cot + ln_bg + ln_loc
            if total_ln > 0.0 and z > 0.0:
                # normalize over the explained log-mass, capped at the
                # realized log-overhead so buckets stay conservative
                unit = comm_over / max(z, total_ln)
                b_sync += unit * ln_burst
                b_cont = unit * (ln_cot + ln_bg)
                b_loc = unit * ln_loc
        meas.append(step_times[t])
        floor.append(floor_t)
        sync.append(b_sync)
        cont.append(b_cont)
        loc.append(b_loc)
    mean_bd = BucketBreakdown(
        measured_s=statistics.fmean(meas),
        floor_s=statistics.fmean(floor),
        synchronization_s=statistics.fmean(sync),
        contention_s=statistics.fmean(cont),
        locality_s=statistics.fmean(loc)).seal()
    tail = _tail_indices(meas)
    p99_bd = BucketBreakdown(
        measured_s=statistics.fmean([meas[i] for i in tail]),
        floor_s=statistics.fmean([floor[i] for i in tail]),
        synchronization_s=statistics.fmean([sync[i] for i in tail]),
        contention_s=statistics.fmean([cont[i] for i in tail]),
        locality_s=statistics.fmean([loc[i] for i in tail])).seal()
    notes: List[str] = []
    if f_loc > 1.0:
        notes.append(f"placement costs {f_loc:.2f}x the compact-best "
                     f"comm floor (span {int(factors['span'])} vs "
                     f"{int(factors['span_best'])})")
    return TenantAttribution(tenant=name, kind="training", mean=mean_bd,
                             p99=p99_bd, steps=n, factors=factors,
                             notes=tuple(notes))


def _inference_attribution(t) -> TenantAttribution:
    """Coarse inference attribution: the contended-share deficit of the
    fleet's collectives (measured minus co-tenant-free duration) is
    charged to contention; queueing/batching structure stays in the
    residual. Latencies, not step times, are the measured series."""
    lats = t.latencies
    if not lats:
        raise AdvisorError(
            f"tenant {t.name!r} completed no requests")
    durs = [entry[2] for entry in t.collective_log]
    solos = list(t.collective_solo)
    if len(solos) != len(durs):
        raise AdvisorError(
            f"tenant {t.name!r} carries no collective instrumentation "
            f"— attribution needs a reference-backend result")
    deficits = [max(d - d0, 0.0) for d, d0 in zip(durs, solos)]
    contention = statistics.fmean(deficits) if deficits else 0.0
    mean_bd = BucketBreakdown(
        measured_s=statistics.fmean(lats), floor_s=0.0,
        contention_s=contention).seal()
    p99_bd = BucketBreakdown(
        measured_s=t.latency_quantile(0.99), floor_s=0.0,
        contention_s=contention).seal()
    return TenantAttribution(
        tenant=t.name, kind="inference", mean=mean_bd, p99=p99_bd,
        steps=len(lats),
        notes=("inference attribution is coarse: only the collective "
               "contended-share deficit is bucketed; queueing and "
               "batching structure stay in the residual",))


def attribute(result) -> Attribution:
    """Decompose each tenant's overhead above its uncontended
    compute+comm floor into the paper's failure-mode buckets.

    ``result`` must come from the reference backend (the batched
    backends return series without the per-step instrumentation the
    decomposition reads). Buckets are conservative — an effect the
    scenario does not exercise attributes exactly zero — and
    ``sync + contention + locality + residual`` reconstructs the
    measured overhead bit-exactly per tenant.
    """
    scenario = result.scenario
    topo = result.topo
    cfg = scenario.congestion if scenario.congestion is not None \
        else CongestionConfig()
    tenants: Dict[str, TenantAttribution] = {}
    for t in result._tenants():
        kind = getattr(t, "kind", "training") or "training"
        if kind == "inference":
            tenants[t.name] = _inference_attribution(t)
            continue
        if len(t.comm_times) != len(t.step_times):
            raise AdvisorError(
                f"tenant {t.name!r} carries no step instrumentation "
                f"(comm_times/comm_solo/skews) — attribution needs a "
                f"reference-backend result; re-run with "
                f"backend='reference'")
        if result.kind == "fabric":
            waits, comp_means = _fabric_step_stats(t)
        else:
            waits = [mx - mn for mx, mn in zip(t.comp_maxs,
                                               t.comp_means)]
            comp_means = list(t.comp_means)
        tenants[t.name] = _training_attribution(
            t.name, topo, cfg, t.spec, t.nodes, t.algo,
            scenario.base_seed, t.step_times, t.comm_times, t.comm_solo,
            t.skews, waits, comp_means)
    return Attribution(scenario.name, tenants)


# ---------------------------------------------------------------------------
# the counterfactual advisor
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Recommendation:
    """One counterfactual the advisor executed and graded.

    ``predicted_delta_s`` is the target tenant's mean step-time saving
    under the edit; ``predicted_recovery`` that saving as a fraction of
    the tenant's attributed overhead. ``verified_delta_s`` is the same
    delta re-measured end-to-end on the reference backend (``None`` when
    verification was skipped). ``confidence`` grades the prediction:
    ``high`` when reference-verified (or reference-executed), ``medium``
    when it rests on the batched backend's equivalence tier, ``low``
    when the target tenant's inputs are themselves suspect (e.g. a
    trace-fitted tenant whose burstiness exceeded the replay model)."""
    action: str
    bucket: str
    tenant: str
    edits: Dict[str, Any]
    predicted_delta_s: float
    predicted_recovery: float
    confidence: str
    backend: str
    verified_delta_s: Optional[float] = None
    scenario: Any = None

    @property
    def delta_s(self) -> float:
        """Best available estimate: verified when present."""
        return self.verified_delta_s \
            if self.verified_delta_s is not None \
            else self.predicted_delta_s

    def summary(self) -> str:
        rec = self.predicted_recovery * 100.0
        tag = "verified" if self.verified_delta_s is not None \
            else f"predicted ({self.backend})"
        return (f"{self.action}: recovers {rec:.0f}% of {self.tenant}'s "
                f"attributed overhead ({self.delta_s * 1e3:.2f} ms/step, "
                f"{tag}, confidence {self.confidence})")

    def to_row(self) -> Dict[str, Any]:
        return {"action": self.action, "bucket": self.bucket,
                "tenant": self.tenant,
                "edits": ";".join(f"{k}={v}" for k, v in
                                  sorted(self.edits.items())),
                "predicted_delta_s": self.predicted_delta_s,
                "predicted_recovery": self.predicted_recovery,
                "verified_delta_s": self.verified_delta_s
                if self.verified_delta_s is not None else "",
                "confidence": self.confidence, "backend": self.backend}


def _spec_paths(scenario) -> List[Tuple[str, Any]]:
    """(dotted-path, spec) pairs addressing each training tenant in the
    scenario's dict form."""
    out: List[Tuple[str, Any]] = []
    if scenario.jobs is not None:
        for i, spec in enumerate(scenario.jobs):
            out.append((f"jobs.{i}", spec))
    else:
        from repro_torch.fabric.events import Arrival
        for j, ev in enumerate(scenario.events):
            if isinstance(ev, Arrival):
                out.append((f"events.{j}.spec", ev.spec))
    return out


def _candidates(scenario, attr: Attribution
                ) -> List[Tuple[str, str, str, Dict[str, Any]]]:
    """(action, bucket, tenant, edits) tuples along implicated axes
    only — the advisor never sweeps an axis the attribution does not
    point at."""
    from repro_torch.fabric.engine import JobSpec
    out: List[Tuple[str, str, str, Dict[str, Any]]] = []
    seen: set = set()

    def add(action, bucket, tenant, edits):
        key = tuple(sorted((k, repr(v)) for k, v in edits.items()))
        if key in seen:
            return
        seen.add(key)
        out.append((action, bucket, tenant, edits))

    timeline = scenario.events is not None
    for path, spec in _spec_paths(scenario):
        if not isinstance(spec, JobSpec):
            continue
        ta = attr.tenants.get(spec.name)
        if ta is None:
            continue
        implicated = ta.implicated()
        if "locality" in implicated:
            if spec.nodes is None and spec.placement != "compact":
                add(f"placement {spec.placement}->compact", "locality",
                    spec.name, {f"{path}.placement": "compact"})
            if spec.algo not in ("hierarchical", "auto"):
                add(f"algo {spec.algo}->hierarchical", "locality",
                    spec.name, {f"{path}.algo": "hierarchical"})
        if "contention" in implicated:
            if scenario.topology.kind == "multi_pod" \
                    and scenario.topology.inter_pod_links > 1 \
                    and scenario.policies.routing == "ecmp_static":
                add("adaptive inter-pod routing", "contention", spec.name,
                    {"policies.routing": "adaptive_spray"})
            if spec.weight < 4.0:
                add("wfq weight boost", "contention", spec.name,
                    {"policies.fairness": "wfq",
                     f"{path}.weight": 4.0})
            add("strict-priority promotion", "contention", spec.name,
                {"policies.fairness": "strict_priority",
                 f"{path}.priority": 10})
            if timeline and scenario.policies.scheduler in ("fifo",
                                                            "backfill"):
                add("EASY-backfill scheduler", "contention", spec.name,
                    {"policies.scheduler": "easy"})
        if "synchronization" in implicated:
            if spec.pacing is None:
                add("bounded pacing", "synchronization", spec.name,
                    {f"{path}.pacing":
                     dataclasses.asdict(PacingConfig())})
            if spec.algo not in ("hierarchical", "auto"):
                add(f"algo {spec.algo}->hierarchical",
                    "synchronization", spec.name,
                    {f"{path}.algo": "hierarchical"})
    return out


def _mean_step(result, tenant: str) -> Optional[float]:
    try:
        series = result.series(tenant)
    except KeyError:
        return None
    return statistics.fmean(series) if series else None


def advise(scenario, result=None, *, backend: str = "cuda",
           verify: bool = True, top_k: int = 3,
           bursty: Sequence[str] = (), device=None,
           dtype=None) -> List[Recommendation]:
    """Attribution-guided counterfactual search over one scenario.

    Runs the scenario on the reference backend if ``result`` is not
    supplied, attributes each tenant's overhead, generates candidate
    edits only along the implicated axes, executes all candidates in one
    batched sweep on ``backend`` (candidates the batched runner cannot
    take run on the reference engine, decided before anything runs;
    ``device`` and ``dtype`` go to the batched runner, as in
    :meth:`Scenario.run`), and — when ``verify`` — re-runs the
    ``top_k`` predicted winners end-to-end on the reference backend.
    Returns recommendations sorted best-first by the most trustworthy
    delta available. ``bursty`` names tenants whose inputs the caller
    distrusts (e.g. :class:`repro_torch.fabric.trace.BurstDispersionWarning`
    targets); their recommendations are graded ``low`` confidence.
    """
    from repro_torch.fabric.backend import (BATCHED_SCENARIO_BACKENDS,
                                            counterfactual_sweep)
    from repro_torch.fabric.backend.torch_engine import batched_refusal
    from repro_torch.fabric.scenario import (Scenario, ScenarioError, _set_path)
    if result is None:
        result = scenario.run(backend="reference")
    attr = attribute(result)
    base_means = {name: _mean_step(result, name)
                  for name in result.names()}
    cands = _candidates(scenario, attr)
    variants: List[Any] = []
    kept: List[Tuple[str, str, str, Dict[str, Any]]] = []
    for action, bucket, tenant, edits in cands:
        d = scenario.to_dict()
        try:
            for p, v in edits.items():
                _set_path(d, p, v)
            d["name"] = f"{scenario.name}[{action}]"
            # the port's default backend is the card's batched runner; an
            # edit that runner cannot take names the Python engine, so
            # the candidate is built and not dropped
            pol = d["policies"]
            if pol["backend"] in BATCHED_SCENARIO_BACKENDS \
                    and batched_refusal(d["jobs"] is not None,
                                        pol["fairness"], pol["routing"]):
                pol["backend"] = "reference"
            variants.append(Scenario.from_dict(d))
        except (KeyError, IndexError, TypeError, ScenarioError):
            continue            # edit does not apply to this scenario
        kept.append((action, bucket, tenant, edits))
    if not variants:
        return []
    runs = counterfactual_sweep(variants, backend=backend, device=device,
                                dtype=dtype)
    recs: List[Recommendation] = []
    for (action, bucket, tenant, edits), variant, (var_result, bk) in \
            zip(kept, variants, runs):
        base = base_means.get(tenant)
        var_mean = _mean_step(var_result, tenant)
        if base is None or var_mean is None:
            continue
        delta = base - var_mean
        overhead = attr[tenant].mean.overhead_s
        recovery = delta / overhead if overhead > 0.0 else 0.0
        confidence = "high" if bk == "reference" else "medium"
        if tenant in bursty:
            confidence = "low"
        recs.append(Recommendation(
            action=action, bucket=bucket, tenant=tenant, edits=edits,
            predicted_delta_s=delta, predicted_recovery=recovery,
            confidence=confidence, backend=bk, scenario=variant))
    recs.sort(key=lambda r: -r.predicted_delta_s)
    if verify:
        for rec in recs[:top_k]:
            if rec.backend == "reference":
                rec.verified_delta_s = rec.predicted_delta_s
                continue
            ref = rec.scenario.run(backend="reference")
            var_mean = _mean_step(ref, rec.tenant)
            base = base_means.get(rec.tenant)
            if var_mean is None or base is None:
                continue
            rec.verified_delta_s = base - var_mean
            overhead = attr[rec.tenant].mean.overhead_s
            rec.predicted_recovery = rec.verified_delta_s / overhead \
                if overhead > 0.0 else 0.0
            if rec.tenant not in bursty:
                rec.confidence = "high"
        recs.sort(key=lambda r: -r.delta_s)
    return recs
