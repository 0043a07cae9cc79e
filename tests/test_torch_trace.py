"""The port's trace module (import, export, fit, replay validation,
calibration) against the JAX package's.

``repro_torch.fabric.trace`` is a copy of the JAX package's module with
the departures the port's ``cuda`` default forces: the bundled event
generators name ``backend="reference"`` (the export drops the backend, so
the files under ``tests/traces/`` are reproduced byte for byte); a fitted
scenario the batched runner cannot take names ``reference``, while a
static fit keeps ``cuda``; the fit's bisection probe runs the Python engine
by name, so the fitted ``u_mean`` keeps the JAX fit's bits; and
``calibrate`` batches a static trace's grid on the card by default
(``backend="cuda"``), with ``device=``/``dtype=`` for the runner.
"""
import json
import os

import pytest
import torch

from repro.fabric import trace as jax_trace
from repro.fabric.scenario import Scenario as JaxScenario
from repro_torch.fabric import (CongestionConfig, JobSpec, Trace, TraceError,
                                calibrate, fit_trace, load_trace)
from repro_torch.fabric.scenario import Policies, Scenario, TopologySpec
from repro_torch.fabric.trace import (BUNDLED_TRACES, bundled_scenario,
                                      generate_bundled, validate_result)

TRACE_DIR = os.path.join(os.path.dirname(__file__), "traces")
MEAN_GATE, P99_GATE = 0.10, 0.20     # tests/test_trace.py's replay gates
STATIC = ("steady_trainers",)


def trace_path(name):
    return os.path.join(TRACE_DIR, f"{name}.json")


@pytest.fixture(scope="module")
def fits():
    """name -> (the port's fit, the JAX package's fit) of a bundled
    trace, fitted once."""
    return {name: (fit_trace(load_trace(trace_path(name))),
                   jax_trace.fit_trace(jax_trace.load_trace(
                       trace_path(name))))
            for name in BUNDLED_TRACES}


def _without_backend(scn):
    d = scn.to_dict()
    return d["policies"].pop("backend"), d


@pytest.mark.parametrize("name", BUNDLED_TRACES)
def test_torch_trace_bundled_traces_load_like_jax(name):
    mine = load_trace(trace_path(name))
    theirs = jax_trace.load_trace(trace_path(name))
    assert isinstance(mine, Trace)
    assert mine.to_dict() == theirs.to_dict()
    assert Trace.from_dict(json.loads(mine.to_json())).to_dict() == \
        mine.to_dict()


@pytest.mark.parametrize("name", BUNDLED_TRACES)
def test_torch_trace_generators_reproduce_bundled_files_byte_for_byte(name):
    gen = generate_bundled(name)
    with open(trace_path(name)) as f:
        committed = f.read()
    assert json.dumps(gen.to_dict(), indent=1) + "\n" == committed
    assert gen.to_json() == jax_trace.generate_bundled(name).to_json()
    # the generator names its backend; the export leaves it out
    want = "cuda" if name in STATIC else "reference"
    assert bundled_scenario(name).policies.backend == want
    assert "backend" not in gen.policies


@pytest.mark.parametrize("name", BUNDLED_TRACES)
def test_torch_trace_fit_matches_jax_fit(name, fits):
    mine, theirs = fits[name]
    assert mine.congestion.u_mean.hex() == theirs.congestion.u_mean.hex()
    got_backend, got = _without_backend(mine.scenario)
    _, want = _without_backend(theirs.scenario)
    assert got == want
    assert got_backend == ("cuda" if name in STATIC else "reference")
    assert mine.notes == theirs.notes
    assert {k: (v.sigma, v.base_compute_s)
            for k, v in mine.stragglers.items()} == \
        {k: (v.sigma, v.base_compute_s)
         for k, v in theirs.stragglers.items()}
    assert mine.arrivals == theirs.arrivals


@pytest.mark.parametrize("name", BUNDLED_TRACES)
def test_torch_trace_fit_replay_within_gates(name, fits):
    fit = fits[name][0]
    tr = fit.trace
    res = fit.scenario.run(backend="reference")
    val = res.validate(tr)
    assert not val.missing
    ov = val.overall()
    assert ov["mean_rel_err"] <= MEAN_GATE, (name, val)
    assert ov["p99_rel_err"] <= P99_GATE, (name, val)
    want = jax_trace.validate_result(
        fits[name][1].scenario.run(backend="reference"),
        jax_trace.load_trace(trace_path(name))).overall()
    assert ov == want


def test_torch_trace_static_fit_replays_on_the_batched_runner(fits):
    fit = fits["steady_trainers"][0]
    res = fit.scenario.run(backend="torch", device="cpu",
                           dtype=torch.float64)
    ov = validate_result(res, fit.trace).overall()
    ref = validate_result(fit.scenario.run(backend="reference"),
                          fit.trace).overall()
    assert ov["mean_rel_err"] <= MEAN_GATE and ov["p99_rel_err"] <= P99_GATE
    for k in ("mean_rel_err", "p99_rel_err"):
        assert ov[k] == pytest.approx(ref[k], rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("name", BUNDLED_TRACES)
def test_torch_trace_replay_round_trips_its_own_trace(name, fits):
    scn = fits[name][0].scenario
    res = scn.run(backend="reference")
    tr2 = res.to_trace()
    val = scn.run(backend="reference").validate(tr2)
    ov = val.overall()
    assert ov["mean_rel_err"] <= 1e-9 and ov["p99_rel_err"] <= 1e-9
    assert tr2.to_dict() == jax_trace.result_to_trace(
        JaxScenario.from_dict(_as_jax(scn)).run()).to_dict()


def _as_jax(scn):
    d = scn.to_dict()
    d["policies"]["backend"] = "reference"
    return d


def test_torch_trace_from_trace_front_door_matches_fit(fits):
    fit = fits["noisy_serving"][0]
    scn = Scenario.from_trace(trace_path("noisy_serving"))
    assert scn.to_dict() == fit.scenario.to_dict()
    with pytest.raises(TraceError):
        Scenario.from_trace([])


def test_torch_trace_export_needs_the_python_engine():
    scn = bundled_scenario("steady_trainers")
    fast = scn.run(backend="torch", device="cpu", dtype=torch.float64)
    with pytest.raises(TraceError, match="backend='reference'"):
        fast.to_trace()


def _static_trace(**policies):
    """A two-tenant static trace exported by the JAX package under the
    given policies."""
    gen = JaxScenario.from_dict(_as_jax(Scenario(
        name="p", topology=TopologySpec(n_nodes=32, nodes_per_leaf=8),
        jobs=(JobSpec("a", 8, nodes=tuple(range(8)), grad_bytes=2e9),
              JobSpec("b", 8, nodes=tuple(range(8, 16)))),
        congestion=CongestionConfig(u_mean=0.2),
        policies=Policies(backend="reference", **policies),
        iters=40, warmup=0)))
    return jax_trace.result_to_trace(gen.run())


@pytest.mark.parametrize("policies,want", [
    ({}, "cuda"),
    ({"fairness": "wfq"}, "cuda"),
    ({"fairness": "drr"}, "reference"),
    ({"fairness": "offered"}, "reference"),
    ({"routing": "adaptive_spray"}, "reference"),
])
def test_torch_trace_fit_names_the_engine_it_needs(policies, want):
    tr = _static_trace(**policies)
    mine = fit_trace(Trace.from_dict(tr.to_dict()))
    theirs = jax_trace.fit_trace(tr)
    got_backend, got = _without_backend(mine.scenario)
    assert got_backend == want
    assert got == _without_backend(theirs.scenario)[1]
    assert mine.congestion.u_mean.hex() == theirs.congestion.u_mean.hex()


def test_torch_trace_calibrate_matches_jax_cells():
    tr = load_trace(trace_path("steady_trainers"))
    mine = calibrate(tr, backend="torch", device="cpu", dtype=torch.float64)
    theirs = jax_trace.calibrate(
        jax_trace.load_trace(trace_path("steady_trainers")),
        backend="reference")
    assert mine.backend == "torch" and mine.axes == theirs.axes
    assert mine.best_params == theirs.best_params
    assert len(mine.cells) == len(theirs.cells) == 9
    for (p, v), (q, w) in zip(mine.cells, theirs.cells):
        assert p == q
        assert v.score() == pytest.approx(w.score(), rel=1e-9, abs=0.0)
    assert mine.seed_validation.score() == pytest.approx(
        theirs.seed_validation.score(), rel=1e-9, abs=0.0)
    ov = mine.best_validation.overall()
    assert ov["mean_rel_err"] <= MEAN_GATE and ov["p99_rel_err"] <= P99_GATE
    assert mine.calibrated.policies.backend == "cuda"
    assert mine.to_csv().splitlines()[0] == \
        theirs.to_csv().splitlines()[0]


def test_torch_trace_calibrate_defaults_to_the_card():
    """A static trace's grid goes to the card unless the caller asks for
    the CPU: without one the call ends with the reason, nothing runs
    elsewhere in its place."""
    tr = load_trace(trace_path("steady_trainers"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    with pytest.raises(RuntimeError):
        calibrate(tr)


@pytest.mark.parametrize("name", ("noisy_serving", "recovering_trainer"))
def test_torch_trace_event_calibrate_runs_the_python_engine(name):
    tr = load_trace(trace_path(name))
    mine = calibrate(tr)
    theirs = jax_trace.calibrate(jax_trace.load_trace(trace_path(name)))
    assert mine.backend == theirs.backend == "reference"
    assert mine.best_params == theirs.best_params
    assert [v.score() for _, v in mine.cells] == \
        [v.score() for _, v in theirs.cells]
