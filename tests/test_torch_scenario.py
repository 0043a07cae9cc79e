"""The port's declarative front door against the JAX package's.

A scenario crosses between the two packages as data
(``Scenario.from_dict(scn.to_dict())``). The port's ``reference`` backend
is its own copy of the Python engines and must give the same bit-exact
``fingerprint()`` as the JAX package's on every named library scenario —
static-jobs and lifecycle alike — since the copied modules change no
arithmetic.
"""
import json

import pytest
import torch

from repro.fabric.scenario import Scenario as JaxScenario
from repro.fabric.scenario import library
from repro_torch.fabric import (Arrival, InferenceSpec, JobSpec, NodeFailure)
from repro_torch.fabric.backend import BackendError
from repro_torch.fabric.backend import torch_engine as TE
from repro_torch.fabric.scenario import (Policies, Scenario, ScenarioError,
                                         ScenarioGrid, TopologySpec)

STATIC = ("topology_contention", "locality_variance",
          "synchronization_amplification", "cross_pod_interference",
          "routing_rescue")
LIFECYCLE = ("noisy_neighbor_inference", "priority_preemption",
             "failure_recovery", "continuous_batching_relief",
             "slo_placement")


def test_torch_scenario_library_is_fully_covered_here():
    assert sorted(STATIC + LIFECYCLE) == sorted(library.names())


@pytest.mark.parametrize("name", STATIC + LIFECYCLE)
def test_torch_scenario_round_trips_between_packages(name):
    theirs = library.build(name)
    mine = Scenario.from_dict(theirs.to_dict())
    assert mine.to_dict() == theirs.to_dict()
    assert (mine.jobs is not None) == (name in STATIC)
    # through JSON text and back into the JAX package
    back = JaxScenario.from_json(Scenario.from_json(theirs.to_json())
                                 .to_json())
    assert back == theirs
    assert json.loads(mine.to_json()) == theirs.to_dict()


@pytest.mark.parametrize("name", STATIC + LIFECYCLE)
def test_torch_reference_backend_fingerprint_matches_jax_package(name):
    theirs = library.build(name)
    want = theirs.run()
    got = Scenario.from_dict(theirs.to_dict()).run(backend="reference")
    assert got.kind == want.kind
    assert got.fingerprint() == want.fingerprint()
    assert got.slo_attainment() == want.slo_attainment()
    assert got.diagnostics() == want.diagnostics()


def test_torch_reference_checkpoint_aware_resume_matches_jax_package():
    """A failure with ``ckpt_every`` set reaches the port's own copy of
    the checkpoint cadence arithmetic."""
    from repro.fabric import Arrival as JA, NodeFailure as JF
    from repro.fabric.engine import JobSpec as JJ
    from repro.fabric.scenario import Policies as JP
    from repro.fabric.scenario import TopologySpec as JT

    def build(S, T, A, F, J, P):
        return S(name="resume", topology=T(n_nodes=32, nodes_per_leaf=8),
                 events=[A(0.0, J("train", 12, ckpt_every=5)),
                         F(6.0, 3)], policies=P(backend="reference"),
                 horizon=14.0)

    mine = build(Scenario, TopologySpec, Arrival, NodeFailure, JobSpec,
                 Policies)
    theirs = build(JaxScenario, JT, JA, JF, JJ, JP)
    assert mine.to_dict() == theirs.to_dict()
    got, want = mine.run(), theirs.run()
    assert got.fingerprint() == want.fingerprint()
    assert [k for _, k, _ in got.log] == [k for _, k, _ in want.log]
    assert "replaced" in [k for _, k, _ in got.log]


# -- what the batched backends refuse ----------------------------------------


def _static(**kw):
    base = dict(name="s", topology=TopologySpec(n_nodes=32, nodes_per_leaf=8),
                jobs=[JobSpec("a", 8), JobSpec("b", 8)], iters=12, warmup=2)
    base.update(kw)
    return Scenario(**base)


def test_torch_backend_error_for_event_timelines():
    spec = dict(name="ev",
                topology=TopologySpec(n_nodes=32, nodes_per_leaf=8),
                events=[Arrival(0.0, JobSpec("a", 8)),
                        Arrival(0.0, InferenceSpec("serve", 4))],
                horizon=3.0)
    scn = Scenario(policies=Policies(backend="reference"), **spec)
    for bk in ("torch", "cuda"):
        with pytest.raises(BackendError) as e:
            TE._prep(scn, backend=bk)
        assert str(e.value) == (
            f"backend={bk!r} runs static-jobs scenarios only; unsupported "
            f"feature: events= (lifecycle timeline); nearest supported "
            f"backend: 'reference'")
    with pytest.raises(BackendError, match="events= \\(lifecycle timeline\\)"):
        scn.run(backend="torch", device="cpu")
    # under the declared backend — "cuda" unless the scenario names
    # another — the same scope is refused eagerly
    for pol in (Policies(backend="cuda"), Policies()):
        with pytest.raises(ScenarioError,
                           match="event timelines need backend='reference'"):
            scn.replace(policies=pol)
    with pytest.raises(ScenarioError, match="backend='cuda' runs static"):
        Scenario(**spec)
    assert scn.run().kind == "lifecycle"       # reference, asked by name


def test_torch_backend_error_for_drr_fairness():
    scn = _static(policies=Policies(fairness="drr", backend="reference"))
    with pytest.raises(BackendError) as e:
        scn.run(backend="torch", device="cpu")
    assert str(e.value) == (
        "backend='torch' supports fairness ('maxmin', 'wfq', "
        "'strict_priority'); unsupported feature: fairness='drr'; nearest "
        "supported backend: 'reference'")
    for pol in (Policies(fairness="drr", backend="torch"),
                Policies(fairness="drr")):
        with pytest.raises(ScenarioError, match="supports fairness"):
            _static(policies=pol)
    assert scn.run(backend="reference").kind == "fabric"


def test_torch_backend_error_for_adaptive_routing():
    theirs = library.build("routing_rescue")
    scn = Scenario.from_dict(theirs.to_dict())
    assert scn.policies.routing == "adaptive_spray"
    with pytest.raises(BackendError) as e:
        scn.run(backend="torch", device="cpu")
    assert "unsupported feature: routing='adaptive_spray' (per-iteration " \
        "byte re-split); nearest supported backend: 'reference'" \
        in str(e.value)
    with pytest.raises(ScenarioError, match="encodes static routes only"):
        scn.replace(policies=Policies(routing="adaptive_spray",
                                      backend="torch"))


def test_torch_policies_know_the_ports_backends_only():
    assert Policies().backend == "cuda"          # the card is the default
    assert _static().policies.backend == "cuda"
    assert _static(policies=Policies(backend="reference")).policies.backend \
        == "reference"
    for name in ("jnp", "pallas", "numpy"):
        with pytest.raises(ScenarioError, match="unknown backend"):
            Policies(backend=name).validate()


@pytest.mark.parametrize("call", ["from_trace", "attribute", "advise",
                                  "diagnose", "to_trace", "validate"])
def test_torch_unported_surfaces_say_where_they_are_queued(call):
    """These surfaces were queued for a later slice of the port and raised
    ``NotImplementedError`` naming the queue; they are ported now, so each
    reaches the port's trace or advisor module and gives what the JAX
    package's gives on the same run."""
    from repro.fabric.trace import TraceError as JaxTraceError
    from repro_torch.fabric.trace import TraceError
    scn = _static()
    res = scn.run(backend="reference")
    d = scn.to_dict()
    d["policies"]["backend"] = "reference"
    want = JaxScenario.from_dict(d).run()
    if call == "from_trace":
        with pytest.raises(TraceError) as mine:
            Scenario.from_trace([])
        with pytest.raises(JaxTraceError) as theirs:
            JaxScenario.from_trace([])
        assert str(mine.value) == str(theirs.value)
        fitted = Scenario.from_trace(res.to_trace())
        assert fitted.jobs is not None and fitted.policies.backend == "cuda"
    elif call == "validate":
        assert res.validate(res.to_trace()).overall() == \
            want.validate(want.to_trace()).overall()
    elif call == "to_trace":
        assert res.to_trace().to_dict() == want.to_trace().to_dict()
    elif call == "advise":
        got = [(r.action, r.tenant, r.delta_s) for r in
               res.advise(backend="reference")]
        assert got == [(r.action, r.tenant, r.delta_s) for r in
                       want.advise(backend="reference")]
    elif call == "attribute":
        assert res.attribute().to_dict() == want.attribute().to_dict()
    else:
        assert res.diagnose() == want.diagnose()


def test_torch_grid_mixes_reference_and_batched_variants():
    grid = ScenarioGrid(_static(), {"policies.backend": ["reference", "torch"],
                                    "congestion": [None]})
    out = grid.run(device="cpu", dtype=torch.float64)
    (_, ref), (_, fast) = out
    assert ref.raw.jobs[0].step_times == pytest.approx(
        fast.raw.jobs[0].step_times, rel=1e-9)
    assert grid.to_csv(results=out).count("\n") == 1 + 2 * 2
