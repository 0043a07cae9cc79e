"""The port's bottleneck attribution and what-if advisor against the JAX
package's.

``repro_torch.fabric.advisor`` is a copy of the JAX package's module with
one departure the port's ``cuda`` default forces: a candidate whose edits
the batched runner cannot take (adaptive routing, here) names
``backend="reference"`` before it is built, so no candidate is dropped and
the port advises what the JAX package advises. Attribution reads the
Python engine's step instrumentation, so it is held bit for bit; the
counterfactual sweep runs its batched variants on the plain ``torch``
runner (CPU, float64) and the top recommendation is re-verified on the
Python engine, so its verified delta is held bit for bit too.

``counterfactual_sweep`` decides which variant goes where before anything
runs and has no quiet stand-in: an error of the batched run ends the call.
"""
import pytest
import torch

from repro.fabric import advisor as jax_advisor
from repro.fabric.scenario import library as jax_library
from repro_torch.fabric import Arrival, JobSpec
from repro_torch.fabric.advisor import AdvisorError, advise, attribute
from repro_torch.fabric.advisor import _candidates
from repro_torch.fabric.backend import BackendError, counterfactual_sweep
from repro_torch.fabric.scenario import (Policies, Scenario, TopologySpec,
                                         library)

# tests/test_advisor.py's acceptance matrix, and the multi-pod entry whose
# adaptive-routing candidate the batched runner cannot take
MATRIX = ("synchronization_amplification", "topology_contention",
          "locality_variance", "cross_pod_interference")


@pytest.fixture(scope="module")
def runs():
    """name -> (port scenario, port reference result, JAX scenario, JAX
    reference result), each run once."""
    out = {}
    for name in MATRIX:
        scn, jscn = library.build(name), jax_library.build(name)
        out[name] = (scn, scn.run(backend="reference"), jscn, jscn.run())
    return out


@pytest.fixture(scope="module")
def advice(runs):
    """name -> (port advice on the torch runner in float64, JAX advice on
    its reference engine), each computed once."""
    return {name: (advise(scn, res, backend="torch", device="cpu",
                          dtype=torch.float64),
                   jax_advisor.advise(jscn, jres, backend="reference"))
            for name, (scn, res, jscn, jres) in runs.items()}


def _key(rec):
    return (rec.action, rec.bucket, rec.tenant, repr(sorted(
        rec.edits.items())))


@pytest.mark.parametrize("name", MATRIX)
def test_torch_advisor_buckets_bit_identical_to_jax(name, runs):
    _, res, _, jres = runs[name]
    mine, theirs = attribute(res), jax_advisor.attribute(jres)
    assert mine.names() == theirs.names()
    for ta in mine:
        tb = theirs[ta.tenant]
        assert ta.factors == tb.factors and ta.notes == tb.notes
        for a, b in ((ta.mean, tb.mean), (ta.p99, tb.p99)):
            assert {k: v.hex() for k, v in a.to_dict().items()} == \
                {k: v.hex() for k, v in b.to_dict().items()}
            assert a.reconstruct().hex() == a.overhead_s.hex()
    assert mine.summary() == theirs.summary()


@pytest.mark.parametrize("name", MATRIX)
def test_torch_advisor_candidates_equal_jax(name, runs, advice):
    scn, res, jscn, jres = runs[name]
    mine = _candidates(scn, attribute(res))
    theirs = jax_advisor._candidates(jscn, jax_advisor.attribute(jres))
    assert mine == theirs
    # every candidate was built and run: none dropped by the cuda default
    recs, jrecs = advice[name]
    assert sorted(map(_key, recs)) == sorted(map(_key, jrecs))
    assert len(recs) == len(mine)


@pytest.mark.parametrize("name", MATRIX)
def test_torch_advisor_top_recommendation_matches_jax(name, advice):
    recs, jrecs = advice[name]
    top, jtop = recs[0], jrecs[0]
    assert _key(top) == _key(jtop)
    assert top.verified_delta_s is not None
    assert top.verified_delta_s.hex() == jtop.verified_delta_s.hex()
    assert top.predicted_recovery.hex() == jtop.predicted_recovery.hex()
    assert top.confidence == "high"
    # the top-3 were re-verified on the Python engine, in both packages
    assert [_key(r) for r in recs[:3]] == [_key(r) for r in jrecs[:3]]
    assert [r.verified_delta_s for r in recs[:3]] == \
        [r.verified_delta_s for r in jrecs[:3]]


@pytest.mark.parametrize("name", MATRIX)
def test_torch_advisor_reference_advice_bit_identical_to_jax(name, runs,
                                                             advice):
    scn, res, _, _ = runs[name]
    mine = advise(scn, res, backend="reference")
    theirs = advice[name][1]
    assert [_key(r) for r in mine] == [_key(r) for r in theirs]
    assert [(r.predicted_delta_s.hex(), r.backend, r.confidence)
            for r in mine] == \
        [(r.predicted_delta_s.hex(), r.backend, r.confidence)
         for r in theirs]


@pytest.mark.parametrize("name", MATRIX)
def test_torch_advisor_labels_each_candidate_by_its_engine(name, advice):
    """The batched variants are labelled ``torch``; a candidate the
    runner cannot take (adaptive routing) ran on the Python engine and
    says so."""
    for rec in advice[name][0]:
        routing = rec.scenario.policies.routing
        if routing == "adaptive_spray":
            assert rec.backend == "reference"
            assert rec.scenario.policies.backend == "reference"
        else:
            assert rec.backend == "torch"
            assert rec.scenario.policies.backend == "cuda"


def test_torch_advisor_keeps_the_adaptive_routing_candidate(advice):
    recs, jrecs = advice["cross_pod_interference"]
    mine = [r for r in recs if r.action == "adaptive inter-pod routing"]
    theirs = [r for r in jrecs if r.action == "adaptive inter-pod routing"]
    assert len(mine) == len(theirs) == 1
    assert mine[0].predicted_delta_s.hex() == \
        theirs[0].predicted_delta_s.hex()


def test_torch_advisor_event_timeline_matches_jax():
    scn = library.build("noisy_neighbor_inference")
    jscn = jax_library.build("noisy_neighbor_inference")
    mine = advise(scn, backend="cuda")          # every variant: reference
    theirs = jax_advisor.advise(jscn)
    assert [(_key(r), r.backend, r.delta_s.hex()) for r in mine] == \
        [(_key(r), r.backend, r.delta_s.hex()) for r in theirs]


def test_torch_advisor_batched_result_raises_clear_error():
    res = library.build("topology_contention").run(
        backend="torch", device="cpu", dtype=torch.float64)
    with pytest.raises(AdvisorError, match="reference"):
        attribute(res)


def test_torch_advisor_result_front_doors(runs):
    scn, res, _, jres = runs["topology_contention"]
    attr = res.attribute()
    assert attr["primary"].dominant == "contention"
    assert res.diagnose() == attr.summary() == jres.diagnose()
    recs = res.advise(backend="torch", device="cpu", dtype=torch.float64,
                      verify=False)
    assert all(r.verified_delta_s is None for r in recs)
    assert any(r.backend == "torch" and r.confidence == "medium"
               for r in recs)


# -- counterfactual_sweep ----------------------------------------------------


_TOPO = TopologySpec(n_nodes=32, nodes_per_leaf=8)


def _static(**policies):
    return Scenario(name="s", topology=_TOPO,
                    jobs=(JobSpec("a", 8, placement="scattered"),
                          JobSpec("b", 8, placement="scattered",
                                  grad_bytes=2e9)),
                    policies=Policies(**policies), iters=12, warmup=2)


def _mixed():
    """Variants the runner takes (maxmin, strict_priority) and variants it
    does not (drr fairness, an event timeline, adaptive routing)."""
    timeline = Scenario(name="t", topology=_TOPO,
                        events=(Arrival(0.0, JobSpec("a", 8)),),
                        policies=Policies(backend="reference"),
                        horizon=2.0)
    return [_static(), _static(fairness="drr", backend="reference"),
            timeline, _static(fairness="strict_priority"),
            _static(routing="adaptive_spray", backend="reference")]


def test_torch_counterfactual_sweep_labels_each_variant():
    variants = _mixed()
    out = counterfactual_sweep(variants, backend="torch", device="cpu",
                               dtype=torch.float64)
    assert [bk for _, bk in out] == ["torch", "reference", "reference",
                                     "torch", "reference"]
    for scn, (res, bk) in zip(variants, out):
        assert res.scenario is scn or res.scenario == scn
        ref = scn.run(backend="reference")
        if bk == "reference":
            assert res.fingerprint() == ref.fingerprint()
        else:
            for t in ref.names():
                assert res.series(t) == pytest.approx(ref.series(t),
                                                      rel=1e-9, abs=0.0)
    # the reference backend by name runs every variant on the host
    assert [bk for _, bk in counterfactual_sweep(variants,
                                                 backend="reference")] == \
        ["reference"] * len(variants)


def test_torch_counterfactual_sweep_lets_a_runner_error_through(
        monkeypatch):
    """A BackendError the JAX package would swallow (and rerun the batch
    on the Python engine) ends the call here, before any variant has run
    anywhere: the cuda runner refuses the CPU."""
    ran = []
    real = Scenario._run_reference
    monkeypatch.setattr(Scenario, "_run_reference",
                        lambda self, topo=None: ran.append(self.name)
                        or real(self, topo))
    with pytest.raises(BackendError, match="runs on a CUDA device"):
        counterfactual_sweep(_mixed(), backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="float32 or torch.float64"):
        counterfactual_sweep(_mixed(), backend="torch", device="cpu",
                             dtype=torch.float16)
    assert ran == []
    # a list the runner takes nothing from never reaches it
    only_ref = [v for v in _mixed() if v.policies.backend == "reference"]
    out = counterfactual_sweep(only_ref, backend="cuda", device="cpu")
    assert [bk for _, bk in out] == ["reference"] * 3


def test_torch_counterfactual_sweep_has_no_rerun_elsewhere():
    """The sweep holds no ``except``: nothing catches a batched failure
    to run the batch on another backend."""
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(counterfactual_sweep))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
