"""The port's scenario library and legacy ``simulate()`` against the JAX
package's.

The library (``repro_torch.fabric.scenario.library``) is a copy of the JAX
package's with one departure: entries the batched runner cannot take
(event timelines, adaptive routing) name ``backend="reference"``, since the
port's default backend is the card. So on ``reference`` every entry must
give the live JAX run's ``fingerprint()`` bit for bit, and the static
entries on the batched ``torch`` runner (CPU, float64) stay within the
``scenario`` kernel's 1e-9 of it. ``simulate``/``efficiency_curve`` (the
paper's Fig. 1) and the seed loop they are held to
(``_reference.simulate_reference``) must equal the JAX package's bit for
bit.
"""
import pytest
import torch

from repro.fabric import simulator as jax_simulator
from repro.fabric.scenario import library as jax_library
from repro_torch.fabric import (SimConfig, efficiency_curve, job_spec_from,
                                scenario_from, simulate)
from repro_torch.fabric._reference import simulate_reference
from repro_torch.fabric.scenario import Scenario, library

STATIC = ("synchronization_amplification", "topology_contention",
          "locality_variance", "cross_pod_interference")
REFERENCE_ONLY = ("noisy_neighbor_inference", "priority_preemption",
                  "failure_recovery", "continuous_batching_relief",
                  "slo_placement", "routing_rescue")


@pytest.fixture(scope="module")
def jax_runs():
    """name -> the JAX package's reference Result, run once."""
    return {name: jax_library.build(name).run()
            for name in jax_library.names()}


def test_torch_library_names_match_jax_package():
    assert library.names() == jax_library.names()
    assert sorted(STATIC + REFERENCE_ONLY) == sorted(library.names())


@pytest.mark.parametrize("name", STATIC + REFERENCE_ONLY)
def test_torch_library_declares_the_jax_scenario(name):
    """The same scenario as data, apart from the declared backend: the
    static entries keep the port's default (the card), the others name
    the Python engine, which is the JAX package's default."""
    mine, theirs = library.build(name).to_dict(), \
        jax_library.build(name).to_dict()
    want = "cuda" if name in STATIC else "reference"
    assert mine["policies"].pop("backend") == want
    assert theirs["policies"].pop("backend") == "reference"
    assert mine == theirs


@pytest.mark.parametrize("name", STATIC + REFERENCE_ONLY)
def test_torch_library_reference_fingerprint_matches_jax_run(name,
                                                             jax_runs):
    want = jax_runs[name]
    got = library.build(name).run(backend="reference")
    assert got.kind == want.kind
    assert got.fingerprint() == want.fingerprint()
    assert got.diagnostics() == want.diagnostics()


@pytest.mark.parametrize("name", STATIC)
def test_torch_library_static_entries_on_torch_within_rtol(name, jax_runs):
    want = jax_runs[name]
    got = library.build(name).run(backend="torch", device="cpu",
                                  dtype=torch.float64)
    assert got.names() == want.names()
    for tenant in want.names():
        assert got.series(tenant) == pytest.approx(want.series(tenant),
                                                   rel=1e-9, abs=0.0)


@pytest.mark.parametrize("name", REFERENCE_ONLY)
def test_torch_library_reference_only_entries_refuse_the_batched_runner(
        name):
    from repro_torch.fabric.backend import BackendError
    with pytest.raises(BackendError, match="nearest supported backend: "
                                           "'reference'"):
        library.build(name).run(backend="torch", device="cpu")


@pytest.mark.parametrize("n,coordination", [(8, False), (16, True),
                                            (24, False)])
def test_torch_simulate_bit_identical_to_jax_package(n, coordination):
    mine = simulate(SimConfig.fast(n, coordination=coordination, seed=3))
    theirs = jax_simulator.simulate(jax_simulator.SimConfig.fast(
        n, coordination=coordination, seed=3))
    assert [x.hex() for x in mine.step_times] == \
        [x.hex() for x in theirs.step_times]
    assert mine.link_bytes == theirs.link_bytes
    assert (mine.mean_step, mine.cv, mine.throughput) == \
        (theirs.mean_step, theirs.cv, theirs.throughput)
    # the per-rank records come from the Python engine by name
    assert len(mine.records) == n
    assert [r.wait_time for r in mine.records[0]] == \
        [r.wait_time for r in theirs.records[0]]


@pytest.mark.parametrize("coordination", [False, True])
def test_torch_simulate_matches_the_seed_loop(coordination):
    cfg = SimConfig.fast(16, coordination=coordination, seed=1)
    got, want = simulate(cfg), simulate_reference(cfg)
    assert got.step_times == want.step_times
    assert got.link_bytes.keys() == want.link_bytes.keys()
    for r in (0, 15):
        assert [(x.compute_time, x.wait_time, x.pacing_delay)
                for x in got.records[r]] == \
            [(x.compute_time, x.wait_time, x.pacing_delay)
             for x in want.records[r]]


def test_torch_simulate_warns_as_a_legacy_entry_point():
    with pytest.warns(DeprecationWarning, match="scenario_from"):
        simulate(SimConfig.fast(8))


@pytest.mark.parametrize("coordination", [False, True])
def test_torch_efficiency_curve_bit_identical_to_jax_package(coordination):
    got = efficiency_curve([8, 16], coordination=coordination)
    want = jax_simulator.efficiency_curve([8, 16],
                                          coordination=coordination)
    assert got == want
    assert got[8]["efficiency"] == 1.0


def test_torch_scenario_from_keeps_the_card_default_and_the_jax_scenario():
    cfg = SimConfig.fast(16, coordination=True, seed=2)
    scn = scenario_from(cfg)
    assert isinstance(scn, Scenario) and scn.policies.backend == "cuda"
    mine = scn.to_dict()
    theirs = jax_simulator.scenario_from(
        jax_simulator.SimConfig.fast(16, coordination=True, seed=2)).to_dict()
    assert mine["policies"].pop("backend") == "cuda"
    assert theirs["policies"].pop("backend") == "reference"
    assert mine == theirs
    assert job_spec_from(cfg).spanning_override == 2
    # on the batched runner (CPU, float64) the same series within 1e-9
    fast = scn.run(backend="torch", device="cpu", dtype=torch.float64)
    assert fast.series("job0") == pytest.approx(simulate(cfg).step_times,
                                                rel=1e-9, abs=0.0)
