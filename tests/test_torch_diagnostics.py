"""The port's failure-mode diagnostics (``repro_torch.core.diagnostics``, a
copy of the JAX package's ``repro.core.diagnostics``) against the JAX
package's.

Held: ``diagnose_jobs`` on each static library scenario's engine run
(the Python engine, ``backend="reference"``, in each package) gives the
JAX package's reports field by field, and ``diagnose`` on one set of
records (the port's engine's) gives the same report in both packages,
with and without a transfer floor; ``expected_max_factor`` equal.
"""
import dataclasses

import pytest

from repro import core as jcore
from repro.fabric.scenario import library as jax_library

from repro_torch import core
from repro_torch.fabric.scenario import library

STATIC = ("synchronization_amplification", "topology_contention",
          "locality_variance", "cross_pod_interference")


def _fields(report):
    return dataclasses.asdict(report)


@pytest.mark.parametrize("name", STATIC)
def test_torch_diagnose_jobs_matches_jax_package(name):
    mine = library.build(name).run(backend="reference").raw
    theirs = jax_library.build(name).run(backend="reference").raw
    got, want = core.diagnose_jobs(mine), jcore.diagnose_jobs(theirs)
    assert list(got) == list(want) and got
    for job in want:
        assert isinstance(got[job], core.DiagnosticReport)
        assert _fields(got[job]) == _fields(want[job]), job
        assert got[job].to_dict() == want[job].to_dict()


@pytest.mark.parametrize("floor", [0.0, 0.05], ids=["no floor", "floor"])
def test_torch_diagnose_on_the_same_records_matches_jax_package(floor):
    raw = library.build("topology_contention").run(backend="reference").raw
    for jr in raw.jobs:
        records = jr.per_rank_records()
        got = core.diagnose(records, transfer_floor=floor)
        want = jcore.diagnose(records, transfer_floor=floor)
        assert _fields(got) == _fields(want), jr.name
        assert [s.mode for s in got.scores] == [
            "sync_amplification", "fabric_contention", "locality_variance",
            "runtime_jitter"]


def test_torch_expected_max_factor_matches_jax_package():
    for n in (0, 1, 2, 8, 64, 512):
        assert core.expected_max_factor(n) == jcore.expected_max_factor(n)
    with pytest.raises(ValueError):
        core.diagnose([])
