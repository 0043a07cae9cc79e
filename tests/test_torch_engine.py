"""The port's batched runner against the JAX package's, on the CPU.

Three layers, same scenarios through both packages (a scenario crosses as
data, ``Scenario.from_dict(scn.to_dict())``):

  * host prep: every array the port's ``_prep`` makes equals the JAX
    package's (``np.array_equal``);
  * the runner: the JAX package's prepped state, loaded with
    ``load_prep`` and stepped by the port's loop, against the JAX
    package's compiled scan under float64 at rtol 1e-12 (same operation
    sequence; observed maximum 7.4e-13) and 1e-10 with a paced tenant
    (observed 3.8e-12). The port's series on these scenarios is
    bit-identical to the Python reference engine's, so what is observed
    is the compiled scan's own distance from the reference, which its
    pacing arithmetic widens;
  * the whole slice: ``ScenarioGrid.run(backend="torch", device="cpu")``
    against the JAX package's ``Scenario.run(backend="pallas")`` (Pallas
    kernels in interpret mode) and against the live Python reference
    engine, at the ``scenario`` tier: rtol 1e-9 in float64, 1e-3 in
    float32.
"""
import jax
import numpy as np
import pytest
import torch

from repro.fabric.backend import KernelType as JaxKernelType
from repro.fabric.backend import jnp_engine as JE
from repro.fabric.scenario import Scenario as JaxScenario
from repro_torch.configs.base import PacingConfig
from repro_torch.fabric import JobSpec
from repro_torch.fabric.backend import (BATCHED_SCENARIO_FAIRNESS,
                                        EQUIVALENCE_TIERS, KernelType)
from repro_torch.fabric.backend import torch_engine as TE
from repro_torch.fabric.congestion import CongestionConfig
from repro_torch.fabric.scenario import (Policies, Scenario, ScenarioGrid,
                                         TopologySpec)

ITERS, WARMUP = 30, 5
NAMES = ("a", "b", "c", "d")
# thresholds low enough that the controller really paces tenant "a" here
# (its waits are a few thousandths of its multi-second steps)
PACING = PacingConfig(enabled=True, window=6, cv_threshold=0.01,
                      skew_threshold=0.001, max_delay_frac=0.5, gain=0.8,
                      decay=0.8, warmup_iters=4)


def four_tenants(fairness="maxmin", paced=True, iters=ITERS, seed=0,
                 u_mean=0.3, name="four"):
    """The sweep's population at a small size: four 8-rank tenants on a
    32-node fabric, every tenant contending on most shared links."""
    return Scenario(
        name=name,
        topology=TopologySpec(n_nodes=32, nodes_per_leaf=4),
        jobs=[
            JobSpec("a", 8, placement="scattered", weight=2.0, priority=2,
                    pacing=PACING if paced else None),
            JobSpec("b", 8, placement="scattered", grad_bytes=2e9,
                    priority=1),
            JobSpec("c", 8, placement="striped", grad_bytes=4e9),
            JobSpec("d", 8, placement="compact"),
        ],
        congestion=CongestionConfig(k_kick=0.25, u_mean=u_mean),
        policies=Policies(fairness=fairness),
        base_seed=seed, iters=iters, warmup=WARMUP)


def to_jax(scn):
    """The scenario in the JAX package. Backend names are each package's
    own, so the declared default (the port's ``"cuda"``) does not cross;
    every call below names its backend."""
    d = scn.to_dict()
    d["policies"]["backend"] = "reference"
    return JaxScenario.from_dict(d)


def max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and a.size
    return float(np.max(np.abs(a - b) / np.abs(a)))


def series(result):
    return np.array([result.series(n) for n in NAMES])


# -- host prep ---------------------------------------------------------------


@pytest.mark.parametrize("fairness", BATCHED_SCENARIO_FAIRNESS)
def test_torch_prep_arrays_equal_jax_prep(fairness):
    scn = four_tenants(fairness)
    mine = TE._prep(scn)
    theirs = JE._prep(to_jax(scn))
    assert mine.sig == theirs.sig
    assert sorted(mine.data) == sorted(theirs.data)
    for k in mine.data:
        assert mine.data[k].dtype == theirs.data[k].dtype, k
        assert np.array_equal(mine.data[k], theirs.data[k]), k
    ms, ts = mine.static, theirs.static
    assert (ms["J"], ms["L"], ms["iters"], ms["fairness"]) == \
        (ts["J"], ts["L"], ts["iters"], ts["fairness"])
    assert (ms["J"], ms["L"]) == (4, 9)
    assert np.array_equal(ms["used"], ts["used"])
    assert np.array_equal(ms["priorities"], ts["priorities"])
    for a, b in zip(ms["jobs"], ts["jobs"]):
        assert np.array_equal(a["own"], b["own"]) and a["own"].size >= 5
        assert a["pace"] == b["pace"] and a["n"] == b["n"]
        assert a["sched"]["groups"] == b["sched"]["groups"]
        for k in ("sidx", "mask", "m"):
            assert np.array_equal(a["sched"][k], b["sched"][k])


# -- the runner on one and the same prepped state ----------------------------


@pytest.mark.parametrize("fairness,paced", [
    ("maxmin", False), ("wfq", False), ("strict_priority", False),
    ("maxmin", True)])
def test_torch_runner_matches_jax_runner_on_jax_prep(fairness, paced):
    ports = [four_tenants(fairness, paced, seed=s, u_mean=um)
             for s, um in ((0, 0.2), (1, 0.35), (2, 0.5))]
    variants = [to_jax(p) for p in ports]
    preps = [JE._prep(v) for v in variants]
    assert len({p.sig for p in preps}) == 1
    static = preps[0].static
    data = {k: np.stack([p.data[k] for p in preps]) for k in preps[0].data}
    with jax.enable_x64(True):
        runner = JE._get_runner(preps[0].sig, static, JaxKernelType.JNP)
        want = np.asarray(runner(data))
    assert want.dtype == np.float64 and want.shape == (3, ITERS, 4)
    loaded = TE.load_prep(static, data, "cpu", torch.float64)
    got = TE.run_loaded(loaded, KernelType.TORCH)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert max_rel(want, got.numpy()) <= (1e-10 if paced else 1e-12)
    ref = np.stack([series(p.run(backend="reference")).T for p in ports])
    assert max_rel(ref, got.numpy()[:, WARMUP:]) <= 1e-12     # observed 0.0
    if paced:      # float32 pacing decisions flip on one-ulp differences
        return
    # float32, the production dtype, against the JAX package's float32
    want32 = np.asarray(JE._get_runner(
        preps[0].sig, static, JaxKernelType.JNP)(data))
    assert want32.dtype == np.float32
    got32 = TE.run_loaded(TE.load_prep(static, data, "cpu", None))
    assert got32.dtype == torch.float32
    assert max_rel(want32, got32.numpy()) <= 1e-3


def test_torch_load_prep_builds_index_tensors_once():
    p = TE._prep(four_tenants("wfq"))
    data = {k: v[None] for k, v in p.data.items()}
    loaded = TE.load_prep(p.static, data, "cpu", torch.float64)
    assert loaded["device"] == torch.device("cpu")
    assert all(v.dtype == torch.float64 for v in loaded["data"].values())
    for i, jb in enumerate(loaded["jobs"]):
        assert jb["sidx"].dtype == torch.int64
        assert jb["co"].tolist() == [k for k in range(4) if k != i]
        assert jb["co_use_t"].shape == (jb["n_own"], 3) and jb["contended"]
    with pytest.raises(ValueError, match="dtype must be"):
        TE.load_prep(p.static, data, "cpu", torch.float16)


# -- the whole slice ----------------------------------------------------------


@pytest.mark.parametrize("fairness", BATCHED_SCENARIO_FAIRNESS)
def test_torch_slice_matches_pallas_backend_and_reference_f64(fairness):
    tol = EQUIVALENCE_TIERS["scenario"][1]
    assert tol == 1e-9
    base = four_tenants(fairness)
    grid = ScenarioGrid(base, {"congestion.u_mean": [0.2, 0.45],
                               "base_seed": [0, 3]})
    stats = {}
    out = grid.run(backend="torch", device="cpu", dtype=torch.float64,
                   stats=stats)
    assert stats["groups"] == 1 and stats["variants"] == 4
    assert len(out) == 4
    for params, res in out:
        scn = res.scenario
        assert scn.base_seed == params["base_seed"]
        mine = series(res)
        assert mine.shape == (4, ITERS - WARMUP)
        assert np.isfinite(mine).all() and (mine > 0).all()
        assert max_rel(series(scn.run(backend="reference")), mine) <= tol        # live reference
    # the JAX package, Pallas kernels in interpret mode, float64
    scn = out[1][1].scenario
    with jax.enable_x64(True):
        theirs = to_jax(scn).run(backend="pallas")
    assert max_rel(series(theirs), series(out[1][1])) <= tol


@pytest.mark.parametrize("fairness", BATCHED_SCENARIO_FAIRNESS)
def test_torch_slice_float32_default_tracks_pallas_and_reference(fairness):
    """float32 is the default dtype. Against the JAX package's float32
    run (Pallas kernels, interpret mode) the operation sequence is the
    same and rtol 1e-3 holds for every fairness mode (observed <= 6e-4).
    Against the float64 Python reference, 1e-3 holds for ``maxmin``
    (observed 3e-4); under ``wfq`` and ``strict_priority`` a starved
    tenant's small share divides its step time, so float32 rounding of
    the simulated clocks is amplified far past 1e-3 within these 30
    iterations (observed 2e-2 and 1.0) in both packages alike — float64
    is the dtype that tracks the reference there. (Unpaced: a float32
    pacing threshold that flips on a one-ulp difference moves a whole
    step, 6e-3 between the two packages.)"""
    scn = four_tenants(fairness, paced=False)
    res = scn.run(backend="torch", device="cpu")          # float32 default
    mine = series(res)
    theirs = to_jax(scn).run(backend="pallas")            # float32 too
    assert max_rel(series(theirs), mine) <= 1e-3
    if fairness == "maxmin":
        assert max_rel(series(scn.run(backend="reference")), mine) <= 1e-3
    assert res.link_bytes == theirs.link_bytes
    assert [j["nodes"] for j in res.fingerprint()["jobs"]] == \
        [j["nodes"] for j in theirs.fingerprint()["jobs"]]


def test_torch_pacing_bank_really_paces_in_the_batched_runner():
    """The paced tenant's series differs from the unpaced run's (so the
    paced cases above exercise the bank's decisions, not only its
    bookkeeping) and still tracks the reference at the scenario tier."""
    paced, plain = four_tenants("maxmin", True), four_tenants("maxmin", False)
    kw = dict(backend="torch", device="cpu", dtype=torch.float64)
    a, b = series(paced.run(**kw)), series(plain.run(**kw))
    assert max_rel(a, b) > 1e-6
    assert max_rel(series(paced.run(backend="reference")), a) <= 1e-9


def test_torch_grid_groups_by_structure_and_keeps_order():
    """A placement axis changes the schedule structure: two groups, and
    the results still come back in grid order."""
    base = four_tenants("maxmin", paced=False, iters=12)
    grid = ScenarioGrid(base, {"jobs.3.placement": ["compact", "striped"],
                               "congestion.k_burst": [0.5, 1.5]})
    stats = {}
    out = grid.run(backend="torch", device="cpu", dtype=torch.float64,
                   stats=stats)
    assert stats["groups"] == 2
    for (params, res), (_, scn) in zip(out, grid):
        assert res.scenario is scn
        assert max_rel(series(scn.run(backend="reference")), series(res)) <= 1e-9


def test_torch_single_job_and_policies_backend_default():
    """``J == 1`` skips the contention block; ``Policies.backend`` is the
    declarative default and ``run(backend=)`` overrides it."""
    scn = Scenario(name="solo",
                   topology=TopologySpec(n_nodes=16, nodes_per_leaf=4),
                   jobs=[JobSpec("a", 16)],
                   congestion=CongestionConfig(k_kick=0.25),
                   policies=Policies(backend="torch"), iters=20, warmup=4)
    fast = scn.run(device="cpu", dtype=torch.float64)
    ref = scn.run(backend="reference")
    assert max_rel(ref.series("a"), fast.series("a")) <= 1e-9
    assert fast.raw.jobs[0].link_bytes == ref.raw.jobs[0].link_bytes


# -- past the JAX runner's 64-slot segment ring -------------------------------


def test_torch_segment_store_is_lossless_past_64_iterations():
    """A deliberate departure from the JAX runner, on record against it.

    The JAX runner keeps each tenant's last ``SEG_CAPACITY = 64`` busy
    segments in a ring; the port keeps one slot per iteration. Tenants'
    clocks drift apart: here ``fast`` steps in about 3.5 s and ``slow`` in
    about 12.7 s, so from iteration 88 ``fast``'s window overlaps segments
    of ``slow`` that the ring has overwritten. From there the JAX runner
    leaves the Python reference engine (observed 0.47 relative on
    ``fast``), while the port stays on it (observed 0.0; held at the
    ``scenario`` tier's 1e-9). Up to iteration 64 the two runners agree.
    """
    assert JE.SEG_CAPACITY == 64
    iters, warmup = 100, 5
    scn = Scenario(
        name="drift", topology=TopologySpec(n_nodes=32, nodes_per_leaf=4),
        jobs=[JobSpec("slow", 8, placement="striped", grad_bytes=8e9),
              JobSpec("fast", 8, placement="scattered", grad_bytes=5e8)],
        congestion=CongestionConfig(k_kick=0.25), iters=iters, warmup=warmup)
    ref = scn.run(backend="reference")
    mine = scn.run(backend="torch", device="cpu", dtype=torch.float64)
    with jax.enable_x64(True):
        theirs = to_jax(scn).run(backend="jnp")
    for name in ("slow", "fast"):
        assert len(mine.series(name)) == iters - warmup
        assert max_rel(ref.series(name), mine.series(name)) <= 1e-9
    head = JE.SEG_CAPACITY - warmup
    assert max_rel(ref.series("fast")[:head],
                   theirs.series("fast")[:head]) <= 1e-12
    assert max_rel(ref.series("fast"), theirs.series("fast")) > 0.1
    assert max_rel(ref.series("slow"), theirs.series("slow")) <= 1e-12
    # the store's size is what the lossless form costs: one start and one
    # end per variant, tenant and iteration
    p = TE._prep(scn)
    loaded = TE.load_prep(p.static, {k: v[None] for k, v in p.data.items()},
                          "cpu", torch.float64)
    assert TE.segment_store_bytes(loaded) == 2 * 1 * 2 * iters * 8


# -- the overlap call reads the store in place, filled slots only --------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_torch_sweep_overlap_in_place_keeps_the_gathered_calls_bits(
        monkeypatch, dtype):
    """The runner hands the overlap kernel its whole busy-segment store
    with an owner's co-tenant index and the step's count of filled slots
    (``n_filled = t``). The four-tenant ``backend="torch"`` sweep on the
    CPU is bit for bit what it was when the runner gathered the
    co-tenants' rows into a copy and summed all ``iters`` slots of it
    (the empty slots add ``+0.0``), in float32 and float64, past 64
    iterations."""
    grid = ScenarioGrid(four_tenants(iters=70),
                        {"congestion.u_mean": [0.2, 0.4],
                         "policies.fairness": ["maxmin", "wfq"]})
    now = grid.run(backend="torch", device="cpu", dtype=dtype)
    plain = TE.get_kernel("segment_overlap", KernelType.TORCH)
    calls = []

    def gathered(s_i, e_i, starts, ends, *, n_filled=None, co=None):
        calls.append(n_filled)
        idx = co.long()
        return plain(s_i, e_i, starts[:, idx], ends[:, idx])

    real = TE.get_kernel
    monkeypatch.setattr(TE, "get_kernel", lambda name, kernels: gathered
                        if name == "segment_overlap" else real(name, kernels))
    before = grid.run(backend="torch", device="cpu", dtype=dtype)
    # one call per owner and step, at n_filled 0 .. iters - 1
    assert calls == [t for t in range(70) for _ in NAMES] * 2
    for (_, a), (_, b) in zip(now, before):
        for name in NAMES:
            assert a.series(name) == b.series(name), name
