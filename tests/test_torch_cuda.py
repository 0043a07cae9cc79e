"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need a CUDA device and ``nvcc`` (the kernels are built at
first use); they carry the ``gpu`` marker and skip where there is no
card. Run them on a machine with one:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

float64 results must be bit-identical to the plain versions (same
operation sequence, no fused multiply-add); float32 within 1 ulp.
"""
import numpy as np
import pytest
import torch

from repro_torch.fabric import JobSpec
from repro_torch.fabric.backend import cuda_kernels as CK
from repro_torch.fabric.backend import torch_kernels as TK
from repro_torch.fabric.scenario import (Policies, Scenario, ScenarioGrid,
                                         TopologySpec)

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _inputs(rows, n, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 1.0, size=(rows, n))
    d[rng.uniform(size=d.shape) < 0.25] = 0.0
    d[::3, -1] = d[::3, 0]
    w = rng.uniform(0.25, 4.0, size=(rows, n))
    cap = rng.uniform(0.0, 2.0, size=rows)
    to = lambda x: torch.as_tensor(x).to(device=device, dtype=dtype)
    return to(d), to(w), to(cap)


def _same(got, want):
    if want.dtype == torch.float64:
        return torch.equal(got, want)
    eps = torch.finfo(want.dtype).eps
    return bool(((got - want).abs() <= eps * want.abs()).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("rows,n", [(1000, 5), (36864, 4), (17, 1)])
def test_torch_cuda_allocators_match_plain_versions(card, dtype, rows, n):
    d, w, cap = _inputs(rows, n, dtype, card)
    pr = list(range(n))[::-1]
    before = CK.launch_counts()
    assert _same(CK.maxmin_shares(d, cap), TK.maxmin_shares(d, cap))
    assert _same(CK.wfq_shares(d, w, cap), TK.wfq_shares(d, w, cap))
    assert _same(CK.strict_priority_shares(d, pr, cap),
                 TK.strict_priority_shares(d, pr, cap))
    after = CK.launch_counts()
    for k in ("maxmin_shares", "wfq_shares", "strict_priority_shares"):
        assert after[k] == before[k] + 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_torch_cuda_segment_overlap_matches_plain_version(card, dtype):
    rng = np.random.default_rng(1)
    starts = rng.uniform(0.0, 10.0, size=(300, 64))
    ends = starts + rng.uniform(0.0, 3.0, size=(300, 64))
    ends[rng.uniform(size=ends.shape) < 0.3] = -np.inf
    to = lambda x: torch.as_tensor(x).to(device=card, dtype=dtype)
    s_i = to(rng.uniform(0.0, 10.0, size=(100, 1)))
    e_i = s_i + 2.0
    st, en = to(starts).reshape(100, 3, 64), to(ends).reshape(100, 3, 64)
    assert _same(CK.segment_overlap(s_i, e_i, st, en),
                 TK.segment_overlap(s_i, e_i, st, en))


def test_torch_cuda_backend_grid_is_bit_identical_to_torch_backend(card):
    base = Scenario(
        name="g", topology=TopologySpec(n_nodes=32, nodes_per_leaf=4),
        jobs=[JobSpec("a", 8, placement="scattered", weight=2.0, priority=1),
              JobSpec("b", 8, placement="scattered", grad_bytes=2e9),
              JobSpec("c", 8, placement="striped", grad_bytes=4e9)],
        policies=Policies(fairness="wfq"), iters=30, warmup=5)
    grid = ScenarioGrid(base, {"policies.fairness": ["maxmin", "wfq",
                                                     "strict_priority"],
                               "base_seed": [0, 1]})
    CK.reset_launch_counts()
    fast = grid.run(backend="cuda", dtype=torch.float64)     # device=None
    assert CK.launch_counts()["segment_overlap"] == 3 * 30 * 3
    plain = grid.run(backend="torch", dtype=torch.float64)
    for (_, a), (_, b) in zip(fast, plain):
        for name in ("a", "b", "c"):
            assert a.series(name) == b.series(name)
            ref = a.scenario.run(backend="reference").series(name)
            assert np.allclose(ref, a.series(name), rtol=1e-9, atol=0.0)


def test_torch_cuda_bare_run_launches_the_kernels_on_the_card(card):
    """Nothing asked for: ``policies.backend`` defaults to ``"cuda"`` and
    ``device=None`` is the card, in float32."""
    scn = Scenario(
        name="bare", topology=TopologySpec(n_nodes=32, nodes_per_leaf=4),
        jobs=[JobSpec("a", 8, placement="scattered"),
              JobSpec("b", 8, placement="scattered", grad_bytes=2e9)],
        iters=10, warmup=2)
    CK.reset_launch_counts()
    res = scn.run()
    counts = CK.launch_counts()
    assert counts["maxmin_shares"] == counts["segment_overlap"] == 2 * 10
    (_, again), = ScenarioGrid(scn, {"base_seed": [0]}).run()
    assert again.series("a") == res.series("a")
    assert CK.launch_counts()["segment_overlap"] == 2 * 2 * 10
