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


# flow counts 1..8 have a kernel each (the row in registers); 16 and 32
# take the runtime-n form
ALLOC_SHAPES = [(1000, 5), (36864, 4), (17, 1)] + \
    [(300, n) for n in (1, 2, 3, 4, 6, 7, 8, 16, 32)]
PARTITIONS = {
    "descending": lambda n, rng: list(range(n))[::-1],
    "one class": lambda n, rng: [0] * n,
    "main path": lambda n, rng: ([2, 1] + [0] * n)[:n],
    "random": lambda n, rng: rng.integers(0, 3, size=n),
}


@pytest.mark.parametrize("partition", sorted(PARTITIONS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("rows,n", ALLOC_SHAPES)
def test_torch_cuda_allocators_match_plain_versions(card, dtype, rows, n,
                                                    partition):
    d, w, cap = _inputs(rows, n, dtype, card, seed=n)
    pr = PARTITIONS[partition](n, np.random.default_rng(rows + n))
    before = CK.launch_counts()
    assert _same(CK.maxmin_shares(d, cap), TK.maxmin_shares(d, cap))
    assert _same(CK.wfq_shares(d, w, cap), TK.wfq_shares(d, w, cap))
    # one weight vector per group of three rows, read in place
    if rows % 3 == 0:
        wg = w[::3].reshape(rows // 3, 1, n).contiguous()
        d3 = d.reshape(rows // 3, 3, n)
        assert _same(CK.wfq_shares(d3, wg), TK.wfq_shares(d3, wg))
    assert _same(CK.strict_priority_shares(d, pr, cap),
                 TK.strict_priority_shares(d, pr, cap))
    after = CK.launch_counts()
    for k in ("maxmin_shares", "strict_priority_shares"):
        assert after[k] == before[k] + 1
    assert after["wfq_shares"] == before["wfq_shares"] + 1 + (rows % 3 == 0)


def _offset_view(x):
    """``x``'s values in a contiguous view one element into its storage."""
    v = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    return v.view(x.shape).copy_(x)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [4, 8])
def test_torch_cuda_allocators_take_unaligned_rows(card, dtype, n):
    """At 4 and 8 flows a row is a whole number of 16-byte vectors, which
    the kernels load and store as such when the bases are 16-byte
    aligned. Demands, weights and capacity one element into their storage
    take the scalar loads instead: the same bits as the aligned call."""
    d, w, cap = _inputs(300, n, dtype, card, seed=20 + n)
    od, ow, ocap = _offset_view(d), _offset_view(w), _offset_view(cap)
    assert od.data_ptr() % 16 and ow.data_ptr() % 16
    for name, extra, oextra in (
            ("maxmin_shares", (), ()), ("wfq_shares", (w,), (ow,)),
            ("strict_priority_shares", ([2, 1] + [0] * (n - 2),),
             ([2, 1] + [0] * (n - 2),))):
        got = getattr(CK, name)(od, *oextra, ocap)
        assert torch.equal(got, getattr(CK, name)(d, *extra, cap)), name
        assert _same(got, getattr(TK, name)(d, *extra, cap)), name


def test_torch_cuda_allocator_wrappers_refuse_what_the_kernels_do_not_take(
        card):
    d = torch.rand(8, 4, device=card, dtype=torch.float64)
    before = CK.launch_counts()
    for name, extra in (("maxmin_shares", ()), ("wfq_shares", (None,)),
                        ("strict_priority_shares", ([1, 0, 0, 0],))):
        fn = getattr(CK, name)
        with pytest.raises(ValueError, match="takes CUDA tensors; demands "
                                             "is on cpu. backend='torch'"):
            fn(d.cpu(), *extra)
        with pytest.raises(ValueError, match="takes torch.float32 or "
                                             "torch.float64; demands is "
                                             "torch.float16"):
            fn(d.half(), *extra, validate=False)
        wide = torch.rand(2, CK.MAX_FLOWS + 1, device=card)
        with pytest.raises(ValueError, match=f"at most {CK.MAX_FLOWS} flows "
                                             f"per row, got 33"):
            fn(wide, *((list(range(33)),) if extra and extra[0] else extra))
    with pytest.raises(ValueError, match="4 demands but 3 priorities"):
        CK.strict_priority_shares(d, [1, 0, 0])
    with pytest.raises(ValueError, match="weights is torch.float32"):
        CK.wfq_shares(d, torch.ones(8, 4, device=card))
    with pytest.raises(ValueError, match="capacity is on cpu"):
        CK.maxmin_shares(d, torch.ones(8, dtype=torch.float64))
    assert CK.launch_counts() == before


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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("S,n_filled", [(400, 0), (400, 1), (400, 37),
                                        (400, 200), (400, 400), (64, 50),
                                        (7, 5)])
def test_torch_cuda_segment_overlap_reads_the_store_in_place(card, dtype, S,
                                                             n_filled):
    """K3 as the runner calls it: the whole (V, J, S) store through an
    owner's int32 co-tenant index, the window a strided column of the
    (V, J) windows, the first ``n_filled`` slots (37 and 50 are off the
    tile of 32 float32 or 16 float64 slots; S 7 takes the value-at-a-time
    staging). Bit-identical to the plain version in both dtypes, 93 rows
    (not a whole number of 32-row tiles)."""
    V, J = 31, 4
    rng = np.random.default_rng(S + n_filled)
    starts = rng.uniform(0.0, 10.0, size=(V, J, S))
    ends = starts + rng.uniform(0.0, 3.0, size=(V, J, S))
    ends[rng.uniform(size=ends.shape) < 0.2] = -np.inf
    starts[:, :, n_filled:], ends[:, :, n_filled:] = 0.0, -np.inf
    win = rng.uniform(0.0, 10.0, size=(V, J))
    to = lambda x: torch.as_tensor(x).to(device=card, dtype=dtype)
    st, en, ws = to(starts), to(ends), to(win)
    we = ws + 2.0
    for owner in range(J):
        co = [k for k in range(J) if k != owner]
        idx = torch.tensor(co, dtype=torch.int32, device=card)
        before = CK.launch_counts()["segment_overlap"]
        got = CK.segment_overlap(ws[:, owner:owner + 1],
                                 we[:, owner:owner + 1], st, en,
                                 n_filled=n_filled, co=idx)
        assert CK.launch_counts()["segment_overlap"] == before + 1
        want = TK.segment_overlap(ws[:, owner:owner + 1],
                                  we[:, owner:owner + 1], st, en,
                                  n_filled=n_filled, co=idx)
        assert got.shape == (V, J - 1) and torch.equal(got, want)
        # the same bits as the plain version on the gathered, cut store
        assert torch.equal(got, TK.segment_overlap(
            ws[:, owner:owner + 1], we[:, owner:owner + 1],
            st[:, co, :n_filled], en[:, co, :n_filled]))


def test_torch_cuda_segment_overlap_refuses_what_the_kernel_does_not_take(
        card):
    st = torch.zeros(4, 3, 8, device=card)
    w = torch.zeros(4, 1, device=card)
    before = CK.launch_counts()["segment_overlap"]
    with pytest.raises(ValueError, match="n_filled"):
        CK.segment_overlap(w, w, st, st, n_filled=9)
    for co in (torch.tensor([0, 1], device=card),            # int64
               torch.tensor([0, 1], dtype=torch.int32),       # on the CPU
               [0, 1]):
        with pytest.raises(ValueError, match="int32"):
            CK.segment_overlap(w, w, st, st, co=co)
    with pytest.raises(ValueError, match="CUDA tensors"):
        CK.segment_overlap(w.cpu(), w, st, st)
    assert CK.launch_counts()["segment_overlap"] == before


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


def test_torch_cuda_counterfactual_sweep_ends_on_a_refused_store(
        card, monkeypatch):
    """The runner refuses a group whose busy-segment store does not fit
    the card's free memory; ``counterfactual_sweep`` lets that refusal end
    the call instead of running the batch on the Python engine. The card
    is made to report 64 bytes free (the store of two variants x two jobs
    x 10 iterations in float32 is 320), so the refusal is the runner's
    own."""
    from repro_torch.fabric.backend import (BackendError,
                                            counterfactual_sweep)
    scn = Scenario(
        name="store", topology=TopologySpec(n_nodes=32, nodes_per_leaf=4),
        jobs=[JobSpec("a", 8, placement="scattered"),
              JobSpec("b", 8, placement="scattered", grad_bytes=2e9)],
        iters=10, warmup=2)
    ran = []
    real = Scenario._run_reference
    monkeypatch.setattr(Scenario, "_run_reference",
                        lambda self, topo=None: ran.append(self.name)
                        or real(self, topo))
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (64, 80 << 30))
    with pytest.raises(BackendError, match="busy-segment store"):
        counterfactual_sweep([scn, scn.replace(name="other")],
                             backend="cuda")
    assert ran == []


def test_torch_cuda_advise_and_calibrate_on_the_card(card):
    """The diagnostic path's front doors with nothing asked for: the
    advisor's and the calibration's batched runs go to the card."""
    import os

    from repro_torch.fabric.advisor import advise
    from repro_torch.fabric.scenario import library
    from repro_torch.fabric.trace import calibrate, load_trace
    scn = library.build("topology_contention")
    CK.reset_launch_counts()
    recs = advise(scn, verify=True)
    counts = CK.launch_counts()
    assert counts["strict_priority_shares"] > 0
    assert counts["maxmin_shares"] > 0 and counts["segment_overlap"] > 0
    want = advise(scn, backend="reference")
    assert [(r.action, r.tenant) for r in recs[:3]] == \
        [(r.action, r.tenant) for r in want[:3]]
    assert recs[0].verified_delta_s == want[0].verified_delta_s
    tr = load_trace(os.path.join(os.path.dirname(__file__), "traces",
                                 "steady_trainers.json"))
    cal = calibrate(tr)
    assert cal.backend == "cuda"
    cpu = calibrate(tr, backend="torch", device="cpu", dtype=torch.float64)
    assert cal.best_params == cpu.best_params


def _load_chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# K6 (the WKV6 recurrence) within 2e-4 of its plain version in float32
# and 2e-2 in bfloat16, y and the final state (tests/test_kernels.py's),
# over chip_smoke.py's cases and inputs
SMOKE = _load_chip_smoke()
REAL = SMOKE.REAL


SMOKE = _load_chip_smoke()


# -- the model substrate's kernels (K4 flash attention, K5 RMSNorm) ---------
#
# Held to their plain versions in kernels/ref.py: attention 2e-5 in float32
# and 2e-2 in bfloat16 (the JAX package's own tolerances); RMSNorm within
# 2 ulp relative in float32 and 1 ulp in bfloat16 (both round the float64
# mean of squares once to float32 and then make the same correctly rounded
# operations, so they are expected to agree bit for bit). K4 runs
# flash_fwd_wgmma_kernel for bfloat16 and flash_fwd_kernel for float32.

# (B, Sq, Sk, H, KV, Dqk, Dv, causal, window, q_offset, v_dn): v is the
# slice [..., v_dn:] of a (B, Sk, KV, v_dn + Dv) tensor where v_dn > 0, as
# MLA makes it; then chip_smoke.py's cases (the served shapes among them)
ATTN_CASES = [
    (2, 100, 100, 4, 2, 32, 32, True, 0, 0, 0),
    (1, 64, 200, 7, 1, 64, 64, True, 0, 136, 0),
    (1, 130, 130, 2, 2, 128, 128, True, 48, 0, 0),
    (2, 70, 90, 4, 4, 64, 64, False, 0, 0, 0),
    # MLA's head dims: ragged Sq, a fused v, q_offset, a window, GQA
    (2, 100, 100, 4, 4, 96, 64, True, 0, 0, 64),
    (1, 130, 130, 2, 2, 192, 128, True, 0, 0, 128),
    (1, 77, 200, 3, 3, 96, 64, True, 0, 123, 64),
    (1, 150, 150, 4, 2, 192, 128, True, 40, 0, 0),
    (2, 70, 90, 4, 4, 96, 64, False, 0, 0, 0),
] + [(B, Sq, Sk, H, KV, Dqk, Dv, causal, window, q_off, v_dn)
     for _, (B, Sq, Sk, H, KV, Dqk, Dv), causal, window, q_off, v_dn
     in SMOKE.ATTN_CASES]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_torch_cuda_flash_attention_matches_plain_version(card, dtype, case):
    from repro_torch.kernels import cuda_kernels as MK
    from repro_torch.kernels.flash_attention import (flash_attention, plain,
                                                     select_kernel)
    B, Sq, Sk, H, KV, Dqk, Dv, causal, window, q_off, v_dn = case
    gen = torch.Generator(device=card).manual_seed(sum(case[:6]))
    q = torch.randn(B, Sq, H, Dqk, generator=gen, device=card).to(dtype)
    k = torch.randn(B, Sk, KV, Dqk, generator=gen, device=card).to(dtype)
    v = torch.randn(B, Sk, KV, v_dn + Dv, generator=gen,
                    device=card).to(dtype)[..., v_dn:]
    assert select_kernel(q, k, v) == ("flash_fwd_wgmma_kernel"
                                      if dtype == torch.bfloat16
                                      else "flash_fwd_kernel")
    before = MK.launch_counts()["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, window=window,
                          q_offset=q_off)
    torch.cuda.synchronize()
    assert MK.launch_counts()["flash_attention"] == before + 1
    want = plain(q, k, v, causal=causal, window=window, q_offset=q_off)
    assert got.shape == (B, Sq, H, Dv) and got.is_contiguous()
    t = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=t, atol=t)


def test_torch_cuda_flash_attention_reads_fused_kv_slices(card):
    """k and v as slices of one (B, S, 2 KV, D) tensor: strided, with
    16-byte strides and base addresses, so the bfloat16 kernel takes
    them."""
    from repro_torch.kernels import cuda_kernels as MK
    from repro_torch.kernels.flash_attention import (flash_attention, plain,
                                                     select_kernel)
    B, S, H, KV, D = 2, 300, 28, 4, 128
    gen = torch.Generator(device=card).manual_seed(3)
    q = torch.randn(B, S, H, D, generator=gen, device=card).bfloat16()
    kv = torch.randn(B, S, 2 * KV, D, generator=gen, device=card).bfloat16()
    k, v = kv[:, :, :KV], kv[:, :, KV:]
    assert not k.is_contiguous()
    assert select_kernel(q, k, v) == "flash_fwd_wgmma_kernel"
    before = MK.launch_counts()["flash_attention"]
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert MK.launch_counts()["flash_attention"] == before + 1
    torch.testing.assert_close(got.float(), plain(q, k, v).float(),
                               rtol=2e-2, atol=2e-2)


def test_torch_cuda_flash_attention_refuses_misaligned_bfloat16(card):
    """TMA reads 16-byte aligned bases only: a bfloat16 q two bytes off is
    refused, and nothing is launched."""
    from repro_torch.kernels import cuda_kernels as MK
    from repro_torch.kernels.flash_attention import flash_attention
    B, S, H, D = 1, 64, 4, 64
    flat = torch.randn(B * S * H * D + 1, device=card).bfloat16()
    q = flat[1:].view(B, S, H, D)
    k = torch.randn(B, S, H, D, device=card).bfloat16()
    before = MK.launch_counts()["flash_attention"]
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        flash_attention(q, k, k)
    assert MK.launch_counts()["flash_attention"] == before


# the served rows (Qwen2 3584, Jamba 4096 and its inner norms 256 and 16),
# rows walked twice (8192; 12289 also unaligned), and a scalar row (100)
NORM_SHAPES = [(33, 3584), (4, 3584), (5, 7, 128), (3, 100), (3, 12289),
               (5, 4096), (9, 256), (9, 16), (7, 8192)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", NORM_SHAPES, ids=str)
def test_torch_cuda_rmsnorm_matches_plain_version(card, dtype, shape):
    from repro_torch.kernels import cuda_kernels as MK
    from repro_torch.kernels.rmsnorm import plain, rmsnorm
    gen = torch.Generator(device=card).manual_seed(shape[-1])
    x = (3 * torch.randn(shape, generator=gen, device=card)).to(dtype)
    s = (1 + 0.2 * torch.randn(shape[-1], generator=gen, device=card)
         ).to(dtype)
    before = MK.launch_counts()["rmsnorm"]
    got = rmsnorm(x, s, 1e-5)
    torch.cuda.synchronize()
    assert MK.launch_counts()["rmsnorm"] == before + 1
    want = plain(x, s, 1e-5)
    ulps = 1 if dtype == torch.bfloat16 else 2
    bound = ulps * torch.finfo(dtype).eps * want.float().abs()
    assert bool(((got.float() - want.float()).abs() <= bound).all())
    # and, as expected, the same bits
    assert torch.equal(got, want)


def test_torch_cuda_model_wrappers_refuse_what_the_kernels_do_not_take(card):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    q = torch.randn(1, 8, 2, 48, device=card)
    with pytest.raises(ValueError, match="head dim 48"):
        flash_attention(q, q, q)
    # a (Dqk, Dv) pair that is not built is refused, naming the list
    q = torch.randn(1, 8, 2, 96, device=card)
    with pytest.raises(ValueError, match=r"\(96, 64\), \(192, 128\)"):
        flash_attention(q, q, q)
    q = torch.randn(1, 8, 2, 32, device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        flash_attention(q, q, q)
    x = torch.randn(4, 64, device=card).T
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm(x, torch.ones(4, device=card))


def test_torch_cuda_smoke_generate_matches_torch_backend(card):
    """The serving path on the card with the kernels, float32 smoke
    model: the same greedy tokens as the plain versions."""
    from repro_torch.configs import get_model_config
    from repro_torch.kernels import cuda_kernels as MK
    from repro_torch.launch.serve import generate
    from repro_torch.models.api import build_model
    cfg = get_model_config("qwen2-7b", smoke=True).replace(
        dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    model.init(0)
    prompts = np.random.default_rng(0).integers(0, 512, size=(2, 16))
    MK.reset_launch_counts()
    a, _ = generate(arch="qwen2-7b", prompt_tokens=prompts, model=model,
                    max_new_tokens=6)
    assert MK.launch_counts() == {"flash_attention": cfg.num_layers,
                                  "rmsnorm": (2 * cfg.num_layers + 1) * 7,
                                  "wkv6": 0, "mamba_scan": 0}
    b, _ = generate(arch="qwen2-7b", prompt_tokens=prompts, model=model,
                    max_new_tokens=6, backend="torch")
    assert torch.equal(a, b)


@pytest.mark.parametrize("Dqk,Dv", [(96, 64), (192, 128)])
def test_torch_cuda_flash_wgmma_shared_memory_fits_the_block(card, Dqk, Dv):
    """The bfloat16 kernel's two-stage ring at MLA's head dims: V tiles
    sized by Dv, Q and K by Dqk padded to whole 64-column boxes."""
    from repro_torch.kernels import cuda_kernels as MK
    pad = lambda d: -(-d // 64) * 64
    ring = 128 * pad(Dqk) * 2 * 3 + 2 * 128 * pad(Dv) * 2
    assert MK.flash_wgmma_smem_bytes(Dqk, Dv) == ring + 8 * 9 + 1024
    assert MK.flash_wgmma_smem_bytes(Dqk, Dv) <= 232_448
    assert MK.flash_wgmma_smem_bytes(96, 96) == -1


def test_torch_cuda_smoke_minicpm3_prefill_and_decode_match_torch_backend(
        card):
    """MLA on the card with the kernels: MiniCPM3 at full width cut to 2
    layers, float32, prefill logits within 1e-4 relative of the plain
    versions' and the same greedy tokens through ``generate``; the launch
    counts are K4 once per layer in the prefill, none in a decode step,
    and K5 4 per layer and the final norm in every forward."""
    from repro_torch.configs import get_model_config
    from repro_torch.kernels import cuda_kernels as MK
    from repro_torch.launch.serve import generate
    from repro_torch.models.api import build_model
    cfg = get_model_config("minicpm3-4b").replace(
        num_layers=2, dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    model.init(1)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                size=(2, 96))
    batch = {"tokens": torch.as_tensor(prompts, device=card)}
    with torch.inference_mode():
        lc, _ = model.prefill(batch, 104)
        lt, _ = model.prefill(batch, 104, backend="torch")
    assert float((lc - lt).abs().max() / lt.abs().max()) <= 1e-4
    MK.reset_launch_counts()
    a, _ = generate(arch="minicpm3-4b", prompt_tokens=prompts, model=model,
                    max_new_tokens=8)
    assert MK.launch_counts() == {"flash_attention": 2, "rmsnorm": 9 * 9,
                                  "wkv6": 0, "mamba_scan": 0}
    b, _ = generate(arch="minicpm3-4b", prompt_tokens=prompts, model=model,
                    max_new_tokens=8, backend="torch")
    assert torch.equal(a, b)


def test_torch_cuda_smoke_qwen2vl_vision_prefill_matches_torch_backend(card):
    """M-RoPE and the vision stub on the card with the kernels: Qwen2-VL at
    full width cut to 2 layers, float32, a vision prefill's logits within
    1e-4 relative of the plain versions' and the same greedy tokens after
    it; K4 once per layer in the prefill, none in a decode step, K5 twice
    per layer and the final norm in every forward."""
    from repro_torch.configs import get_model_config
    from repro_torch.kernels import cuda_kernels as MK
    from repro_torch.models.api import build_model
    cfg = get_model_config("qwen2-vl-2b").replace(
        num_layers=2, dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    model.init(1)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                size=(2, 300))
    batch = {"tokens": torch.as_tensor(prompts, device=card),
             **SMOKE.vision_inputs(cfg, prompts, 3)}
    MK.reset_launch_counts()
    lc, a = SMOKE.greedy_after_prefill(model, batch, 6, "cuda")
    assert MK.launch_counts() == {"flash_attention": 2, "rmsnorm": 5 * 7,
                                  "wkv6": 0, "mamba_scan": 0}
    lt, b = SMOKE.greedy_after_prefill(model, batch, 6, "torch")
    assert float((lc - lt).abs().max() / lt.abs().max()) <= 1e-4
    assert torch.equal(a, b)


def test_torch_cuda_smoke_seamless_generate_matches_torch_backend(card):
    """The encoder-decoder on the card with the kernels: SeamlessM4T at
    full width cut to 2 + 2 layers, float32, the same greedy tokens as the
    plain versions through ``generate``; K4 once per encoder layer in the
    encode, twice per decoder layer in the prefill and once per decoder
    layer in a decode step (cross attention at one query row), no K5."""
    from repro_torch.configs import get_model_config
    from repro_torch.kernels import cuda_kernels as MK
    from repro_torch.launch.serve import generate
    from repro_torch.models.api import build_model
    cfg = get_model_config("seamless-m4t-large-v2").replace(
        num_layers=2, num_encoder_layers=2, dtype="float32",
        param_dtype="float32")
    model = build_model(cfg)
    model.init(1)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(2, 40))
    enc = (rng.standard_normal((2, 70, cfg.d_model)) * 0.02
           ).astype(np.float32)
    MK.reset_launch_counts()
    a, _ = generate(arch=cfg.name, prompt_tokens=prompts, model=model,
                    enc_embeds=enc, max_new_tokens=6)
    assert MK.launch_counts() == {"flash_attention": 2 + 4 + 2 * 6,
                                  "rmsnorm": 0, "wkv6": 0, "mamba_scan": 0}
    b, _ = generate(arch=cfg.name, prompt_tokens=prompts, model=model,
                    enc_embeds=enc, max_new_tokens=6, backend="torch")
    assert torch.equal(a, b)


# K6 (the WKV6 recurrence) within 2e-4 of its plain version in float32
# and 2e-2 in bfloat16, y and the final state (tests/test_kernels.py's),
# over chip_smoke.py's cases and inputs
REAL = SMOKE.REAL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SMOKE.WKV_CASES, ids=lambda c: c[0])
def test_torch_cuda_wkv6_matches_plain_version(card, dtype, case):
    from repro_torch.kernels import cuda_kernels as MK
    from repro_torch.kernels.wkv6 import plain, wkv6
    _, shape, with_s0, logw = case
    args = SMOKE.wkv_inputs(shape, with_s0, logw, dtype, seed=shape[1])
    before = MK.launch_counts()["wkv6"]
    y, s = wkv6(*args)
    torch.cuda.synchronize()
    assert MK.launch_counts()["wkv6"] == before + 1
    assert y.dtype == dtype and s.dtype == torch.float32
    y_want, s_want = plain(*args)
    t = 2e-2 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(y.float(), y_want.float(), rtol=t, atol=t)
    # each state element is rounded as the plain version rounds it
    assert torch.equal(s, s_want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,V", [(64, 40), (64, 100), (16, 24), (8, 9)])
def test_torch_cuda_wkv6_splits_v_across_blocks_unevenly(card, dtype, K, V):
    """A block takes 16 state columns: V 40, 100, 24 and 9 leave the last
    block of each (b, h) ragged (or alone and ragged)."""
    from repro_torch.kernels.wkv6 import plain, wkv6
    args = SMOKE.wkv_inputs((2, 50, 3, K, V), True, REAL, dtype, seed=V)
    y, s = wkv6(*args)
    y_want, s_want = plain(*args)
    t = 2e-2 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(y.float(), y_want.float(), rtol=t, atol=t)
    assert torch.equal(s, s_want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_torch_cuda_wkv6_reads_strided_unaligned_views(card, dtype):
    """r, k, w and v as views into wider tensors, offset by one element:
    rows that are not 16-byte aligned take the kernel's scalar loads."""
    from repro_torch.kernels.wkv6 import plain, wkv6
    B, S, H, K, V = 2, 70, 3, 64, 48
    args = list(SMOKE.wkv_inputs((B, S, H, K + 1, V + 3), True, REAL, dtype,
                                 seed=5))
    for i in range(4):
        n = V if i == 2 else K
        args[i] = args[i][..., 1:n + 1]
        assert args[i].stride(-1) == 1 and not args[i].is_contiguous()
    args[4] = args[4][:, :K].contiguous()
    args[5] = args[5][:, :, :K, :V].contiguous()
    y, s = wkv6(*args)
    y_want, s_want = plain(*args)
    t = 2e-2 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(y.float(), y_want.float(), rtol=t, atol=t)
    assert torch.equal(s, s_want)


def test_torch_cuda_wkv6_wrapper_refuses_what_the_kernel_does_not_take(card):
    from repro_torch.kernels import cuda_kernels as MK
    from repro_torch.kernels.wkv6 import wkv6
    before = MK.launch_counts()["wkv6"]
    r, k, v, w, u, s0 = SMOKE.wkv_inputs((1, 8, 2, 48, 48), True,
                                         (-1.0, -0.1), torch.float32, seed=0)
    with pytest.raises(ValueError, match="key dim K = 48"):
        wkv6(r, k, v, w, u, s0)
    r, k, v, w, u, s0 = SMOKE.wkv_inputs((1, 8, 2, 32, 32), True,
                                         (-1.0, -0.1), torch.float32, seed=0)
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        wkv6(r.half(), k.half(), v.half(), w.half(), u, s0)
    with pytest.raises(ValueError, match="u must be torch.float32"):
        wkv6(r, k, v, w, u.bfloat16(), s0)
    with pytest.raises(ValueError, match="last dimension must be contiguous"):
        wkv6(r.transpose(2, 3).contiguous().transpose(2, 3), k, v, w, u, s0)
    with pytest.raises(ValueError, match="s0 must be a contiguous"):
        wkv6(r, k, v, w, u, s0.transpose(2, 3))
    with pytest.raises(ValueError, match="value dim V = 1025"):
        wkv6(r, k, torch.zeros(1, 8, 2, 1025, device=card), w, u)
    assert MK.launch_counts()["wkv6"] == before


def test_torch_cuda_smoke_rwkv_generate_matches_torch_backend(card):
    """The RWKV-6 serving path on the card with K6, float32 smoke model:
    one K6 launch per layer in the prefill, none in the decode steps, and
    the same greedy tokens as the plain versions."""
    from repro_torch.configs import get_model_config
    from repro_torch.kernels import cuda_kernels as MK
    from repro_torch.launch.serve import generate
    from repro_torch.models.api import build_model
    cfg = get_model_config("rwkv6-3b", smoke=True).replace(
        dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    model.init(0)
    prompts = np.random.default_rng(0).integers(0, 512, size=(2, 40))
    MK.reset_launch_counts()
    a, _ = generate(arch="rwkv6-3b", prompt_tokens=prompts, model=model,
                    max_new_tokens=6)
    assert MK.launch_counts() == {"flash_attention": 0, "rmsnorm": 0,
                                  "wkv6": cfg.num_layers, "mamba_scan": 0}
    b, _ = generate(arch="rwkv6-3b", prompt_tokens=prompts, model=model,
                    max_new_tokens=6, backend="torch")
    assert torch.equal(a, b)


# K7 (the Mamba selective scan) within 2e-4 of its plain version in
# float32 and 2e-2 in bfloat16, y and the final state
# (tests/test_kernels.py's), over chip_smoke.py's cases and inputs (S at
# the kernel's chunk's edges among them); the final state bit-identical


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SMOKE.MAMBA_CASES, ids=lambda c: c[0])
def test_torch_cuda_mamba_scan_matches_plain_version(card, dtype, case):
    from repro_torch.kernels import cuda_kernels as MK
    from repro_torch.kernels.mamba_scan import mamba_scan, plain
    _, shape, h0, dt_range = case
    args = SMOKE.mamba_inputs(shape, h0, dt_range, dtype, seed=shape[1])
    before = MK.launch_counts()["mamba_scan"]
    y, h = mamba_scan(*args)
    torch.cuda.synchronize()
    assert MK.launch_counts()["mamba_scan"] == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    y_want, h_want = plain(*args)
    t = 2e-2 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(y.float(), y_want.float(), rtol=t, atol=t)
    torch.testing.assert_close(h, h_want, rtol=t, atol=t)
    assert torch.equal(h, h_want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_torch_cuda_mamba_scan_reads_strided_views(card, dtype):
    """x, dt, B and C as views into wider tensors (the slices of a
    projection), offset by one element, so that no row of x or dt is
    16-byte aligned (the element-by-element copies); Din not a multiple of
    the block. The same bits as the call on contiguous (aligned) copies."""
    from repro_torch.kernels.mamba_scan import mamba_scan, plain
    B, S, Din, N = 2, 70, 200, 16
    x, dt, A, Bm, C, D, h0 = SMOKE.mamba_inputs((B, S, Din + 3, N + 1),
                                                "given", None, dtype, seed=5)
    x, dt = x[..., 1:Din + 1], dt[..., 1:Din + 1]
    Bm, C = Bm[..., 1:], C[..., 1:]
    A, D = A[:Din, :N].contiguous(), D[:Din].contiguous()
    h0 = h0[:, :Din, :N].contiguous()
    for t in (x, dt, Bm, C):
        assert t.stride(-1) == 1 and not t.is_contiguous()
    y, h = mamba_scan(x, dt, A, Bm, C, D, h0)
    y_want, h_want = plain(x, dt, A, Bm, C, D, h0)
    t = 2e-2 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(y.float(), y_want.float(), rtol=t, atol=t)
    torch.testing.assert_close(h, h_want, rtol=t, atol=t)
    assert x.data_ptr() % 16 != 0 and (x.stride(1) * x.element_size()) % 16
    y_al, h_al = mamba_scan(*(v.contiguous() for v in (x, dt, A, Bm, C, D,
                                                       h0)))
    assert torch.equal(y, y_al) and torch.equal(h, h_al)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_torch_cuda_mamba_scan_reads_aligned_strided_views(card, dtype):
    """x and dt as 16-byte aligned slices of wider rows (the cp.async
    copies through strides, as the Jamba mixer's projection slices would
    be): the same bits as the call on contiguous copies, and the plain
    version's final state."""
    from repro_torch.kernels.mamba_scan import mamba_scan, plain
    B, S, Din, N = 2, 70, 1000, 16
    x, dt, A, Bm, C, D, h0 = SMOKE.mamba_inputs((B, S, 2 * Din + 16, N),
                                                "given", None, dtype, seed=6)
    x, dt = x[..., 16:16 + Din], dt[..., Din + 16:]
    A, D = A[:Din].contiguous(), D[:Din].contiguous()
    h0 = h0[:, :Din].contiguous()
    for v in (x, dt):
        assert v.data_ptr() % 16 == 0 and not v.is_contiguous()
        assert (v.stride(1) * v.element_size()) % 16 == 0
    y, h = mamba_scan(x, dt, A, Bm, C, D, h0)
    y_al, h_al = mamba_scan(x.contiguous(), dt.contiguous(), A, Bm, C, D, h0)
    assert torch.equal(y, y_al) and torch.equal(h, h_al)
    assert torch.equal(h, plain(x, dt, A, Bm, C, D, h0)[1])


def test_torch_cuda_mamba_scan_wrapper_refuses_what_the_kernel_does_not_take(
        card):
    from repro_torch.kernels import cuda_kernels as MK
    from repro_torch.kernels.mamba_scan import mamba_scan
    before = MK.launch_counts()["mamba_scan"]
    x, dt, A, Bm, C, D, h0 = SMOKE.mamba_inputs((1, 8, 64, 4), "given", None,
                                                torch.float32, seed=0)
    with pytest.raises(ValueError, match="state dim N = 4"):
        mamba_scan(x, dt, A, Bm, C, D, h0)
    x, dt, A, Bm, C, D, h0 = SMOKE.mamba_inputs((1, 8, 64, 8), "given", None,
                                                torch.float32, seed=0)
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        mamba_scan(x.half(), dt.half(), A, Bm.half(), C.half(), D, h0)
    with pytest.raises(ValueError, match="A must be torch.float32"):
        mamba_scan(x, dt, A.bfloat16(), Bm, C, D, h0)
    with pytest.raises(ValueError, match="last dimension must be contiguous"):
        mamba_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, Bm,
                   C, D, h0)
    with pytest.raises(ValueError, match="h0 must be a contiguous"):
        mamba_scan(x, dt, A, Bm, C, D, h0.transpose(1, 2))
    assert MK.launch_counts()["mamba_scan"] == before


def test_torch_cuda_smoke_jamba_generate_matches_torch_backend(card):
    """The Jamba serving path on the card with K4, K5 and K7, float32 smoke
    model at the full model's layout (8 layers, attention on layer 4):
    one K7 launch per Mamba layer and one K4 launch per attention layer in
    the prefill, none of either in the decode steps, and the same greedy
    tokens as the plain versions."""
    from repro_torch.configs import get_model_config
    from repro_torch.kernels import cuda_kernels as MK
    from repro_torch.launch.serve import generate
    from repro_torch.models.api import build_model
    cfg = get_model_config("jamba-v0.1-52b", smoke=True).replace(
        dtype="float32", param_dtype="float32", num_layers=8, attn_period=8,
        attn_offset=4)
    model = build_model(cfg)
    model.init(0)
    prompts = np.random.default_rng(0).integers(0, 512, size=(2, 40))
    MK.reset_launch_counts()
    a, _ = generate(arch="jamba-v0.1-52b", prompt_tokens=prompts,
                    model=model, max_new_tokens=6)
    per = SMOKE.expected_launches(cfg, "jamba-v0.1-52b")
    per_prefill, per_step = per["prefill"], per["decode_step"]
    assert per_prefill["flash_attention"] == 1
    assert per_prefill["mamba_scan"] == 7
    assert MK.launch_counts() == {k: per_prefill[k] + 6 * per_step[k]
                                  for k in per_prefill}
    b, _ = generate(arch="jamba-v0.1-52b", prompt_tokens=prompts,
                    model=model, max_new_tokens=6, backend="torch")
    assert torch.equal(a, b)


def test_torch_cuda_smoke_builds_twice_in_one_checkout(card, capsys):
    """``chip_smoke.build_all`` on libraries that are already built (a
    second run, or a run after these tests) loads them and still reports
    their registers."""
    import json
    for _ in range(2):
        SMOKE.build_all()
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    builds = [ln["model_build"] for ln in lines if "model_build" in ln]
    assert len(builds) == 2 and builds[1]["cached"]
    for b in builds:
        assert b["max_registers"] > 0 and b["spill_bytes"] is not None


# ---------------------------------------------------------------------------
# training: K4's and K5's autograd Functions, and train() on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", SMOKE.TRAIN_ATTN_CASES,
                         ids=lambda c: f"{c[0]} {c[2]}")
def test_torch_cuda_attention_function_gradients_match_torch(card, case):
    """ops.attention on "cuda" (K4 forward, chunked backward) against
    "torch": the output and dq, dk, dv (v's on the fused tensor it is a
    slice of) within 2e-2 (bf16) / 1e-4 (f32) of the largest value."""
    from repro_torch.kernels import cuda_kernels as MK
    from repro_torch.kernels import ops
    label, (B, Sq, Sk, H, KV, Dqk, Dv), dtype, v_dn = case
    g = torch.Generator(device=card).manual_seed(3)
    mk = lambda *s: torch.randn(*s, generator=g, device=card).to(dtype)
    q, k, vb, go = mk(B, Sq, H, Dqk), mk(B, Sk, KV, Dqk), \
        mk(B, Sk, KV, v_dn + Dv), mk(B, Sq, H, Dv)
    got = {}
    for be in ("cuda", "torch"):
        leaves = [t.detach().requires_grad_() for t in (q, k, vb)]
        before = MK.launch_counts()["flash_attention"]
        out = ops.attention(leaves[0], leaves[1], leaves[2][..., v_dn:],
                            scale=Dqk ** -0.5, backend=be)
        out.backward(go)
        torch.cuda.synchronize()
        assert MK.launch_counts()["flash_attention"] == \
            before + (be == "cuda")
        got[be] = [out.detach()] + [t.grad for t in leaves]
    tol = SMOKE.TRAIN_TOL[dtype]
    for a, b in zip(got["cuda"], got["torch"]):
        assert SMOKE.rel_err(a, b) <= tol


@pytest.mark.parametrize("case", SMOKE.TRAIN_NORM_CASES,
                         ids=lambda c: f"{c[0]} {c[2]}")
def test_torch_cuda_rmsnorm_function_gradients_match_torch(card, case):
    from repro_torch.kernels import ops
    label, shape, dtype = case
    g = torch.Generator(device=card).manual_seed(4)
    x = (3 * torch.randn(*shape, generator=g, device=card)).to(dtype)
    s = (1 + 0.2 * torch.randn(shape[-1], generator=g, device=card)).to(dtype)
    go = torch.randn(*shape, generator=g, device=card).to(dtype)
    got = {}
    for be in ("cuda", "torch"):
        xl, sl = x.detach().requires_grad_(), s.detach().requires_grad_()
        out = ops.rmsnorm(xl, sl, 1e-5, backend=be)
        out.backward(go)
        got[be] = [out.detach(), xl.grad, sl.grad]
    for a, b in zip(got["cuda"], got["torch"]):
        assert SMOKE.rel_err(a, b) <= SMOKE.TRAIN_TOL[dtype]


@pytest.mark.parametrize(
    "kind,case", [("wkv6", c) for c in SMOKE.TRAIN_WKV_CASES]
    + [("mamba_scan", c) for c in SMOKE.TRAIN_MAMBA_CASES],
    ids=lambda c: c if isinstance(c, str) else f"{c[0]} {c[2]}")
def test_torch_cuda_scan_function_gradients_match_torch(card, kind, case):
    """ops.wkv6 / ops.mamba_scan on "cuda" (K6 / K7 forward, the chunked
    scan backward) against "torch": y, the final state and every input's
    gradient within 2e-2 (bf16) / 1e-4 (f32) of the largest value, the
    state's cotangent None as in training; the gradients are the same
    function of the same inputs on both backends."""
    from repro_torch.kernels import ops
    label, shape, dtype, rng = case
    if kind == "wkv6":
        r, k, v, w, u, _ = SMOKE.wkv_inputs(shape, False, rng, dtype,
                                            seed=5)
        leaves, fn = (r, k, v, w, u), ops.wkv6
        go, grad_fn = torch.randn(*v.shape, device=card).to(dtype), \
            "_WKV6Backward"
    else:
        leaves = SMOKE.mamba_inputs(shape, None, rng, dtype, seed=6)[:6]
        fn, grad_fn = ops.mamba_scan, "_MambaScanBackward"
        go = torch.randn(*leaves[0].shape, device=card).to(dtype)
    row = SMOKE.function_check(kind, label, shape, dtype, grad_fn,
                               lambda ls, be: fn(*ls, backend=be), leaves,
                               (go, None))
    assert row["ok"], row
    assert row["grads_bit_identical"], row


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_torch_cuda_smoke_ssm_train_matches_torch_backend(card, arch):
    """Two steps of train() on the card through K6 / K7 (and K4, K5 for
    Jamba) against the plain versions, the same float32 smoke weights:
    the losses within 1e-5 relative, and the kernels launched as
    chip_smoke.py holds them."""
    from repro_torch.configs import get_model_config
    from repro_torch.kernels import cuda_kernels as MK
    from repro_torch.launch.train import train
    from repro_torch.models.api import build_model
    cfg = get_model_config(arch, smoke=True).replace(
        dtype="float32", param_dtype="float32", remat="dots")
    losses = {}
    for be in ("cuda", "torch"):
        model = build_model(cfg)
        model.init(0)
        MK.reset_launch_counts()
        res = train(arch=arch, model=model, steps=2, seq_len=64,
                    global_batch=2, log_every=0, backend=be)
        losses[be] = res.losses
        if be == "cuda":
            want = SMOKE.expected_train_launches(cfg)
            assert MK.launch_counts() == {k: 2 * v for k, v in want.items()}
    np.testing.assert_allclose(losses["cuda"], losses["torch"], rtol=1e-5)


def test_torch_cuda_smoke_train_matches_torch_backend(card):
    """Two steps of train() on the card through the kernels against the
    plain versions, the same float32 smoke weights: the losses within
    1e-5 relative, and K4 and K5 launched as chip_smoke.py holds them."""
    from repro_torch.configs import get_model_config
    from repro_torch.kernels import cuda_kernels as MK
    from repro_torch.launch.train import train
    from repro_torch.models.api import build_model
    cfg = get_model_config("qwen2-7b", smoke=True).replace(
        dtype="float32", param_dtype="float32", remat="dots")
    losses = {}
    for be in ("cuda", "torch"):
        model = build_model(cfg)
        model.init(0)
        MK.reset_launch_counts()
        res = train(arch="qwen2-7b", model=model, steps=2, seq_len=64,
                    global_batch=2, log_every=0, backend=be)
        losses[be] = res.losses
        if be == "cuda":
            want = SMOKE.expected_train_launches(cfg)
            assert MK.launch_counts() == {k: 2 * v for k, v in want.items()}
    np.testing.assert_allclose(losses["cuda"], losses["torch"], rtol=1e-5)


def test_torch_cuda_checkpoint_round_trip_of_card_tensors(card, tmp_path):
    """CUDA leaves (bf16, float32, int32, a stacked pair) snapshot into
    pinned host memory, are isolated from later in-place writes, and
    restore in place on the card bit for bit."""
    from repro_torch.ckpt import CheckpointManager, Stacked
    g = torch.Generator(device=card).manual_seed(0)
    tree = {"w": torch.randn(33, 7, generator=g, device=card).to(
                torch.bfloat16),
            "s": Stacked([torch.randn(5, generator=g, device=card)
                          for _ in range(2)]),
            "n": torch.full((), 7, dtype=torch.int32, device=card)}
    want = {"w": tree["w"].clone(), "s": [t.clone() for t in tree["s"]],
            "n": tree["n"].clone()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    tree["w"].add_(1)
    for t in tree["s"]:
        t.add_(1)
    mgr.wait()
    got, _ = mgr.restore(1, tree)
    assert got["w"] is tree["w"] and got["w"].is_cuda
    assert torch.equal(tree["w"], want["w"])
    assert all(torch.equal(a, b) for a, b in zip(tree["s"], want["s"]))
    assert torch.equal(tree["n"], want["n"])
    assert mgr.last_save["bytes"] == 33 * 7 * 2 + 2 * 5 * 4 + 4


def test_torch_cuda_smoke_train_resume_is_bit_identical(card, tmp_path):
    """On the card, through the kernels: 3 steps, a save and a resume to 6
    against 6 straight, the smoke Qwen2 in bf16; bit for bit where two
    straight runs agree bit for bit."""
    from repro_torch.configs import OptimizerConfig, get_model_config
    from repro_torch.launch.train import train
    from repro_torch.models.api import build_model
    cfg = get_model_config("qwen2-7b", smoke=True)
    ocfg = OptimizerConfig(warmup_steps=2, total_steps=10)

    def run(steps, **kw):
        m = build_model(cfg)
        m.init(0)
        res = train(arch="qwen2-7b", model=m, steps=steps, seq_len=64,
                    global_batch=2, log_every=0, opt_cfg=ocfg, **kw)
        return m, res.losses

    a, la = run(6)
    a2, la2 = run(6)
    _, lb = run(3, ckpt_dir=str(tmp_path), ckpt_every=3)
    c, lc = run(6, ckpt_dir=str(tmp_path), resume=True)
    same = la == la2 and all(torch.equal(p, q) for p, q in zip(
        a.params.parameters(), a2.params.parameters()))
    if same:
        assert lb + lc == la
        assert all(torch.equal(p, q) for p, q in zip(
            a.params.parameters(), c.params.parameters()))
    else:
        np.testing.assert_allclose(lb + lc, la, rtol=1e-2)


def test_torch_cuda_world1_nccl_mesh_step_is_the_plain_step(card, tmp_path):
    """An NCCL group of world size 1 and a (data 1, model 1) mesh, ZeRO-1
    on: three steps of train(mesh=) give the bits of three steps with no
    mesh."""
    import socket
    import torch.distributed as dist
    from repro_torch.configs import OptimizerConfig, get_model_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.train import train
    from repro_torch.models.api import build_model
    cfg = get_model_config("qwen2-7b", smoke=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        mesh = mesh_lib.make_local_mesh()
        out = []
        for m in (None, mesh):
            model = build_model(cfg)
            model.init(0)
            res = train(arch="qwen2-7b", model=model, steps=3, seq_len=64,
                        global_batch=2, log_every=0, mesh=m,
                        opt_cfg=OptimizerConfig(warmup_steps=1,
                                                total_steps=4))
            out.append((model, res.losses))
        assert out[0][1] == out[1][1]
        assert all(torch.equal(p, q) for p, q in zip(
            out[0][0].params.parameters(), out[1][0].params.parameters()))
    finally:
        dist.destroy_process_group()


_TP_CHILD = r'''
import sys, torch, torch.distributed as dist
from repro_torch.configs import get_model_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.api import build_model
rank, rdv, dtype, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=2,
                        rank=rank)
try:
    mesh = mesh_lib.make_local_mesh(2, device_type="cuda")
    cfg = get_model_config("qwen2-7b", smoke=True).replace(
        dtype=dtype, param_dtype=dtype)
    model = build_model(cfg, mesh=mesh)
    model.init(0)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 64), generator=g).cuda()
    with torch.inference_mode():
        mesh_lib.reset_collective_counts()
        logits, _ = model.prefill({"tokens": tokens}, 72)
        counts = mesh_lib.collective_counts()
    if rank == 0:
        torch.save({"logits": logits.float().cpu(), "counts": counts}, out)
finally:
    dist.destroy_process_group()
'''


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_cuda_smoke_tp_prefill_in_two_processes(card, tmp_path, dtype):
    """The smoke Qwen2's prefill over a (data 1, model 2) mesh of two
    processes sharing the card (gloo; K4 and K5 on the card at a rank's
    heads) against one process on the card: float32 within 1e-4 of the
    largest logit and the first tokens equal, bfloat16 within 2e-2; one
    all-reduce for the embedding, two a layer, one all-gather."""
    import os
    import subprocess
    import sys
    from repro_torch.configs import get_model_config
    from repro_torch.models.api import build_model
    out = tmp_path / "out.pt"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(p) for p in sys.path if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TP_CHILD, str(r), str(tmp_path / "rdv"),
         dtype, str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs[0][-3000:]
    got = torch.load(out)
    cfg = get_model_config("qwen2-7b", smoke=True).replace(
        dtype=dtype, param_dtype=dtype)
    model = build_model(cfg)
    model.init(0)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 64), generator=g).cuda()
    with torch.inference_mode():
        want, _ = model.prefill({"tokens": tokens}, 72)
    want = want.float().cpu()
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert (got["logits"] - want).abs().max() <= tol * want.abs().max()
    if dtype == "float32":
        assert torch.equal(got["logits"].argmax(-1), want.argmax(-1))
    L = cfg.num_layers
    assert got["counts"] == {"all_reduce": 1 + 2 * L, "all_gather": 1}
