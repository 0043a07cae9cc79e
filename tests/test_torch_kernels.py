"""The port's plain PyTorch kernels against the Python reference loops and
against the JAX package's ``jnp`` and ``pallas`` (interpret mode) kernels.

Everything runs on the CPU (``device="cpu"``) in float64 unless a test
says otherwise; inputs are made from a seed with numpy and handed to both
packages. Tolerances, per kernel (``EQUIVALENCE_TIERS``):

  * allocators (``maxmin``/``wfq``/``strict_priority``): **bit-identical**
    to the Python loops and to both JAX backends — same operation
    sequence, stable sort, left-to-right sums;
  * ``segment_overlap``: bit-identical to the JAX kernels (same
    left-to-right accumulation);
  * ``bank_decide`` / ``pacing_decide``: within 4 ULPs of the JAX kernel
    and of the Python ``PacingBank`` (the ``ulp`` tier; observed 0);
  * ``drr_shares`` / ``offered_share`` (plain versions only, off the
    batched runner's path): **bit-identical** to the Python loops and to
    the JAX ``jnp`` kernels under float64.
"""
import jax
import numpy as np
import pytest
import torch

from repro.fabric.backend import get_kernel as jax_kernel
from repro.fabric.backend import jnp_kernels as JK
from repro_torch.configs.base import PacingConfig
from repro_torch.core.pacing import PacingBank
from repro_torch.fabric import congestion as ref
from repro_torch.fabric.backend import (BACKENDS, CUDA_KERNELS,
                                        EQUIVALENCE_TIERS, KERNELS,
                                        TORCH_KERNELS, BackendError,
                                        KernelType, available_backends,
                                        get_kernel, register_kernel)
from repro_torch.fabric.backend import torch_kernels as TK

F64 = torch.float64
ALLOCATORS = ("maxmin_shares", "wfq_shares", "strict_priority_shares")


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _cases(seed, rows, n):
    """Demands with ties, zeros and saturating flows; non-integer weights;
    capacities including 0."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 1.0, size=(rows, n))
    d[rng.uniform(size=d.shape) < 0.2] = 0.0
    d[rng.uniform(size=d.shape) < 0.2] = 1.0
    if n > 1:
        d[::3, 1] = d[::3, 0]                       # ties
    w = rng.uniform(0.25, 4.0, size=(rows, n))
    cap = rng.uniform(0.0, 2.0, size=rows)
    cap[::7] = 0.0
    pr = rng.integers(0, 3, size=n)
    return d, w, cap, pr


def _extra(name, w, pr):
    if name == "wfq_shares":
        return (w,)
    if name == "strict_priority_shares":
        return (pr,)
    return ()


def _ref_rows(name, d, w, cap, pr):
    fn = getattr(ref, name)
    out = []
    for r in range(d.shape[0]):
        extra = (list(w[r]),) if name == "wfq_shares" else \
            (list(pr),) if name == "strict_priority_shares" else ()
        out.append(fn(list(d[r]), *extra, float(cap[r])))
    return np.array(out, dtype=np.float64).reshape(d.shape)


# -- the registry -----------------------------------------------------------


def test_torch_registry_catalogue_matches_jax_package():
    from repro.fabric import backend as jb
    assert KERNELS == jb.KERNELS
    assert EQUIVALENCE_TIERS == jb.EQUIVALENCE_TIERS
    assert BACKENDS == ("reference", "torch", "cuda")
    assert set(CUDA_KERNELS) <= set(TORCH_KERNELS) <= set(KERNELS)


def test_torch_registry_parse_and_errors():
    assert KernelType.parse("CUDA") is KernelType.CUDA
    assert KernelType.parse(None) is KernelType.REFERENCE
    with pytest.raises(BackendError, match="unknown backend 'pallas'"):
        KernelType.parse("pallas")
    with pytest.raises(BackendError, match="unknown kernel"):
        get_kernel("nope", "torch")
    with pytest.raises(ValueError, match="already registered"):
        get_kernel("maxmin_shares", "torch")
        register_kernel("maxmin_shares", KernelType.TORCH, lambda: None)
    # drr / offered have plain versions and no CUDA kernel; the error
    # names the nearest backend that has them
    for name in ("drr_shares", "offered_share"):
        with pytest.raises(BackendError,
                           match="nearest supported backend: 'torch'"):
            get_kernel(name, "cuda")
    with pytest.raises(BackendError,
                       match="nearest supported backend: 'torch'"):
        get_kernel("pacing_decide", "cuda")


@pytest.mark.parametrize("name", KERNELS)
def test_torch_registry_every_kernel_has_its_declared_backends(name):
    want = {"reference"}
    if name in TORCH_KERNELS:
        want.add("torch")
    if name in CUDA_KERNELS:
        want.add("cuda")
    assert set(available_backends(name)) == want


# -- allocators: bit-identical ------------------------------------------------


@pytest.mark.parametrize("n", [1, 4, 5, 8])
@pytest.mark.parametrize("name", ALLOCATORS)
def test_torch_allocators_bit_identical_to_python_reference(name, n):
    d, w, cap, pr = _cases(11 + n, 60, n)
    got = get_kernel(name, "torch")(
        _t(d), *[_t(x) if name == "wfq_shares" else x
                 for x in _extra(name, w, pr)], _t(cap)).numpy()
    assert got.dtype == np.float64
    assert np.array_equal(got, _ref_rows(name, d, w, cap, pr))


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("name", ALLOCATORS)
def test_torch_allocators_bit_identical_to_jax_kernels(name, backend):
    d, w, cap, pr = _cases(5, 37, 6)           # ragged row count
    extra = _extra(name, w, pr)
    got = get_kernel(name, "torch")(
        _t(d), *[_t(x) if name == "wfq_shares" else x for x in extra],
        _t(cap)).numpy()
    with jax.enable_x64(True):
        want = np.asarray(jax_kernel(name, backend)(d, *extra, cap))
    assert want.dtype == np.float64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ALLOCATORS)
def test_torch_allocators_batch_dims_and_float32(name):
    d, w, cap, pr = _cases(3, 24, 4)
    extra = [_t(x) if name == "wfq_shares" else x
             for x in _extra(name, w, pr)]
    fn = get_kernel(name, "torch")
    flat = fn(_t(d), *extra, _t(cap))
    extra3 = [x.reshape(4, 6, 4) if isinstance(x, torch.Tensor) else x
              for x in extra]
    assert torch.equal(
        fn(_t(d).reshape(4, 6, 4), *extra3, _t(cap).reshape(4, 6)),
        flat.reshape(4, 6, 4))
    # float32 (the production dtype): arrays are placed by dtype=/device=
    f32 = fn(d, *_extra(name, w, pr), cap, device="cpu")
    assert f32.dtype == torch.float32 and f32.device.type == "cpu"
    # float32 against the JAX package in its default float32: same
    # operation sequence, so the same bits
    want = np.asarray(jax_kernel(name, "jnp")(d, *_extra(name, w, pr), cap))
    assert want.dtype == np.float32
    assert np.array_equal(f32.numpy(), want)


def test_torch_wfq_weight_broadcast_per_variant():
    """The runner's layout: one weight vector per variant against that
    variant's links."""
    d, w, _, _ = _cases(9, 12, 4)
    d3 = _t(d).reshape(3, 4, 4)
    wv = _t(w[:3]).reshape(3, 1, 4)
    got = TK.wfq_shares(d3, wv)
    for v in range(3):
        for l in range(4):
            want = ref.wfq_shares(list(d3[v, l].numpy()), list(w[v]), 1.0)
            assert got[v, l].tolist() == want


def test_torch_maxmin_zero_demand_padding_is_exact():
    rng = np.random.default_rng(2)
    d = rng.uniform(0.0, 0.6, size=(40, 3))
    padded = np.concatenate([d, np.zeros((40, 5))], axis=1)
    perm = rng.permutation(8)
    out = TK.maxmin_shares(_t(padded[:, perm]), 1.0)
    inv = np.argsort(perm)
    assert torch.equal(out[:, inv][:, :3], TK.maxmin_shares(_t(d), 1.0))
    assert torch.equal(out[:, inv][:, 3:], torch.zeros(40, 5, dtype=F64))


@pytest.mark.parametrize("name", ALLOCATORS)
def test_torch_allocators_empty_flow_axis(name):
    extra = {"maxmin_shares": (), "wfq_shares": (torch.zeros(3, 0, dtype=F64),),
             "strict_priority_shares": (np.zeros(0),)}[name]
    out = get_kernel(name, "torch")(torch.zeros(3, 0, dtype=F64), *extra)
    assert out.shape == (3, 0) and out.dtype == F64


@pytest.mark.parametrize("name", ALLOCATORS)
def test_torch_allocators_rejection_texts_match_reference(name):
    extra = {"maxmin_shares": (), "wfq_shares": ([1.0, 1.0],),
             "strict_priority_shares": ([0, 1],)}[name]
    rfn = getattr(ref, name)
    tfn = get_kernel(name, "torch")
    for d, cap in (([0.5, float("nan")], 1.0), ([0.5, -0.25], 1.0),
                   ([0.5, 0.5], -1.0), ([0.5, 0.5], float("nan"))):
        with pytest.raises(ValueError) as want:
            rfn(d, *extra, cap)
        with pytest.raises(ValueError) as got:
            tfn(_t(d), *extra, cap)
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError) as got:     # array-likes too
            tfn(d, *extra, cap, device="cpu")
        assert str(got.value) == str(want.value)


def test_torch_strict_priority_needs_concrete_matching_priorities():
    with pytest.raises(ValueError, match="3 demands but 2 priorities"):
        TK.strict_priority_shares(_t([0.1, 0.2, 0.3]), [1, 0])


def test_torch_kernels_reject_integer_tensors_and_odd_dtypes():
    with pytest.raises(ValueError, match="float32 or torch.float64 tensor"):
        TK.maxmin_shares(torch.ones(2, 3, dtype=torch.int64))
    with pytest.raises(ValueError, match="dtype must be"):
        TK.maxmin_shares([0.5, 0.5], dtype=torch.float16, device="cpu")


# -- segment overlap ----------------------------------------------------------


def _segments(seed, rows, S):
    rng = np.random.default_rng(seed)
    starts = rng.uniform(0.0, 10.0, size=(rows, S))
    ends = starts + rng.uniform(0.0, 3.0, size=(rows, S))
    ends[rng.uniform(size=ends.shape) < 0.3] = -np.inf     # empty slots
    s_i = rng.uniform(0.0, 10.0, size=rows)
    e_i = s_i + rng.uniform(0.0, 4.0, size=rows)
    return s_i, e_i, starts, ends


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_torch_segment_overlap_bit_identical_to_jax_kernels(backend):
    s_i, e_i, starts, ends = _segments(4, 21, 64)
    got = TK.segment_overlap(_t(s_i), _t(e_i), _t(starts), _t(ends)).numpy()
    with jax.enable_x64(True):
        want = np.asarray(jax_kernel("segment_overlap", backend)(
            s_i, e_i, starts, ends))
    assert np.array_equal(got, want)
    # and the definition, accumulated left to right in Python
    for r in range(21):
        tot = 0.0
        for k in range(64):
            ov = min(e_i[r], ends[r, k]) - max(s_i[r], starts[r, k])
            tot += ov if ov > 0.0 else 0.0
        assert got[r] == tot


def test_torch_segment_overlap_window_broadcast_and_empty():
    s_i, e_i, starts, ends = _segments(6, 12, 8)
    full = TK.segment_overlap(_t(s_i), _t(e_i), _t(starts), _t(ends))
    # one window per group of rows, the runner's (V, 1) against (V, K, S)
    s3, e3 = _t(starts).reshape(4, 3, 8), _t(ends).reshape(4, 3, 8)
    win_s, win_e = _t(s_i[::3]).reshape(4, 1), _t(e_i[::3]).reshape(4, 1)
    got = TK.segment_overlap(win_s, win_e, s3, e3)
    want = TK.segment_overlap(win_s.expand(4, 3).reshape(12),
                              win_e.expand(4, 3).reshape(12),
                              _t(starts), _t(ends))
    assert torch.equal(got.reshape(12), want)
    assert full.shape == (12,)
    assert torch.equal(
        TK.segment_overlap(_t(s_i), _t(e_i), torch.zeros(12, 0, dtype=F64),
                           torch.zeros(12, 0, dtype=F64)),
        torch.zeros(12, dtype=F64))


def _store(seed, V, J, S, n_filled):
    """A ``(V, J, S)`` busy-segment store as the runner holds it at step
    ``n_filled`` (slots ``[0, n_filled)`` written, the rest empty: start
    0, end -inf), and the step's ``(V, J)`` windows."""
    rng = np.random.default_rng(seed)
    starts = rng.uniform(0.0, 10.0, size=(V, J, S))
    ends = starts + rng.uniform(0.0, 3.0, size=(V, J, S))
    ends[rng.uniform(size=ends.shape) < 0.2] = -np.inf
    starts[:, :, n_filled:] = 0.0
    ends[:, :, n_filled:] = -np.inf
    win_s = rng.uniform(0.0, 10.0, size=(V, J))
    win_e = win_s + rng.uniform(0.0, 4.0, size=(V, J))
    return win_s, win_e, starts, ends


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("n_filled", [0, 1, 37, 64])
def test_torch_segment_overlap_reads_the_store_in_place(dtype, n_filled):
    """``n_filled`` and the co-tenant index ``co`` against the runner's
    former call on the gathered store (every slot, the empty ones adding
    ``+0.0``): bit-identical, with the window a strided column of the
    ``(V, J)`` windows; ``co`` as int32, int64 or a list."""
    V, J, S = 10, 4, 64
    ws, we, starts, ends = (torch.as_tensor(a).to(dtype)
                            for a in _store(n_filled, V, J, S, n_filled))
    for owner in range(J):
        co = [k for k in range(J) if k != owner]
        s_w, e_w = ws[:, owner:owner + 1], we[:, owner:owner + 1]
        want = TK.segment_overlap(s_w, e_w, starts[:, co], ends[:, co])
        assert want.shape == (V, J - 1) and want.dtype == dtype
        for idx in (torch.tensor(co, dtype=torch.int32), torch.tensor(co),
                    co):
            got = TK.segment_overlap(s_w, e_w, starts, ends,
                                     n_filled=n_filled, co=idx)
            assert torch.equal(got, want)
    # without co the rows are the store's own; n_filled alone
    rows_s, rows_e = starts[:, 0], ends[:, 0]
    got = TK.segment_overlap(ws[:, 0], we[:, 0], rows_s, rows_e,
                             n_filled=n_filled)
    assert torch.equal(got, TK.segment_overlap(ws[:, 0], we[:, 0], rows_s,
                                               rows_e))


@pytest.mark.parametrize("n_filled", [0, 1, 37, 64])
def test_torch_segment_overlap_in_place_matches_jax_pallas_and_python(
        n_filled):
    """float64: the store read in place, cut to ``n_filled`` slots, against
    the JAX package's Pallas kernel (interpret mode) on the gathered full
    store, and against the definition summed left to right in Python over
    the filled slots."""
    V, J, S = 6, 4, 64
    ws, we, starts, ends = _store(100 + n_filled, V, J, S, n_filled)
    owner, co = 1, [0, 2, 3]
    got = TK.segment_overlap(_t(ws)[:, owner:owner + 1],
                             _t(we)[:, owner:owner + 1], _t(starts),
                             _t(ends), n_filled=n_filled,
                             co=torch.tensor(co, dtype=torch.int32)).numpy()
    with jax.enable_x64(True):
        want = np.asarray(jax_kernel("segment_overlap", "pallas")(
            ws[:, owner:owner + 1], we[:, owner:owner + 1], starts[:, co],
            ends[:, co]))
    assert np.array_equal(got, want)
    for v in range(V):
        for c, k in enumerate(co):
            tot = 0.0
            for s in range(n_filled):
                ov = min(we[v, owner], ends[v, k, s]) - \
                    max(ws[v, owner], starts[v, k, s])
                tot += ov if ov > 0.0 else 0.0
            assert got[v, c] == tot


def test_torch_segment_overlap_refuses_a_bad_n_filled():
    s_i, e_i, starts, ends = (_t(a) for a in _segments(7, 4, 8))
    for bad, err in ((-1, ValueError), (9, ValueError), (2.0, TypeError),
                     (True, TypeError)):
        with pytest.raises(err, match="n_filled"):
            TK.segment_overlap(s_i, e_i, starts, ends, n_filled=bad)


# -- pacing -------------------------------------------------------------------


def _ulps(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return float(np.max(np.abs(a - b) / scale)) if a.size else 0.0


@pytest.mark.parametrize("t", [0, 1, 2, 7, 8, 15, 16, 17, 40])
def test_torch_bank_decide_within_ulp_tier_of_jax_kernel(t):
    """Ring-buffer state as the engine carries it at iteration ``t``."""
    n, w = 6, 16
    rng = np.random.default_rng(100 + t)
    waits = rng.uniform(0.0, 0.5, size=(n, w))
    steps = rng.uniform(0.8, 1.2, size=(n, w))
    early = waits + rng.uniform(0.0, 0.1, size=(n, w))
    delay = rng.uniform(0.0, 0.05, size=n)
    kw = dict(enabled=True, warmup_iters=8.0, cv_threshold=0.05,
              skew_threshold=0.10, gain=0.5, decay=0.9, max_delay_frac=0.5)
    pos, count, seen = (t + 1) % w, min(t + 1, w), t + 1
    got = TK.bank_decide(_t(waits), _t(steps), _t(early), _t(delay),
                         pos=pos, count=count, seen=seen, **kw)
    with jax.enable_x64(True):
        want = JK.bank_decide(waits, steps, early, delay, pos=pos,
                              count=count, seen=seen, **kw)
        want = [np.asarray(x) for x in want]
    tol = EQUIVALENCE_TIERS["pacing_decide"][1]
    assert _ulps(got[0].numpy(), want[0]) <= tol
    assert _ulps(got[1].numpy(), want[1]) <= tol
    # a leading variant axis with per-variant parameters gives the rows
    kv = {k: (torch.full((3, 1), float(v), dtype=F64)
              if k != "enabled" else v) for k, v in kw.items()}
    b = TK.bank_decide(*[_t(x).expand(3, *x.shape).contiguous()
                         for x in (waits, steps, early, delay)],
                       pos=pos, count=count, seen=seen, **kv)
    for v in range(3):
        assert torch.equal(b[0][v], got[0]) and torch.equal(b[1][v], got[1])


def test_torch_pacing_decide_tracks_python_bank_and_jax_kernel():
    """The kernel consumes the ``(n, window)`` ring-buffer state a live
    :class:`PacingBank` holds; with the cursor at 0 (whole window wraps)
    the two agree within the declared ULP budget on both the bounded
    delays and the carried internal delay state."""
    import random
    from repro.configs.base import PacingConfig as JaxPacing
    kw = dict(enabled=True, window=6, cv_threshold=0.05,
              skew_threshold=0.04, max_delay_frac=0.5, gain=0.8, decay=0.8,
              warmup_iters=4)
    cfg = PacingConfig(**kw)
    tol = EQUIVALENCE_TIERS["pacing_decide"][1]
    fast = get_kernel("pacing_decide", "torch")
    n = 8
    bank = PacingBank(cfg, n)
    rng = random.Random(9)
    for _ in range(5):
        for _ in range(cfg.window):       # full wraps keep the cursor at 0
            bank.observe(
                np.array([abs(rng.gauss(0.02, 0.03)) for _ in range(n)]),
                np.array([0.2 + rng.gauss(0.0, 0.02) for _ in range(n)]))
        assert bank._pos == 0
        waits, steps = bank._bw.copy(), bank._bs.copy()
        early, delay = bank._be.copy(), bank._delay.copy()
        seen = bank._seen
        want = bank.decide()              # mutates bank._delay
        got, new_delay = fast(_t(waits), _t(steps), _t(early), _t(delay),
                              seen, cfg)
        assert _ulps(got.numpy(), want) <= tol
        assert _ulps(new_delay.numpy(), bank._delay) <= tol
        with jax.enable_x64(True):
            jgot, jnew = jax_kernel("pacing_decide", "jnp")(
                waits, steps, early, delay, seen, JaxPacing(**kw))
            jgot, jnew = np.asarray(jgot), np.asarray(jnew)
        assert _ulps(got.numpy(), jgot) <= tol
        assert _ulps(new_delay.numpy(), jnew) <= tol
    off = TK.pacing_decide(_t(waits), _t(steps), _t(early), _t(delay), seen,
                           PacingConfig(enabled=False))
    assert torch.equal(off[0], torch.zeros(n, dtype=F64))
    assert torch.equal(off[1], _t(delay))


# -- drr and offered share: plain versions, bit-identical --------------------


@pytest.mark.parametrize("rounds", [1, 7, 64])
@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_torch_drr_shares_bit_identical_to_python_reference(n, rounds):
    d, w, cap, _ = _cases(40 + n, 50, n)
    w[::4] = 1.0                                # the unit-quantum rows
    got = get_kernel("drr_shares", "torch")(_t(d), _t(w), _t(cap),
                                            rounds=rounds)
    assert got.dtype == F64 and got.shape == d.shape
    want = np.array([ref.drr_shares(list(d[r]), list(w[r]), float(cap[r]),
                                    rounds=rounds) for r in range(len(d))])
    assert np.array_equal(got.numpy(), want)
    unweighted = TK.drr_shares(_t(d), None, _t(cap), rounds=rounds)
    assert np.array_equal(unweighted.numpy(), np.array(
        [ref.drr_shares(list(d[r]), None, float(cap[r]), rounds=rounds)
         for r in range(len(d))]))


def test_torch_drr_shares_bit_identical_to_jax_kernel():
    d, w, cap, _ = _cases(3, 33, 6)
    d = d.reshape(3, 11, 6)
    w = w.reshape(3, 11, 6)
    cap = cap.reshape(3, 11)
    got = TK.drr_shares(_t(d), _t(w), _t(cap)).numpy()
    with jax.enable_x64(True):
        want = np.asarray(jax_kernel("drr_shares", "jnp")(d, w, cap))
    assert want.dtype == np.float64 and np.array_equal(got, want)


def test_torch_drr_shares_edges_and_rejections():
    assert TK.drr_shares(_t(np.zeros((2, 0))), device="cpu").shape == (2, 0)
    # a lane that drains early keeps its bits while the others go on
    d = _t([[0.1, 0.2], [5.0, 7.0]])
    got = TK.drr_shares(d, None, _t([1.0, 1.0]), rounds=4)
    assert got[0].tolist() == ref.drr_shares([0.1, 0.2], None, 1.0, 4)
    assert got[1].tolist() == ref.drr_shares([5.0, 7.0], None, 1.0, 4)
    with pytest.raises(ValueError, match="demands must be >= 0"):
        TK.drr_shares(_t([1.0, -1.0]))
    with pytest.raises(ValueError, match="weights must be positive"):
        TK.drr_shares(_t([1.0, 1.0]), _t([1.0, 0.0]))
    with pytest.raises(ValueError, match="rounds must be >= 1"):
        TK.drr_shares(_t([1.0]), rounds=0)
    f32 = TK.drr_shares(torch.rand(4, 3), device="cpu")
    assert f32.dtype == torch.float32


def _offered_cases(seed, rows, flows):
    rng = np.random.default_rng(seed)
    d_i = rng.uniform(0.05, 2.0, size=rows)
    own = rng.uniform(0.0, 5.0, size=rows)
    own[::5] = 0.0                          # the RESIDUAL_SHARE floor
    ov = rng.uniform(0.0, 3.0, size=(rows, flows))
    ov[::3, 0] = d_i[::3]                   # overlap == window: whole bytes
    b = rng.uniform(0.0, 5.0, size=(rows, flows))
    return own, d_i, ov, b


@pytest.mark.parametrize("flows", [1, 3, 6])
def test_torch_offered_share_bit_identical_to_python_reference(flows):
    own, d_i, ov, b = _offered_cases(flows, 60, flows)
    got = get_kernel("offered_share", "torch")(_t(own), _t(d_i), _t(ov),
                                               _t(b))
    want = [ref.offered_share(float(own[r]), float(d_i[r]),
                              list(zip(ov[r], b[r]))) for r in range(60)]
    assert got.dtype == F64 and got.tolist() == want


def test_torch_offered_share_mask_and_jax_kernel():
    own, d_i, ov, b = _offered_cases(9, 40, 5)
    mask = np.ones((40, 5), dtype=bool)
    mask[:, 3:] = False                     # padded flow slots
    got = TK.offered_share(_t(own), _t(d_i), _t(ov), _t(b), mask)
    want = [ref.offered_share(float(own[r]), float(d_i[r]),
                              list(zip(ov[r, :3], b[r, :3])))
            for r in range(40)]
    assert got.tolist() == want
    with jax.enable_x64(True):
        jx = np.asarray(jax_kernel("offered_share", "jnp")(
            own, d_i, ov, b, mask))
    assert np.array_equal(got.numpy(), jx)
