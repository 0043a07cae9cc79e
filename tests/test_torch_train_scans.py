"""The backward of K6 and K7 held against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Held: the chunked scans (``kernels/chunked.py``: ``wkv6_chunked``,
``mamba_chunked`` and the associative scan inside the latter), value and
vjp for every input, against ``xla_impl.wkv6_chunked`` /
``mamba_chunked`` and ``jax.vjp`` of them, over ragged S at several
chunks, the initial state given and not, S = 1, and decays near and below
the clamp at e^-8 (forward 2e-4 as ``tests/test_kernels.py`` holds the
chunked scans; gradients 1e-4 of each input's largest value in float32,
2e-2 in bfloat16); the ``torch.autograd.Function`` s of ``ops.wkv6`` and
``ops.mamba_scan`` on ``backend="torch"`` against the JAX ``ops.wkv6`` /
``ops.mamba_scan`` under ``set_backend("interpret")`` -- the Pallas
forward in interpret mode with its ``custom_vjp`` backward, the split the
port makes.

Near the clamp the chunked form's float32 gradient of the decay is itself
ill-conditioned: its pair factors reach e^(8 x 16 / 2) = e^64 and cancel.
There the reference's own dw is some 3e-4 of its largest value off the
same form evaluated in float64, and two float32 evaluations that sum in
different orders differ by as much. So there the port's dw is held to the
float64 value within twice the reference's own distance from it (every
other gradient at 1e-4 of the reference's, as elsewhere).
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import xla_impl as jxla

from repro_torch.kernels import chunked, ops

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FWD_TOL = 2e-4
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rel(got, want):
    got, want = f32(got), f32(want)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture
def interpret():
    """The JAX package's ops on the Pallas kernels in interpret mode."""
    before = jops.backend()
    jops.set_backend("interpret")
    try:
        yield
    finally:
        jops.set_backend(before)


def wkv_arrays(B, S, H, K, V, *, logw=(-3.0, -0.01), s0=True, seed=0):
    """r, k, v, w, u, s0 and the cotangents of y and of the final state,
    float32 numpy; ``log w`` uniform in ``logw``."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    w = np.exp(rng.uniform(*logw, size=(B, S, H, K))).astype(np.float32)
    return dict(r=n(B, S, H, K), k=n(B, S, H, K), v=n(B, S, H, V), w=w,
                u=0.5 * n(H, K), s0=0.5 * n(B, H, K, V) if s0 else None,
                gy=n(B, S, H, V), gs=n(B, H, K, V))


def mamba_arrays(B, S, Dm, N, *, h0=True, seed=0):
    """x, dt, A, B, C, D, h0 and the cotangents, float32 numpy: dt a
    softplus, A = -exp(.)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    dt = (0.1 * np.log1p(np.exp(n(B, S, Dm)))).astype(np.float32)
    return dict(x=n(B, S, Dm), dt=dt, A=-np.exp(n(Dm, N)), Bm=n(B, S, N),
                C=n(B, S, N), D=n(Dm), h0=0.5 * n(B, Dm, N) if h0 else None,
                gy=n(B, S, Dm), gh=n(B, Dm, N))


WKV_INPUTS = ("r", "k", "v", "w", "u", "s0")
MAMBA_INPUTS = ("x", "dt", "A", "Bm", "C", "D", "h0")
SCALAR_F32 = ("u", "s0", "A", "D", "h0")       # float32 in training too


def jax_vjp(fn, a, names, cot, dtype="float32", **kw):
    """The value and every input's cotangent of the JAX ``fn`` (the
    initial state passed only when given)."""
    jd = DTYPES[dtype][0]
    given = [n for n in names if a[n] is not None]
    args = [jnp.asarray(a[n]).astype(jnp.float32 if n in SCALAR_F32 else jd)
            for n in given]
    call = lambda *xs: fn(*xs, **kw)
    out, vjp = jax.vjp(call, *args)
    grads = vjp(tuple(jnp.asarray(a[c]).astype(o.dtype)
                      for c, o in zip(cot, out)))
    return out, dict(zip(given, grads))


def torch_vjp(fn, a, names, cot, dtype="float32", state_cot=True, **kw):
    td = DTYPES[dtype][1]
    leaves = {n: None if a[n] is None else torch.from_numpy(a[n]).to(
        torch.float32 if n in SCALAR_F32 else td).requires_grad_()
        for n in names}
    out = fn(*leaves.values(), **kw)
    if state_cot:
        torch.autograd.backward(list(out), [
            torch.from_numpy(a[c]).to(o.dtype) for c, o in zip(cot, out)])
    else:
        out[0].backward(torch.from_numpy(a[cot[0]]).to(out[0].dtype))
    return out, {n: t.grad for n, t in leaves.items() if t is not None}, \
        leaves


# ---------------------------------------------------------------------------
# the chunked scans against xla_impl
# ---------------------------------------------------------------------------

# (S, chunk): S ragged over several chunks, a whole number of chunks, one
# chunk longer than S, and S = 1
WKV_CHUNKS = [(40, 8), (40, 16), (100, 8), (48, 16), (1, 16)]


@pytest.mark.parametrize("s0", [True, False], ids=["s0", "no s0"])
@pytest.mark.parametrize("S,chunk", WKV_CHUNKS, ids=str)
def test_torch_wkv6_chunked_and_its_vjp_match_xla_impl(S, chunk, s0):
    a = wkv_arrays(2, S, 3, 8, 6, s0=s0, seed=S + chunk)
    (jy, js), jg = jax_vjp(jxla.wkv6_chunked, a, WKV_INPUTS, ("gy", "gs"),
                           chunk=chunk)
    (ty, ts), tg, _ = torch_vjp(chunked.wkv6_chunked, a, WKV_INPUTS,
                                ("gy", "gs"), chunk=chunk)
    assert ty.dtype == torch.float32 and ts.dtype == torch.float32
    assert rel(ty, jy) <= FWD_TOL and rel(ts, js) <= FWD_TOL
    assert set(tg) == set(jg)
    for n in jg:
        assert tg[n].shape == jg[n].shape
        assert rel(tg[n], jg[n]) <= GRAD_TOL["float32"], n


def _wkv6_f64(r, k, v, w, u, s0=None, *, chunk):
    """The port's chunked WKV6 evaluated in float64 (its source with
    float32 read as float64)."""
    src = inspect.getsource(chunked.wkv6_chunked).replace(
        ".float()", ".double()").replace("torch.float32", "torch.float64")
    ns = dict(chunked.__dict__)
    exec(src, ns)
    return ns["wkv6_chunked"](r, k, v, w, u, s0, chunk=chunk)


@pytest.mark.parametrize("logw", [(-9.5, -7.0), (-12.0, -6.0)], ids=str)
def test_torch_wkv6_chunked_near_the_clamp_matches_xla_impl(logw):
    """Decays around e^-8, some clamped: the value, the state and every
    gradient but dw at the usual tolerances against the reference; dw
    against the same chunked form in float64, within twice the
    reference's own distance from it."""
    a = wkv_arrays(2, 40, 3, 8, 6, logw=logw, seed=7)
    (jy, js), jg = jax_vjp(jxla.wkv6_chunked, a, WKV_INPUTS, ("gy", "gs"),
                           chunk=16)
    (ty, ts), tg, _ = torch_vjp(chunked.wkv6_chunked, a, WKV_INPUTS,
                                ("gy", "gs"), chunk=16)
    assert rel(ty, jy) <= FWD_TOL and rel(ts, js) <= FWD_TOL
    for n in jg:
        if n != "w":
            assert rel(tg[n], jg[n]) <= GRAD_TOL["float32"], n
    leaves = [torch.from_numpy(a[n]).double().requires_grad_()
              for n in WKV_INPUTS]
    out = _wkv6_f64(*leaves, chunk=16)
    torch.autograd.backward(list(out), [torch.from_numpy(a["gy"]).double(),
                                        torch.from_numpy(a["gs"]).double()])
    exact = leaves[3].grad
    clamped = np.log(a["w"]) < chunked.LOGW_MIN
    assert clamped.any() and (~clamped).any()
    assert float(exact[torch.from_numpy(clamped)].abs().max()) == 0.0
    ref_err = rel(jg["w"], exact)
    assert rel(tg["w"], exact) <= max(GRAD_TOL["float32"], 2 * ref_err), \
        (rel(tg["w"], exact), ref_err)


def test_torch_wkv6_chunked_extreme_decay_stays_finite():
    """``tests/test_kernels.py``'s case: every decay 1e-9, far below the
    clamp; y, the state and every gradient finite and the reference's, dw
    zero."""
    a = wkv_arrays(1, 32, 1, 8, 8, s0=False, seed=20)
    a["w"] = np.full_like(a["w"], 1e-9)
    a["u"] = np.ones_like(a["u"])
    (jy, js), jg = jax_vjp(jxla.wkv6_chunked, a, WKV_INPUTS, ("gy", "gs"),
                           chunk=16)
    (ty, ts), tg, _ = torch_vjp(chunked.wkv6_chunked, a, WKV_INPUTS,
                                ("gy", "gs"), chunk=16)
    assert rel(ty, jy) <= FWD_TOL and rel(ts, js) <= FWD_TOL
    for n in jg:
        assert torch.isfinite(tg[n]).all()
        if n == "w":
            assert float(tg[n].abs().max()) == 0.0 == \
                float(jnp.abs(jg[n]).max())
        else:
            assert rel(tg[n], jg[n]) <= GRAD_TOL["float32"], n


# (S, chunk): the ragged cases, a whole chunk, S = 1
MAMBA_CHUNKS = [(40, 8), (40, 16), (100, 8), (100, 64), (1, 64)]


@pytest.mark.parametrize("h0", [True, False], ids=["h0", "no h0"])
@pytest.mark.parametrize("S,chunk", MAMBA_CHUNKS, ids=str)
def test_torch_mamba_chunked_and_its_vjp_match_xla_impl(S, chunk, h0):
    a = mamba_arrays(2, S, 12, 4, h0=h0, seed=S + chunk)
    (jy, jh), jg = jax_vjp(jxla.mamba_chunked, a, MAMBA_INPUTS,
                           ("gy", "gh"), chunk=chunk)
    (ty, th), tg, _ = torch_vjp(chunked.mamba_chunked, a, MAMBA_INPUTS,
                                ("gy", "gh"), chunk=chunk)
    assert rel(ty, jy) <= FWD_TOL and rel(th, jh) <= FWD_TOL
    assert set(tg) == set(jg)
    for n in jg:
        assert tg[n].shape == jg[n].shape
        assert rel(tg[n], jg[n]) <= GRAD_TOL["float32"], n


@pytest.mark.parametrize("op", ["wkv6", "mamba"])
def test_torch_chunked_scans_match_xla_impl_in_bfloat16(op):
    if op == "wkv6":
        a = wkv_arrays(2, 40, 2, 16, 16, seed=31)
        args = (jxla.wkv6_chunked, chunked.wkv6_chunked, WKV_INPUTS,
                ("gy", "gs"), 16)
    else:
        a = mamba_arrays(2, 100, 24, 8, seed=32)
        args = (jxla.mamba_chunked, chunked.mamba_chunked, MAMBA_INPUTS,
                ("gy", "gh"), 64)
    jfn, tfn, names, cot, chunk = args
    jout, jg = jax_vjp(jfn, a, names, cot, "bfloat16", chunk=chunk)
    tout, tg, leaves = torch_vjp(tfn, a, names, cot, "bfloat16",
                                 chunk=chunk)
    assert tout[0].dtype == torch.bfloat16 and tout[1].dtype == torch.float32
    for t, j in zip(tout, jout):
        assert rel(t, j) <= GRAD_TOL["bfloat16"]
    for n in jg:
        assert tg[n].dtype == leaves[n].dtype
        assert rel(tg[n], jg[n]) <= GRAD_TOL["bfloat16"], n


def test_torch_chunked_scans_keep_the_reference_constants():
    assert chunked.LOGW_MIN == jxla.LOGW_MIN == -8.0
    for port, ref, chunk in ((chunked.wkv6_chunked, jxla.wkv6_chunked, 16),
                             (chunked.mamba_chunked, jxla.mamba_chunked, 64)):
        for fn in (port, ref):
            assert inspect.signature(fn).parameters["chunk"].default == chunk


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 64])
def test_torch_associative_scan_matches_jax_bit_for_bit(n):
    """The linear recurrence's pairs scanned in ``jax.lax.associative_scan``'s
    order, along a middle axis: the same bits."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, size=(2, n, 3)).astype(np.float32)
    b = rng.standard_normal((2, n, 3)).astype(np.float32)
    want = jax.lax.associative_scan(
        lambda e1, e2: (e2[0] * e1[0], e2[0] * e1[1] + e2[1]),
        (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = chunked.associative_scan(
        chunked._linear_combine, (torch.from_numpy(a), torch.from_numpy(b)),
        1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # and it is the sequential recurrence's result
    h = np.zeros((2, 3), np.float64)
    for t in range(n):
        h = a[:, t] * h + b[:, t]
    np.testing.assert_allclose(got[1][:, -1].numpy(), h, rtol=1e-5,
                               atol=1e-6)


def test_torch_mamba_chunked_checkpoints_each_chunk():
    """With grad enabled the chunks are checkpointed: the forward keeps
    no (B, c, D, N) tensor for the backward, and the backward's numbers
    are those of the chunk bodies taken plainly."""
    a = mamba_arrays(1, 40, 6, 4, seed=40)
    names = MAMBA_INPUTS
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    leaves = [torch.from_numpy(a[n]).requires_grad_() for n in names]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, h = chunked.mamba_chunked(*leaves, chunk=8)
    assert not any(len(s) == 4 for s in saved), saved
    torch.autograd.backward([y, h], [torch.from_numpy(a["gy"]),
                                     torch.from_numpy(a["gh"])])
    plain = [torch.from_numpy(a[n]).requires_grad_() for n in names]
    hh, ys = plain[6], []
    for i in range(5):
        part = slice(8 * i, 8 * (i + 1))
        hh, yc = chunked._mamba_chunk(hh, plain[0][:, part], plain[1][:, part],
                                      plain[3][:, part], plain[4][:, part],
                                      plain[2], plain[5])
        ys.append(yc)
    torch.autograd.backward([torch.cat(ys, 1), hh],
                            [torch.from_numpy(a["gy"]),
                             torch.from_numpy(a["gh"])])
    for t, p in zip(leaves, plain):
        assert torch.equal(t.grad, p.grad)


# ---------------------------------------------------------------------------
# the autograd Functions against the JAX custom_vjp ops (Pallas forward)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("given", [True, False], ids=["state", "no state"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_wkv6_function_gradients_match_jax_ops(interpret, dtype,
                                                     given):
    a = wkv_arrays(2, 40, 2, 16, 16, s0=given, seed=50)
    (jy, js), jg = jax_vjp(jops.wkv6, a, WKV_INPUTS, ("gy", "gs"), dtype)
    (ty, ts), tg, leaves = torch_vjp(ops.wkv6, a, WKV_INPUTS, ("gy", "gs"),
                                     dtype, backend="torch")
    assert type(ty.grad_fn).__name__ == "_WKV6Backward"
    tol = GRAD_TOL[dtype]
    assert rel(ty, jy) <= max(FWD_TOL, tol) and rel(ts, js) <= max(FWD_TOL,
                                                                   tol)
    if not given:
        assert "s0" not in tg and leaves["s0"] is None
    for n in tg:
        assert tg[n].dtype == leaves[n].dtype
        assert rel(tg[n], jg[n]) <= tol, n


@pytest.mark.parametrize("given", [True, False], ids=["state", "no state"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_mamba_scan_function_gradients_match_jax_ops(interpret, dtype,
                                                           given):
    a = mamba_arrays(2, 100, 16, 8, h0=given, seed=51)
    (jy, jh), jg = jax_vjp(jops.mamba_scan, a, MAMBA_INPUTS, ("gy", "gh"),
                           dtype)
    (ty, th), tg, leaves = torch_vjp(ops.mamba_scan, a, MAMBA_INPUTS,
                                     ("gy", "gh"), dtype, backend="torch")
    assert type(ty.grad_fn).__name__ == "_MambaScanBackward"
    tol = GRAD_TOL[dtype]
    assert rel(ty, jy) <= max(FWD_TOL, tol) and rel(th, jh) <= max(FWD_TOL,
                                                                   tol)
    if not given:
        assert "h0" not in tg and leaves["h0"] is None
    for n in tg:
        assert tg[n].dtype == leaves[n].dtype
        assert rel(tg[n], jg[n]) <= tol, n


@pytest.mark.parametrize("op", ["wkv6", "mamba_scan"])
def test_torch_scan_functions_take_an_unused_final_state(op):
    """Training uses y alone: the state's cotangent is None, and the
    gradients are those of a zero cotangent for it."""
    if op == "wkv6":
        a, names, cot = wkv_arrays(1, 24, 2, 8, 8, seed=52), WKV_INPUTS, \
            ("gy", "gs")
        a[cot[1]] = np.zeros_like(a[cot[1]])
    else:
        a, names, cot = mamba_arrays(1, 24, 8, 4, seed=53), MAMBA_INPUTS, \
            ("gy", "gh")
        a[cot[1]] = np.zeros_like(a[cot[1]])
    fn = getattr(ops, op)
    _, alone, _ = torch_vjp(fn, a, names, cot, state_cot=False,
                            backend="torch")
    _, both, _ = torch_vjp(fn, a, names, cot, backend="torch")
    assert set(alone) == set(both)
    for n in both:
        torch.testing.assert_close(alone[n], both[n], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("op", ["wkv6", "mamba_scan"])
def test_torch_scan_functions_take_grad_of_some_inputs(op):
    """Only the inputs that require grad get one; the forward is the plain
    recurrence's, bit for bit."""
    if op == "wkv6":
        a, names = wkv_arrays(1, 20, 2, 8, 8, seed=54), WKV_INPUTS
    else:
        a, names = mamba_arrays(1, 20, 8, 4, seed=55), MAMBA_INPUTS
    ts = [torch.from_numpy(a[n]) for n in names]
    ts[1].requires_grad_()
    y, s = getattr(ops, op)(*ts, backend="torch")
    y.sum().backward()
    assert ts[1].grad is not None and all(
        t.grad is None for i, t in enumerate(ts) if i != 1)
    plain = getattr(ops.ref, op)(*[t.detach() for t in ts])
    assert torch.equal(y.detach(), plain[0]) and torch.equal(s.detach(),
                                                             plain[1])


def test_torch_scans_without_grad_take_no_function():
    a = wkv_arrays(1, 8, 2, 8, 8, seed=56)
    m = mamba_arrays(1, 8, 8, 4, seed=57)
    wk = [torch.from_numpy(a[n]).requires_grad_() for n in WKV_INPUTS]
    mb = [torch.from_numpy(m[n]).requires_grad_() for n in MAMBA_INPUTS]
    with torch.no_grad():
        assert ops.wkv6(*wk, backend="torch")[0].grad_fn is None
        assert ops.mamba_scan(*mb, backend="torch")[0].grad_fn is None
    assert ops.wkv6(*[t.detach() for t in wk],
                    backend="torch")[0].grad_fn is None


@pytest.mark.parametrize("op", ["wkv6", "mamba_scan"])
def test_torch_scans_on_cuda_refuse_cpu_tensors_with_or_without_grad(op):
    """"cuda" takes a grad now; a CPU tensor is refused either way, before
    any kernel is built."""
    if op == "wkv6":
        a, names = wkv_arrays(1, 4, 2, 8, 8, seed=58), WKV_INPUTS
    else:
        a, names = mamba_arrays(1, 4, 16, 4, seed=59), MAMBA_INPUTS
    ts = [torch.from_numpy(a[n]) for n in names]
    for grad in (False, True):
        ts[0].requires_grad_(grad)
        with pytest.raises(ValueError, match="backend='cuda'"):
            getattr(ops, op)(*ts, backend="cuda")
