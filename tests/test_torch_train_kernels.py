"""The port's training kernels' gradients held against the JAX package on
the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Held: the chunked flash attention (``kernels/chunked.py``), value and
vjp, against ``xla_impl.flash_attention_xla`` and ``jax.vjp`` of it
(float32, 1e-4 as ``tests/test_kernels.py`` holds its backward); the
``torch.autograd.Function`` s of ``ops.attention`` and ``ops.rmsnorm`` on
``backend="torch"`` against the JAX ``ops.attention`` / ``ops.rmsnorm``
under ``set_backend("interpret")`` -- the Pallas forward in interpret
mode with its ``custom_vjp`` backward (float32 1e-4, bfloat16 2e-2 of the
largest value). The scans' Functions are held in
``test_torch_train_scans.py``.
"""
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


def both(x, name="float32"):
    jd, td = DTYPES[name]
    x = np.asarray(x, np.float32)
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, dtype):
    got, want = f32(got), f32(want)
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.fixture
def interpret():
    """The JAX package's ops on the Pallas kernels in interpret mode."""
    before = jops.backend()
    jops.set_backend("interpret")
    try:
        yield
    finally:
        jops.set_backend(before)


# ---------------------------------------------------------------------------
# the chunked flash attention against flash_attention_xla
# ---------------------------------------------------------------------------

CHUNKED_CASES = {
    # (B, Sq, Sk, H, KV, Dqk, Dv, causal, window, q_offset, block_k)
    "causal gqa": (2, 64, 64, 4, 2, 32, 32, True, 0, 0, 512),
    "causal gqa, 4 blocks": (2, 64, 64, 6, 2, 16, 16, True, 0, 0, 16),
    "window": (1, 80, 80, 4, 2, 16, 16, True, 24, 0, 32),
    "not causal": (2, 33, 50, 4, 1, 32, 32, False, 0, 0, 512),
    "sq != sk, q_offset": (1, 24, 90, 4, 4, 16, 16, True, 0, 66, 32),
    "sk not a multiple of block_k": (1, 600, 600, 2, 1, 16, 16, True, 0,
                                     0, 512),
    "mla 96/64": (1, 48, 48, 4, 4, 96, 64, True, 0, 0, 512),
}


def _attn_inputs(case, seed=0, dtype="float32"):
    B, Sq, Sk, H, KV, Dqk, Dv = case[:7]
    rng = np.random.default_rng(seed)
    return [both(rng.standard_normal(s), dtype) for s in
            ((B, Sq, H, Dqk), (B, Sk, KV, Dqk), (B, Sk, KV, Dv),
             (B, Sq, H, Dv))]


@pytest.mark.parametrize("name", list(CHUNKED_CASES))
def test_torch_chunked_attention_and_its_vjp_match_flash_attention_xla(name):
    case = CHUNKED_CASES[name]
    causal, window, q_off, bk = case[7:]
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = _attn_inputs(case)
    kw = dict(causal=causal, window=window, q_offset=q_off, block_k=bk)
    want, vjp = jax.vjp(lambda q, k, v: jxla.flash_attention_xla(
        q, k, v, **kw), jq, jk, jv)
    dq, dk, dv = vjp(jg)
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    got = chunked.flash_attention(tq, tk, tv, **kw)
    got.backward(tg)
    close(got, want, "float32")
    for g, w in ((tq.grad, dq), (tk.grad, dk), (tv.grad, dv)):
        close(g, w, "float32")
    # K4's backward: the same numbers from the inputs alone
    again = chunked.attention_vjp(tq.detach(), tk.detach(), tv.detach(), tg,
                                  **kw)
    for a, g in zip(again, (tq.grad, tk.grad, tv.grad)):
        assert torch.equal(a, g)


def test_torch_chunked_attention_masks_by_kv_len():
    case = (2, 16, 40, 4, 2, 16, 16)
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = _attn_inputs(case, seed=3)
    kv_len = np.array([40, 23], np.int32)
    kw = dict(causal=False, block_k=16)
    want, vjp = jax.vjp(lambda q, k, v: jxla.flash_attention_xla(
        q, k, v, kv_len=jnp.asarray(kv_len), **kw), jq, jk, jv)
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    got = chunked.flash_attention(tq, tk, tv, kv_len=torch.from_numpy(kv_len),
                                  **kw)
    got.backward(tg)
    close(got, want, "float32")
    for g, w in zip((tq.grad, tk.grad, tv.grad), vjp(jg)):
        close(g, w, "float32")
    assert float(tk.grad[1, 23:].abs().max()) == 0.0


def test_torch_chunked_attention_keeps_its_constants():
    from repro_torch.kernels.ref import NEG_INF
    assert NEG_INF == jxla.NEG_INF == -1e30
    import inspect
    for fn in (chunked.flash_attention, chunked.attention_vjp):
        assert inspect.signature(fn).parameters["block_k"].default == 512
    assert inspect.signature(jxla.flash_attention_xla).parameters[
        "block_k"].default == 512


# ---------------------------------------------------------------------------
# the autograd Functions against the JAX custom_vjp ops (Pallas forward)
# ---------------------------------------------------------------------------

OPS_ATTN_CASES = {
    # (B, Sq, Sk, H, KV, D, D, causal, window, q_offset)
    "causal gqa": (2, 32, 32, 4, 2, 16, 16, True, 0, 0),
    "window": (1, 48, 48, 2, 1, 16, 16, True, 16, 0),
    "not causal": (1, 24, 40, 2, 2, 16, 16, False, 0, 0),
    "q_offset": (1, 16, 48, 4, 2, 16, 16, True, 0, 32),
}


@pytest.mark.parametrize("name", list(OPS_ATTN_CASES))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_attention_function_gradients_match_jax_ops(interpret, name,
                                                          dtype):
    case = OPS_ATTN_CASES[name]
    causal, window, q_off = case[7:]
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = _attn_inputs(case, seed=1,
                                                           dtype=dtype)
    kw = dict(causal=causal, window=window, q_offset=q_off)
    want, vjp = jax.vjp(lambda q, k, v: jops.attention(q, k, v, **kw),
                        jq, jk, jv)
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    got = ops.attention(tq, tk, tv, backend="torch", **kw)
    assert type(got.grad_fn).__name__ == "_AttentionBackward"
    got.backward(tg)
    close(got, want, dtype)
    for g, w in zip((tq.grad, tk.grad, tv.grad), vjp(jg)):
        assert g.dtype == tq.dtype
        close(g, w, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(2, 8, 64), (37, 96)], ids=str)
def test_torch_rmsnorm_function_gradients_match_jax_ops(interpret, dtype,
                                                        shape):
    rng = np.random.default_rng(2)
    jx, tx = both(rng.standard_normal(shape), dtype)
    js, ts = both(1.0 + 0.3 * rng.standard_normal(shape[-1:]), dtype)
    jg, tg = both(rng.standard_normal(shape), dtype)
    want, vjp = jax.vjp(lambda x, s: jops.rmsnorm(x, s, 1e-5), jx, js)
    tx, ts = tx.requires_grad_(), ts.requires_grad_()
    got = ops.rmsnorm(tx, ts, 1e-5, backend="torch")
    assert type(got.grad_fn).__name__ == "_RMSNormBackward"
    got.backward(tg)
    close(got, want, dtype)
    for g, w in zip((tx.grad, ts.grad), vjp(jg)):
        close(g, w, dtype)


def test_torch_rmsnorm_function_takes_grad_of_x_alone():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    x.requires_grad_()
    ops.rmsnorm(x, s, backend="torch").sum().backward()
    want = x.detach().clone().requires_grad_()
    ref_out = ops.ref.rmsnorm(want, s)
    ref_out.sum().backward()
    assert torch.equal(x.grad, want.grad) and s.grad is None


def test_torch_ops_without_grad_take_no_function():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(
        np.float32)).requires_grad_()
    with torch.no_grad():
        assert ops.attention(q, q, q, backend="torch").grad_fn is None
        assert ops.rmsnorm(q, q[0, 0, 0], backend="torch").grad_fn is None
    plain = ops.attention(q.detach(), q.detach(), q.detach(),
                          backend="torch")
    assert torch.equal(plain, ops.attention(q, q, q, backend="torch"))


def test_torch_attention_with_kv_len_stays_on_the_plain_path():
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((2, 1, 2, 16)).astype(
        np.float32)).requires_grad_()
    k = torch.from_numpy(rng.standard_normal((2, 8, 2, 16)).astype(
        np.float32)).requires_grad_()
    out = ops.attention(q, k, k, causal=False,
                        kv_len=torch.tensor([8, 3]), backend="torch")
    assert type(out.grad_fn).__name__ != "_AttentionBackward"
    out.sum().backward()
    assert float(k.grad[1, 3:].abs().max()) == 0.0
