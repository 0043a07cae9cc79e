"""The port's RWKV-6 serving path held against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs as its own tests run it here: the Pallas WKV6 kernel in
interpret mode (``repro.kernels.ops.set_backend("interpret")``, restored in
a ``finally``), the model through ``Model.prefill`` / ``decode_step``
called bare (no mesh bound). The interpret backend runs the kernel's body,
which does not clamp the decay as the default XLA path (``wkv6_chunked``)
does.

Tolerances: the WKV6 recurrence and its decode step 2e-4 in float32
(``tests/test_kernels.py``'s) and 2e-2 in bfloat16 (y and the state);
the time and channel mix 1e-5 in float32 and 2e-2 in bfloat16; the
whole smoke model's float32 logits 1e-4 with identical greedy tokens,
bfloat16 5e-2 of the largest logit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import xla_impl as jxla
from repro.kernels.wkv6 import wkv6 as jwkv6_pallas
from repro.models import ssm as jssm
from repro.models.api import build_model as jbuild
from repro.models.params import KeyGen

from repro_torch import configs as tconfigs
from repro_torch.kernels import chunked, cuda_kernels, ops, ref
from repro_torch.kernels import wkv6 as twkv6
from repro_torch.launch import serve
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_jax

from test_torch_model import DTYPES, both, f32, jax_greedy

# (B, S, H, K, V, chunk): tests/test_kernels.py's WKV_CASES
WKV_CASES = [
    (1, 8, 1, 8, 8, 4),
    (2, 33, 2, 16, 16, 8),
    (1, 64, 3, 32, 16, 16),
    (2, 16, 2, 8, 8, 16),
]


def wkv_tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-4, atol=2e-4)


def wkv_inputs(B, S, H, K, V, dtype, seed=6):
    """r, k, v, w, u, s0 as (JAX array, CPU tensor) pairs. The decay has
    log w in [-2.7, -0.003), the range of real RWKV-6 parameterisations
    (``tests/test_kernels.py``); u and s0 are float32."""
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((B, S, H, K)) for _ in range(2))
    v = rng.standard_normal((B, S, H, V))
    w = np.exp(-np.exp(rng.uniform(-6.0, 1.0, size=(B, S, H, K))))
    u = rng.standard_normal((H, K))
    s0 = 0.1 * rng.standard_normal((B, H, K, V))
    return ([both(a, dtype) for a in (r, k, v, w)]
            + [both(a, "float32") for a in (u, s0)])


@pytest.fixture
def interpret():
    """The JAX package's kernels in Pallas interpret mode for one test."""
    before = jops.backend()
    jops.set_backend("interpret")
    try:
        yield
    finally:
        jops.set_backend(before)


# ---------------------------------------------------------------------------
# the recurrence and its decode step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", WKV_CASES, ids=str)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_wkv6_plain_matches_jax_ref_and_pallas_kernel(case, dtype):
    B, S, H, K, V, chunk = case
    pairs = wkv_inputs(B, S, H, K, V, dtype)
    j = [a for a, _ in pairs]
    t = [b for _, b in pairs]
    y, s = ref.wkv6(*t)
    assert y.dtype == t[0].dtype and s.dtype == torch.float32
    assert y.shape == (B, S, H, V) and s.shape == (B, H, K, V)
    for y_want, s_want in (jref.wkv6(*j),
                           jwkv6_pallas(*j, chunk=chunk, interpret=True)):
        np.testing.assert_allclose(f32(y), f32(y_want), **wkv_tol(dtype))
        np.testing.assert_allclose(f32(s), f32(s_want), **wkv_tol(dtype))
    # the wrapper on CPU tensors is the plain version, and s0=None is zeros
    y0, s0 = twkv6.wkv6(*t[:5])
    y0_want, s0_want = ref.wkv6(*t[:5], torch.zeros_like(t[5]))
    assert torch.equal(y0, y0_want) and torch.equal(s0, s0_want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_wkv6_decode_steps_match_jax_and_the_recurrence(dtype):
    B, S, H, K, V = 2, 5, 2, 8, 8
    pairs = wkv_inputs(B, S, H, K, V, dtype, seed=8)
    (jr, tr), (jk, tk), (jv, tv), (jw, tw), (ju, tu), (js, ts) = pairs
    y_full, s_full = ref.wkv6(tr, tk, tv, tw, tu, ts)
    state, jstate, ys = ts, js, []
    for i in range(S):
        sl = slice(i, i + 1)
        y, new = chunked.wkv6_decode(tr[:, sl], tk[:, sl], tv[:, sl],
                                     tw[:, sl], tu, state)
        assert new is not state
        jy, jstate = jxla.wkv6_decode(jr[:, sl], jk[:, sl], jv[:, sl],
                                      jw[:, sl], ju, jstate)
        np.testing.assert_allclose(f32(y), f32(jy), **wkv_tol(dtype))
        np.testing.assert_allclose(f32(new), f32(jstate), **wkv_tol(dtype))
        ys.append(y)
        state = new
    np.testing.assert_allclose(f32(torch.cat(ys, 1)), f32(y_full),
                               **wkv_tol(dtype))
    np.testing.assert_allclose(f32(state), f32(s_full), **wkv_tol(dtype))


def test_torch_wkv6_cuda_backend_refuses_cpu_tensors_and_unsupported_k():
    """No quiet stand-in: a CPU tensor on ``backend="cuda"`` raises, and
    the wrapper's checks refuse a K the kernel was not built for;
    nothing is launched."""
    before = cuda_kernels.launch_counts()
    _, t = zip(*wkv_inputs(1, 4, 2, 8, 8, "float32"))
    with pytest.raises(ValueError, match="backend='cuda' runs the "
                                         "hand-written kernels"):
        ops.wkv6(*t)
    with pytest.raises(ValueError, match="backend='cuda'"):
        ops.wkv6_decode(*(a[:, :1] for a in t[:4]), t[4], t[5])
    _, t12 = zip(*wkv_inputs(1, 4, 2, 12, 8, "float32"))
    with pytest.raises(ValueError, match=r"key dim K = 12 not in \(8, 16, "
                                         r"32, 64\)"):
        twkv6._check(*t12)
    _, big = zip(*wkv_inputs(1, 2, 1, 8, 1025, "float32"))
    with pytest.raises(ValueError, match="value dim V = 1025"):
        twkv6._check(*big)
    with pytest.raises(ValueError, match="u must be torch.float32"):
        twkv6._check(*t[:4], t[4].bfloat16(), t[5])
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        twkv6._check(*(a.half() for a in t[:4]), t[4], t[5])
    assert cuda_kernels.launch_counts() == before


# ---------------------------------------------------------------------------
# the time mix and channel mix
# ---------------------------------------------------------------------------


def _cfg(dtype):
    j = jconfigs.get_model_config("rwkv6-3b", smoke=True)
    t = tconfigs.get_model_config("rwkv6-3b", smoke=True)
    if dtype == "float32":
        j = j.replace(dtype="float32", param_dtype="float32")
        t = t.replace(dtype="float32", param_dtype="float32")
    return j, t


def _perturb(path, x, rng):
    """Random values where the init puts constants (norm scales 1, biases
    0, the decay base -2), which would hide a dropped scale, bias or a
    decay read in the wrong place."""
    name = str(path[-1].key) if hasattr(path[-1], "key") else ""
    if name in ("scale", "gn_scale"):
        v = 1.0 + 0.2 * rng.standard_normal(x.shape)
    elif name in ("bias", "gn_bias"):
        v = 0.1 * rng.standard_normal(x.shape)
    elif name == "w0":
        v = -2.0 + 0.7 * rng.standard_normal(x.shape)
    else:
        return x
    return jnp.asarray(v.astype(np.float32)).astype(x.dtype)


def _to_torch(tree, dtype_of):
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dtype_of(k))
            for k, v in tree.items()}


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_rwkv_tmix_and_cmix_match_jax(interpret, monkeypatch, mode,
                                            dtype):
    jcfg, tcfg = _cfg(dtype)
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(3)
    kg = KeyGen(jax.random.PRNGKey(4))
    jt = jax.tree_util.tree_map_with_path(
        lambda p, x: _perturb(p, x, rng), jssm.rwkv_tmix_init(kg, jcfg))
    jc = jssm.rwkv_cmix_init(kg, jcfg)
    tt = _to_torch(jt, lambda k: torch.float32 if k == "u" else td)
    tc = _to_torch(jc, lambda k: td)
    assert tt["u"].dtype == torch.float32

    B, D = 2, jcfg.d_model
    H, K = jcfg.num_heads, jcfg.ssm.head_dim
    S = 1 if mode == "decode" else 9
    jx, tx = both(rng.standard_normal((B, S, D)), dtype)
    jlast, tlast = both(rng.standard_normal((B, D)), dtype)
    jlast2, tlast2 = both(rng.standard_normal((B, D)), dtype)
    js, ts = both(0.3 * rng.standard_normal((B, H, K, K)), "float32")

    jout, jnc = jssm.rwkv_tmix_apply(
        jt, jx, cfg=jcfg, mode=mode, cache={"last_x": jlast, "state": js})
    # the recurrence must get the decay (and, in decode, v) rounded to
    # r's dtype, as the reference rounds them (ssm.py:123,126): over a
    # long prompt the state drifts otherwise, too slowly for the
    # tolerances above to see at smoke length
    seen = []
    for name in ("wkv6", "wkv6_decode"):
        def spy(r, k, v, w, *a, _f=getattr(ops, name), **kw):
            seen.append((r.dtype, v.dtype, w.dtype))
            return _f(r, k, v, w, *a, **kw)
        monkeypatch.setattr(ops, name, spy)
    cache = {"last_x": tlast.clone(), "state": ts.clone()}
    tout, tnc = tssm.rwkv_tmix_apply(tt, tx, cfg=tcfg, mode=mode,
                                     cache=cache, backend="torch")
    assert seen == [(td, td, td)]
    assert tnc is cache                       # written in place
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=1e-5, atol=1e-5)
    assert tout.dtype == td
    np.testing.assert_allclose(f32(tout), f32(jout), **tol)
    np.testing.assert_allclose(f32(tnc["state"]), f32(jnc["state"]), **tol)
    assert np.array_equal(f32(tnc["last_x"]), f32(jnc["last_x"]))

    jout, jnc = jssm.rwkv_cmix_apply(jc, jx, cfg=jcfg, mode=mode,
                                     cache={"last_x": jlast2})
    cache = {"last_x": tlast2.clone()}
    tout, tnc = tssm.rwkv_cmix_apply(tc, tx, cfg=tcfg, mode=mode,
                                     cache=cache)
    assert tnc is cache
    np.testing.assert_allclose(f32(tout), f32(jout), **tol)
    assert np.array_equal(f32(tnc["last_x"]), f32(jnc["last_x"]))


# ---------------------------------------------------------------------------
# the whole smoke model
# ---------------------------------------------------------------------------


def jax_rwkv(dtype, seed=0):
    """The JAX smoke rwkv6-3b in ``dtype`` with perturbed constants, as a
    numpy tree too."""
    jcfg, tcfg = _cfg(dtype)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: _perturb(p, x, rng), params)
    return jcfg, tcfg, jm, params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_smoke_rwkv_prefill_and_decode_match_jax(interpret, dtype):
    jcfg, tcfg, jm, params, tree = jax_rwkv(dtype)
    B, S, new = 2, 12, 8
    prompts = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    jtoks, jlogits = jax_greedy(jm, params, prompts, new)

    model = params_from_jax(tree, tcfg, device="cpu")
    with torch.inference_mode():
        lg, cache = model.prefill(
            {"tokens": torch.from_numpy(prompts).long()}, max_len=S + new,
            backend="torch")
        got = [lg.float().numpy()]
        # the decode steps read the JAX loop's tokens, so one near-tie
        # cannot send the two packages down different continuations
        for i in range(new):
            tok = torch.from_numpy(jtoks[:, S + i].astype(np.int64))
            lg, cache = model.decode_step(tok, S + i, cache,
                                          backend="torch")
            got.append(lg.float().numpy())
    assert len(got) == len(jlogits) == new + 1
    for step, (g, w) in enumerate(zip(got, jlogits)):
        assert np.isfinite(g).all()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {step}")
            assert np.array_equal(g.argmax(-1), w.argmax(-1)), step
        else:
            assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max(), step


def test_torch_generate_gives_the_jax_greedy_tokens_for_rwkv(interpret):
    jcfg, tcfg, jm, params, tree = jax_rwkv("float32", seed=2)
    prompts = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, size=(3, 10)).astype(np.int32)
    want, _ = jax_greedy(jm, params, prompts, 8)
    model = params_from_jax(tree, tcfg, device="cpu")
    before = cuda_kernels.launch_counts()
    got, summary = serve.generate(arch="rwkv6-3b", prompt_tokens=prompts,
                                  max_new_tokens=8, model=model,
                                  device="cpu", backend="torch")
    assert got.shape == (3, 18) and np.array_equal(got.numpy(), want)
    assert summary["iters"] == 8.0
    assert cuda_kernels.launch_counts() == before


def test_torch_serve_cli_serves_rwkv_on_the_cpu_when_asked(monkeypatch,
                                                           capsys):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "rwkv6-3b",
                                     "--batch", "2", "--prompt-len", "6",
                                     "--max-new-tokens", "3",
                                     "--device", "cpu", "--backend", "torch"])
    serve.main()
    assert "generated shape: (2, 9)" in capsys.readouterr().out


def test_torch_convert_places_every_rwkv_leaf_once():
    """Every leaf of the JAX tree lands in exactly one parameter of the
    port's model, with its value; ``u`` stays float32 in a bfloat16
    model, and ``ln0`` and the norms' biases have their places."""
    jcfg, tcfg, _, _, tree = jax_rwkv("bfloat16")
    model = params_from_jax(tree, tcfg, device="cpu")
    own = dict(model.params.named_parameters())
    L = tcfg.num_layers
    n_leaves = sum(a.shape[0] if path[0].key == "body" else 1
                   for path, a in jax.tree_util.tree_leaves_with_path(tree))
    assert n_leaves == len(own)
    for name in ("ln0.scale", "ln0.bias", "final_norm.bias",
                 "blocks.0.norm1.bias", f"blocks.{L - 1}.norm2.bias",
                 "blocks.1.mixer.gn_bias", "blocks.1.mlp.mu_r"):
        assert name in own, name
    for i in range(L):
        u = own[f"blocks.{i}.mixer.u"]
        assert u.dtype == torch.float32
        assert np.array_equal(u.numpy(), tree["body"][0]["mixer"]["u"][i])
        w0 = own[f"blocks.{i}.mixer.w0"]
        assert w0.dtype == torch.bfloat16
        assert np.array_equal(w0.float().numpy(), np.asarray(
            tree["body"][0]["mixer"]["w0"][i], np.float32))
    assert np.array_equal(own["ln0.bias"].float().numpy(),
                          np.asarray(tree["ln0"]["bias"], np.float32))
    assert own["ln0.bias"].abs().max() > 0
