"""The port's Jamba serving path (Mamba-1, dropless MoE, attention without
RoPE) and Mixtral held against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs as its own tests run it here: the Pallas kernels in
interpret mode (``repro.kernels.ops.set_backend("interpret")``, restored in
a ``finally``), the models through ``Model.prefill`` / ``decode_step``
called bare (no mesh bound, so the MoE runs its local branch).

Tolerances: the selective scan and its decode step 2e-4 in float32
(``tests/test_kernels.py``'s) and 2e-2 in bfloat16 (y and the state); the
Mamba mixer and the MoE layer 1e-5 in float32 and 2e-2 in bfloat16; the
whole smoke models' float32 logits 1e-4 with identical greedy tokens,
bfloat16 5e-2 of the largest logit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels import xla_impl as jxla
from repro.kernels.mamba_scan import mamba_scan as jmamba_pallas
from repro.models import mlp as jmlp
from repro.models import ssm as jssm
from repro.models.api import build_model as jbuild
from repro.models.params import KeyGen

from repro_torch import configs as tconfigs
from repro_torch.kernels import chunked, cuda_kernels, ops, ref
from repro_torch.kernels import mamba_scan as tmamba
from repro_torch.launch import serve
from repro_torch.models import mlp as tmlp
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import params_from_jax

from test_torch_model import DTYPES, both, f32, jax_greedy, jax_model
from test_torch_rwkv import interpret  # noqa: F401  (fixture)

# (B, S, Din, N, chunk, block_d) for the Pallas kernel: ragged S against
# the chunk, Din not a multiple of the kernel's default block of 256
MAMBA_CASES = [
    (1, 8, 16, 8, 4, 16),
    (2, 33, 300, 8, 16, 256),
    (1, 64, 48, 16, 16, 16),
]


def mamba_tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-4, atol=2e-4)


def layer_tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=1e-5, atol=1e-5)


def mamba_inputs(B, S, Din, N, dtype, seed=9):
    """x, dt, A, B, C, D, h0 as (JAX array, CPU tensor) pairs, drawn as
    ``tests/test_kernels.py`` draws them; A, D and h0 are float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, Din))
    dt = np.logaddexp(rng.standard_normal((B, S, Din)), 0.0)
    A = -np.exp(0.5 * rng.standard_normal((Din, N)))
    Bm = rng.standard_normal((B, S, N))
    C = rng.standard_normal((B, S, N))
    D = rng.standard_normal(Din)
    h0 = 0.1 * rng.standard_normal((B, Din, N))
    return ([both(a, dtype) for a in (x, dt)]
            + [both(A, "float32")]
            + [both(a, dtype) for a in (Bm, C)]
            + [both(a, "float32") for a in (D, h0)])


# ---------------------------------------------------------------------------
# the selective scan and its decode step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no_h0"])
@pytest.mark.parametrize("case", MAMBA_CASES, ids=str)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_mamba_scan_plain_matches_jax_ref_and_pallas_kernel(
        case, dtype, with_h0):
    B, S, Din, N, chunk, block_d = case
    pairs = mamba_inputs(B, S, Din, N, dtype)
    j = [a for a, _ in pairs]
    t = [b for _, b in pairs]
    if not with_h0:
        j[-1] = t[-1] = None
    y, h = ref.mamba_scan(*t)
    assert y.dtype == t[0].dtype and h.dtype == torch.float32
    assert y.shape == (B, S, Din) and h.shape == (B, Din, N)
    for y_want, h_want in (
            jref.mamba_scan(*j),
            jmamba_pallas(*j, chunk=chunk, block_d=block_d, interpret=True)):
        np.testing.assert_allclose(f32(y), f32(y_want), **mamba_tol(dtype))
        np.testing.assert_allclose(f32(h), f32(h_want), **mamba_tol(dtype))
    # the wrapper on CPU tensors is the plain version, h0=None is zeros
    y0, h0 = tmamba.mamba_scan(*t[:6])
    y0_want, h0_want = ref.mamba_scan(
        *t[:6], torch.zeros((B, Din, N), dtype=torch.float32))
    assert torch.equal(y0, y0_want) and torch.equal(h0, h0_want)
    y1, h1 = ops.mamba_scan(*t, backend="torch")
    assert torch.equal(y1, y) and torch.equal(h1, h)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_mamba_decode_steps_match_jax_and_the_scan(dtype):
    B, S, Din, N = 2, 5, 24, 8
    pairs = mamba_inputs(B, S, Din, N, dtype, seed=8)
    (jx, tx), (jdt, tdt), (jA, tA), (jB, tB), (jC, tC), (jD, tD), \
        (jh, th) = pairs
    y_full, h_full = ref.mamba_scan(tx, tdt, tA, tB, tC, tD, th)
    state, jstate, ys = th, jh, []
    for i in range(S):
        sl = slice(i, i + 1)
        y, new = ops.mamba_decode(tx[:, sl], tdt[:, sl], tA, tB[:, sl],
                                  tC[:, sl], tD, state, backend="torch")
        assert new is not state
        jy, jstate = jxla.mamba_decode(jx[:, sl], jdt[:, sl], jA, jB[:, sl],
                                       jC[:, sl], jD, jstate)
        np.testing.assert_allclose(f32(y), f32(jy), **mamba_tol(dtype))
        np.testing.assert_allclose(f32(new), f32(jstate), **mamba_tol(dtype))
        ys.append(y)
        state = new
    np.testing.assert_allclose(f32(torch.cat(ys, 1)), f32(y_full),
                               **mamba_tol(dtype))
    np.testing.assert_allclose(f32(state), f32(h_full), **mamba_tol(dtype))
    y, new = chunked.mamba_decode(tx[:, :1], tdt[:, :1], tA, tB[:, :1],
                                  tC[:, :1], tD, th)
    assert y.dtype == tx.dtype and new.dtype == torch.float32


def test_torch_mamba_cuda_backend_refuses_cpu_tensors_and_unsupported_n():
    """No quiet stand-in: a CPU tensor on ``backend="cuda"`` raises, and
    the wrapper's checks refuse what the kernel was not built for; nothing
    is launched."""
    before = cuda_kernels.launch_counts()
    _, t = zip(*mamba_inputs(1, 4, 16, 8, "float32"))
    x, dt, A, Bm, C, D, h0 = t
    with pytest.raises(ValueError, match="backend='cuda' runs the "
                                         "hand-written kernels"):
        ops.mamba_scan(*t)
    with pytest.raises(ValueError, match="backend='cuda'"):
        ops.mamba_decode(x[:, :1], dt[:, :1], A, Bm[:, :1], C[:, :1], D, h0)
    _, t4 = zip(*mamba_inputs(1, 4, 16, 4, "float32"))
    with pytest.raises(ValueError, match=r"state dim N = 4 not in \(8, 16\)"):
        tmamba._check(*t4)
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        tmamba._check(*(a.half() for a in t[:2]), A,
                      *(a.half() for a in t[3:5]), D, h0)
    with pytest.raises(ValueError, match="dt is torch.bfloat16"):
        tmamba._check(x, dt.bfloat16(), *t[2:])
    with pytest.raises(ValueError, match="A must be torch.float32"):
        tmamba._check(x, dt, A.bfloat16(), *t[3:])
    with pytest.raises(ValueError, match="h0 must be a contiguous"):
        tmamba._check(*t[:6], h0.transpose(1, 2).contiguous())
    with pytest.raises(ValueError, match="last dimension must be contiguous"):
        tmamba._check(x.transpose(1, 2).contiguous().transpose(1, 2),
                      *t[1:])
    with pytest.raises(ValueError, match="do not match"):
        tmamba._check(x, dt[:, :3], *t[2:])
    assert cuda_kernels.launch_counts() == before


# ---------------------------------------------------------------------------
# the Mamba mixer and the MoE layer
# ---------------------------------------------------------------------------

# leaves the inits set to constants (norm scales and D 1, biases 0), which
# would hide a dropped scale, bias or skip term; and dt_bias, whose init
# keeps softplus's argument below 0, where a softplus that returns x above
# a threshold agrees with the reference
PERTURBED = ("scale", "norm_dt", "norm_B", "norm_C", "D", "conv_b",
             "router_bias", "bq", "bk", "bv", "b_up", "b_down", "dt_bias")
FLOAT32_LEAVES = ("router", "router_bias", "A_log", "D", "dt_bias")


def _perturb(path, x, rng, dt_bias=True):
    name = str(path[-1].key) if hasattr(path[-1], "key") else ""
    if name not in PERTURBED or (name == "dt_bias" and not dt_bias):
        return x
    if name in ("scale", "norm_dt", "norm_B", "norm_C", "D"):
        v = 1.0 + 0.2 * rng.standard_normal(x.shape)
    elif name == "dt_bias":
        v = 1.5 * rng.standard_normal(x.shape)
    else:
        v = 0.1 * rng.standard_normal(x.shape)
    return jnp.asarray(v.astype(np.float32)).astype(x.dtype)


def _to_torch(tree, td):
    """A JAX parameter dict as CPU tensors, float32 where the port keeps
    float32 leaves whatever the model's dtype."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _to_torch(v, td)
        else:
            t = torch.from_numpy(np.array(v, np.float32))
            out[k] = t if k in FLOAT32_LEAVES else t.to(td)
    return out


def _cfgs(arch, dtype, **replace):
    j = jconfigs.get_model_config(arch, smoke=True)
    t = tconfigs.get_model_config(arch, smoke=True)
    if dtype == "float32":
        replace.update(dtype="float32", param_dtype="float32")
    return j.replace(**replace), t.replace(**replace)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_mamba_apply_matches_jax(interpret, mode, dtype):
    jcfg, tcfg = _cfgs("jamba-v0.1-52b", dtype)
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(3)
    jp = jax.tree_util.tree_map_with_path(
        lambda p, x: _perturb(p, x, rng),
        jssm.mamba_init(KeyGen(jax.random.PRNGKey(4)), jcfg))
    tp = _to_torch(jp, td)
    assert tp["A_log"].dtype == tp["dt_bias"].dtype == tp["D"].dtype == \
        torch.float32

    s = jcfg.ssm
    B, D = 2, jcfg.d_model
    Din, N = s.expand * D, s.d_state
    S = 1 if mode == "decode" else 9
    jx, tx = both(rng.standard_normal((B, S, D)), dtype)
    jconv, tconv = both(rng.standard_normal((B, s.d_conv - 1, Din)), dtype)
    jh, th = both(0.3 * rng.standard_normal((B, Din, N)), "float32")

    jout, jnc = jssm.mamba_apply(jp, jx, cfg=jcfg, mode=mode,
                                 cache={"conv": jconv, "h": jh})
    cache = {"conv": tconv.clone(), "h": th.clone()}
    tout, tnc = tssm.mamba_apply(tp, tx, cfg=tcfg, mode=mode, cache=cache,
                                 backend="torch")
    assert tnc is cache                       # written in place
    assert tout.dtype == td and tnc["conv"].dtype == td
    np.testing.assert_allclose(f32(tout), f32(jout), **layer_tol(dtype))
    for key in ("h", "conv"):               # conv holds x @ in_proj
        np.testing.assert_allclose(f32(tnc[key]), f32(jnc[key]),
                                   **layer_tol(dtype))


def _moe_cfgs(dtype, router, shared, act):
    jcfg, tcfg = _cfgs("mixtral-8x7b", dtype, act=act)
    moe = dict(router=router, num_shared_experts=shared)
    return (jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe)),
            tcfg.replace(moe=dataclasses.replace(tcfg.moe, **moe)))


@pytest.mark.parametrize("router,shared,act", [
    ("softmax", 0, "swiglu"), ("sigmoid", 0, "swiglu"),
    ("softmax", 1, "swiglu"), ("sigmoid", 1, "swiglu"),
    ("softmax", 1, "gelu")])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_moe_route_and_local_match_jax(dtype, router, shared, act):
    """Routing (ids exactly, weights and the aux loss), the dropless
    expert products with the last expert getting no token, and the whole
    layer with and without a shared expert, SwiGLU and GELU experts."""
    jcfg, tcfg = _moe_cfgs(dtype, router, shared, act)
    jd, td = DTYPES[dtype]
    mo = jcfg.moe
    E = mo.num_experts
    rng = np.random.default_rng(11)
    jp = jax.tree_util.tree_map_with_path(
        lambda p, x: _perturb(p, x, rng),
        jmlp.moe_init(KeyGen(jax.random.PRNGKey(5)), jcfg))
    # positive tokens and a negative router column: expert E-1 is never
    # among the top k, so its group is empty
    router_w = np.array(jp["router"])
    router_w[:, E - 1] = -0.5
    jp["router"] = jnp.asarray(router_w)
    tp = _to_torch(jp, td)
    assert ("shared" in tp) == bool(shared)

    B, S, D = 2, 16, jcfg.d_model
    jx, tx = both(np.abs(rng.standard_normal((B, S, D))), dtype)
    jx2, tx2 = jx.reshape(-1, D), tx.reshape(-1, D)
    jw, jids, jaux = jmlp._route(jp, jx2, mo)
    tw, tids, taux = tmlp._route(tp, tx2, mo)
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    assert not (tids == E - 1).any()
    assert torch.bincount(tids.reshape(-1), minlength=E)[E - 1] == 0
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)

    jout, _ = jmlp._moe_local(jp, jx2, mo, jcfg.act)
    tout, _ = tmlp._moe_local(tp, tx2, mo, tcfg.act)
    assert tout.dtype == td
    np.testing.assert_allclose(f32(tout), f32(jout), **layer_tol(dtype))
    jout, _ = jmlp.moe_apply(jp, jx, cfg=jcfg)
    tout, taux = tmlp.moe_apply(tp, tx, cfg=tcfg)
    assert tout.shape == (B, S, D) and taux.shape == ()
    np.testing.assert_allclose(f32(tout), f32(jout), **layer_tol(dtype))


# ---------------------------------------------------------------------------
# the whole smoke models
# ---------------------------------------------------------------------------

# the smoke Jamba alternates (mamba, dense) and (gqa, moe); at 8 layers
# with the full model's period the stack holds all three of Jamba's kinds:
# (mamba, dense), (mamba, moe) and (gqa, dense) on layer 4
JAMBA_LAYOUTS = {"smoke": {},
                 "8 layers, attention at 4": dict(num_layers=8,
                                                  attn_period=8,
                                                  attn_offset=4)}


def jax_jamba(dtype, layout="smoke", seed=0, wide_dt_bias=None):
    """The JAX smoke Jamba with perturbed constants. A bfloat16 model keeps
    the init's dt_bias unless ``wide_dt_bias``: with it widened, the
    4-expert smoke router's near-ties (probabilities 0.2548 against
    0.2557) flip one token's choice between the packages' bfloat16
    roundings within 8 decode steps, and the flip moves that token's
    logits past any bfloat16 tolerance (the departing ops are silu and
    softplus: see ``test_torch_bf16_silu_and_softplus_round_once``); the
    float32 models carry softplus's upper branch."""
    if wide_dt_bias is None:
        wide_dt_bias = dtype == "float32"
    jcfg, tcfg = _cfgs("jamba-v0.1-52b", dtype, **JAMBA_LAYOUTS[layout])
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: _perturb(p, x, rng, dt_bias=wide_dt_bias), params)
    return jcfg, tcfg, jm, params, jax.tree.map(np.asarray, params)


def _prefill_and_decode(model, jtoks, S, new, B):
    with torch.inference_mode():
        lg, cache = model.prefill(
            {"tokens": torch.from_numpy(jtoks[:, :S]).long()},
            max_len=S + new, backend="torch")
        got = [lg.float().numpy()]
        # the decode steps read the JAX loop's tokens, so one near-tie
        # cannot send the two packages down different continuations
        for i in range(new):
            tok = torch.from_numpy(jtoks[:, S + i].astype(np.int64))
            lg, cache = model.decode_step(
                tok, S + i, cache,
                kv_len=torch.full((B,), S + i + 1, dtype=torch.int32),
                backend="torch")
            got.append(lg.float().numpy())
    return got


def _assert_logits(got, want, dtype):
    assert len(got) == len(want)
    for step, (g, w) in enumerate(zip(got, want)):
        assert np.isfinite(g).all()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {step}")
            assert np.array_equal(g.argmax(-1), w.argmax(-1)), step
        else:
            assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max(), step


@pytest.mark.parametrize("dtype,layout", [
    ("float32", "smoke"), ("bfloat16", "smoke"),
    ("float32", "8 layers, attention at 4")])
def test_torch_smoke_jamba_prefill_and_decode_match_jax(interpret, dtype,
                                                        layout):
    jcfg, tcfg, jm, params, tree = jax_jamba(dtype, layout)
    B, S, new = 2, 12, 8
    prompts = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    jtoks, jlogits = jax_greedy(jm, params, prompts, new)
    model = params_from_jax(tree, tcfg, device="cpu")
    kinds = {tfm.kind_for_layer(tcfg, i) for i in range(tcfg.num_layers)}
    assert len(kinds) == (3 if tcfg.num_layers == 8 else 2)
    _assert_logits(_prefill_and_decode(model, jtoks, S, new, B), jlogits,
                   dtype)


# ---------------------------------------------------------------------------
# bfloat16: where the two packages' roundings part
# ---------------------------------------------------------------------------


def _bf16_ulp(x):
    """One bfloat16 unit in the last place of each value of ``x``."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _silu_by_steps(x):
    """``jax.nn.silu``'s expansion, ``x * (1 / (1 + exp(-x)))``, with every
    step rounded to ``x``'s dtype, as the reference evaluates it."""
    return x * (1 / (1 + torch.exp(-x)))


def _softplus_by_steps(x, other):
    """``jnp.logaddexp(x, other)`` (``jax.nn.softplus`` at ``other = 0``)
    by its steps, ``max(x, other) + log1p(exp(-|x - other|))``, each
    rounded to ``x``'s dtype."""
    return torch.maximum(x, other) + torch.log1p(
        torch.exp(-torch.abs(x - other)))


def test_torch_bf16_silu_and_softplus_round_once():
    """The finding behind the routing flips with dt_bias widened: the
    reference evaluates ``jax.nn.silu`` and ``jax.nn.softplus`` in
    bfloat16 as their expansions, rounding every step (4 and 5 roundings);
    the port's ``F.silu`` and ``torch.logaddexp`` round once. The step
    rounding, written out in PyTorch, gives the reference's bits exactly;
    the port's values are at most two bfloat16 ulps (silu) and one
    (softplus) from the reference's, and closer to the exact function."""
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal(100_000)).astype(np.float32)
    jx, tx = both(x, "bfloat16")
    xb = f32(tx).astype(np.float64)
    exact = {"silu": xb / (1.0 + np.exp(-xb)),
             "softplus": np.logaddexp(xb, 0.0)}
    cases = {"silu": (jax.nn.silu(jx), torch.nn.functional.silu(tx),
                      _silu_by_steps(tx)),
             "softplus": (jax.nn.softplus(jx),
                          torch.logaddexp(tx, tx.new_zeros(())),
                          _softplus_by_steps(tx, tx.new_zeros(())))}
    ulps = {"silu": 2.0, "softplus": 1.0}
    for name, (ref_, port, steps) in cases.items():
        want, got = f32(ref_), f32(port)
        assert np.array_equal(f32(steps), want), name
        differ = got != want
        # 39 % of silu's values and 16 % of softplus's differ here
        assert 0.1 < differ.mean() < 0.5, (name, differ.mean())
        assert (np.abs(got - want) <= ulps[name] * _bf16_ulp(want)).all(), \
            name
        err_port = np.abs(got - exact[name]).mean()
        err_ref = np.abs(want - exact[name]).mean()
        assert err_port < err_ref, (name, err_port, err_ref)


def _jax_block(params, i, prefix, P):
    if i < prefix:
        return params["prefix"][i]
    j = i - prefix
    return jax.tree.map(lambda a: a[j // P], params["body"][j % P])


@pytest.mark.parametrize("layout", list(JAMBA_LAYOUTS))
def test_torch_smoke_jamba_bf16_wide_dt_bias_each_layer_matches_jax(
        interpret, layout):
    """bfloat16 with dt_bias widened, where whole-model logits part once a
    near-tie routing choice flips: each layer on the same input (the
    reference's output of the layer before), the reference's block run
    under ``jax.jit`` as its model runs it, held at the layer bound that
    ``chip_smoke.py`` holds the card's Jamba to: the largest difference
    within 2e-2 of the layer's largest value. The difference is silu's and
    softplus's rounding (one or two bfloat16 ulps per value,
    ``test_torch_bf16_silu_and_softplus_round_once``) carried through one
    layer; a residual sum near 0 can keep an absolute error of an ulp of
    the layer's scale, so the bound is on that scale."""
    from repro.models import transformer as jtfm
    jcfg, tcfg, jm, params, tree = jax_jamba("bfloat16", layout,
                                             wide_dt_bias=True)
    model = params_from_jax(tree, tcfg, device="cpu")
    prefix, kinds, _ = jtfm.layer_layout(jcfg)
    P = len(kinds)                          # layers per scanned period
    B, S = 2, 12
    rng = np.random.default_rng(5)
    jx, tx = both(rng.standard_normal((B, S, jcfg.d_model)), "bfloat16")
    jpos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    tpos = torch.arange(S).expand(B, S)
    for i in range(tcfg.num_layers):
        kind = tfm.kind_for_layer(tcfg, i)
        jfn = jax.jit(lambda p, x, kind=kind: jtfm.block_apply(
            p, x, cfg=jcfg, kind=kind, positions=jpos, mode="train",
            cache=None, kv_len=None)[0])
        jout = jfn(_jax_block(params, i, prefix, P), jx)
        with torch.inference_mode():
            tout = tfm.block_apply(
                model.params.blocks[i], tx, cfg=tcfg, kind=kind,
                positions=tpos, pos0=0, mode="train", cache=None,
                kv_len=None, backend="torch")[0]
        assert tout.dtype == torch.bfloat16
        got, want = f32(tout), f32(jout)
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        assert rel <= 2e-2, (i, kind, rel)      # 0.003 to 0.014 here
        jx = jout
        tx = torch.from_numpy(np.array(f32(jout))).to(torch.bfloat16)


def test_torch_smoke_jamba_bf16_wide_dt_bias_tracks_jax_with_its_rounding(
        interpret, monkeypatch):
    """The whole smoke Jamba in bfloat16 with dt_bias widened: with only
    silu and softplus rounded step by step as the reference rounds them,
    the port's logits stay within the whole-model bound at every decode
    step (as they run the port's silu and softplus, a near-tie routing
    choice flips at step 7). So those two ops are all that the two
    packages' bfloat16 roundings depart by on this model."""
    monkeypatch.setattr(torch.nn.functional, "silu", _silu_by_steps)
    monkeypatch.setattr(torch, "logaddexp", _softplus_by_steps)
    jcfg, tcfg, jm, params, tree = jax_jamba("bfloat16", wide_dt_bias=True)
    B, S, new = 2, 12, 8
    prompts = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    jtoks, jlogits = jax_greedy(jm, params, prompts, new)
    model = params_from_jax(tree, tcfg, device="cpu")
    _assert_logits(_prefill_and_decode(model, jtoks, S, new, B), jlogits,
                   "bfloat16")


def test_torch_generate_gives_the_jax_greedy_tokens_for_jamba(interpret):
    jcfg, tcfg, jm, params, tree = jax_jamba("float32", seed=2)
    prompts = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, size=(3, 10)).astype(np.int32)
    want, _ = jax_greedy(jm, params, prompts, 8)
    model = params_from_jax(tree, tcfg, device="cpu")
    before = cuda_kernels.launch_counts()
    got, summary = serve.generate(arch="jamba-v0.1-52b",
                                  prompt_tokens=prompts, max_new_tokens=8,
                                  model=model, device="cpu", backend="torch")
    assert got.shape == (3, 18) and np.array_equal(got.numpy(), want)
    assert summary["iters"] == 8.0
    assert cuda_kernels.launch_counts() == before


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_smoke_mixtral_prefill_and_decode_match_jax(dtype):
    """GQA with RoPE and a sliding window + dropless MoE on every layer;
    the 60-token prompt and 8 new tokens cross the 64-token window."""
    cfg, jm, params, tree = jax_model("mixtral-8x7b", dtype)
    B, S, new = 2, 60, 8
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    jtoks, jlogits = jax_greedy(jm, params, prompts, new)
    model = params_from_jax(tree, cfg, device="cpu")
    _assert_logits(_prefill_and_decode(model, jtoks, S, new, B), jlogits,
                   dtype)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "mixtral-8x7b"])
def test_torch_convert_places_every_jamba_and_mixtral_leaf_once(arch):
    """Every leaf of the JAX tree lands in exactly one parameter of the
    port's model, with its value: the expert stacks (E, d_in, d_out), and
    the float32 leaves (router, A_log, D, dt_bias) stay float32 in a
    bfloat16 model."""
    jcfg = jconfigs.get_model_config(arch, smoke=True)
    tcfg = tconfigs.get_model_config(arch, smoke=True)
    tree = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(1)))
    model = params_from_jax(tree, tcfg, device="cpu")
    own = dict(model.params.named_parameters())
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    n_leaves = sum(a.shape[0] if path[0].key == "body" else 1
                   for path, a in leaves)
    assert n_leaves == len(own)
    mo = tcfg.moe
    E, Fd, D = mo.num_experts, mo.d_ff_expert, tcfg.d_model
    seen = set()
    for i, blk in enumerate(model.params.blocks):
        body = tree["body"][i % len(tree["body"])]
        period = i // len(tree["body"])
        for name, shape in (("w_gate", (E, D, Fd)), ("w_up", (E, D, Fd)),
                            ("w_down", (E, Fd, D))):
            if "router" not in body["mlp"]:
                continue
            t = own[f"blocks.{i}.mlp.{name}"]
            assert tuple(t.shape) == shape and t.dtype == torch.bfloat16
            assert np.array_equal(
                t.float().numpy(),
                np.asarray(body["mlp"][name][period], np.float32))
            seen.add("moe")
        for sub, name in (("mlp", "router"), ("mixer", "A_log"),
                          ("mixer", "D"), ("mixer", "dt_bias")):
            if name not in body[sub]:
                continue
            t = own[f"blocks.{i}.{sub}.{name}"]
            assert t.dtype == torch.float32, (i, name)
            assert np.array_equal(t.numpy(), body[sub][name][period])
            seen.add(name)
    assert seen == ({"moe", "router", "A_log", "D", "dt_bias"}
                    if arch.startswith("jamba") else {"moe", "router"})


def test_torch_serve_cli_serves_jamba_on_the_cpu_when_asked(monkeypatch,
                                                            capsys):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "jamba-v0.1-52b",
                                     "--batch", "2", "--prompt-len", "6",
                                     "--max-new-tokens", "3",
                                     "--device", "cpu", "--backend", "torch"])
    serve.main()
    assert "generated shape: (2, 9)" in capsys.readouterr().out
