"""The port's MLA serving path (multi-head latent attention, MiniCPM3 and
DeepSeek-V3) held against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs with ``repro.kernels.ops.set_backend("xla")`` (restored
after): the Pallas ``flash_attention`` takes v's head dim from q's, so for
MLA's query/key head dim dn + dr unlike its value head dim dv it is not
the oracle, and ``ops.attention`` documents the XLA path's contract
(``xla_impl.flash_attention_xla``). The models run through
``Model.prefill`` / ``decode_step`` called bare (no mesh bound).

Tolerances: the plain attention 1e-5 in float32; ``mla_apply`` 1e-5 in
float32 and 2e-2 of the largest value in bfloat16, its output and its
cache; the whole smoke models' float32 logits 1e-4 with identical greedy
tokens, bfloat16 5e-2 of the largest logit (``tests/test_torch_model.py``'s).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import xla_impl as jxla
from repro.models import attention as jattn
from repro.models.api import build_model as jbuild
from repro.models.params import KeyGen

from repro_torch import configs as tconfigs
from repro_torch.kernels import cuda_kernels, ops, ref
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tfm
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_jax

from test_torch_model import DTYPES, both, f32, jax_greedy

MLA_ARCHS = ["minicpm3-4b", "deepseek-v3-671b"]


@pytest.fixture
def xla():
    """The JAX package's ops on its XLA path for one test."""
    before = jops.backend()
    jops.set_backend("xla")
    try:
        yield
    finally:
        jops.set_backend(before)


# ---------------------------------------------------------------------------
# K4's plain version at a query/key head dim unlike the value head dim
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # (B, Sq, Sk, H, KV, Dqk, Dv, causal, q_offset)
    (2, 33, 33, 4, 4, 24, 16, True, 0),        # the smoke MLA dims
    (1, 40, 40, 3, 3, 96, 64, True, 0),        # MiniCPM3's dims
    (1, 37, 37, 2, 2, 192, 128, True, 0),      # DeepSeek-V3's dims
    (2, 17, 29, 4, 2, 96, 64, False, 0),       # not causal, group 2
    (1, 16, 48, 4, 4, 96, 64, True, 32),       # q_offset
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_torch_attention_plain_matches_jax_xla_at_unequal_head_dims(xla,
                                                                    case):
    B, Sq, Sk, H, KV, Dqk, Dv, causal, q_off = case
    rng = np.random.default_rng(Dqk + Sq)
    jq, tq = both(rng.standard_normal((B, Sq, H, Dqk)), "float32")
    jk, tk = both(rng.standard_normal((B, Sk, KV, Dqk)), "float32")
    jv, tv = both(rng.standard_normal((B, Sk, KV, Dv)), "float32")
    scale = 0.7 * Dqk ** -0.5
    want = jxla.flash_attention_xla(jq, jk, jv, causal=causal,
                                    q_offset=q_off, scale=scale, block_k=16)
    got = ref.attention(tq, tk, tv, causal=causal, q_offset=q_off,
                        scale=scale)
    assert got.shape == (B, Sq, H, Dv)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)
    # on CPU tensors the wrapper and the op run the plain version
    assert torch.equal(FA.flash_attention(tq, tk, tv, causal=causal,
                                          q_offset=q_off, scale=scale), got)
    assert torch.equal(ops.attention(tq, tk, tv, causal=causal,
                                     q_offset=q_off, scale=scale,
                                     backend="torch"), got)


@pytest.mark.parametrize("Dqk,Dv,fused", [(96, 64, 128), (192, 128, 256)])
def test_torch_k4_checks_take_the_mla_slice_layout(Dqk, Dv, fused):
    """MLA's v is ``kv[..., dn:]`` of the (B, S, H, dn + dv) product: a
    strided view 2 dn bytes into its rows. K4's checks and its bfloat16
    rule take it as it is, with no copy."""
    B, S, H = 2, 64, 4
    q = torch.zeros(B, S, H, Dqk, dtype=torch.bfloat16)
    k = torch.zeros(B, S, H, Dqk, dtype=torch.bfloat16)
    kv = torch.zeros(B, S, H, fused, dtype=torch.bfloat16)
    v = kv[..., fused - Dv:]
    assert not v.is_contiguous()
    assert (v.data_ptr() - kv.data_ptr()) == 2 * (fused - Dv)
    FA._check(q, k, v)
    assert FA.select_kernel(q, k, v) == "flash_fwd_wgmma_kernel"
    assert (Dqk, Dv) in cuda_kernels.HEAD_DIMS
    FA._check(q.float(), k.float(), v.float())


@pytest.mark.parametrize("Dqk,Dv", [(96, 96), (64, 32), (192, 64),
                                    (48, 48), (128, 64)])
def test_torch_k4_checks_refuse_an_unlisted_head_dim_pair(Dqk, Dv):
    q = torch.zeros(1, 8, 2, Dqk)
    v = torch.zeros(1, 8, 2, Dv)
    with pytest.raises(ValueError, match=r"not a built \(Dqk, Dv\) pair"):
        FA._check(q, q, v)


def test_torch_k4_checks_refuse_mismatched_kv():
    q = torch.zeros(1, 8, 2, 96)
    v = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="do not match"):
        FA._check(q, torch.zeros(1, 8, 2, 64), v)     # k's dim is not q's
    with pytest.raises(ValueError, match="do not match"):
        FA._check(q, q, torch.zeros(1, 9, 2, 64))     # v's Sk is not k's


# ---------------------------------------------------------------------------
# the MLA mixer: train, prefill and decode
# ---------------------------------------------------------------------------

PERTURBED = ("scale", "q_norm", "kv_norm", "router_bias")


def _perturb(path, x, rng):
    """Norm scales away from 1 and the router bias away from 0, which
    would hide a dropped scale or bias."""
    name = str(path[-1].key) if hasattr(path[-1], "key") else ""
    if name not in PERTURBED:
        return x
    v = 0.1 * rng.standard_normal(x.shape) if name == "router_bias" else \
        1.0 + 0.2 * rng.standard_normal(x.shape)
    return jnp.asarray(v.astype(np.float32)).astype(x.dtype)


def _cfgs(arch, dtype):
    j = jconfigs.get_model_config(arch, smoke=True)
    t = tconfigs.get_model_config(arch, smoke=True)
    if dtype == "float32":
        j = j.replace(dtype="float32", param_dtype="float32")
        t = t.replace(dtype="float32", param_dtype="float32")
    return j, t


def _mixer_tol(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("arch", MLA_ARCHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_mla_apply_matches_jax(xla, arch, dtype):
    """Train, then a prefill of 9 tokens and 4 decode steps: the output of
    each, and the latent and rope-key caches after the prefill and after
    the last step."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(7)
    jp = jax.tree_util.tree_map_with_path(
        lambda p, x: _perturb(p, x, rng),
        jattn.mla_init(KeyGen(jax.random.PRNGKey(2)), jcfg))
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(td)
          for k, v in jax.tree.map(np.asarray, jp).items()}
    B, S, new, D = 2, 9, 4, jcfg.d_model
    jx, tx = both(rng.standard_normal((B, S, D)), dtype)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos.copy())

    jout, _ = jattn.mla_apply(jp, jx, cfg=jcfg, positions=jpos, mode="train")
    tout, tnc = tattn.mla_apply(tp, tx, cfg=tcfg, positions=tpos,
                                mode="train", backend="torch")
    assert tnc is None and tout.dtype == td
    _mixer_tol(f32(tout), f32(jout), dtype)

    jcache = jattn.mla_init_cache(jcfg, B, S + new)
    tcache = tattn.mla_init_cache(tcfg, B, S + new)
    jout, jcache = jattn.mla_apply(jp, jx, cfg=jcfg, positions=jpos,
                                   mode="prefill", cache=jcache)
    tout, tnc = tattn.mla_apply(tp, tx, cfg=tcfg, positions=tpos,
                                mode="prefill", cache=tcache, pos0=0,
                                backend="torch")
    assert tnc is tcache                       # written in place
    _mixer_tol(f32(tout), f32(jout), dtype)
    for key in ("c", "kr"):
        assert tcache[key].dtype == td
        _mixer_tol(f32(tcache[key]), f32(jcache[key]), dtype)

    for i in range(new):
        jx1, tx1 = both(rng.standard_normal((B, 1, D)), dtype)
        p1 = np.full((B, 1), S + i, np.int32)
        kv_len = np.full((B,), S + i + 1, np.int32)
        jout, jcache = jattn.mla_apply(
            jp, jx1, cfg=jcfg, positions=jnp.asarray(p1), mode="decode",
            cache=jcache, kv_len=jnp.asarray(kv_len))
        tout, _ = tattn.mla_apply(
            tp, tx1, cfg=tcfg, positions=torch.from_numpy(p1),
            mode="decode", cache=tcache, kv_len=torch.from_numpy(kv_len),
            pos0=S + i, backend="torch")
        _mixer_tol(f32(tout), f32(jout), dtype)
    for key in ("c", "kr"):
        _mixer_tol(f32(tcache[key]), f32(jcache[key]), dtype)


def test_torch_mla_decode_masks_by_kv_len(xla):
    """Requests of unequal lengths in one batch: each attends to its own
    ``kv_len`` positions of the latent cache, as in the reference."""
    jcfg, tcfg = _cfgs("minicpm3-4b", "float32")
    rng = np.random.default_rng(11)
    jp = jax.tree_util.tree_map_with_path(
        lambda p, x: _perturb(p, x, rng),
        jattn.mla_init(KeyGen(jax.random.PRNGKey(5)), jcfg))
    tp = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in jax.tree.map(np.asarray, jp).items()}
    B, C, D = 3, 12, jcfg.d_model
    m = jcfg.mla
    jc, tc = both(rng.standard_normal((B, C, m.kv_lora_rank)), "float32")
    jkr, tkr = both(rng.standard_normal((B, C, m.qk_rope_head_dim)),
                    "float32")
    jx, tx = both(rng.standard_normal((B, 1, D)), "float32")
    p1 = np.full((B, 1), 8, np.int32)
    kv_len = np.array([3, 9, 12], np.int32)
    jout, jcache = jattn.mla_apply(
        jp, jx, cfg=jcfg, positions=jnp.asarray(p1), mode="decode",
        cache={"c": jc, "kr": jkr}, kv_len=jnp.asarray(kv_len))
    tcache = {"c": tc.clone(), "kr": tkr.clone()}
    tout, _ = tattn.mla_apply(
        tp, tx, cfg=tcfg, positions=torch.from_numpy(p1), mode="decode",
        cache=tcache, kv_len=torch.from_numpy(kv_len), pos0=8,
        backend="torch")
    np.testing.assert_allclose(f32(tout), f32(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f32(tcache["c"]), f32(jcache["c"]),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the whole smoke models: MiniCPM3 and DeepSeek-V3 (MTP leaves included)
# ---------------------------------------------------------------------------


def jax_mla_model(arch, dtype, seed=0):
    jcfg, tcfg = _cfgs(arch, dtype)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: _perturb(p, x, rng), params)
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


@pytest.mark.parametrize("arch", MLA_ARCHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_smoke_mla_prefill_and_decode_match_jax(xla, arch, dtype):
    jcfg, tcfg, jm, params, tree = jax_mla_model(arch, dtype)
    B, S, new = 2, 12, 8
    prompts = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    jtoks, jlogits = jax_greedy(jm, params, prompts, new)
    model = params_from_jax(tree, tcfg, device="cpu")
    kinds = {tfm.kind_for_layer(tcfg, i) for i in range(tcfg.num_layers)}
    assert {k.mixer for k in kinds} == {"mla"}
    got = _prefill_and_decode(model, jtoks, S, new, B)
    assert len(got) == len(jlogits) == new + 1
    for step, (g, w) in enumerate(zip(got, jlogits)):
        assert np.isfinite(g).all()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {step}")
            assert np.array_equal(g.argmax(-1), w.argmax(-1)), step
        else:
            assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max(), step


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_torch_convert_places_every_mla_and_mtp_leaf_once(arch):
    """Every leaf of the JAX tree lands in exactly one parameter of the
    port's model with its value: the MLA mixer's, DeepSeek-V3's dense
    prefix layer's and its ``mtp`` subtree's (whose block is of the last
    layer's kind, MLA with the MoE)."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    tree = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(1)))
    model = params_from_jax(tree, tcfg, device="cpu")
    own = dict(model.params.named_parameters())
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    n_leaves = sum(a.shape[0] if path[0].key == "body" else 1
                   for path, a in leaves)
    assert n_leaves == len(own)
    names = {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}
    assert {n.split(".")[-1] for n in own
            if n.startswith("blocks.0.mixer.")} == names
    if arch == "deepseek-v3-671b":
        mtp = tree["mtp"]
        assert np.array_equal(own["mtp.proj"].float().numpy(),
                              np.asarray(mtp["proj"], np.float32))
        got = own["mtp.block.mixer.wkv_b"].float().numpy()
        assert np.array_equal(got, np.asarray(mtp["block"]["mixer"]["wkv_b"],
                                              np.float32))
        assert own["mtp.block.mlp.router_bias"].dtype == torch.float32
        assert "mtp.block.mlp.shared.w_gate" in own
        assert "blocks.0.mlp.w_gate" in own           # the dense prefix
        assert "blocks.0.mlp.router" not in own
        assert np.array_equal(
            own["blocks.0.mixer.q_norm"].float().numpy(),
            np.asarray(tree["prefix"][0]["mixer"]["q_norm"], np.float32))
    else:
        assert model.params.mtp is None
    # a leaf of the mtp subtree left out, or one too many, is refused
    if arch == "deepseek-v3-671b":
        short = dict(tree, mtp={k: v for k, v in tree["mtp"].items()
                                if k != "proj"})
        with pytest.raises(ValueError, match="no leaf of the tree filled"):
            params_from_jax(short, tcfg, device="cpu")
    extra = dict(tree, mtp_extra=np.zeros((2,), np.float32))
    with pytest.raises(ValueError, match="has no parameter"):
        params_from_jax(extra, tcfg, device="cpu")


def test_torch_mla_param_count_matches_the_jax_package():
    """The full MiniCPM3 has 4,262,025,728 parameters in both packages
    (counted from the shapes on the meta device, nothing allocated)."""
    cfg = tconfigs.get_model_config("minicpm3-4b")
    with torch.device("meta"):
        p = tfm.init_params(cfg, torch.Generator(), device="meta")
    n = sum(t.numel() for t in p.parameters())
    jshapes = jax.eval_shape(
        lambda k: jbuild(jconfigs.get_model_config("minicpm3-4b")).init(k),
        jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(a.shape))
                    for a in jax.tree_util.tree_leaves(jshapes))
    assert n == 4_262_025_728


def test_torch_generate_gives_the_jax_greedy_tokens_for_minicpm3(xla):
    jcfg, tcfg, jm, params, tree = jax_mla_model("minicpm3-4b", "float32",
                                                 seed=2)
    prompts = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, size=(3, 10)).astype(np.int32)
    want, _ = jax_greedy(jm, params, prompts, 8)
    model = params_from_jax(tree, tcfg, device="cpu")
    before = cuda_kernels.launch_counts()
    got, summary = serve.generate(arch="minicpm3-4b", prompt_tokens=prompts,
                                  max_new_tokens=8, model=model,
                                  device="cpu", backend="torch")
    assert got.shape == (3, 18) and np.array_equal(got.numpy(), want)
    assert summary["iters"] == 8.0
    assert cuda_kernels.launch_counts() == before


def test_torch_generate_serves_minicpm3_on_the_cpu_when_asked():
    """The front door with the arch's name alone: the smoke MiniCPM3 on
    seeded weights, built, filled and decoded on the CPU."""
    prompts = np.random.default_rng(0).integers(0, 512, size=(2, 8))
    a, _ = serve.generate(arch="minicpm3-4b", prompt_tokens=prompts,
                          max_new_tokens=4, device="cpu", backend="torch")
    b, _ = serve.generate(arch="minicpm3-4b", prompt_tokens=prompts,
                          max_new_tokens=4, device="cpu", backend="torch")
    assert a.shape == (2, 12) and torch.equal(a, b)
    model = build_model(tconfigs.get_model_config("minicpm3-4b", smoke=True),
                        device="cpu")
    model.init(0)
    cache = model.init_cache(2, 12)
    assert set(cache[0]["attn"]) == {"c", "kr"}
    assert cache[0]["attn"]["c"].shape == (2, 12, 16)
