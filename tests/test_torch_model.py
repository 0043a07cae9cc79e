"""The port's model substrate held against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs as its own tests run it here: the Pallas kernels in
interpret mode, the model through ``Model.prefill`` / ``decode_step``
called bare (no mesh bound, so the logical-sharding calls are the
identity). Tolerances: attention and RMSNorm 2e-5 in float32 and 2e-2 in
bfloat16 (``tests/test_kernels.py``'s); whole-model float32 logits 1e-4
with identical greedy tokens, bfloat16 5e-2 of the largest logit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import xla_impl as jxla
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.rmsnorm import rmsnorm as jrmsnorm
from repro.models import attention as jattn
from repro.models import rope as jrope
from repro.models.api import build_model as jbuild

from repro_torch import configs as tconfigs
from repro_torch.kernels import chunked, ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models import attention as tattn
from repro_torch.models import rope as trope
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_jax

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)


def both(x, name):
    """The same numpy values as a JAX array and a CPU tensor of dtype
    ``name`` (both round float32 to bfloat16 to nearest even)."""
    jd, td = DTYPES[name]
    x = np.asarray(x, np.float32)
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# configurations: the copies equal the originals field by field
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_torch_config_copies_equal_the_jax_package(arch, smoke):
    j = jconfigs.get_model_config(arch, smoke=smoke)
    t = tconfigs.get_model_config(arch, smoke=smoke)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for f in dataclasses.fields(j):
        jv, tv = getattr(j, f.name), getattr(t, f.name)
        assert type(tv).__name__ == type(jv).__name__, f.name


def test_torch_config_registry_and_shapes_equal_the_jax_package():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.LONG_CONTEXT_ARCHS == jconfigs.LONG_CONTEXT_ARCHS
    assert tconfigs.all_cells() == jconfigs.all_cells()
    for name in ("SHAPES", "SINGLE_POD_MESH", "MULTI_POD_MESH", "SMOKE_MESH"):
        jv, tv = getattr(jconfigs, name), getattr(tconfigs, name)
        if isinstance(jv, tuple):
            assert [dataclasses.asdict(x) for x in tv] == \
                [dataclasses.asdict(x) for x in jv]
        else:
            assert dataclasses.asdict(tv) == dataclasses.asdict(jv)
    for cls in ("OptimizerConfig", "TrainConfig", "PacingConfig"):
        assert dataclasses.asdict(getattr(tconfigs, cls)()) == \
            dataclasses.asdict(getattr(jconfigs, cls)())
    assert tconfigs.get_optimized_config("qwen2-7b") == \
        tconfigs.get_model_config("qwen2-7b").replace(pad_heads_to=16)


# ---------------------------------------------------------------------------
# K4: the plain version (what the wrapper runs on the CPU) against the
# Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # (B, Sq, Sk, H, KV, D, causal, window, q_offset)
    (2, 64, 64, 4, 2, 32, True, 0, 0),         # group 2
    (1, 40, 40, 3, 3, 32, True, 0, 0),         # group 1, ragged S
    (1, 37, 37, 7, 1, 16, True, 0, 0),         # group 7, ragged S
    (1, 64, 64, 2, 2, 32, True, 16, 0),        # sliding window
    (1, 16, 64, 4, 2, 32, True, 0, 48),        # q_offset (chunked prefill)
    (2, 33, 50, 4, 1, 32, False, 0, 0),        # not causal, ragged
    (1, 48, 48, 14, 2, 16, True, 24, 0),       # group 7 + window
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_attention_plain_matches_jax_flash_kernel(case, dtype):
    B, Sq, Sk, H, KV, D, causal, window, q_off = case
    rng = np.random.default_rng(Sq * 7 + H)
    jq, tq = both(rng.standard_normal((B, Sq, H, D)), dtype)
    jk, tk = both(rng.standard_normal((B, Sk, KV, D)), dtype)
    jv, tv = both(rng.standard_normal((B, Sk, KV, D)), dtype)
    want = jflash(jq, jk, jv, causal=causal, window=window, q_offset=q_off,
                  block_q=32, block_k=32, interpret=True)
    got = flash_attention(tq, tk, tv, causal=causal, window=window,
                          q_offset=q_off)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))
    via_ops = ops.attention(tq, tk, tv, causal=causal, window=window,
                            q_offset=q_off, backend="torch")
    assert torch.equal(via_ops, got)


@pytest.mark.parametrize("shape", [(3, 5, 128), (7, 96), (1, 3584)],
                         ids=str)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_rmsnorm_plain_matches_jax_rmsnorm_kernel(shape, dtype):
    rng = np.random.default_rng(len(shape) + shape[-1])
    jx, tx = both(rng.standard_normal(shape) * 3.0, dtype)
    js, ts = both(1.0 + 0.3 * rng.standard_normal(shape[-1]), dtype)
    want = jrmsnorm(jx, js, 1e-5, interpret=True)
    got = rmsnorm(tx, ts, 1e-5)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))
    assert torch.equal(ops.rmsnorm(tx, ts, 1e-5, backend="torch"), got)


# ---------------------------------------------------------------------------
# the modules around the kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_decode_attention_matches_jax(window, dtype):
    B, S, H, KV, D = 3, 24, 6, 2, 32
    rng = np.random.default_rng(window)
    jq, tq = both(rng.standard_normal((B, 1, H, D)), dtype)
    jk, tk = both(rng.standard_normal((B, S, KV, D)), dtype)
    jv, tv = both(rng.standard_normal((B, S, KV, D)), dtype)
    kv_len = np.array([5, 24, 17], np.int32)
    want = jxla.decode_attention_xla(jq, jk, jv, kv_len=jnp.asarray(kv_len),
                                     window=window)
    got = chunked.decode_attention(tq, tk, tv,
                                   kv_len=torch.from_numpy(kv_len),
                                   window=window)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("per_batch", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_apply_rope_matches_jax(per_batch, dtype):
    B, S, H, D = 2, 9, 3, 32
    rng = np.random.default_rng(3)
    jx, tx = both(rng.standard_normal((B, S, H, D)), dtype)
    pos = np.arange(S, dtype=np.int32) + 1000
    if per_batch:
        pos = np.stack([pos, pos + 77])
    want = jrope.apply_rope(jx, jnp.asarray(pos), 1_000_000.0)
    got = trope.apply_rope(tx, torch.from_numpy(pos), 1_000_000.0)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))
    jp = np.asarray(jrope.positions_for(B, S, 5))
    assert np.array_equal(trope.positions_for(B, S, 5).numpy(), jp)


@pytest.mark.parametrize("S,C,pos", [(4, 16, 0), (1, 16, 7), (3, 8, 6),
                                     (10, 8, 3), (8, 8, 0)])
def test_torch_ring_write_matches_jax(S, C, pos):
    rng = np.random.default_rng(S * C + pos)
    cache = rng.standard_normal((2, C, 2, 4)).astype(np.float32)
    new = rng.standard_normal((2, S, 2, 4)).astype(np.float32)
    want = np.asarray(jattn._ring_write(jnp.asarray(cache), jnp.asarray(new),
                                        pos))
    tcache = torch.from_numpy(cache.copy())
    got = tattn._ring_write(tcache, torch.from_numpy(new), pos)
    assert got is tcache                       # written in place
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the whole smoke model: prefill + decode against the JAX package's
# ---------------------------------------------------------------------------


def jax_model(arch, dtype, seed=0):
    """The JAX smoke model in ``dtype`` with its QKV, MLP and LayerNorm
    biases and norm scales set to random non-zero values (the init makes
    them 0 and 1, which would hide a dropped bias or scale), as a numpy
    tree too."""
    cfg = jconfigs.get_model_config(arch, smoke=True)
    if dtype == "float32":
        cfg = cfg.replace(dtype="float32", param_dtype="float32")
    jm = jbuild(cfg)
    params = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)

    def perturb(path, x):
        name = str(path[-1].key) if hasattr(path[-1], "key") else ""
        if name in ("bq", "bk", "bv", "b_up", "b_down", "bias"):
            v = 0.1 * rng.standard_normal(x.shape)
        elif name == "scale":
            v = 1.0 + 0.2 * rng.standard_normal(x.shape)
        else:
            return x
        return jnp.asarray(v.astype(np.float32)).astype(x.dtype)

    params = jax.tree_util.tree_map_with_path(perturb, params)
    tree = jax.tree.map(np.asarray, params)
    return cfg, jm, params, tree


def jax_greedy(jm, params, prompts, new_tokens):
    """The reference's serving loop (``launch/serve.py:62-78``) on
    ``Model.prefill`` / ``decode_step`` called bare. Returns the tokens
    and the logits of the prefill and of every decode step."""
    B, S = prompts.shape
    prefill = jax.jit(lambda p, b: jm.prefill(p, b, max_len=S + new_tokens))
    decode = jax.jit(lambda p, t, pos, kv, c: jm.decode_step(
        p, t, pos, c, kv_len=kv))
    logits, cache = prefill(params, {"tokens": jnp.asarray(prompts)})
    seen = [np.asarray(logits.astype(jnp.float32))]
    out = [np.asarray(prompts)]
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for i in range(new_tokens):
        out.append(np.asarray(tok)[:, None])
        kv_len = jnp.full((B,), S + i + 1, jnp.int32)
        lg, cache = decode(params, tok, jnp.asarray(S + i, jnp.int32),
                           kv_len, cache)
        seen.append(np.asarray(lg.astype(jnp.float32)))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    return np.concatenate(out, axis=1), seen


MODEL_CASES = [("qwen2-7b", "float32"), ("qwen2-7b", "bfloat16"),
               ("starcoder2-15b", "float32")]


@pytest.mark.parametrize("arch,dtype", MODEL_CASES)
def test_torch_smoke_model_prefill_and_decode_match_jax(arch, dtype):
    cfg, jm, params, tree = jax_model(arch, dtype)
    B, S, new = 2, 12, 8
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    jtoks, jlogits = jax_greedy(jm, params, prompts, new)

    model = params_from_jax(tree, cfg, device="cpu")
    assert model.params.blocks[1].mixer["bq"].abs().max() > 0
    with torch.inference_mode():
        lg, cache = model.prefill({"tokens": torch.from_numpy(prompts).long()},
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
    assert len(got) == len(jlogits) == new + 1
    for step, (g, w) in enumerate(zip(got, jlogits)):
        assert np.isfinite(g).all()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {step}")
            assert np.array_equal(g.argmax(-1), w.argmax(-1)), step
        else:
            assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max(), step


def test_torch_convert_refuses_a_leftover_or_missing_leaf():
    cfg, _, _, tree = jax_model("qwen2-7b", "float32")
    extra = dict(tree, pos_embed=np.zeros((4, cfg.d_model), np.float32))
    with pytest.raises(ValueError, match="has no parameter"):
        params_from_jax(extra, cfg, device="cpu")
    short = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="no leaf of the tree filled"):
        params_from_jax(short, cfg, device="cpu")


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_torch_build_model_takes_the_ported_families(arch):
    """All ten configurations of the registry, at smoke size."""
    cfg = tconfigs.get_model_config(arch, smoke=True)
    model = build_model(cfg, device="cpu")
    p = model.init(0)
    assert len(p.blocks) == cfg.num_layers
    assert p.embed.shape == (cfg.padded_vocab(), cfg.d_model)
    assert all(not t.requires_grad for t in p.parameters())
    n_enc = len(p.enc_blocks) if p.enc_blocks is not None else 0
    assert n_enc == (cfg.num_encoder_layers if cfg.is_encoder_decoder
                     else 0)
