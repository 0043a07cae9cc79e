"""The port's vision-language serving path (Qwen2-VL: M-RoPE and the vision
stub) held against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs with ``repro.kernels.ops.set_backend("xla")`` (a fixture,
restored after), or ``"interpret"`` where the Pallas attention kernel is
held; its model through ``Model.prefill`` / ``decode_step`` called bare
(no mesh bound). The vision prefill's batch is built as the smoke script
builds it: an image block of patches per request at a seeded offset, its
(t, h, w) positions (s0, s0 + row, s0 + col), the text after it going on
from the block's largest position + 1, so the three M-RoPE streams
differ.

Tolerances: ``apply_mrope`` 1e-6 relative in float32; ``gqa_apply`` and
the whole smoke model's logits 1e-5 (``rtol`` and ``atol``) in float32
with identical greedy tokens, 2e-2 of the largest value in bfloat16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import rope as jrope
from repro.models.params import KeyGen

from repro_torch import configs as tconfigs
from repro_torch.kernels import cuda_kernels
from repro_torch.models import attention as tattn
from repro_torch.models import rope as trope
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import params_from_jax

from test_torch_mla import xla  # noqa: F401  (a fixture)
from test_torch_model import DTYPES, both, f32, jax_model

ARCH = "qwen2-vl-2b"


@pytest.fixture(params=["xla", "interpret"])
def jax_backend(request):
    """The JAX package's ops on one backend for one test."""
    before = jops.backend()
    jops.set_backend(request.param)
    try:
        yield request.param
    finally:
        jops.set_backend(before)


def close(got, want, dtype):
    """float32 within 1e-5 (``rtol`` and ``atol``); bfloat16 within 2e-2
    of the largest value."""
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def vision_batch(B, S, n_side, seed):
    """Tokens, one n_side x n_side block of patch embeddings per request
    at a seeded offset, and its M-RoPE positions, as numpy: text at
    t = h = w = index; patch (row, col) of a block starting at s0 at
    (s0, s0 + row, s0 + col); the text after the block from its largest
    position + 1. Patch positions are distinct within a request."""
    rng = np.random.default_rng(seed)
    n = n_side * n_side
    tokens = rng.integers(0, 512, size=(B, S)).astype(np.int32)
    starts = rng.integers(0, S - n + 1, size=B)
    pp = np.stack([s0 + np.arange(n) for s0 in starts]).astype(np.int32)
    mrope = np.empty((3, B, S), np.int32)
    for b, s0 in enumerate(starts):
        text = np.arange(S)
        mrope[:, b] = text
        row, col = np.divmod(np.arange(n), n_side)
        mrope[0, b, s0:s0 + n] = s0
        mrope[1, b, s0:s0 + n] = s0 + row
        mrope[2, b, s0:s0 + n] = s0 + col
        after = np.arange(s0 + n, S)
        mrope[:, b, s0 + n:] = s0 + n_side + (after - (s0 + n))
    return tokens, pp, mrope, rng


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [8, 32, 128])
@pytest.mark.parametrize("streams", ["equal", "distinct"])
def test_torch_apply_mrope_matches_jax(D, streams):
    """Equal streams give ``apply_rope`` in both packages; three distinct
    streams (each section rotated by its own) give the JAX package's
    ``apply_mrope``, float32 within 1e-6 relative."""
    rng = np.random.default_rng(D)
    B, S, H = 2, 11, 3
    x = rng.standard_normal((B, S, H, D)).astype(np.float32)
    if streams == "equal":
        pos = np.broadcast_to(rng.integers(0, 5000, size=(B, S)),
                              (3, B, S)).astype(np.int32)
    else:
        pos = rng.integers(0, 5000, size=(3, B, S)).astype(np.int32)
    got = trope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                            1e6).numpy()
    want = np.asarray(jrope.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                        1e6))
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    if streams == "equal":
        rope = trope.apply_rope(torch.from_numpy(x),
                                torch.from_numpy(pos[0].copy()), 1e6).numpy()
        np.testing.assert_allclose(got, rope, rtol=1e-6,
                                   atol=1e-6 * np.abs(rope).max())
    else:
        # the sections really differ: no single stream gives the result
        for i in range(3):
            one = trope.apply_rope(torch.from_numpy(x),
                                   torch.from_numpy(pos[i].copy()),
                                   1e6).numpy()
            assert np.abs(got - one).max() > 1e-3


def test_torch_apply_mrope_takes_the_sections_given():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 5, 2, 16)).astype(np.float32)
    pos = rng.integers(0, 100, size=(3, 1, 5)).astype(np.int32)
    got = trope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                            sections=(2, 2, 4)).numpy()
    want = np.asarray(jrope.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                        sections=(2, 2, 4)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="do not sum to 8"):
        trope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                          sections=(2, 2, 2))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_gqa_apply_with_mrope_matches_jax(jax_backend, dtype):
    """Qwen2-VL's mixer (QKV bias, group 2) on M-RoPE positions: train,
    then a prefill that fills the cache with the rotated keys, then a
    decode step at plain RoPE position S; the output of each and the
    cache."""
    jcfg = jconfigs.get_model_config(ARCH, smoke=True)
    tcfg = tconfigs.get_model_config(ARCH, smoke=True)
    if dtype == "float32":
        jcfg = jcfg.replace(dtype="float32", param_dtype="float32")
        tcfg = tcfg.replace(dtype="float32", param_dtype="float32")
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(4)
    jp = jattn.gqa_init(KeyGen(jax.random.PRNGKey(2)), jcfg)
    jp = {k: jnp.asarray((0.1 * rng.standard_normal(v.shape) if k[0] == "b"
                          else np.asarray(v, np.float32)).astype(np.float32)
                         ).astype(jd) for k, v in jp.items()}
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(td)
          for k, v in jp.items()}
    B, S = 2, 24
    _, _, mrope, _ = vision_batch(B, S, 3, seed=9)
    jx, tx = both(rng.standard_normal((B, S, jcfg.d_model)), dtype)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos.copy())
    jm, tm = jnp.asarray(mrope), torch.from_numpy(mrope)

    jout, _ = jattn.gqa_apply(jp, jx, cfg=jcfg, positions=jpos,
                              mode="train", mrope_positions=jm)
    tout, _ = tattn.gqa_apply(tp, tx, cfg=tcfg, positions=tpos,
                              mode="train", mrope_positions=tm,
                              backend="torch")
    close(f32(tout), f32(jout), dtype)
    # without mrope_positions the mixer takes plain RoPE, as the reference
    plain, _ = tattn.gqa_apply(tp, tx, cfg=tcfg, positions=tpos,
                               mode="train", backend="torch")
    assert np.abs(f32(plain) - f32(tout)).max() > 1e-3

    jc = jattn.gqa_init_cache(jcfg, B, S + 1)
    tc = tattn.gqa_init_cache(tcfg, B, S + 1)
    jout, jc = jattn.gqa_apply(jp, jx, cfg=jcfg, positions=jpos,
                               mode="prefill", cache=jc, mrope_positions=jm)
    tout, _ = tattn.gqa_apply(tp, tx, cfg=tcfg, positions=tpos,
                              mode="prefill", cache=tc, pos0=0,
                              mrope_positions=tm, backend="torch")
    close(f32(tout), f32(jout), dtype)
    close(f32(tc["k"]), f32(jc["k"]), dtype)
    jx1, tx1 = both(rng.standard_normal((B, 1, jcfg.d_model)), dtype)
    p1 = np.full((B, 1), S, np.int32)
    kv = np.full((B,), S + 1, np.int32)
    jout, jc = jattn.gqa_apply(jp, jx1, cfg=jcfg, positions=jnp.asarray(p1),
                               mode="decode", cache=jc,
                               kv_len=jnp.asarray(kv))
    tout, _ = tattn.gqa_apply(tp, tx1, cfg=tcfg,
                              positions=torch.from_numpy(p1), mode="decode",
                              cache=tc, kv_len=torch.from_numpy(kv), pos0=S,
                              backend="torch")
    close(f32(tout), f32(jout), dtype)
    close(f32(tc["k"]), f32(jc["k"]), dtype)


# ---------------------------------------------------------------------------
# the vision stub: patches scattered into the token stream
# ---------------------------------------------------------------------------


SCATTER_CASES = {
    "in range": [[0, 3, 5], [7, 1, 2]],
    # a position >= S and one < -S are dropped; -1 is S - 1 and -S is 0
    "out of range": [[8, 9, 100], [-9, -20, 2]],
    "negative in range": [[-1, -8, 4], [-3, 0, 6]],
}


@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_torch_scatter_patches_matches_jax(case):
    """``scatter_patches`` against the reference's ``x.at[bidx, pp].set``
    (``transformer.forward``), positions distinct within a row: in range,
    out of range (dropped by both, no device-side assert here) and
    negative (counted from the end by both)."""
    B, S, D = 2, 8, 4
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    pp = np.asarray(SCATTER_CASES[case], np.int32)
    pe = rng.standard_normal((B, pp.shape[1], D)).astype(np.float32)
    bidx = jnp.arange(B, dtype=jnp.int32)[:, None]
    want = np.asarray(jnp.asarray(x).at[bidx, jnp.asarray(pp)].set(
        jnp.asarray(pe)))
    tx = torch.from_numpy(x)
    got = tfm.scatter_patches(tx, torch.from_numpy(pe),
                              torch.from_numpy(pp)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(tx.numpy(), x)         # the input is not written
    if case == "out of range":
        # row 0 keeps its tokens; row 1 gets its one valid patch only
        assert np.array_equal(got[0], x[0])
        assert np.array_equal(got[1, 2], pe[1, 2])
        assert np.array_equal(np.delete(got[1], 2, 0), np.delete(x[1], 2, 0))


# ---------------------------------------------------------------------------
# the whole smoke model: a vision prefill, then greedy decode
# ---------------------------------------------------------------------------


def jax_vision_greedy(jm, params, batch, new_tokens):
    """The reference's serving loop after a vision prefill, on
    ``Model.prefill`` / ``decode_step`` called bare: decode at plain RoPE
    position S + i, as its ``decode_step`` does. Returns the tokens and
    the logits of the prefill and of every decode step."""
    B, S = batch["tokens"].shape
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, cache = jax.jit(lambda p, b: jm.prefill(
        p, b, max_len=S + new_tokens))(params, jb)
    decode = jax.jit(lambda p, t, pos, kv, c: jm.decode_step(
        p, t, pos, c, kv_len=kv))
    seen = [np.asarray(logits.astype(jnp.float32))]
    out = [np.asarray(batch["tokens"])]
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for i in range(new_tokens):
        out.append(np.asarray(tok)[:, None])
        lg, cache = decode(params, tok, jnp.asarray(S + i, jnp.int32),
                           jnp.full((B,), S + i + 1, jnp.int32), cache)
        seen.append(np.asarray(lg.astype(jnp.float32)))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    return np.concatenate(out, axis=1), seen


def torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            batch.items()}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_smoke_vlm_prefill_and_decode_match_jax(xla, dtype):
    """A vision prefill (patch embeddings scattered in, M-RoPE positions
    whose streams differ) and 8 greedy decode steps, the decode steps
    reading the JAX loop's tokens: logits at every step."""
    cfg, jm, params, tree = jax_model(ARCH, dtype)
    B, S, new = 2, 24, 8
    tokens, pp, mrope, rng = vision_batch(B, S, 3, seed=5)
    pe = (rng.standard_normal((B, pp.shape[1], cfg.d_model)) * 0.02
          ).astype(np.float32)
    batch = {"tokens": tokens, "patch_embeds": pe, "patch_positions": pp,
             "mrope_positions": mrope}
    jtoks, jlogits = jax_vision_greedy(jm, params, batch, new)

    model = params_from_jax(tree, cfg, device="cpu")
    assert model.params.blocks[1].mixer["bq"].abs().max() > 0
    tb = torch_batch(batch)
    tb["tokens"] = tb["tokens"].long()
    with torch.inference_mode():
        lg, cache = model.prefill(tb, max_len=S + new, backend="torch")
        got = [lg.float().numpy()]
        for i in range(new):
            tok = torch.from_numpy(jtoks[:, S + i].astype(np.int64))
            lg, cache = model.decode_step(
                tok, S + i, cache,
                kv_len=torch.full((B,), S + i + 1, dtype=torch.int32),
                backend="torch")
            got.append(lg.float().numpy())
        # the patches and the M-RoPE positions both reach the logits
        for drop in ("patch_embeds", "mrope_positions"):
            b2 = {k: v for k, v in tb.items()
                  if k != drop and not (drop == "patch_embeds"
                                        and k == "patch_positions")}
            lg2, _ = model.prefill(b2, max_len=S + new, backend="torch")
            assert np.abs(lg2.float().numpy() - got[0]).max() > 1e-4, drop
    assert len(got) == len(jlogits) == new + 1
    for step, (g, w) in enumerate(zip(got, jlogits)):
        assert np.isfinite(g).all()
        close(g, w, dtype)
        if dtype == "float32":
            assert np.array_equal(g.argmax(-1), w.argmax(-1)), step


def test_torch_convert_places_every_vlm_leaf_once():
    cfg, _, _, tree = jax_model(ARCH, "bfloat16", seed=2)
    model = params_from_jax(tree, cfg, device="cpu")
    own = dict(model.params.named_parameters())
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert sum(a.shape[0] if path[0].key == "body" else 1
               for path, a in leaves) == len(own)
    assert np.array_equal(
        own["blocks.1.mixer.bk"].float().numpy(),
        np.asarray(tree["body"][0]["mixer"]["bk"][1], np.float32))
    assert model.params.pos_embed is None and model.params.enc_blocks is None


def test_torch_vlm_generate_serves_text_on_the_cpu_when_asked():
    """``generate`` takes no patches, as the reference's: the smoke
    Qwen2-VL on seeded weights serves text prompts (plain RoPE, which is
    M-RoPE with three equal streams), launching no kernel."""
    from repro_torch.launch import serve
    prompts = np.random.default_rng(1).integers(0, 512, size=(2, 7))
    before = cuda_kernels.launch_counts()
    a, summary = serve.generate(arch=ARCH, prompt_tokens=prompts,
                                max_new_tokens=5, seed=3, device="cpu",
                                backend="torch")
    assert a.shape == (2, 12) and summary["iters"] == 5.0
    assert cuda_kernels.launch_counts() == before
