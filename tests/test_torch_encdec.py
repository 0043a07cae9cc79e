"""The port's encoder-decoder serving path (SeamlessM4T: learned positions,
the non-causal encoder, cross attention, LayerNorm with bias) held against
the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
frame embeddings are a seeded normal x 0.02, as the reference's serving
CLI makes them. The JAX side runs with
``repro.kernels.ops.set_backend("xla")`` (a fixture, restored after), or
``"interpret"`` where the Pallas attention kernel is held; its model
bare: ``transformer.encode``, then ``Model.prefill`` and ``decode_step``
with ``memory`` (its ``generate`` binds a mesh, which fails on this tree
under jax 0.9.0: ``test_train_integration.py::test_generate_encdec``).

Tolerances: ``cross_apply``, ``encode`` and the whole smoke model's
logits 1e-5 (``rtol`` and ``atol``) in float32 with identical greedy
tokens, 2e-2 of the largest value in bfloat16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.models.params import KeyGen

from repro_torch import configs as tconfigs
from repro_torch.kernels import cuda_kernels
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tfm
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_jax

from test_torch_mla import xla  # noqa: F401  (a fixture)
from test_torch_model import DTYPES, both, f32, jax_model
from test_torch_vlm import close, jax_backend  # noqa: F401  (a fixture)

ARCH = "seamless-m4t-large-v2"


def enc_embeds(B, S, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, D)) * 0.02).astype(np.float32)


# ---------------------------------------------------------------------------
# cross attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("Sq,Sk", [(12, 20), (20, 7), (1, 20)],
                         ids=["Sq<Sk", "Sq>Sk", "Sq=1"])
def test_torch_cross_apply_matches_jax(jax_backend, dtype, Sq, Sk):
    """Decoder queries over encoder memory, non-causal, no rope: at
    Sq != Sk and at Sq = 1 (the decode step's), with a QKV bias."""
    jcfg = jconfigs.get_model_config(ARCH, smoke=True).replace(
        qkv_bias=True)
    tcfg = tconfigs.get_model_config(ARCH, smoke=True).replace(
        qkv_bias=True)
    if dtype == "float32":
        jcfg = jcfg.replace(dtype="float32", param_dtype="float32")
        tcfg = tcfg.replace(dtype="float32", param_dtype="float32")
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(Sq * 31 + Sk)
    jp = jattn.cross_init(KeyGen(jax.random.PRNGKey(1)), jcfg)
    jp = {k: jnp.asarray((0.1 * rng.standard_normal(v.shape) if k[0] == "b"
                          else np.asarray(v, np.float32)).astype(np.float32)
                         ).astype(jd) for k, v in jp.items()}
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(td)
          for k, v in jp.items()}
    B, D = 2, jcfg.d_model
    jx, tx = both(rng.standard_normal((B, Sq, D)), dtype)
    jm, tm = both(rng.standard_normal((B, Sk, D)), dtype)
    want = jattn.cross_apply(jp, jx, jm, cfg=jcfg)
    got = tattn.cross_apply(tp, tx, tm, cfg=tcfg, backend="torch")
    assert got.shape == (B, Sq, D) and got.dtype == td
    close(f32(got), f32(want), dtype)


# ---------------------------------------------------------------------------
# the encoder and the whole smoke model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_encode_matches_jax(jax_backend, dtype):
    cfg, jm, params, tree = jax_model(ARCH, dtype)
    emb = enc_embeds(2, 16, cfg.d_model, seed=3)
    want = jtfm.encode(params, cfg, jnp.asarray(emb))
    model = params_from_jax(tree, cfg, device="cpu")
    assert model.params.enc_blocks[0].norm1["bias"].abs().max() > 0
    with torch.inference_mode():
        got = model.encode(torch.from_numpy(emb), backend="torch")
    assert got.shape == (2, 16, cfg.d_model)
    assert got.dtype == DTYPES[dtype][1]
    close(f32(got), f32(want), dtype)


def jax_encdec_greedy(jm, params, cfg, prompts, emb, new_tokens):
    """The reference's serving loop (``launch/serve.py:52-78``) on
    ``transformer.encode``, ``Model.prefill`` and ``decode_step`` called
    bare. Returns the tokens and the logits of the prefill and of every
    decode step."""
    B, S = prompts.shape
    memory = jax.jit(lambda p, e: jtfm.encode(p, cfg, e))(
        params, jnp.asarray(emb))
    logits, cache = jax.jit(lambda p, b: jm.prefill(
        p, b, max_len=S + new_tokens))(
        params, {"tokens": jnp.asarray(prompts), "memory": memory})
    decode = jax.jit(lambda p, t, pos, kv, c, m: jm.decode_step(
        p, t, pos, c, kv_len=kv, memory=m))
    seen = [np.asarray(logits.astype(jnp.float32))]
    out = [np.asarray(prompts)]
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for i in range(new_tokens):
        out.append(np.asarray(tok)[:, None])
        lg, cache = decode(params, tok, jnp.asarray(S + i, jnp.int32),
                           jnp.full((B,), S + i + 1, jnp.int32), cache,
                           memory)
        seen.append(np.asarray(lg.astype(jnp.float32)))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    return np.concatenate(out, axis=1), seen


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_smoke_encdec_prefill_and_decode_match_jax(xla, dtype):
    """An encoder prefill (the memory in the prefill batch) and 8 greedy
    decode steps over the same memory, the decode steps reading the JAX
    loop's tokens: logits at every step."""
    cfg, jm, params, tree = jax_model(ARCH, dtype)
    B, S, Se, new = 2, 12, 16, 8
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    emb = enc_embeds(B, Se, cfg.d_model, seed=6)
    jtoks, jlogits = jax_encdec_greedy(jm, params, cfg, prompts, emb, new)

    model = params_from_jax(tree, cfg, device="cpu")
    with torch.inference_mode():
        memory = model.encode(torch.from_numpy(emb), backend="torch")
        lg, cache = model.prefill(
            {"tokens": torch.from_numpy(prompts).long(), "memory": memory},
            max_len=S + new, backend="torch")
        got = [lg.float().numpy()]
        for i in range(new):
            tok = torch.from_numpy(jtoks[:, S + i].astype(np.int64))
            lg, cache = model.decode_step(
                tok, S + i, cache,
                kv_len=torch.full((B,), S + i + 1, dtype=torch.int32),
                memory=memory, backend="torch")
            got.append(lg.float().numpy())
        # a batch with enc_embeds is encoded inside the forward
        lg2, _ = model.prefill(
            {"tokens": torch.from_numpy(prompts).long(),
             "enc_embeds": torch.from_numpy(emb)},
            max_len=S + new, backend="torch")
    assert torch.equal(lg2, torch.from_numpy(got[0]).to(lg2.dtype))
    assert len(got) == len(jlogits) == new + 1
    for step, (g, w) in enumerate(zip(got, jlogits)):
        assert np.isfinite(g).all()
        close(g, w, dtype)
        if dtype == "float32":
            assert np.array_equal(g.argmax(-1), w.argmax(-1)), step


def test_torch_convert_places_every_encdec_leaf_once():
    """Every leaf lands in exactly one parameter with its value: the
    encoder's one stacked slot (leading axis ``num_encoder_layers``),
    ``pos_embed``, ``enc_norm`` and the decoder's ``cross_norm`` /
    ``cross`` leaves; a leftover or missing one is refused."""
    cfg, _, _, tree = jax_model(ARCH, "bfloat16", seed=2)
    model = params_from_jax(tree, cfg, device="cpu")
    own = dict(model.params.named_parameters())
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert sum(a.shape[0] if path[0].key in ("body", "enc_body") else 1
               for path, a in leaves) == len(own)
    assert len(model.params.enc_blocks) == cfg.num_encoder_layers
    for name, want in (
            ("enc_blocks.1.mixer.wk", tree["enc_body"][0]["mixer"]["wk"][1]),
            ("blocks.1.cross.wv", tree["body"][0]["cross"]["wv"][1]),
            ("blocks.0.cross_norm.bias",
             tree["body"][0]["cross_norm"]["bias"][0]),
            ("enc_norm.bias", tree["enc_norm"]["bias"]),
            ("pos_embed", tree["pos_embed"])):
        assert np.array_equal(own[name].float().numpy(),
                              np.asarray(want, np.float32)), name
    assert "enc_blocks.0.cross.wq" not in own
    short = dict(tree, enc_norm={"scale": tree["enc_norm"]["scale"]})
    with pytest.raises(ValueError, match="no leaf of the tree filled"):
        params_from_jax(short, cfg, device="cpu")
    body = [dict(tree["enc_body"][0])]
    body[0]["mixer"] = dict(body[0]["mixer"],
                            wq=body[0]["mixer"]["wq"][:1])
    with pytest.raises(ValueError, match="leading axis 1"):
        params_from_jax(dict(tree, enc_body=body), cfg, device="cpu")


def test_torch_encdec_param_count_matches_the_jax_package():
    """The full SeamlessM4T-large-v2 has 1,649,135,616 parameters in both
    packages, and Qwen2-VL-2B 1,777,088,000 (counted from the shapes on
    the meta device, nothing allocated)."""
    for arch, want in ((ARCH, 1_649_135_616), ("qwen2-vl-2b", 1_777_088_000)):
        cfg = tconfigs.get_model_config(arch)
        with torch.device("meta"):
            p = tfm.init_params(cfg, torch.Generator(), device="meta")
        n = sum(t.numel() for t in p.parameters())
        jshapes = jax.eval_shape(
            lambda k: jtfm.init_params(jconfigs.get_model_config(arch), k),
            jax.random.PRNGKey(0))
        assert n == sum(int(np.prod(a.shape))
                        for a in jax.tree_util.tree_leaves(jshapes)) == want


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_torch_generate_gives_the_jax_greedy_tokens_for_seamless(xla):
    cfg, jm, params, tree = jax_model(ARCH, "float32", seed=3)
    prompts = np.random.default_rng(11).integers(
        0, cfg.vocab_size, size=(3, 10)).astype(np.int32)
    emb = enc_embeds(3, 14, cfg.d_model, seed=12)
    want, _ = jax_encdec_greedy(jm, params, cfg, prompts, emb, 8)
    model = params_from_jax(tree, cfg, device="cpu")
    before = cuda_kernels.launch_counts()
    stats = {}
    got, summary = serve.generate(arch=ARCH, prompt_tokens=prompts,
                                  max_new_tokens=8, model=model,
                                  enc_embeds=emb, device="cpu",
                                  backend="torch", stats=stats)
    assert got.shape == (3, 18) and np.array_equal(got.numpy(), want)
    assert summary["iters"] == 8.0 and len(stats["decode_s"]) == 8
    assert cuda_kernels.launch_counts() == before


def test_torch_generate_needs_enc_embeds_for_an_encoder_decoder():
    prompts = np.zeros((1, 4), np.int64)
    with pytest.raises(ValueError, match="needs enc_embeds"):
        serve.generate(arch=ARCH, prompt_tokens=prompts, device="cpu",
                       backend="torch")


def test_torch_serve_cli_serves_seamless_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--batch", "2",
                                     "--prompt-len", "6",
                                     "--max-new-tokens", "3",
                                     "--device", "cpu", "--backend", "torch"])
    serve.main()
    assert "generated shape: (2, 9)" in capsys.readouterr().out


def test_torch_build_model_refuses_a_layer_kind_it_does_not_build():
    """No configuration of the registry has MLA with cross attention: a
    MiniCPM3 made an encoder-decoder is refused when built."""
    cfg = tconfigs.get_model_config("minicpm3-4b", smoke=True).replace(
        is_encoder_decoder=True, num_encoder_layers=2)
    with pytest.raises(NotImplementedError,
                       match="mla mixer \\+ dense mlp \\+ cross attention"):
        build_model(cfg, device="cpu")
