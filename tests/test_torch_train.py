"""The port's training path held against the JAX package on the CPU.

JAX parameters go through ``convert.params_from_jax``, inputs are made
with numpy from a seed, and the JAX side runs bare (no mesh), on its XLA
path (``repro.kernels.ops.set_backend("xla")``, a fixture, restored
after; the Pallas attention is no oracle for MLA's unequal head dims,
ROADMAP Queue 3 item 4). The JAX ``train()`` builds a mesh, which fails
under jax 0.9.0 (as its ``generate`` does), so the loss stream
is held against the reference's own step (``launch.steps.make_train_step``,
jitted, no mesh) over the reference's ``SyntheticLM`` batches.

Held: ``Model.loss`` and every leaf's gradient against
``jax.value_and_grad(model.loss)`` for the eight attention
configurations at smoke size in float32 (the loss within 1e-5 relative,
each gradient within 1e-4 of its leaf's largest value; norm scales and
biases perturbed away from 1 and 0), Qwen2-7B in bfloat16 (2e-2); remat
``none`` / ``dots`` / ``full`` bit-identical, ``dots`` saving the weight
products; ``loss_chunk`` against the whole loss; ``cosine_lr``, the decay mask leaf by leaf, three AdamW
steps' trajectories (1e-5), the plain and the accumulation step;
``SyntheticLM`` bit for bit; ``train()`` on the CPU.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.data import Prefetcher as JPrefetcher
from repro.data import SyntheticLM as JSyntheticLM
from repro.kernels import ops as jops
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import transformer as jtfm
from repro.models.api import build_model as jbuild
from repro.optim import adamw as jadamw

from repro_torch import configs as tconfigs
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_train_step
from repro_torch.models import convert
from repro_torch.models import transformer as tfm
from repro_torch.models.api import build_model
from repro_torch.optim import adamw

ATTN_ARCHS = [a for a in jconfigs.ARCH_IDS
              if a not in ("rwkv6-3b", "jamba-v0.1-52b")]
SCALES = ("scale", "gn_scale", "norm_dt", "norm_B", "norm_C")
PERTURBED = SCALES + ("bias", "gn_bias", "q_norm", "kv_norm", "router_bias",
                      "bq", "bk", "bv", "b_up", "b_down")


@pytest.fixture
def xla():
    before = jops.backend()
    jops.set_backend("xla")
    try:
        yield
    finally:
        jops.set_backend(before)


def _perturb(path, x, rng):
    """Norm scales away from 1, biases away from 0: a dropped one shows."""
    name = str(path[-1].key) if hasattr(path[-1], "key") else ""
    if name not in PERTURBED:
        return x
    if name in SCALES or name.endswith("_norm"):
        v = 1.0 + 0.2 * rng.standard_normal(x.shape)
    else:
        v = 0.1 * rng.standard_normal(x.shape)
    return jnp.asarray(v.astype(np.float32)).astype(x.dtype)


def _cfgs(arch, dtype="float32", **kw):
    j = jconfigs.get_model_config(arch, smoke=True)
    t = tconfigs.get_model_config(arch, smoke=True)
    if dtype == "float32":
        kw.update(dtype="float32", param_dtype="float32")
    return j.replace(**kw) if kw else j, t.replace(**kw) if kw else t


def jax_model(arch, dtype="float32", seed=0, **kw):
    jcfg, tcfg = _cfgs(arch, dtype, **kw)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: _perturb(p, x, rng), params)
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    model.requires_grad_(True)
    return jcfg, tcfg, jm, params, model


def batches(cfg, B=2, S=16, seed=1, loss_mask=False):
    """The same training batch for both packages: tokens (B, S+1), and the
    configuration's extras (frame embeddings; patch embeddings with
    distinct positions and three differing M-RoPE streams)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(
        np.int32)}
    if cfg.is_encoder_decoder:
        b["enc_embeds"] = (rng.standard_normal((B, 12, cfg.d_model))
                           * 0.02).astype(np.float32)
    if cfg.frontend == "vision":
        n = 4
        b["patch_embeds"] = (rng.standard_normal((B, n, cfg.d_model))
                             * 0.02).astype(np.float32)
        b["patch_positions"] = np.stack([2 + i + np.arange(n)
                                         for i in range(B)]).astype(np.int32)
        mrope = np.broadcast_to(np.arange(S, dtype=np.int32),
                                (3, B, S)).copy()
        for i in range(B):
            mrope[1, i, 2 + i:2 + i + n] = 2 + i + np.arange(n) // 2
            mrope[2, i, 2 + i:2 + i + n] = 2 + i + np.arange(n) % 2
        b["mrope_positions"] = mrope
    if loss_mask:
        b["loss_mask"] = (rng.uniform(size=(B, S + 1)) < 0.7).astype(
            np.int32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def jax_grads_by_name(grads, tcfg):
    """The reference's gradient tree as the port's parameter names, the
    stacked leaves split per layer (``convert``'s own map)."""
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), grads)
    return {n: a for n, _, a in convert._targets(tree, tcfg)}


def port_grads(model):
    return {n: (p.grad.float().numpy() if p.grad is not None
                else np.zeros(p.shape, np.float32))
            for n, p in model.params.named_parameters()}


def hold_grads(got, want, tol):
    assert set(got) == set(want)
    for n, w in want.items():
        g = got[n]
        assert np.isfinite(g).all(), n
        err = np.abs(g - w).max()
        assert err <= tol * np.abs(w).max(), (n, err, np.abs(w).max())


# ---------------------------------------------------------------------------
# Model.loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_torch_loss_and_every_gradient_match_jax(xla, arch):
    jcfg, tcfg, jm, params, model = jax_model(arch)
    jb, tb = batches(jcfg, loss_mask=arch == "qwen2-7b")
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(params, jb)
    loss, met = model.loss(tb, backend="torch")
    loss.backward()
    assert set(met) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    hold_grads(port_grads(model), jax_grads_by_name(jg, tcfg), 1e-4)


def test_torch_loss_and_gradients_match_jax_in_bfloat16(xla):
    jcfg, tcfg, jm, params, model = jax_model("qwen2-7b", "bfloat16")
    jb, tb = batches(jcfg)
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(params, jb)
    loss, _ = model.loss(tb, backend="torch")
    loss.backward()
    assert abs(float(loss) - float(jl)) <= 2e-2 * abs(float(jl))
    got = port_grads(model)
    assert all(p.grad.dtype == torch.bfloat16
               for p in model.params.parameters())
    hold_grads(got, jax_grads_by_name(jg, tcfg), 2e-2)


def test_torch_chunked_loss_equals_the_whole_loss():
    # S = 16 in chunks of 5: three whole chunks and a remainder of 1
    _, tcfg = _cfgs("qwen2-7b")
    _, tb = batches(tcfg)
    out = {}
    for chunk in (0, 5):
        cfg = tcfg.replace(loss_chunk=chunk)
        m = build_model(cfg, device="cpu")
        m.init(0)
        m.requires_grad_(True)
        loss, _ = m.loss(tb, backend="torch")
        loss.backward()
        out[chunk] = (float(loss), port_grads(m))
    np.testing.assert_allclose(out[5][0], out[0][0], rtol=1e-6)
    hold_grads(out[5][1], out[0][1], 1e-6)


def test_torch_chunked_mtp_loss_matches_jax(xla):
    jcfg, tcfg, jm, params, model = jax_model("deepseek-v3-671b",
                                              loss_chunk=6)
    jb, tb = batches(jcfg)
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(params, jb)
    loss, met = model.loss(tb, backend="torch")
    loss.backward()
    for k in jmet:
        np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=1e-5)
    hold_grads(port_grads(model), jax_grads_by_name(jg, tcfg), 1e-4)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


class CountWeightProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in tfm.SAVED_BY_DOTS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _load_chip_smoke()


@pytest.mark.parametrize("arch", ["qwen2-7b", "mixtral-8x7b",
                                  "seamless-m4t-large-v2"])
def test_torch_remat_policies_give_the_same_numbers(arch, monkeypatch):
    _, tcfg = _cfgs(arch)
    _, tb = batches(tcfg)
    calls = {"attention": 0, "rmsnorm": 0}
    fwd = {"attention": ops._attention_fwd, "rmsnorm": ops._rmsnorm_fwd}

    def counting(name):
        def fn(*a, **k):
            calls[name] += 1
            return fwd[name](*a, **k)
        return fn

    monkeypatch.setattr(ops, "_attention_fwd", counting("attention"))
    monkeypatch.setattr(ops, "_rmsnorm_fwd", counting("rmsnorm"))
    out = {}
    for remat in ("none", "dots", "full"):
        m = build_model(tcfg.replace(remat=remat), device="cpu")
        m.init(0)
        m.requires_grad_(True)
        calls.update(attention=0, rmsnorm=0)
        with CountWeightProducts() as mm:
            loss, _ = m.loss(tb, backend="torch")
            loss.backward()
        grads = {n: p.grad for n, p in m.params.named_parameters()}
        out[remat] = (loss.detach(), grads, mm.n, dict(calls))
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        for n, g in out["none"][1].items():
            g2 = out[remat][1][n]
            assert (g is None and g2 is None) or torch.equal(g, g2), n
    # "dots" keeps the weight products: its backward runs no more of them
    # than without remat; "full" runs them again
    assert out["dots"][2] == out["none"][2] < out["full"][2]
    if arch == "qwen2-7b":
        # the K4 and K5 launches a step that chip_smoke.py holds on the
        # card are the Functions' forwards counted here
        for remat in ("none", "dots", "full"):
            want = SMOKE.expected_train_launches(tcfg.replace(remat=remat))
            assert out[remat][3] == {"attention": want["flash_attention"],
                                     "rmsnorm": want["rmsnorm"]}, remat


def test_torch_train_reckoning_of_the_card_cut():
    """chip_smoke.py's reckoning of the Qwen2-7B cut, on the meta device:
    14 of 28 layers, 52.2 GB of state; the 28 layers' 91.4 GB do not fit
    the card's 80 GB."""
    full = tconfigs.get_model_config("qwen2-7b")
    cut = SMOKE.train_reckoning(full.replace(num_layers=SMOKE.TRAIN_LAYERS))
    whole = SMOKE.train_reckoning(full)
    assert cut["params"] == 14 * 233_057_792 + 2 * 544_997_376 + 3_584 \
        == 4_352_807_424
    assert whole["params"] == 7_615_616_512
    assert round(cut["state_bytes"] / 1e9, 1) == 52.2
    assert round(whole["state_bytes"] / 1e9, 1) == 91.4
    assert round(cut["saved_weight_products_bytes"] / 1e9, 1) == 5.7
    assert cut["reckoned_peak_bytes"] < 80e9 < whole["state_bytes"]


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def test_torch_cosine_lr_matches_jax():
    for cfg in (jconfigs.OptimizerConfig(warmup_steps=3, total_steps=12),
                jconfigs.OptimizerConfig(warmup_steps=0, total_steps=5,
                                         lr=1e-3, min_lr_frac=0.0)):
        for s in range(16):
            want = float(jadamw.cosine_lr(cfg, jnp.asarray(s, jnp.int32)))
            got = adamw.cosine_lr(cfg, torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=1e-6,
                                       err_msg=str(s))


def _meta_params(cfg):
    with torch.device("meta"):
        p = tfm.init_params(cfg, torch.Generator(), device="meta")
    return dict(p.named_parameters())


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_torch_decay_mask_matches_jax_leaf_by_leaf(arch):
    for smoke in (True, False) if arch in ("qwen2-7b", "jamba-v0.1-52b",
                                           "minicpm3-4b") else (True,):
        jcfg = jconfigs.get_model_config(arch, smoke=smoke)
        tcfg = tconfigs.get_model_config(arch, smoke=smoke)
        shapes = jax.eval_shape(lambda: jtfm.init_params(
            jcfg, jax.random.PRNGKey(0)))
        want = dict(jtfm._iter_paths(jadamw._decay_mask(shapes)))
        params = _meta_params(tcfg)
        got = adamw.decay_mask(tcfg, params)
        assert set(got) == set(params)
        seen = set()
        for n, v in got.items():
            path, _ = convert.jax_path(n, tcfg)
            assert v == want[path], (arch, n, path)
            seen.add(path)
        assert seen == set(want)


def _opt_tree(arch):
    """A model's parameters (float32) and three steps of random gradients
    in both packages; the second step's are small, so that clipping is
    off there and on in the others."""
    jcfg, tcfg, jm, params, model = jax_model(arch)
    tparams = dict(model.params.named_parameters())
    rng = np.random.default_rng(11)
    steps = []
    for s, size in enumerate((1.0, 1e-4, 3.0)):
        g = {n: (size * rng.standard_normal(p.shape)).astype(np.float32)
             for n, p in tparams.items()}
        steps.append(g)
    return jcfg, tcfg, params, model, tparams, steps


def _to_jax_tree(named, params, tcfg):
    """A dict by the port's names as the reference's tree (stacked)."""
    leaves = {}
    for n, a in named.items():
        path, stacked = convert.jax_path(n, tcfg)
        leaves.setdefault(path, []).append((n, a))

    def build(path, leaf):
        items = leaves[path]
        if len(items) == 1 and not convert.jax_path(items[0][0], tcfg)[1]:
            return jnp.asarray(items[0][1])
        layer = lambda n: int(n.split(".")[1])
        items = sorted(items, key=lambda it: layer(it[0]))
        return jnp.stack([jnp.asarray(a) for _, a in items])
    return jtfm._map_with_paths(params, build)


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-v3-671b"])
def test_torch_adamw_trajectory_matches_jax(arch):
    jcfg, tcfg, jparams, model, tparams, steps = _opt_tree(arch)
    cfg = jconfigs.OptimizerConfig(warmup_steps=1, total_steps=4)
    jstate = jadamw.init_opt_state(cfg, jparams)
    tstate = adamw.init_opt_state(cfg, tparams)
    decay = adamw.decay_mask(tcfg, tparams)
    for s, g in enumerate(steps):
        jg = _to_jax_tree(g, jparams, tcfg)
        jparams, jstate, jmet = jadamw.adamw_update(cfg, jparams, jg, jstate)
        _, tstate, tmet = adamw.adamw_update(
            cfg, tparams, {n: torch.from_numpy(a) for n, a in g.items()},
            tstate, decay)
        assert int(tstate.step) == int(jstate.step) == s + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-6)
        for got, want in ((tparams, jparams), (tstate.mu, jstate.mu),
                          (tstate.nu, jstate.nu)):
            want = jax_grads_by_name(want, tcfg)
            for n, w in want.items():
                np.testing.assert_allclose(got[n].detach().numpy(), w,
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=f"step {s} {n}")
    assert float(tmet["grad_norm"]) > cfg.grad_clip


def test_torch_clip_by_global_norm_matches_jax_and_rounds_back():
    rng = np.random.default_rng(12)
    tree = {"a": rng.standard_normal((8, 5)), "b": rng.standard_normal(7)}
    jt = {k: jnp.asarray(v.astype(np.float32)).astype(jnp.bfloat16)
          for k, v in tree.items()}
    tt = {k: torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
          for k, v in tree.items()}
    jc, jn = jadamw.clip_by_global_norm(jt, 1.0)
    tc, tn = adamw.clip_by_global_norm(tt, 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(adamw.global_norm(tt)),
                               float(jadamw.global_norm(jt)), rtol=1e-6)
    for k in tree:
        assert tc[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tc[k].float().numpy(), np.asarray(jc[k].astype(jnp.float32)))


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,microbatches", [("qwen2-7b", 1),
                                               ("qwen2-7b", 2),
                                               ("qwen2-vl-2b", 2)])
def test_torch_train_step_matches_jax(xla, arch, microbatches):
    jcfg, tcfg, jm, params, model = jax_model(arch)
    cfg = jconfigs.OptimizerConfig(warmup_steps=1, total_steps=4)
    jb, tb = batches(jcfg, B=4)
    jstep = jax.jit(jmake_train_step(jm, cfg, microbatches=microbatches))
    jstate = jadamw.init_opt_state(cfg, params)
    tstate = adamw.init_opt_state(cfg, dict(model.params.named_parameters()))
    step = make_train_step(model, cfg, microbatches=microbatches,
                           backend="torch")
    for s in range(2):
        params, jstate, jmet = jstep(params, jstate, jb)
        tstate, tmet = step(tstate, tb)
        for k in ("loss", "grad_norm", "lr") + \
                (("lm_loss", "aux_loss") if microbatches > 1 else ()):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        # Adam divides each gradient by its own root mean square, so an
        # element whose gradient is rounding noise moves by up to a whole
        # learning rate either way (a key bias, bk: a query's softmax
        # ignores a shift of its scores); the parameters are held within
        # a tenth of the learning rate
        want = jax_grads_by_name(params, tcfg)
        got = {n: p.detach().numpy()
               for n, p in model.params.named_parameters()}
        for n, w in want.items():
            np.testing.assert_allclose(got[n], w, rtol=1e-5,
                                       atol=0.1 * cfg.lr,
                                       err_msg=f"step {s} {n}")
    assert all(p.grad is None for p in model.params.parameters())


def test_torch_train_step_needs_trainable_parameters():
    m = build_model(tconfigs.get_model_config("qwen2-7b", smoke=True),
                    device="cpu")
    m.init(0)
    with pytest.raises(ValueError, match="requires_grad_"):
        make_train_step(m, tconfigs.OptimizerConfig(), backend="torch")


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(vocab_size=512, seq_len=32, global_batch=4, seed=0),
    dict(vocab_size=152064, seq_len=64, global_batch=4, seed=3,
         num_hosts=2, host_index=1),
    dict(vocab_size=100, seq_len=8, global_batch=2, seed=7, zipf_a=1.5),
], ids=["smoke", "qwen2 vocab, host 1 of 2", "zipf 1.5"])
def test_torch_synthetic_lm_is_the_jax_packages_bit_for_bit(kw):
    want, got = JSyntheticLM(**kw), SyntheticLM(**kw)
    for step in (0, 1, 2, 17):
        w, g = want.batch(step), got.batch(step)
        assert set(g) == set(w) == {"tokens"}
        assert g["tokens"].dtype == w["tokens"].dtype
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
    jp = JPrefetcher(want, start_step=2, max_steps=5)
    tp = Prefetcher(got, start_step=2, max_steps=5)
    for _ in range(3):
        np.testing.assert_array_equal(tp.next()["tokens"],
                                      jp.next()["tokens"])
    with pytest.raises(StopIteration):
        tp.next()
    jp.close()
    tp.close()


# ---------------------------------------------------------------------------
# train()
# ---------------------------------------------------------------------------


def test_torch_train_loss_stream_matches_the_jax_step_loop(xla):
    steps, S, B = 8, 32, 4
    jcfg = jconfigs.get_model_config("qwen2-7b", smoke=True)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    model = convert.params_from_jax(
        jax.tree.map(np.asarray, params),
        tconfigs.get_model_config("qwen2-7b", smoke=True), device="cpu")
    ocfg = jconfigs.OptimizerConfig(warmup_steps=max(2, steps // 10),
                                    total_steps=max(steps, 10))
    jstep = jax.jit(jmake_train_step(jm, ocfg))
    state = jadamw.init_opt_state(ocfg, params)
    source = JSyntheticLM(vocab_size=jcfg.vocab_size, seq_len=S,
                          global_batch=B, seed=0)
    want = []
    for s in range(steps):
        batch = {k: jnp.asarray(v) for k, v in source.batch(s).items()}
        params, state, met = jstep(params, state, batch)
        want.append(float(met["loss"]))
    stats = {}
    res = ttrain.train(arch="qwen2-7b", model=model, steps=steps,
                       seq_len=S, global_batch=B, seed=0, log_every=0,
                       device="cpu", backend="torch", stats=stats)
    assert res.steps == steps and res.final_loss == res.losses[-1]
    np.testing.assert_allclose(res.losses, want, rtol=2e-2)
    assert stats["loss"] == res.losses
    assert len(stats["step_s"]) == len(stats["lr"]) == steps
    assert all(g > 0 for g in stats["grad_norm"])
    assert res.summary["iters"] == steps


def test_torch_train_loss_decreases():
    res = ttrain.train(arch="qwen2-7b", smoke=True, steps=20, seq_len=64,
                       global_batch=4, log_every=0, seed=0, device="cpu",
                       backend="torch")
    first, last = np.mean(res.losses[:5]), np.mean(res.losses[-5:])
    assert np.isfinite(res.final_loss)
    assert last < first - 0.1, (first, last)


@pytest.mark.parametrize("kw", [dict(ckpt_dir="ck"), dict(ckpt_every=5),
                                dict(resume=True)], ids=str)
def test_torch_train_refuses_checkpointing(kw):
    """Checkpointing is ported (``tests/test_torch_checkpoint.py``); what
    is refused is a half-given checkpoint: ``ckpt_every`` or ``resume``
    without ``ckpt_dir``, and a ``ckpt_dir`` with neither, which would
    save and restore nothing."""
    match = "nothing would be saved" if "ckpt_dir" in kw else "need ckpt_dir"
    with pytest.raises(ValueError, match=match):
        ttrain.train(arch="qwen2-7b", steps=1, device="cpu",
                     backend="torch", **kw)


def test_torch_train_refuses_rwkv_and_a_model_of_another_arch():
    """RWKV-6 is no longer refused (its training is held in
    ``test_torch_train_ssm.py``); a model of another arch is."""
    res = ttrain.train(arch="rwkv6-3b", steps=1, seq_len=8, global_batch=2,
                       log_every=0, device="cpu", backend="torch")
    assert np.isfinite(res.final_loss)
    m = build_model(tconfigs.get_model_config("qwen2-7b", smoke=True),
                    device="cpu")
    m.init(0)
    with pytest.raises(ValueError, match="arch"):
        ttrain.train(arch="stablelm-12b", model=m, steps=1, device="cpu",
                     backend="torch")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_torch_train_runs_on_the_card_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train(arch="qwen2-7b", steps=1)
    with pytest.raises(ValueError, match="backend='cuda'"):
        ttrain.train(arch="qwen2-7b", steps=1, seq_len=8, global_batch=2,
                     device="cpu")


def test_torch_train_cli_trains_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "train", "--steps", "3", "--seq-len", "16", "--global-batch", "2",
        "--device", "cpu", "--backend", "torch"])
    ttrain.main()
    out = capsys.readouterr().out
    assert "step     0 loss" in out and '"final_loss"' in out


def test_torch_train_runs_in_a_process_without_jax_or_repro():
    import subprocess
    import sys
    import textwrap
    root = pathlib.Path(__file__).resolve().parents[1]
    code = textwrap.dedent("""
        import sys
        from repro_torch.launch.train import train
        res = train(arch="qwen2-7b", steps=2, seq_len=8,
                    global_batch=2, log_every=0, device="cpu",
                    backend="torch")
        assert len(res.losses) == 2
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "jaxlib" or m == "repro"
                     or m.startswith("repro."))
        assert not bad, bad
        print("CLEAN")
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=str(root), timeout=300,
        env={"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "CLEAN"
