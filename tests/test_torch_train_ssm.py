"""RWKV-6 and Jamba training held against the JAX package on the CPU.

JAX parameters go through ``convert.params_from_jax`` (norm scales and
biases perturbed, the group norm's and Mamba's inner norms' among them),
batches are made with numpy from a seed, and the JAX side runs bare (no
mesh) under ``repro.kernels.ops.set_backend("interpret")``: the Pallas
WKV6 / Mamba forward in interpret mode with the chunked scans' VJP, the
split the port makes on both of its backends. The port runs
``backend="torch"`` (the plain recurrences forward, the chunked scans
backward).

Held: ``Model.loss`` and every leaf's gradient against
``jax.value_and_grad(model.loss)`` for the smoke ``rwkv6-3b`` and
``jamba-v0.1-52b`` (float32: the loss and each metric, Jamba's aux loss
among them, within 1e-5 relative, each leaf within 1e-4 of its largest
value; bfloat16: the loss at 2e-2, the whole gradient as close to the
float32 one as the reference's, and within 2e-2 of the reference's with
silu and softplus rounded its way); remat ``none`` / ``dots`` / ``full``
giving the same bits, with the K4-K7 forwards a step equal to
``chip_smoke.expected_train_launches``; ``train()`` falling over 20
steps and its loss stream against the reference's jitted
``make_train_step`` over the same ``SyntheticLM`` batches (2e-2, the
configurations' bfloat16); the reckoning of the card's two training
deployments on the meta device.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import SyntheticLM as JSyntheticLM
from repro.kernels import ops as jops
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models.api import build_model as jbuild
from repro.optim import adamw as jadamw

from repro_torch import configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models import convert
from repro_torch.models.api import build_model

from test_torch_train import (SMOKE, CountWeightProducts, _cfgs, batches,
                              hold_grads, jax_grads_by_name, jax_model,
                              port_grads)
from test_torch_jamba import _silu_by_steps, _softplus_by_steps
from test_torch_train_scans import interpret  # noqa: F401  (a fixture)

SSM_ARCHS = ["rwkv6-3b", "jamba-v0.1-52b"]
FWD = {"attention": "_attention_fwd", "rmsnorm": "_rmsnorm_fwd",
       "wkv6": "_wkv6_fwd", "mamba_scan": "_mamba_scan_fwd"}
LAUNCH_KEY = {"attention": "flash_attention", "rmsnorm": "rmsnorm",
              "wkv6": "wkv6", "mamba_scan": "mamba_scan"}


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_torch_ssm_loss_and_every_gradient_match_jax(interpret, arch):
    jcfg, tcfg, jm, params, model = jax_model(arch)
    jb, tb = batches(jcfg)
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(params, jb)
    loss, met = model.loss(tb, backend="torch")
    loss.backward()
    assert set(met) == set(jmet)
    assert ("aux_loss" in met) == (arch == "jamba-v0.1-52b")
    for k in jmet:
        np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    want = jax_grads_by_name(jg, tcfg)
    hold_grads(port_grads(model), want, 1e-4)
    # the leaves _perturb moves are among those held
    names = {n.rsplit(".", 1)[-1] for n in want}
    assert names >= ({"gn_scale", "gn_bias", "u", "w0"} if arch == "rwkv6-3b"
                     else {"norm_dt", "norm_B", "norm_C", "A_log", "D",
                           "dt_bias", "router"})


def _global_rel(got, want, names):
    """The whole gradient's distance, every leaf as one vector, over the
    length of ``want``'s."""
    num = sum(np.sum((got[n] - want[n]) ** 2, dtype=np.float64)
              for n in names)
    den = sum(np.sum(want[n] ** 2, dtype=np.float64) for n in names)
    return float(np.sqrt(num / den))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_torch_ssm_loss_and_gradients_match_jax_in_bfloat16(interpret,
                                                            arch,
                                                            monkeypatch):
    """bfloat16: the loss within 2e-2 relative of the reference's, every
    gradient in its parameter's dtype; the whole gradient no farther from
    the float32 gradient at the same weights than the reference's
    bfloat16 gradient is, give or take 2e-2 of its length; and with silu
    and softplus rounded step by step as the reference rounds them
    (``test_torch_jamba.py``: the two ops where the packages' bfloat16
    roundings part), the whole gradient within 2e-2 of the reference's.

    Leaf by leaf the bfloat16 gradients are not held to each other at
    2e-2 of the largest value: at this size the reference's own is up to
    some 5 % (RWKV-6's u) and 90 % (Jamba, whose top-2 routing flips
    between the dtypes) of a leaf's largest value away from its float32
    gradient."""
    jcfg, tcfg, jm, params, model = jax_model(arch, "bfloat16")
    jb, tb = batches(jcfg)
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(params, jb)
    jm32 = jbuild(jcfg.replace(dtype="float32", param_dtype="float32"))
    p32 = jax.tree.map(lambda x: x.astype(jnp.float32), params)
    _, g32 = jax.value_and_grad(jm32.loss, has_aux=True)(p32, jb)
    want = jax_grads_by_name(jg, tcfg)
    exact = jax_grads_by_name(g32, tcfg)
    names = sorted(exact)

    def port():
        for p in model.params.parameters():
            p.grad = None
        loss, _ = model.loss(tb, backend="torch")
        loss.backward()
        for n, p in model.params.named_parameters():
            assert p.grad.dtype == p.dtype, n
        return float(loss.detach()), port_grads(model)

    loss, got = port()
    assert set(got) == set(want) == set(exact)
    assert abs(loss - float(jl)) <= 2e-2 * abs(float(jl))
    assert all(np.isfinite(g).all() for g in got.values())
    assert _global_rel(got, exact, names) <= \
        _global_rel(want, exact, names) + 2e-2
    monkeypatch.setattr(torch.nn.functional, "silu", _silu_by_steps)
    monkeypatch.setattr(torch, "logaddexp", _softplus_by_steps)
    loss, got = port()
    assert abs(loss - float(jl)) <= 2e-2 * abs(float(jl))
    assert _global_rel(got, want, names) <= 2e-2


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_torch_ssm_remat_policies_give_the_same_numbers(arch, monkeypatch):
    _, tcfg = _cfgs(arch)
    _, tb = batches(tcfg)
    calls = dict.fromkeys(FWD, 0)

    def counting(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    for name, attr in FWD.items():
        monkeypatch.setattr(ops, attr, counting(name, getattr(ops, attr)))
    out = {}
    for remat in ("none", "dots", "full"):
        cfg = tcfg.replace(remat=remat)
        m = build_model(cfg, device="cpu")
        m.init(0)
        m.requires_grad_(True)
        calls.update(dict.fromkeys(FWD, 0))
        with CountWeightProducts() as mm:
            loss, _ = m.loss(tb, backend="torch")
            loss.backward()
        grads = {n: p.grad for n, p in m.params.named_parameters()}
        out[remat] = (loss.detach(), grads, mm.n)
        # the Functions' forwards a step are the launches chip_smoke.py
        # holds on the card
        want = SMOKE.expected_train_launches(cfg)
        assert {LAUNCH_KEY[k]: v for k, v in calls.items()} == want, remat
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        for n, g in out["none"][1].items():
            assert torch.equal(g, out[remat][1][n]), (remat, n)
    assert out["dots"][2] == out["none"][2] < out["full"][2]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_torch_ssm_train_loss_decreases(arch):
    res = ttrain.train(arch=arch, smoke=True, steps=20, seq_len=64,
                       global_batch=4, log_every=0, seed=0, device="cpu",
                       backend="torch")
    first, last = np.mean(res.losses[:5]), np.mean(res.losses[-5:])
    assert np.all(np.isfinite(res.losses))
    assert last < first - 0.1, (first, last)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_torch_ssm_train_loss_stream_matches_the_jax_step_loop(interpret,
                                                               arch):
    steps, S, B = 6, 32, 4
    jcfg = jconfigs.get_model_config(arch, smoke=True)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    model = convert.params_from_jax(
        jax.tree.map(np.asarray, params),
        tconfigs.get_model_config(arch, smoke=True), device="cpu")
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
    res = ttrain.train(arch=arch, model=model, steps=steps, seq_len=S,
                       global_batch=B, seed=0, log_every=0, device="cpu",
                       backend="torch")
    np.testing.assert_allclose(res.losses, want, rtol=2e-2)
    assert res.losses[-1] < res.losses[0]


def test_torch_ssm_train_reckoning_of_the_card_deployments():
    """chip_smoke.py's reckoning on the meta device: RWKV-6 3B at all 32
    layers, 3,099,863,040 parameters and 37.2 GB of state; Jamba v0.1 at
    3 of 32 layers, 4,023,784,288 and 48.3 GB, where 4 layers would hold
    6,947,738,752 and 83.4 GB of state alone, above the card."""
    rwkv = tconfigs.get_model_config("rwkv6-3b")
    jamba = tconfigs.get_model_config("jamba-v0.1-52b")
    r = SMOKE.train_reckoning(rwkv)
    j = SMOKE.train_reckoning(jamba.replace(num_layers=SMOKE.JAMBA_TRAIN_LAYERS))
    j4 = SMOKE.train_reckoning(jamba.replace(num_layers=4))
    assert r["params"] == 3_099_863_040
    assert j["params"] == 4_023_784_288 and j4["params"] == 6_947_738_752
    assert round(r["state_bytes"] / 1e9, 1) == 37.2
    assert round(j["state_bytes"] / 1e9, 1) == 48.3
    assert round(j4["state_bytes"] / 1e9, 1) == 83.4
    for rk in (r, j):
        assert rk["scan_backward_bytes"] > 0
        assert rk["reckoned_peak_bytes"] < 80e9
    assert j4["state_bytes"] > 80e9
