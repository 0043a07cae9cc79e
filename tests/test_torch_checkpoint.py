"""The port's checkpoint store and restart, held against the JAX package
on the CPU.

Held: the reference's three checkpoint tests over torch tensors (a round
trip with bfloat16 and int32 leaves, async saves with ``keep`` retention,
no ``.tmp`` left behind); a training state ``(params, opt_state)`` saved
by the reference's ``CheckpointManager`` restoring in the port leaf by
leaf, and the port's restoring in the reference's ``restore``, bit for
bit, for the smoke ``qwen2-7b`` (dense) and ``jamba-v0.1-52b`` (MoE and
Mamba, three stacked body slots); ``convert.reference_tree`` giving the
reference's leaf paths and stacked shapes for all ten configurations at
their full widths (meta device against ``jax.eval_shape``); an async
save isolated from in-place writes that follow it; refused restores
(a leaf with no place, a place with no leaf, a shape or dtype that
differs); and ``train()`` on the CPU: 6 steps straight against 3 steps,
a save and a resume to 6 (the losses and the final parameters and
moments bit-identical), both held to the reference's jitted
``make_train_step`` loop at the loss-stream test's tolerance (the JAX
``train()`` fails under this jax, ``ROADMAP.md`` "Standing facts").
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.ckpt.checkpoint import _flatten_with_paths as jflatten
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import transformer as jtfm
from repro.models.api import build_model as jbuild
from repro.optim import adamw as jadamw

from repro_torch import configs as tconfigs
from repro_torch.ckpt import CheckpointManager, Stacked
from repro_torch.ckpt.checkpoint import _flatten_with_paths, dtype_name
from repro_torch.launch import train as ttrain
from repro_torch.models import convert
from repro_torch.models import transformer as tfm
from repro_torch.models.api import build_model
from repro_torch.optim import adamw


def _tree():
    return {"layer": {"w": torch.arange(6.0).reshape(2, 3),
                      "b": torch.ones((3,), dtype=torch.bfloat16)},
            "stack": [torch.zeros((2, 2)),
                      torch.full((1,), 7, dtype=torch.int32)]}


def _bits(x) -> np.ndarray:
    """The raw bits of a torch tensor or a JAX / numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().copy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# the reference's three tests, over torch tensors
# ---------------------------------------------------------------------------


def test_torch_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    tree = _tree()
    mgr.save(10, tree, metadata={"next_step": 10}, block=True)
    assert mgr.latest_step() == 10
    restored, meta = mgr.restore(10, {"layer": {"w": None, "b": None},
                                      "stack": [None, None]})
    assert meta["next_step"] == 10
    flat_a, flat_b = _flatten_with_paths(tree), _flatten_with_paths(restored)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_torch_checkpoint_retention_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    tree = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    assert mgr.last_save["step"] == 4 and mgr.last_save["write_s"] > 0


def test_torch_checkpoint_atomic_no_tmp_left(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(5, _tree(), block=True)
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_torch_checkpoint_layout_is_the_references(tmp_path):
    """File names, the manifest and bfloat16's raw bytes as the reference
    writes them (its own save of the same tree)."""
    a, b = tmp_path / "port", tmp_path / "ref"
    CheckpointManager(str(a), async_save=False).save(3, _tree(), {"k": 1})
    jtree = {"layer": {"w": jnp.arange(6.0).reshape(2, 3),
                       "b": jnp.ones((3,), jnp.bfloat16)},
             "stack": [jnp.zeros((2, 2)), jnp.full((1,), 7, jnp.int32)]}
    JCheckpointManager(str(b), async_save=False).save(3, jtree, {"k": 1})
    names = sorted(os.listdir(a / "step_00000003"))
    assert names == sorted(os.listdir(b / "step_00000003"))
    for n in names:
        fa, fb = a / "step_00000003" / n, b / "step_00000003" / n
        if n == "manifest.json":
            import json
            assert json.loads(fa.read_text()) == json.loads(fb.read_text())
        else:
            ra, rb = np.load(fa), np.load(fb)
            assert ra.dtype == rb.dtype and ra.shape == rb.shape
            np.testing.assert_array_equal(ra, rb)


# ---------------------------------------------------------------------------
# a training state across the packages
# ---------------------------------------------------------------------------


def _jax_state(arch, seed=0):
    """The reference's smoke (params, OptState) with random moments and a
    step, so that no leaf is trivially zero."""
    jcfg = jconfigs.get_model_config(arch, smoke=True)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    mom = lambda: jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32)), params)
    state = jadamw.OptState(step=jnp.asarray(7, jnp.int32), mu=mom(),
                            nu=mom())
    return jcfg, params, state


def _port_state(arch, seed=3):
    cfg = tconfigs.get_model_config(arch, smoke=True)
    model = build_model(cfg, device="cpu")
    model.init(seed)
    params = dict(model.params.named_parameters())
    state = adamw.init_opt_state(tconfigs.OptimizerConfig(), params)
    g = torch.Generator().manual_seed(seed)
    for t in (*state.mu.values(), *state.nu.values()):
        t.copy_(torch.randn(t.shape, generator=g))
    state = state._replace(step=torch.tensor(5, dtype=torch.int32))
    return cfg, model, params, state


def _hold_state(params, state, jparams, jstate, cfg):
    """The port's (params, OptState) against the reference's, leaf by leaf
    (the stacked leaves split per layer), bit for bit."""
    assert int(state.step) == int(jstate.step)
    for got, want in ((params, jparams), (state.mu, jstate.mu),
                      (state.nu, jstate.nu)):
        want = {n: a for n, _, a in convert._targets(
            jax.tree.map(np.asarray, want), cfg)}
        assert set(got) == set(want)
        for n, w in want.items():
            g = got[n]
            assert tuple(g.shape) == w.shape, n
            assert dtype_name(g.dtype) == w.dtype.name, n
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=n)


@pytest.mark.parametrize("arch", ["qwen2-7b", "jamba-v0.1-52b"])
def test_torch_checkpoint_restores_the_references_bit_for_bit(tmp_path,
                                                              arch):
    jcfg, jparams, jstate = _jax_state(arch)
    JCheckpointManager(str(tmp_path), async_save=False).save(
        7, (jparams, jstate), metadata={"next_step": 7, "arch": arch})
    cfg, model, params, state = _port_state(arch)
    tree, meta = CheckpointManager(str(tmp_path)).restore(
        7, convert.train_state_tree(params, state, cfg))
    assert meta == {"next_step": 7, "arch": arch}
    # restored in place: the model's parameter objects hold the values
    assert all(a is b for a, b in zip(params.values(),
                                      model.params.parameters()))
    _hold_state(params, state, jparams, jstate, cfg)


@pytest.mark.parametrize("arch", ["qwen2-7b", "jamba-v0.1-52b"])
def test_torch_checkpoint_is_restored_by_the_reference_bit_for_bit(
        tmp_path, arch):
    cfg, model, params, state = _port_state(arch)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, convert.train_state_tree(params, state, cfg),
             metadata={"next_step": 5, "arch": arch})
    mgr.wait()
    jcfg, jparams, jstate = _jax_state(arch, seed=9)
    (rp, rs), meta = JCheckpointManager(str(tmp_path)).restore(
        5, (jparams, jstate))
    assert meta == {"next_step": 5, "arch": arch}
    assert sorted(p for p, _ in jflatten((rp, rs))) == sorted(
        p for p, _ in _flatten_with_paths(
            convert.train_state_tree(params, state, cfg)))
    for (_, a), (_, b) in zip(jflatten((rp, rs)), jflatten((jparams,
                                                             jstate))):
        assert a.dtype == b.dtype and a.shape == b.shape
    _hold_state(params, state, rp, rs, cfg)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_torch_reference_tree_has_the_references_paths_and_shapes(arch):
    """Every full-width leaf of the reference's tree is one leaf of the
    port's, stacked where the reference stacks, with its shape."""
    jcfg = jconfigs.get_model_config(arch)
    cfg = tconfigs.get_model_config(arch)
    shapes = jax.eval_shape(lambda: jtfm.init_params(
        jcfg, jax.random.PRNGKey(0)))
    with torch.device("meta"):
        p = tfm.init_params(cfg, torch.Generator(), device="meta")
    tree = convert.reference_tree(dict(p.named_parameters()), cfg)
    got = {}
    for path, leaf in _flatten_with_paths(tree):
        if isinstance(leaf, Stacked):
            assert len({tuple(t.shape) for t in leaf}) == 1, path
            got[path] = (len(leaf),) + tuple(leaf[0].shape)
        else:
            got[path] = tuple(leaf.shape)
    want = {path: tuple(s.shape) for path, s in jflatten(shapes)}
    assert got == want


def test_torch_checkpoint_async_save_is_isolated_from_later_writes(
        tmp_path):
    cfg, model, params, state = _port_state("qwen2-7b")
    before = {n: p.detach().clone() for n, p in params.items()}
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, convert.train_state_tree(params, state, cfg))
    with torch.no_grad():                 # the optimizer writes in place
        for p in params.values():
            p.add_(1.0)
    mgr.wait()
    _, _, fresh, fresh_state = _port_state("qwen2-7b", seed=11)
    CheckpointManager(str(tmp_path)).restore(
        1, convert.train_state_tree(fresh, fresh_state, cfg))
    for n, b in before.items():
        np.testing.assert_array_equal(_bits(fresh[n]), _bits(b), err_msg=n)


@pytest.mark.parametrize("fault", ["extra leaf", "missing leaf", "shape",
                                   "dtype"])
def test_torch_checkpoint_restore_refuses_a_tree_that_differs(tmp_path,
                                                              fault):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _tree())
    like = {"layer": {"w": torch.zeros(2, 3),
                      "b": torch.zeros(3, dtype=torch.bfloat16)},
            "stack": [torch.zeros(2, 2), torch.zeros(1, dtype=torch.int32)]}
    if fault == "extra leaf":
        del like["layer"]["w"]
    elif fault == "missing leaf":
        like["more"] = torch.zeros(1)
    elif fault == "shape":
        like["stack"][0] = torch.zeros(2, 3)
    else:
        like["layer"]["w"] = torch.zeros(2, 3, dtype=torch.float64)
    with pytest.raises(ValueError):
        mgr.restore(1, like)


# ---------------------------------------------------------------------------
# train(): resume
# ---------------------------------------------------------------------------


def _jax_loss_stream(steps, S, B, ocfg):
    jcfg = jconfigs.get_model_config("qwen2-7b", smoke=True)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    jstep = jax.jit(jmake_train_step(jm, ocfg))
    state = jadamw.init_opt_state(ocfg, params)
    source = JSyntheticLM(vocab_size=jcfg.vocab_size, seq_len=S,
                          global_batch=B, seed=0)
    out = []
    for s in range(steps):
        batch = {k: jnp.asarray(v) for k, v in source.batch(s).items()}
        params, state, met = jstep(params, state, batch)
        out.append(float(met["loss"]))
    return params, out


def _port_model(jparams):
    return convert.params_from_jax(
        jax.tree.map(np.asarray, jparams),
        tconfigs.get_model_config("qwen2-7b", smoke=True), device="cpu")


def test_torch_train_resume_is_bit_identical_to_a_straight_run(tmp_path):
    steps, S, B = 6, 32, 4
    ocfg = jconfigs.OptimizerConfig(warmup_steps=max(2, steps // 10),
                                    total_steps=max(steps, 10))
    tocfg = tconfigs.OptimizerConfig(warmup_steps=ocfg.warmup_steps,
                                     total_steps=ocfg.total_steps)
    jm = jbuild(jconfigs.get_model_config("qwen2-7b", smoke=True))
    init = jm.init(jax.random.PRNGKey(0))
    _, want = _jax_loss_stream(steps, S, B, ocfg)
    kw = dict(arch="qwen2-7b", seq_len=S, global_batch=B, seed=0,
              log_every=0, device="cpu", backend="torch", opt_cfg=tocfg)

    straight = _port_model(init)
    a = ttrain.train(model=straight, steps=steps, **kw)
    first = _port_model(init)
    sb = {}
    b = ttrain.train(model=first, steps=3, ckpt_dir=str(tmp_path),
                     ckpt_every=3, stats=sb, **kw)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003"]
    assert sb["recovery"] == [{"kind": "resume", "step": 3,
                               "detail": "checkpoint saved"}]
    again = _port_model(jax.tree.map(lambda x: x * 0, init))   # overwritten
    sc = {}
    c = ttrain.train(model=again, steps=steps, ckpt_dir=str(tmp_path),
                     resume=True, stats=sc, **kw)
    assert sc["start_step"] == 3 and sc["restore_s"] > 0
    assert b.losses + c.losses == a.losses            # the same bits
    for (n, p), q in zip(straight.params.named_parameters(),
                         again.params.parameters()):
        np.testing.assert_array_equal(_bits(p), _bits(q), err_msg=n)
    # both streams against the reference's step loop
    np.testing.assert_allclose(a.losses, want, rtol=2e-2)
    np.testing.assert_allclose(b.losses + c.losses, want, rtol=2e-2)


def test_torch_train_resume_without_a_checkpoint_starts_at_zero(tmp_path):
    st = {}
    res = ttrain.train(arch="qwen2-7b", steps=2, seq_len=8, global_batch=2,
                       log_every=0, device="cpu", backend="torch",
                       ckpt_dir=str(tmp_path), resume=True, stats=st)
    assert st["start_step"] == 0 and len(res.losses) == 2
    assert "restore_s" not in st and os.listdir(tmp_path) == []
