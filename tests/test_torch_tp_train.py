"""Tensor-parallel training over meshes of ``gloo`` CPU ranks: the loss
and its gradients, ``make_train_step(mesh=)``, ZeRO-1 beside a ``model``
axis, the checkpoint, on smoke configurations in float32.

As ``tests/test_torch_tp.py``: this file run as a script, one process a
rank, at a ``file://`` rendezvous: a world of 2 over ``(data 1, model
2)``, then a world of 4 over ``(data 1, model 4)`` and ``(data 2, model
2)``; the JAX reference in a subprocess over 4 host devices, its
``jax.value_and_grad(Model.loss)`` and ``make_train_step`` jitted with
``param_shardings`` on the same meshes (``AxisType.Auto`` axes).

Held, for ``qwen2-7b``, ``starcoder2-15b`` and ``mixtral-8x7b`` on the
three meshes: the loss within 1e-5 and every gradient leaf, made whole,
within 1e-4 of its largest value, against one process and against the
reference; remat ``"dots"`` (whose recompute issues the attention's
all-reduce again) giving the same bits as ``"none"``; 3 steps of
``make_train_step(mesh=)`` against one process (metrics 1e-5, parameters
``rtol`` 1e-5 / ``atol`` 1e-4) and their metrics against the reference's
step; ZeRO-1 on and off at ``(2, 2)`` giving the same bits, each rank
holding its ``data`` slice of its ``model`` shard of the moments; the
collectives of a step, counted; a checkpoint written by ``train(mesh=)``
at ``(1, 2)`` restored bit for bit at ``(1, 1)`` and at ``(2, 2)``;
``(pod 2, data 1, model 2)``, whose batch axes' group is made by
``axes_group`` from ``dist.new_group``, giving the bits of ``(2, 2)``; the
compressed step refusing, on a ``model`` axis of 2, a model not built on
the mesh; ``train(mesh=)`` at
``(1, 2)`` for all five configurations the slice ports
(``stablelm-12b`` and ``qwen2-vl-2b`` too) against one process.
"""
import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("qwen2-7b", "starcoder2-15b", "mixtral-8x7b")
STEP_ARCHS = ("qwen2-7b", "mixtral-8x7b")
ALL_ARCHS = ARCHS + ("stablelm-12b", "qwen2-vl-2b")
MESHES = {2: ((1, 2),), 4: ((1, 4), (2, 2))}
B, S, STEPS, SEED = 8, 16, 3, 0
OPT = dict(warmup_steps=1, total_steps=4)
CKPT_STEP = 2


def _cfg(arch, **kw):
    from repro_torch import configs
    return configs.get_model_config(arch, smoke=True).replace(
        dtype="float32", param_dtype="float32", **kw)


def _tree(npz):
    tree = {}
    for path, a in np.load(npz).items():
        *parents, leaf = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree


def _model(arch, init, mesh=None, **kw):
    from repro_torch.models import convert
    m = convert.params_from_jax(_tree(init), _cfg(arch, **kw), device="cpu",
                                mesh=mesh)
    m.requires_grad_(True)
    return m


def _batches():
    from repro_torch.data import SyntheticLM
    src = SyntheticLM(vocab_size=_cfg(ARCHS[0]).vocab_size, seq_len=S,
                      global_batch=B, seed=SEED)
    return [{"tokens": torch.from_numpy(src.batch(s)["tokens"])}
            for s in range(STEPS)]


def loss_and_grads(model, batch, mesh=None):
    """The loss and every gradient leaf made whole, and the collectives
    the loss and its backward issued. With more than one data rank each
    takes its slice of the batch, as the train step does, and the loss and
    gradients are averaged over them after."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import _local
    from repro_torch.optim.compress import mean_over
    dp = 1 if mesh is None else mesh_lib.dp_size(mesh)
    if dp > 1:
        batch = _local(batch, dp, mesh_lib.coordinate(mesh, ("data",)))
    params = dict(model.params.named_parameters())
    mesh_lib.reset_collective_counts()
    loss, _ = model.loss(batch, backend="torch")
    loss.backward()
    counts = mesh_lib.collective_counts()
    mean = (lambda t: t) if dp == 1 else \
        (lambda t: mean_over(t, mesh_lib.axes_group(mesh, ("data",)), dp))
    out = {"loss": mean(loss.detach())}
    for n, p in params.items():
        out[f"g/{n}"] = model.gather(n, mean(p.grad))
        p.grad = None
    return out, counts


def one_process_grads(model, halves):
    """``loss_and_grads`` with no mesh, as a data axis of ``halves`` ranks
    takes it: the mean over the batch's slices (a MoE's aux loss is each
    slice's, as the reference's ``pmean`` over ``data`` takes it)."""
    from repro_torch.launch.steps import _split
    parts = [loss_and_grads(model, b)[0]
             for b in _split(_batches()[0], halves)]
    return {k: sum(p[k] for p in parts) / halves for k in parts[0]}


def run_steps(model, mesh=None, zero1=True, steps=STEPS, microbatches=1):
    """``steps`` steps of the train step; returns (metrics per step, the
    collectives of the first, the parameters and moments made whole, the
    moments as held, the same state after ``CKPT_STEP`` steps)."""
    from repro_torch.configs import OptimizerConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import init_opt_state
    ocfg = OptimizerConfig(zero1=zero1, **OPT)
    params = dict(model.params.named_parameters())
    step = make_train_step(model, ocfg, microbatches=microbatches,
                           backend="torch", mesh=mesh)
    state = init_opt_state(ocfg, params, step.zero)
    met, counts, at_ckpt = [], None, None
    for s, batch in enumerate(_batches()[:steps]):
        mesh_lib.reset_collective_counts()
        state, m = step(state, batch)
        if s == 0:
            counts = mesh_lib.collective_counts()
        met.append({k: float(v) for k, v in m.items()})
        if s + 1 == CKPT_STEP:
            at_ckpt = _snapshot(model, state, step.zero)
    return met, counts, _snapshot(model, state, step.zero), \
        {k: v.clone() for k, v in state.mu.items()}, at_ckpt, step.zero


def train_seeded(arch, mesh=None):
    """``train(mesh=)`` for 2 steps of the smoke ``arch`` in float32,
    seeded (on a mesh each rank draws every leaf whole and keeps its
    shard): the losses."""
    from repro_torch.configs import OptimizerConfig
    from repro_torch.launch.train import train
    from repro_torch.models.api import build_model
    model = build_model(_cfg(arch), device="cpu", mesh=mesh)
    model.init(SEED)
    return train(arch=arch, model=model, steps=2, seq_len=S,
                 global_batch=B, seed=SEED, log_every=0, device="cpu",
                 backend="torch", opt_cfg=OptimizerConfig(**OPT),
                 mesh=mesh).losses


def _snapshot(model, state, zero):
    def whole(n, t):
        return model.gather(n, t if zero is None else zero.gather(n, t))
    # a leaf that is not gathered comes back as a view: copied here
    snap = {f"p/{n}": model.gather(n, p).clone()
            for n, p in model.params.named_parameters()}
    for which, tree in (("mu", state.mu), ("nu", state.nu)):
        snap.update({f"{which}/{n}": whole(n, t).clone()
                     for n, t in tree.items()})
    snap["step"] = state.step.clone()
    return snap


def _save(path, tensors):
    np.savez(path, **{k: v.numpy() for k, v in tensors.items()})


def _local_mesh(shape):
    from repro_torch.launch import mesh as mesh_lib
    return mesh_lib.make_mesh(mesh_lib.MeshConfig(shape, ("data", "model")),
                              device_type="cpu")


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


# ---------------------------------------------------------------------------
# the workers (this file run as a script)
# ---------------------------------------------------------------------------


def _worker(world, rank, rdv, out, jax_dir, ckpt_dir):
    import torch.distributed as dist
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import OptimizerConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import _zero_placement, train
    from repro_torch.models import convert
    from repro_torch.optim import init_opt_state
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    init = lambda arch: os.path.join(jax_dir, f"init_{arch}.npz")
    try:
        res = {}
        for shape in MESHES[world]:
            mesh, tag = _local_mesh(shape), _tag(shape)
            for arch in ARCHS:
                remats = ("none", "dots") if arch == "qwen2-7b" else ("none",)
                for remat in remats:
                    g, counts = loss_and_grads(
                        _model(arch, init(arch), mesh, remat=remat),
                        _batches()[0], mesh)
                    _save(os.path.join(out, f"g_{arch}_{remat}_{tag}_{rank}"
                                            f".npz"), g)
                    res[f"loss_counts_{arch}_{remat}_{tag}"] = counts
            for arch in STEP_ARCHS:
                for zero1 in ((True, False) if shape == (2, 2) else (True,)):
                    model = _model(arch, init(arch), mesh)
                    met, counts, snap, held, ck, zero = run_steps(
                        model, mesh, zero1)
                    key = f"{arch}_{tag}_z{int(zero1)}"
                    res[f"steps_{key}"] = met
                    res[f"step_counts_{key}"] = counts
                    res[f"zero_dims_{key}"] = None if zero is None \
                        else zero.dims
                    res[f"leaves_{arch}"] = len(snap) // 3
                    _save(os.path.join(out, f"s_{key}_{rank}.npz"), snap)
                    _save(os.path.join(out, f"held_{key}_{rank}.npz"), held)
                    if key == "qwen2-7b_1x2_z1":
                        _save(os.path.join(out, f"ckpt_{rank}.npz"), ck)
            if shape == (1, 2):
                for arch in ALL_ARCHS:
                    res[f"train_{arch}"] = train_seeded(arch, mesh)
                model = _model("qwen2-7b", init("qwen2-7b"), mesh)
                r = train(arch="qwen2-7b", model=model, steps=CKPT_STEP,
                          seq_len=S, global_batch=B, seed=SEED, log_every=0,
                          device="cpu", backend="torch",
                          opt_cfg=OptimizerConfig(**OPT), mesh=mesh,
                          ckpt_dir=ckpt_dir, ckpt_every=CKPT_STEP)
                res["train_losses"] = r.losses
            if shape == (2, 2):
                # the (1, 2) checkpoint, restored under ZeRO-1 at (2, 2)
                model = _model("qwen2-7b", init("qwen2-7b"), mesh)
                params = dict(model.params.named_parameters())
                ocfg = OptimizerConfig(**OPT)
                zstep = make_train_step(model, ocfg, backend="torch",
                                        mesh=mesh)
                state = init_opt_state(ocfg, params, zstep.zero)
                CheckpointManager(ckpt_dir).restore(
                    CKPT_STEP, convert.train_state_tree(params, state,
                                                        model.cfg),
                    placement_fn=_zero_placement(params, zstep.zero,
                                                 model.cfg, model))
                _save(os.path.join(out, f"restored_{rank}.npz"),
                      _snapshot(model, state, zstep.zero))
                _save(os.path.join(out, f"restored_held_{rank}.npz"),
                      {n: t for n, t in state.mu.items()})
        if world == 4:
            # (pod 2, data 1, model 2): the batch axes are two, and their
            # group (ZeRO-1's) is one dist.new_group per model coordinate
            from repro_torch.launch import mesh as mesh_lib
            mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(
                (2, 1, 2), ("pod", "data", "model")), device_type="cpu")
            group = mesh_lib.axes_group(mesh, ("pod", "data"))
            res["pod_group_ranks"] = dist.get_process_group_ranks(group)
            met, _, snap, _, _, zero = run_steps(
                _model("qwen2-7b", init("qwen2-7b"), mesh), mesh)
            res["steps_pod"] = met
            res["zero_group_is_pod_group"] = zero.group is group
            _save(os.path.join(out, f"s_pod_{rank}.npz"), snap)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _jax_oracle(out):
    """The reference's initial parameters; its loss and gradients on each
    mesh, and the metrics of ``STEPS`` of its train step at ``(2, 2)``,
    with the parameters placed by ``param_shardings``."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.launch import sharding as jshd
    from repro.launch.steps import make_train_step, param_shardings
    from repro.models import transformer as jtfm
    from repro.models.api import build_model as jbuild
    from repro.optim import init_opt_state
    assert len(jax.devices()) == 4
    batches = [{"tokens": jnp.asarray(b["tokens"].numpy(), jnp.int32)}
               for b in _batches()]
    for arch in ARCHS:
        jcfg = jconfigs.get_model_config(arch, smoke=True).replace(
            dtype="float32", param_dtype="float32")
        jm = jbuild(jcfg)
        params = jm.init(jax.random.PRNGKey(SEED))
        np.savez(os.path.join(out, f"init_{arch}.npz"), **{
            p.strip("/"): np.asarray(v) for p, v in jtfm._iter_paths(params)})
        for shape in MESHES[2] + MESHES[4]:
            mesh = jax.make_mesh(
                shape, ("data", "model"),
                axis_types=(jax.sharding.AxisType.Auto,) * 2,
                devices=jax.devices()[:shape[0] * shape[1]])
            with mesh, jshd.axis_rules(mesh):
                p = jax.device_put(params, param_shardings(mesh, jm, params))
                (loss, _), g = jax.jit(jax.value_and_grad(
                    jm.loss, has_aux=True))(p, batches[0])
                res = {"loss": np.asarray(loss)}
                res.update({f"g{path}": np.asarray(v)
                            for path, v in jtfm._iter_paths(g)})
                np.savez(os.path.join(out, f"g_{arch}_{_tag(shape)}.npz"),
                         **res)
                if shape != (2, 2) or arch not in STEP_ARCHS:
                    continue
                ocfg = jconfigs.OptimizerConfig(**OPT)
                state = init_opt_state(ocfg, p)
                step = jax.jit(make_train_step(jm, ocfg))
                met = []
                for b in batches:
                    p, state, m = step(p, state, b)
                    met.append({k: float(v) for k, v in m.items()})
                with open(os.path.join(out, f"steps_{arch}.json"), "w") as f:
                    json.dump(met, f)


def _env(**extra):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    env.update(extra)
    return env


def _launch(world, args, tmp):
    procs = [subprocess.Popen(
        [sys.executable, __file__, "worker", str(world), str(r),
         str(tmp / f"rdv{world}")] + [str(a) for a in args],
        env=_env(), cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]


def _jax(args):
    """This file's JAX oracle as a subprocess over 4 host devices."""
    return subprocess.Popen(
        [sys.executable, __file__] + [str(a) for a in args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(ROOT), env=_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=4"))


def _finish(procs):
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's oracle (and its initial parameters) first, then
    the worlds in turn."""
    tmp = tmp_path_factory.mktemp("tp_train")
    jax_out = tmp / "jax"
    jax_out.mkdir()
    _finish([_jax(["jax", jax_out])])
    dirs = {w: tmp / f"w{w}" for w in MESHES}
    ckpt = tmp / "ckpt"
    for w, d in dirs.items():          # world 4 restores world 2's save
        d.mkdir()
        _launch(w, [d, jax_out, ckpt], tmp)
    return {"jax": jax_out, "ckpt": ckpt, **dirs}


def _load(path):
    return {k: v for k, v in np.load(path).items()}


def _json(path):
    return json.loads(pathlib.Path(path).read_text())


def _near(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


def _reference_grads(npz, cfg):
    """The reference's gradient tree by the port's names."""
    from repro_torch.models import convert
    tree = {}
    for key in npz:
        if key.startswith("g/"):
            *parents, leaf = key[2:].split("/")
            node = tree
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = npz[key]
    return {f"g/{n}": w for n, _, w in convert._targets(tree, cfg)}


ALL_SHAPES = MESHES[2] + MESHES[4]


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_torch_tp_loss_and_gradients_match_one_process(runs, arch, shape):
    model = _model(arch, runs["jax"] / f"init_{arch}.npz")
    want = one_process_grads(model, shape[0])
    world = shape[0] * shape[1]
    for r in range(world):
        got = _load(runs[world] / f"g_{arch}_none_{_tag(shape)}_{r}.npz")
        assert set(got) == set(want)
        for k, w in want.items():
            _near(got[k], w.numpy(), 1e-5 if k == "loss" else 1e-4,
                  f"{shape} rank {r} {k}")


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_torch_tp_loss_and_gradients_match_the_reference(runs, arch, shape):
    ref = _load(runs["jax"] / f"g_{arch}_{_tag(shape)}.npz")
    want = _reference_grads(ref, _cfg(arch))
    world = shape[0] * shape[1]
    got = _load(runs[world] / f"g_{arch}_none_{_tag(shape)}_0.npz")
    _near(got["loss"], ref["loss"], 1e-5, "loss")
    assert set(want) == set(got) - {"loss"}
    for k, w in want.items():
        _near(got[k], w, 1e-4, f"{shape} {k}")


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=_tag)
def test_torch_tp_remat_dots_gives_the_same_bits(runs, shape):
    world = shape[0] * shape[1]
    none = _load(runs[world] / f"g_qwen2-7b_none_{_tag(shape)}_0.npz")
    dots = _load(runs[world] / f"g_qwen2-7b_dots_{_tag(shape)}_0.npz")
    for k in none:
        np.testing.assert_array_equal(dots[k], none[k], err_msg=k)


def _expected_counts(arch, shape, remat="none"):
    """The collectives of a loss and its backward on a ``(data, model)``
    mesh (before any reduction over ``data``): forward, an all-reduce for the embedding, one a layer for its
    attention's ``wo`` and one for its MLP's ``w_down`` (or the MoE's
    sum), and three for the cross entropy (max, sum of exponentials,
    target logit); the MoE's aux mean over ``data`` when it has more than
    one rank; in the backward, one a ``copy_to_model``: the attention's
    input and the MLP's (the MoE's tokens and routing weights: two), the
    head's input, and under the KV fallback ``wk``, ``wv``, ``bk``, ``bv``
    a layer. Remat ``"dots"`` recomputes each layer up to the last tensor
    its backward needs, which takes the attention's all-reduce again and
    stops before the MLP's."""
    cfg = _cfg(arch)
    L, moe, tp = cfg.num_layers, cfg.moe is not None, shape[1]
    fwd = 1 + 2 * L + 3 + (L if moe and shape[0] > 1 else 0)
    bwd = L * (3 if moe else 2) + 1
    if cfg.padded_kv_heads() % tp:
        bwd += L * (4 if cfg.qkv_bias else 2)
    return fwd + bwd + (L if remat == "dots" else 0)


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_torch_tp_collectives_of_a_loss_and_its_backward(runs, arch, shape):
    world = shape[0] * shape[1]
    for r in range(world):
        res = _json(runs[world] / f"rank{r}.json")
        for remat in (("none", "dots") if arch == "qwen2-7b" else ("none",)):
            got = res[f"loss_counts_{arch}_{remat}_{_tag(shape)}"]
            assert got == {"all_reduce": _expected_counts(arch, shape,
                                                          remat)}, \
                (remat, r, got)


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=_tag)
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_torch_tp_train_steps_match_one_process(runs, arch, shape):
    """Against one process's step on the same global batch; with two
    data ranks, its accumulation step over the same two halves (a MoE's
    aux loss is each half's there too)."""
    model = _model(arch, runs["jax"] / f"init_{arch}.npz")
    met, _, snap, _, _, _ = run_steps(model, microbatches=shape[0])
    world = shape[0] * shape[1]
    key = f"{arch}_{_tag(shape)}_z1"
    for r in range(world):
        got_met = _json(runs[world] / f"rank{r}.json")[f"steps_{key}"]
        for a, b in zip(got_met, met):
            # the accumulation step's lm_loss is its total loss
            for k in ("loss", "grad_norm", "lr") + (
                    ("aux_loss",) if "aux_loss" in a else ()):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
        got = _load(runs[world] / f"s_{key}_{r}.npz")
        for k, v in snap.items():
            if k.startswith("p/"):
                np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-5,
                                           atol=1e-4, err_msg=k)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_torch_tp_train_steps_match_the_reference_step(runs, arch):
    """The metrics of 3 steps at ``(2, 2)`` against the reference's
    ``make_train_step`` on the same mesh: loss, grad norm and learning
    rate within 1e-5."""
    want = _json(runs["jax"] / f"steps_{arch}.json")
    got = _json(runs[4] / "rank0.json")[f"steps_{arch}_2x2_z1"]
    for a, b in zip(got, want):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_torch_tp_zero1_on_and_off_give_the_same_bits(runs, arch):
    res = _json(runs[4] / "rank0.json")
    on, off = f"{arch}_2x2_z1", f"{arch}_2x2_z0"
    assert res[f"steps_{on}"] == res[f"steps_{off}"]
    dims = res[f"zero_dims_{on}"]
    assert res[f"zero_dims_{off}"] is None
    assert any(d is not None for d in dims.values())
    for r in range(4):
        a = _load(runs[4] / f"s_{on}_{r}.npz")
        b = _load(runs[4] / f"s_{off}_{r}.npz")
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        # each rank holds its data slice of its model shard of the moments
        held = _load(runs[4] / f"held_{on}_{r}.npz")
        whole = _load(runs[4] / f"held_{off}_{r}.npz")
        data = r // 2
        for n, d in dims.items():
            w = whole[n]
            if d is not None:
                k = w.shape[d] // 2
                w = np.take(w, range(data * k, (data + 1) * k), axis=d)
            np.testing.assert_array_equal(held[n], w, err_msg=n)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_torch_tp_collectives_of_a_train_step(runs, arch):
    """A step adds to its loss's collectives one all-reduce for the global
    norm (the sharded leaves' sum of squares), an all-reduce a gradient
    leaf and one a metric over ``data`` (over one rank too), and under
    ZeRO-1 an all-gather a sliced leaf."""
    for world, shapes in MESHES.items():
        for shape in shapes:
            res = _json(runs[world] / "rank0.json")
            key = f"{arch}_{_tag(shape)}_z1"
            got = res[f"step_counts_{key}"]
            metrics = len(res[f"steps_{key}"][0]) - 2
            dims = res[f"zero_dims_{key}"]
            want = {"all_reduce": _expected_counts(arch, shape) + 1
                    + res[f"leaves_{arch}"] + metrics,
                    "all_gather": sum(d is not None for d in dims.values())}
            assert want["all_gather"] > 0
            assert got == want, (shape, got, want)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_torch_tp_train_at_model_2_matches_one_process(runs, arch):
    """``train(mesh=)`` (so ``make_train_step(mesh=)``) at ``(1, 2)``
    for every configuration this slice ports: 2 steps' losses within
    1e-5 of one process's from the same seed."""
    want = train_seeded(arch)
    for r in range(2):
        got = _json(runs[2] / f"rank{r}.json")[f"train_{arch}"]
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_torch_tp_pod_and_data_axes_beside_a_model_axis(runs):
    """``(pod 2, data 1, model 2)``: the group over ``pod x data`` holds
    the ranks with this rank's model coordinate, ZeRO-1 slices over it,
    and 3 steps give the bits of ``(data 2, model 2)``, whose batch
    halves and sums are the same."""
    for r in range(4):
        res = _json(runs[4] / f"rank{r}.json")
        assert res["pod_group_ranks"] == [r % 2, r % 2 + 2]
        assert res["zero_group_is_pod_group"]
        assert res["steps_pod"] == res["steps_qwen2-7b_2x2_z1"]
        a = _load(runs[4] / f"s_pod_{r}.npz")
        b = _load(runs[4] / f"s_qwen2-7b_2x2_z1_{r}.npz")
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_torch_tp_checkpoint_at_1x2_restores_at_1x1(runs):
    """``train(mesh=)`` at ``(1, 2)`` gathered the model-sharded leaves
    and rank 0 wrote whole ones; restored with no mesh they are the state
    the step reached at the save, bit for bit."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import OptimizerConfig
    from repro_torch.models import convert
    from repro_torch.optim import init_opt_state
    res = _json(runs[2] / "rank0.json")
    assert res["train_losses"] == [m["loss"] for m in
                                   res["steps_qwen2-7b_1x2_z1"][:CKPT_STEP]]
    want = _load(runs[2] / "ckpt_0.npz")
    model = _model("qwen2-7b", runs["jax"] / "init_qwen2-7b.npz")
    params = dict(model.params.named_parameters())
    state = init_opt_state(OptimizerConfig(**OPT), params)
    _, meta = CheckpointManager(str(runs["ckpt"])).restore(
        CKPT_STEP, convert.train_state_tree(params, state, model.cfg))
    assert meta == {"next_step": CKPT_STEP, "arch": "qwen2-7b"}
    got = _snapshot(model, state, None)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_torch_tp_checkpoint_at_1x2_restores_at_2x2(runs):
    """The same checkpoint restored at ``(2, 2)``: each rank holds its
    model shard of every sharded leaf and its data slice of the moments,
    and made whole they are the saved state, bit for bit."""
    want = _load(runs[2] / "ckpt_0.npz")
    dims = _json(runs[4] / "rank0.json")["zero_dims_qwen2-7b_2x2_z1"]
    for r in range(4):
        got = _load(runs[4] / f"restored_{r}.npz")
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=(r, k))
        held = _load(runs[4] / f"restored_held_{r}.npz")
        assert sum(held[n].size for n in held) < \
            sum(want[f"mu/{n}"].size for n in held) / 2
        assert any(d is not None for d in dims.values())


def test_torch_tp_the_compressed_step_refuses_a_model_axis():
    """The compressed step runs under a ``model`` axis now
    (``tests/test_torch_compressed_tp.py``); like ``make_train_step`` it
    refuses a model not built on that mesh (it would hold whole leaves)."""
    from repro_torch.configs import OptimizerConfig
    from repro_torch.launch.compressed import make_compressed_train_step
    from repro_torch.models.api import build_model
    m = build_model(_cfg("qwen2-7b"), device="cpu")
    m.init(SEED)
    m.requires_grad_(True)
    tp = types.SimpleNamespace(shape={"pod": 2, "data": 1, "model": 2})
    with pytest.raises(ValueError, match="built on it"):
        make_compressed_train_step(m, OptimizerConfig(), tp, backend="torch")


def test_torch_tp_a_model_axis_needs_a_model_built_on_it():
    from repro_torch.configs import OptimizerConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.api import build_model
    m = build_model(_cfg("qwen2-7b"), device="cpu")
    m.init(SEED)
    m.requires_grad_(True)
    tp = types.SimpleNamespace(shape={"data": 1, "model": 2})
    with pytest.raises(ValueError, match="built on it"):
        make_train_step(m, OptimizerConfig(), backend="torch", mesh=tp)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_oracle(sys.argv[2])
    else:
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
                sys.argv[6], sys.argv[7])
