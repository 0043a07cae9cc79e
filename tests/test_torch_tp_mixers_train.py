"""Tensor-parallel training with the MLA, RWKV-6, Mamba and
cross-attention mixers over meshes of ``gloo`` CPU ranks: the loss and
its gradients, ``make_train_step(mesh=)``, remat, the checkpoint, on
smoke configurations in float32.

As ``tests/test_torch_tp_train.py``: this file run as a script, one
process a rank, at a ``file://`` rendezvous: a world of 2 over ``(data 1,
model 2)``, then a world of 4 over ``(data 1, model 4)`` and ``(data 2,
model 2)``, side by side, and one process with no mesh in a
subprocess of its own; the JAX reference in a subprocess a
configuration, its
``jax.value_and_grad(Model.loss)`` jitted bare (the gradient its
``make_train_step`` takes; ``tests/test_torch_tp_mixers.py`` holds the
same models to the reference jitted on the meshes).

Held, for ``minicpm3-4b``, ``deepseek-v3-671b`` (its MTP loss through the
same tensor-parallel block, the embedding of its shifted tokens
vocab-parallel), ``rwkv6-3b``, ``jamba-v0.1-52b`` and
``seamless-m4t-large-v2`` (frame embeddings through the encoder) on the
three meshes: the loss within 1e-5 and every gradient leaf, made whole,
within 1e-4 of its largest value, against one process and (at ``(1, 2)``
and ``(1, 4)``) against the reference; the collectives of a loss and its
backward, counted; remat ``"dots"`` giving the bits of ``"none"``; 3
steps of ``make_train_step(mesh=)`` at ``(1, 2)`` against one process
(the first step's metrics 1e-5, the later steps' 1e-4, parameters
``rtol`` 1e-5 / ``atol`` 1e-4); Jamba's checkpoint written by
``train(mesh=)`` at ``(1, 2)`` (Mamba's ``in_proj`` gathered from its
half-by-half shards) restored bit for bit with no mesh, at ``(1, 2)`` and
at ``(2, 2)``.
"""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("minicpm3-4b", "deepseek-v3-671b", "rwkv6-3b", "jamba-v0.1-52b",
         "seamless-m4t-large-v2")
REMAT_ARCHS = ARCHS
CKPT_ARCH = "jamba-v0.1-52b"
MESHES = {2: ((1, 2),), 4: ((1, 4), (2, 2))}
B, S, S_ENC, STEPS, SEED = 8, 16, 12, 3, 0
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


def _batches(arch):
    """``STEPS`` batches of the synthetic stream; an encoder-decoder's
    with seeded frame embeddings."""
    from repro_torch.data import SyntheticLM
    cfg = _cfg(arch)
    src = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                      seed=SEED)
    rng = np.random.default_rng(SEED + 5)
    out = []
    for s in range(STEPS):
        b = {"tokens": torch.from_numpy(src.batch(s)["tokens"])}
        if cfg.is_encoder_decoder:
            b["enc_embeds"] = torch.from_numpy((rng.standard_normal(
                (B, S_ENC, cfg.d_model)) * 0.02).astype(np.float32))
        out.append(b)
    return out


def loss_and_grads(model, batch, mesh=None):
    """The loss and every gradient leaf made whole, and the collectives
    the loss and its backward issued. With more than one data rank each
    takes its slice of the batch, and the loss and gradients are averaged
    over them after."""
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
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        out[f"g/{n}"] = model.gather(n, mean(g))
        p.grad = None
    return out, counts


def one_process_grads(model, arch, halves):
    """``loss_and_grads`` with no mesh, as a data axis of ``halves`` ranks
    takes it: the mean over the batch's slices."""
    from repro_torch.launch.steps import _split
    parts = [loss_and_grads(model, b)[0]
             for b in _split(_batches(arch)[0], halves)]
    return {k: sum(p[k] for p in parts) / halves for k in parts[0]}


def run_steps(model, arch, mesh=None):
    """``STEPS`` steps of the train step; returns (metrics per step, the
    parameters and moments made whole after the last and after
    ``CKPT_STEP``)."""
    from repro_torch.configs import OptimizerConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import init_opt_state
    ocfg = OptimizerConfig(**OPT)
    params = dict(model.params.named_parameters())
    step = make_train_step(model, ocfg, backend="torch", mesh=mesh)
    state = init_opt_state(ocfg, params, step.zero)
    met, at_ckpt = [], None
    for s, batch in enumerate(_batches(arch)):
        state, m = step(state, batch)
        met.append({k: float(v) for k, v in m.items()})
        if s + 1 == CKPT_STEP:
            at_ckpt = _snapshot(model, state, step.zero)
    return met, _snapshot(model, state, step.zero), at_ckpt


def _snapshot(model, state, zero):
    def whole(n, t):
        return model.gather(n, t if zero is None else zero.gather(n, t))
    snap = {f"p/{n}": model.gather(n, p).clone()
            for n, p in model.params.named_parameters()}
    for which, tree in (("mu", state.mu), ("nu", state.nu)):
        snap.update({f"{which}/{n}": whole(n, t).clone()
                     for n, t in tree.items()})
    snap["step"] = state.step.clone()
    return snap


def _restore(model, ckpt_dir, mesh=None):
    """``model`` (fresh parameters) with the state of the checkpoint at
    ``CKPT_STEP`` restored, made whole; on a mesh each rank keeps its
    shards and its ZeRO-1 slices."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import OptimizerConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import _zero_placement
    from repro_torch.models import convert
    from repro_torch.optim import init_opt_state
    model.requires_grad_(True)
    params = dict(model.params.named_parameters())
    ocfg = OptimizerConfig(**OPT)
    zero = make_train_step(model, ocfg, backend="torch",
                           mesh=mesh).zero if mesh is not None else None
    state = init_opt_state(ocfg, params, zero)
    CheckpointManager(str(ckpt_dir)).restore(
        CKPT_STEP, convert.train_state_tree(params, state, model.cfg),
        placement_fn=None if mesh is None else
        _zero_placement(params, zero, model.cfg, model))
    return _snapshot(model, state, zero)


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
    from repro_torch.configs import OptimizerConfig
    from repro_torch.launch.train import train
    from repro_torch.models.api import build_model
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    init = lambda arch: os.path.join(jax_dir, f"init_{arch}.npz")
    done = pathlib.Path(ckpt_dir).parent / "ckpt_done"
    try:
        res = {}
        for shape in MESHES[world]:
            mesh, tag = _local_mesh(shape), _tag(shape)
            if shape == (1, 2):
                r = train(arch=CKPT_ARCH, model=_model(CKPT_ARCH,
                                                       init(CKPT_ARCH), mesh),
                          steps=CKPT_STEP, seq_len=S, global_batch=B,
                          seed=SEED, log_every=0, device="cpu",
                          backend="torch", opt_cfg=OptimizerConfig(**OPT),
                          mesh=mesh, ckpt_dir=ckpt_dir,
                          ckpt_every=CKPT_STEP)
                res["train_losses"] = r.losses
                if rank == 0:
                    done.touch()
            for arch in ARCHS:
                remats = ("none", "dots") if arch in REMAT_ARCHS and \
                    shape == (1, 2) else ("none",)
                for remat in remats:
                    g, counts = loss_and_grads(
                        _model(arch, init(arch), mesh, remat=remat),
                        _batches(arch)[0], mesh)
                    _save(os.path.join(out, f"g_{arch}_{remat}_{tag}_{rank}"
                                            f".npz"), g)
                    res[f"loss_counts_{arch}_{remat}_{tag}"] = counts
                if shape == (1, 2):
                    met, snap, ck = run_steps(_model(arch, init(arch), mesh),
                                              arch, mesh)
                    res[f"steps_{arch}"] = met
                    _save(os.path.join(out, f"s_{arch}_{rank}.npz"), snap)
                    if arch == CKPT_ARCH:
                        _save(os.path.join(out, f"ckpt_{rank}.npz"), ck)
            if shape in ((1, 2), (2, 2)):
                # a fresh seed's parameters, the (1, 2) checkpoint restored
                deadline = time.monotonic() + 300
                while not done.exists():
                    assert time.monotonic() < deadline, "no checkpoint"
                    time.sleep(0.2)
                fresh = build_model(_cfg(CKPT_ARCH), device="cpu", mesh=mesh)
                fresh.init(SEED + 1)
                _save(os.path.join(out, f"restored_{tag}_{rank}.npz"),
                      _restore(fresh, ckpt_dir, mesh))
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _one_process(out, jax_dir, ckpt_dir):
    """One process, no mesh, beside the ranks: each model's loss and
    gradients as a data axis of 1 and of 2 takes them
    (:func:`one_process_grads`), its ``STEPS`` train steps
    (:func:`run_steps`), and the ranks' checkpoint restored, once world 2
    has written it."""
    init = lambda arch: os.path.join(jax_dir, f"init_{arch}.npz")
    for arch in ARCHS:
        for halves in (1, 2):
            _save(os.path.join(out, f"g_{arch}_{halves}.npz"),
                  one_process_grads(_model(arch, init(arch)), arch, halves))
        met, snap, _ = run_steps(_model(arch, init(arch)), arch)
        _save(os.path.join(out, f"s_{arch}.npz"), snap)
        with open(os.path.join(out, f"steps_{arch}.json"), "w") as f:
            json.dump(met, f)
    done = pathlib.Path(ckpt_dir).parent / "ckpt_done"
    deadline = time.monotonic() + 300
    while not done.exists():
        assert time.monotonic() < deadline, "no checkpoint"
        time.sleep(0.2)
    from repro_torch.models.api import build_model
    fresh = build_model(_cfg(CKPT_ARCH), device="cpu")
    fresh.init(SEED + 1)
    _save(os.path.join(out, "restored_1x1.npz"), _restore(fresh, ckpt_dir))


def _jax_oracle(out, arch):
    """The reference's initial parameters for ``arch`` (then the file
    ``init_<arch>.done``); its loss and gradients of the first batch,
    jitted bare."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import transformer as jtfm
    from repro.models.api import build_model as jbuild
    jcfg = jconfigs.get_model_config(arch, smoke=True).replace(
        dtype="float32", param_dtype="float32")
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(SEED))
    np.savez(os.path.join(out, f"init_{arch}.npz"), **{
        p.strip("/"): np.asarray(v) for p, v in jtfm._iter_paths(params)})
    pathlib.Path(out, f"init_{arch}.done").touch()
    batch = {k: jnp.asarray(v.numpy(), jnp.int32 if k == "tokens"
                            else jnp.float32)
             for k, v in _batches(arch)[0].items()}
    (loss, _), g = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, batch)
    res = {"loss": np.asarray(loss)}
    res.update({f"g{path}": np.asarray(v)
                for path, v in jtfm._iter_paths(g)})
    np.savez(os.path.join(out, f"g_{arch}.npz"), **res)


def _env(**extra):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    env.update(extra)
    return env


def _launch(world, args, tmp):
    return [subprocess.Popen(
        [sys.executable, __file__, "worker", str(world), str(r),
         str(tmp / f"rdv{world}")] + [str(a) for a in args],
        env=_env(), cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _jax(args):
    """This file as a subprocess: the JAX oracle, or the one-process
    runs."""
    return subprocess.Popen(
        [sys.executable, __file__] + [str(a) for a in args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(ROOT), env=_env())


def _wait(procs):
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's oracle, a process a configuration; once they have
    written their initial parameters, both worlds and one process beside
    them, each a single-threaded process (the world of 4 and the one
    process restore the world of 2's checkpoint once it is written)."""
    tmp = tmp_path_factory.mktemp("tp_mixers_train")
    jax_out = tmp / "jax"
    jax_out.mkdir()
    jax_procs = [_jax(["jax", jax_out, arch]) for arch in ARCHS]
    deadline = time.monotonic() + 600
    while not all((jax_out / f"init_{a}.done").exists() for a in ARCHS):
        if any(p.poll() not in (None, 0) for p in jax_procs) or \
                time.monotonic() > deadline:
            _wait(jax_procs)
            pytest.fail("the reference wrote no initial parameters")
        time.sleep(0.2)
    dirs = {w: tmp / f"w{w}" for w in MESHES}
    ckpt = tmp / "ckpt"
    one = tmp / "one"
    one.mkdir()
    procs = jax_procs + [_jax(["one", one, jax_out, ckpt])]
    for w, d in dirs.items():
        d.mkdir()
        procs += _launch(w, [d, jax_out, ckpt], tmp)
    _wait(procs)
    return {"jax": jax_out, "ckpt": ckpt, "one": one, **dirs}


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
MODEL_SHAPES = ((1, 2), (1, 4))


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_torch_tp_mixers_loss_and_gradients_match_one_process(runs, arch,
                                                              shape):
    want = _load(runs["one"] / f"g_{arch}_{shape[0]}.npz")
    world = shape[0] * shape[1]
    for r in range(world):
        got = _load(runs[world] / f"g_{arch}_none_{_tag(shape)}_{r}.npz")
        assert set(got) == set(want)
        for k, w in want.items():
            _near(got[k], w, 1e-5 if k == "loss" else 1e-4,
                  f"{shape} rank {r} {k}")


@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_torch_tp_mixers_loss_and_gradients_match_the_reference(runs, arch,
                                                                shape):
    """Against ``jax.value_and_grad`` of the reference's loss, jitted
    bare, on the same batch: at ``(1, 2)`` and ``(1, 4)``, whose one data
    rank takes the whole batch (at ``(2, 2)`` a MoE's aux loss is each
    half's, held against one process's accumulation over the halves)."""
    ref = _load(runs["jax"] / f"g_{arch}.npz")
    want = _reference_grads(ref, _cfg(arch))
    world = shape[0] * shape[1]
    got = _load(runs[world] / f"g_{arch}_none_{_tag(shape)}_0.npz")
    _near(got["loss"], ref["loss"], 1e-5, "loss")
    assert set(want) == set(got) - {"loss"}
    for k, w in want.items():
        _near(got[k], w, 1e-4, f"{shape} {k}")


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_torch_tp_mixers_remat_dots_gives_the_same_bits(runs, arch):
    """Remat ``"dots"`` at ``(1, 2)``: each block's recompute binds the
    mesh again (the mixers' copies into the model axis among it; the
    encoder's blocks too) and the loss and every gradient leaf keep the
    bits of ``"none"``."""
    for r in range(2):
        none = _load(runs[2] / f"g_{arch}_none_1x2_{r}.npz")
        dots = _load(runs[2] / f"g_{arch}_dots_1x2_{r}.npz")
        for k in none:
            np.testing.assert_array_equal(dots[k], none[k], err_msg=k)


def _mixer_copies(cfg, kind, tp):
    """The ``copy_to_model`` a block's mixer and cross attention enter in
    the forward, whose backward all-reduces: GQA its input (and the KV
    projection's leaves every rank keeps whole under the KV fallback),
    MLA the normed q latent, ``c`` and ``kr``, RWKV-6's time mix its four
    column-parallel inputs, the decay's low-rank activation and five
    leaves read at its heads, Mamba its input, ``dt_low``, ``B``, ``C``
    and ``dt_bias``, cross attention ``x`` and the memory; none for a
    mixer that runs whole."""
    kv_fallback = 0 if cfg.padded_kv_heads() % tp == 0 else \
        (4 if cfg.qkv_bias else 2)
    n = 0
    if kind.mixer == "gqa" and cfg.padded_heads() % tp == 0:
        n += 1 + kv_fallback
    elif kind.mixer == "mla" and cfg.padded_heads() % tp == 0:
        n += 3
    elif kind.mixer == "rwkv" and cfg.num_heads % tp == 0:
        n += 10
    elif kind.mixer == "mamba":
        n += 5
    if kind.cross:
        n += 2 + kv_fallback
    return n


def _mlp_copies(cfg, kind):
    """The MLP's: its input (the MoE's tokens and routing weights, and its
    shared experts' input)."""
    if kind.mlp == "moe":
        return 2 + int(cfg.moe.num_shared_experts > 0)
    return 1


def _forward_reduces(cfg, kind, tp):
    """A block's all-reduces in the forward (``test_torch_tp_mixers``'s
    ``_layer_collectives`` for one layer)."""
    whole = (kind.mixer == "rwkv" and cfg.num_heads % tp) or \
        (kind.mixer in ("gqa", "mla") and cfg.padded_heads() % tp)
    n = 0 if whole else (2 if kind.mixer == "mamba" else 1)
    n += int(kind.cross) + 1
    return n + int(kind.mlp == "moe" and cfg.moe.num_shared_experts > 0)


def _expected_counts(arch, shape):
    """The all-reduces of a loss and its backward (before any reduction
    over ``data``): the embedding's, each block's forward ones and, in
    the backward, its copies into the model axis, the cross entropy's
    three (max, sum of exponentials, target logit) and the head's copy;
    a MoE's aux mean over ``data`` where it has more than one rank; the
    encoder's two a layer forward and one copy a layer backward;
    DeepSeek-V3's MTP block as one more block after its own embedding
    and before its own cross entropy and head."""
    from repro_torch.models import transformer as tfm
    cfg = _cfg(arch)
    dp, tp = shape
    kinds = [tfm._kind(cfg, i) for i in range(cfg.num_layers)]
    if cfg.mtp_depth:
        kinds.append(tfm.kind_for_layer(cfg, cfg.num_layers - 1))
    n = (1 + 3 + 1) * (1 + cfg.mtp_depth)
    for k in kinds:
        n += _forward_reduces(cfg, k, tp) + _mixer_copies(cfg, k, tp) + \
            _mlp_copies(cfg, k) + int(k.mlp == "moe" and dp > 1)
    if cfg.is_encoder_decoder:
        n += cfg.num_encoder_layers * (2 + 2)
    return n


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_torch_tp_mixers_collectives_of_a_loss_and_its_backward(runs, arch,
                                                               shape):
    world = shape[0] * shape[1]
    for r in range(world):
        res = _json(runs[world] / f"rank{r}.json")
        for remat in (("none", "dots") if arch in REMAT_ARCHS and
                      shape == (1, 2) else ("none",)):
            got = res[f"loss_counts_{arch}_{remat}_{_tag(shape)}"]
            want = _expected_counts(arch, shape)
            if remat == "dots":
                # each block's recompute issues its forward all-reduces
                # up to the last tensor its backward needs again: all
                # but the MLP's, which its backward does not read, except
                # the channel mix's, which its receptance gate multiplies
                from repro_torch.models import transformer as tfm
                cfg = _cfg(arch)
                kinds = [tfm._kind(cfg, i) for i in range(cfg.num_layers)]
                want += sum(_forward_reduces(cfg, k, 2) - (k.mlp != "cmix")
                            for k in kinds) + cfg.num_encoder_layers
            assert got == {"all_reduce": want}, (remat, r, got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_torch_tp_mixers_train_steps_match_one_process(runs, arch):
    """3 steps of ``make_train_step(mesh=)`` at ``(1, 2)`` against one
    process's on the same batches: the first step's metrics within 1e-5,
    the later steps' within 1e-4, parameters ``rtol`` 1e-5 / ``atol``
    1e-4. The later steps are looser because AdamW divides each gradient
    element by its own magnitude: RWKV-6's ``decay_a`` and ``mu_x`` have
    elements whose gradient is some 1e-10, as large as the two runs'
    rounding difference, so the first update moves them by different
    fractions of the learning rate, and the second step's gradient norm
    differs by 2.5e-5 of itself while its loss agrees to 1e-7."""
    met = _json(runs["one"] / f"steps_{arch}.json")
    snap = _load(runs["one"] / f"s_{arch}.npz")
    for r in range(2):
        got_met = _json(runs[2] / f"rank{r}.json")[f"steps_{arch}"]
        assert len(got_met) == len(met) == STEPS
        for s, (a, b) in enumerate(zip(got_met, met)):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_allclose(a[k], b[k],
                                           rtol=1e-5 if s == 0 else 1e-4,
                                           atol=1e-7, err_msg=(s, k))
        got = _load(runs[2] / f"s_{arch}_{r}.npz")
        for k, v in snap.items():
            if k.startswith("p/"):
                np.testing.assert_allclose(got[k], v, rtol=1e-5,
                                           atol=1e-4, err_msg=k)


def _hold_restored(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=(what, k))


def test_torch_tp_mixers_checkpoint_at_1x2_restores_at_1x1(runs):
    """``train(mesh=)`` at ``(1, 2)`` gathered every model-sharded leaf
    (Mamba's ``in_proj`` from its halves) and rank 0 wrote whole ones;
    restored with no mesh they are the state the step reached at the
    save, bit for bit."""
    res = _json(runs[2] / "rank0.json")
    assert res["train_losses"] == [m["loss"] for m in
                                   res[f"steps_{CKPT_ARCH}"][:CKPT_STEP]]
    want = _load(runs[2] / "ckpt_0.npz")
    got = _load(runs["one"] / "restored_1x1.npz")
    _hold_restored(got, want, "(1, 1)")
    assert not np.array_equal(got["p/blocks.0.mixer.in_proj"][:, :8],
                              got["p/blocks.0.mixer.in_proj"][:, -8:])


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=_tag)
def test_torch_tp_mixers_checkpoint_at_1x2_restores_on_a_mesh(runs, shape):
    """The same checkpoint restored at ``(1, 2)`` and at ``(2, 2)``: each
    rank holds its model shard of every sharded leaf (``in_proj`` cut half
    by half) and its data slice of the moments, and made whole they are
    the saved state, bit for bit."""
    want = _load(runs[2] / "ckpt_0.npz")
    world = shape[0] * shape[1]
    for r in range(world):
        _hold_restored(_load(runs[world] / f"restored_{_tag(shape)}_{r}.npz"),
                       want, (shape, r))


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_oracle(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "one":
        _one_process(sys.argv[2], sys.argv[3], sys.argv[4])
    else:
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
                sys.argv[6], sys.argv[7])
