"""Context-parallel prefill and training: the ``seq`` axis rule bound to
``data`` at batch 1 cuts the activations' sequence into a block a rank,
over worlds of ``gloo`` CPU ranks, on smoke configurations in float32.

As ``tests/test_torch_context_parallel.py``: this file run as a script,
one process a rank, at a ``file://`` rendezvous, the ranks of each world
meeting once (a world of 2 over ``(data 2, model 1)``, a world of 4 over
``(data 2, model 2)``: ``long_500k``'s composition of ``seq -> data``
with tensor parallelism), one process with no mesh beside them, and the
JAX reference in two subprocesses over 4 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``), of
``AxisType.Auto`` axes, which write their initial parameters first and
run each case jitted under the same rules, the parameters placed by
``param_shardings``.

Held, for ``mixtral-8x7b`` (an 80-token prompt in a 64-slot window: the
ring wraps; also on ``(2, 2)``), ``jamba-v0.1-52b`` (Mamba, attention and
MoE layers), ``rwkv6-3b`` (K6's state and both token shifts across the
boundary), ``minicpm3-4b`` (MLA), ``seamless-m4t-large-v2`` (the encoder
cut too, the memory gathered for cross attention), ``qwen2-vl-2b``
(patches on both sides of the boundary, one counted from the end and one
dropped, M-RoPE) and ``deepseek-v3-671b`` (MTP), against the reference
under the rule and against one process: ``make_prefill_step``'s
last-token logits and the cache gathered back whole (1e-5 of the largest
value), the greedy decode after it on the prefill's own cut cache
(logits 1e-5, tokens equal), the loss (1e-5) and every gradient leaf
(1e-4 of its largest value) averaged over ``data`` as the step averages
them, ``generate``'s tokens (under the bound rule); against one process also one
``make_train_step(mesh=)`` step (its loss 1e-5, the parameters after it
``rtol`` 1e-5 / ``atol`` 1e-5); the collectives over the sequence's axis
of a prefill and of a loss with its backward, exact (each rank's other
collectives, the tensor-parallel ones, left out); remat ``"dots"`` bit
for bit with ``"none"``; the chunked loss (DeepSeek-V3, MTP included)
against one process. Refusals: ``seq -> model`` in a prefill and a train
step raises ``ValueError`` where the reference raises
``DuplicateSpecError`` (the subprocess shows it), as does ``seq -> data``
at a batch that ``data`` divides; ``encode`` under ``seq -> model``,
which the reference runs, runs cut over ``model`` and is held to it
(``tests/test_torch_sp_prefill.py`` holds that cut throughout). A length
the axis does not divide stays whole, the fallback recorded, bit for bit
the run without the rule.
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
SEED, NEW, S_ENC = 0, 4, 24
RULES = {"seq": "data"}
# name: (arch, mesh (data, model), prompt tokens)
CASES = {
    "mixtral": ("mixtral-8x7b", (2, 1), 80),
    "mixtral_2x2": ("mixtral-8x7b", (2, 2), 80),
    "jamba": ("jamba-v0.1-52b", (2, 1), 32),
    "rwkv6": ("rwkv6-3b", (2, 1), 32),
    "minicpm3": ("minicpm3-4b", (2, 1), 32),
    "seamless": ("seamless-m4t-large-v2", (2, 1), 32),
    "qwen2vl": ("qwen2-vl-2b", (2, 1), 32),
    "deepseek": ("deepseek-v3-671b", (2, 1), 32),
}
# the reference's cases, split over two subprocesses; the first also
# shows the duplicate specs, the second the encoder under seq -> model
JAX_GROUPS = (("mixtral", "mixtral_2x2", "jamba", "rwkv6"),
              ("minicpm3", "seamless", "qwen2vl", "deepseek"))
# a row's patches (vision): positions on both sides of the block
# boundary at 16, one counted from the end (-1: 31), one dropped (40)
PATCH_POSITIONS = [3, 10, 15, 16, 17, 25, -1, 40]


def _cfg(arch, **kw):
    from repro_torch import configs
    return configs.get_model_config(arch, smoke=True).replace(
        dtype="float32", param_dtype="float32", **kw)


def _batch(cfg, S, extra=0, B=1):
    """The prompt (``extra`` tokens more for a loss) and the modality
    inputs, from a seed: frame embeddings for the encoder-decoder,
    patches and M-RoPE positions for the vision model."""
    rng = np.random.default_rng(SEED)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S + extra))}
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = (rng.standard_normal((B, S_ENC, cfg.d_model))
                             * 0.02).astype(np.float32)
    if cfg.frontend == "vision":
        n = len(PATCH_POSITIONS)
        out["patch_embeds"] = rng.standard_normal(
            (B, n, cfg.d_model)).astype(np.float32)
        out["patch_positions"] = np.array([PATCH_POSITIONS] * B)
        out["mrope_positions"] = rng.integers(0, S, size=(3, B, S))
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _tree(npz):
    tree = {}
    for path, a in np.load(npz).items():
        *parents, leaf = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree


def _model(arch, jax_dir, mesh=None, **kw):
    from repro_torch.models import convert
    return convert.params_from_jax(
        _tree(os.path.join(jax_dir, f"init_{arch}.npz")), _cfg(arch, **kw),
        device="cpu", mesh=mesh)


def _cache_leaves(cache, model):
    """Copies of the cache's tensors (a decode step writes it in place)
    by ``layer/part/name``, each KV head whole (gathered over ``model``
    where a rank holds its heads)."""
    from repro_torch.launch import sharding as shd
    out = {}
    with model.bound():
        for i, layer in enumerate(cache):
            for part, leaves in layer.items():
                for n, t in leaves.items():
                    if n in ("k", "v") and t.shape[2] < \
                            model.cfg.padded_kv_heads():
                        t = shd.gather_from_model(t, 2)
                    out[f"{i}/{part}/{n}"] = t.clone()
    return out


class _SeqCounter:
    """The collectives the port issues over one process group (the
    sequence's axis), by kind, while entered
    (``launch.mesh.collective_counts(group)``)."""

    def __init__(self, group):
        self.group, self.counts = group, {}

    def __enter__(self):
        from repro_torch.launch import mesh as mesh_lib
        mesh_lib.reset_collective_counts()
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import mesh as mesh_lib
        self.counts = mesh_lib.collective_counts(self.group)


def _run(model, arch, S, mesh=None, group=None):
    """A case on ``model``: (with ``mesh``) under ``RULES``, the prefill
    through ``make_prefill_step``, the cache gathered back whole, ``NEW``
    greedy decode steps on the prefill's cache, the loss and every
    gradient leaf (averaged over ``data``, as the step averages them,
    and made whole), ``generate``'s tokens, then one
    ``make_train_step`` step: its loss and the parameters after it. With
    ``group`` the collectives over it of the prefill and of the loss with
    its backward."""
    import contextlib
    from repro_torch.configs import OptimizerConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import (make_decode_step,
                                          make_prefill_step, make_train_step)
    from repro_torch.optim import init_opt_state
    from repro_torch.optim.compress import mean_over
    cfg = model.cfg
    out, counts = {}, {}
    rules = shd.axis_rules(mesh, RULES) if mesh is not None else \
        contextlib.nullcontext()
    count = (lambda: _SeqCounter(group)) if group is not None else \
        contextlib.nullcontext
    batch = _torch(_batch(cfg, S))
    with rules:
        with torch.no_grad():
            with count() as c:
                logits, cache = make_prefill_step(
                    model, S + NEW, backend="torch", mesh=mesh)(batch)
            if c is not None:
                counts["prefill"] = c.counts
            out["prefill"] = logits
            whole = model.gather_cache(cache) if mesh is not None else cache
            out.update({f"cache/{k}": t for k, t in
                        _cache_leaves(whole, model).items()})
            memory = model.encode(batch["enc_embeds"], backend="torch") \
                if cfg.is_encoder_decoder else None
            decode = make_decode_step(model, backend="torch", mesh=mesh)
            tok = logits.argmax(-1)
            toks = [tok]
            for i in range(NEW):
                kv_len = torch.full((1,), S + i + 1, dtype=torch.int32)
                lg, cache = decode(tok, S + i, kv_len, cache, memory)
                out[f"decode{i}"] = lg
                tok = lg.argmax(-1)
                toks.append(tok)
            out["tokens"] = torch.stack(toks, 1)
            gen, _ = generate(arch=arch, prompt_tokens=batch["tokens"],
                              max_new_tokens=NEW, model=model,
                              backend="torch", enc_embeds=batch.get(
                                  "enc_embeds"), mesh=mesh)
            out["generate"] = gen[:, S:]
        model.requires_grad_(True)
        params = dict(model.params.named_parameters())
        lb = _torch(_batch(cfg, S, extra=1))
        with count() as c:
            loss, _ = model.loss(lb, backend="torch")
            loss.backward()
        if c is not None:
            counts["loss_and_backward"] = c.counts
        dp = 1 if mesh is None else mesh_lib.mesh_shape(mesh)["data"]
        mean = (lambda t: t) if dp == 1 else \
            (lambda t: mean_over(t, mesh_lib.axes_group(mesh, ("data",)),
                                 dp))
        out["loss"] = mean(loss.detach())
        for n, p in params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            out[f"g/{n}"] = model.gather(n, mean(g))
            p.grad = None
        opt = OptimizerConfig(warmup_steps=1, total_steps=4)
        step = make_train_step(model, opt, backend="torch", mesh=mesh)
        state = init_opt_state(opt, params, step.zero)
        _, metrics = step(state, lb)
        out["step_loss"] = metrics["loss"]
        for n, p in params.items():
            out[f"p/{n}"] = model.gather(n, p.detach())
        model.requires_grad_(False)
    return out, counts


def _extras(rank, mesh2x1, mesh1x2, jax_dir):
    """On the world of 2: remat ``"dots"`` against ``"none"`` (Jamba's
    gradients, bit for bit); the chunked loss (DeepSeek-V3's, MTP
    included); the refusals; a length the axis does not divide."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.configs import OptimizerConfig
    from repro_torch.optim import init_opt_state
    from repro_torch.optim.compress import mean_over
    from repro_torch.launch import mesh as mesh_lib
    data = mesh_lib.axes_group(mesh2x1, ("data",))
    res, tensors = {}, {}

    def grads(model, lb):
        """The loss and each rank's gradient averaged over ``data``, as
        the step averages it."""
        model.requires_grad_(True)
        loss, _ = model.loss(lb, backend="torch")
        loss.backward()
        out = {"loss": loss.detach()}
        for n, p in model.params.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            out[n] = mean_over(g.clone(), data, 2)
            p.grad = None
        model.requires_grad_(False)
        return out

    lb = _torch(_batch(_cfg("jamba-v0.1-52b"), 32, extra=1))
    with shd.axis_rules(mesh2x1, RULES):
        none = grads(_model("jamba-v0.1-52b", jax_dir, mesh2x1), lb)
        dots = grads(_model("jamba-v0.1-52b", jax_dir, mesh2x1,
                            remat="dots"), lb)
    res["remat_bit_identical"] = all(torch.equal(none[k], dots[k])
                                     for k in none)
    # the chunked loss: 32 positions in chunks of 6 (16 a rank: 6, 6, 4)
    lb = _torch(_batch(_cfg("deepseek-v3-671b"), 32, extra=1))
    with shd.axis_rules(mesh2x1, RULES):
        got = grads(_model("deepseek-v3-671b", jax_dir, mesh2x1,
                           loss_chunk=6), lb)
    tensors.update({f"chunked/{k}": v for k, v in got.items()})
    # refusals: seq -> model maps model twice with the vocabulary; seq ->
    # data at a batch data divides maps data twice with the batch
    moe1x2 = _model("mixtral-8x7b", jax_dir, mesh1x2)
    moe2x1 = _model("mixtral-8x7b", jax_dir, mesh2x1)
    opt = OptimizerConfig(warmup_steps=1, total_steps=4)

    def prefill(model, mesh, B=1):
        return make_prefill_step(model, 36, backend="torch", mesh=mesh)(
            {"tokens": torch.zeros((B, 32), dtype=torch.long)})

    def train(model, mesh):
        model.requires_grad_(True)
        params = dict(model.params.named_parameters())
        step = make_train_step(model, opt, backend="torch", mesh=mesh)
        try:
            return step(init_opt_state(opt, params, step.zero),
                        {"tokens": torch.zeros((1, 33), dtype=torch.long)})
        finally:
            model.requires_grad_(False)
    for what, call, mesh, rules in (
            ("prefill_seq_model", lambda: prefill(moe1x2, mesh1x2),
             mesh1x2, {"seq": "model"}),
            ("train_seq_model", lambda: train(moe1x2, mesh1x2), mesh1x2,
             {"seq": "model"}),
            ("prefill_batch_divides", lambda: prefill(moe2x1, mesh2x1, 2),
             mesh2x1, RULES)):
        with shd.axis_rules(mesh, rules):
            try:
                call()
                res[what] = ""
            except ValueError as e:
                res[what] = f"ValueError: {e}"
    seamless = _model("seamless-m4t-large-v2", jax_dir, mesh1x2)
    with shd.axis_rules(mesh1x2, {"seq": "model"}), torch.no_grad():
        frames = _torch(_batch(seamless.cfg, 32))["enc_embeds"]
        res["encode_seq_model_cut"] = list(shd.activation_axes(
            *frames.shape[:2]) or ())
        tensors["encode_seq_model"] = seamless.encode(frames,
                                                      backend="torch")
    # 21 prompt tokens (and 21 positions in the loss), which 2 does not
    # divide: whole on both ranks, the fallback recorded, bit for bit
    model = _model("jamba-v0.1-52b", jax_dir, mesh2x1)
    plain = {}
    for rules in (None, RULES):
        with shd.axis_rules(mesh2x1, rules), torch.no_grad():
            logits, cache = make_prefill_step(
                model, 25, backend="torch", mesh=mesh2x1)(
                {"tokens": torch.arange(21)[None]})
            loss, _ = model.loss({"tokens": torch.arange(22)[None]},
                                 backend="torch")
            if rules:
                res["odd_fallbacks"] = [list(f) for f in shd.fallbacks()]
        got = {"logits": logits, "loss": loss,
               **_cache_leaves(cache, model)}
        if rules is None:
            plain = got
        else:
            res["odd_bit_identical"] = all(torch.equal(plain[k], got[k])
                                           for k in plain)
    return res, tensors


def _save(path, tensors):
    np.savez(path, **{k: v.float().numpy() for k, v in tensors.items()})


def _wait_for(paths, what):
    deadline = time.monotonic() + 300
    while not all(pathlib.Path(p).exists() for p in paths):
        assert time.monotonic() < deadline, what
        time.sleep(0.2)


def _init_done(jax_dir):
    return [os.path.join(jax_dir, f"init{g}.done")
            for g in range(len(JAX_GROUPS))]


def _worker(world, rank, rdv, out, jax_dir):
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    try:
        shapes = ((2, 1), (1, 2)) if world == 2 else ((2, 2),)
        meshes = {s: mesh_lib.make_mesh(
            mesh_lib.MeshConfig(s, ("data", "model")), device_type="cpu")
            for s in shapes}
        _wait_for(_init_done(jax_dir), "no initial parameters")
        res = {}
        for name, (arch, shape, S) in CASES.items():
            if shape not in meshes:
                continue
            mesh = meshes[shape]
            model = _model(arch, jax_dir, mesh)
            got, counts = _run(model, arch, S, mesh,
                               mesh_lib.axes_group(mesh, ("data",)))
            _save(os.path.join(out, f"{name}_{rank}.npz"), got)
            res[name] = counts
        if world == 2:
            res["extras"], tensors = _extras(rank, meshes[(2, 1)],
                                             meshes[(1, 2)], jax_dir)
            _save(os.path.join(out, f"extras_{rank}.npz"), tensors)
        with open(os.path.join(out, f"rank{world}_{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _one_process(out, jax_dir):
    """Each case and the chunked loss with no mesh."""
    torch.set_num_threads(1)
    _wait_for(_init_done(jax_dir), "no initial parameters")
    for name, (arch, _, S) in CASES.items():
        if name.endswith("_2x2"):
            continue
        got, _ = _run(_model(arch, jax_dir), arch, S)
        _save(os.path.join(out, f"{name}.npz"), got)
    model = _model("deepseek-v3-671b", jax_dir, loss_chunk=6)
    model.requires_grad_(True)
    loss, _ = model.loss(_torch(_batch(model.cfg, 32, extra=1)),
                         backend="torch")
    loss.backward()
    tensors = {"chunked/loss": loss.detach()}
    for n, p in model.params.named_parameters():
        tensors[f"chunked/{n}"] = p.grad if p.grad is not None else \
            torch.zeros_like(p)
    _save(os.path.join(out, "extras.npz"), tensors)


def _jax_oracle(out, group):
    """The reference's initial parameters of the group's architectures
    (then ``init<group>.done``), then each case under ``{"seq": "data"}``
    on its mesh: the prefill, the cache, the greedy decode after it, the
    loss and its gradients; the first group also the duplicate specs'
    errors, the second the encoder under ``seq -> model``."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.launch import sharding as jshd
    from repro.launch.steps import (make_decode_step, make_prefill_step,
                                    param_shardings)
    from repro.models import transformer as jtfm
    from repro.models.api import build_model as jbuild
    assert len(jax.devices()) == 4
    names = JAX_GROUPS[int(group)]
    models = {}
    for name in names:
        arch = CASES[name][0]
        if arch not in models:
            jcfg = jconfigs.get_model_config(arch, smoke=True).replace(
                dtype="float32", param_dtype="float32")
            jm = jbuild(jcfg)
            params = jm.init(jax.random.PRNGKey(SEED))
            np.savez(os.path.join(out, f"init_{arch}.npz"), **{
                p.strip("/"): np.asarray(v)
                for p, v in jtfm._iter_paths(params)})
            models[arch] = (jcfg, jm, params)
    pathlib.Path(out, f"init{group}.done").touch()

    def mesh_of(shape):
        return jax.make_mesh(shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2,
                             devices=jax.devices()[:shape[0] * shape[1]])

    def jbatch(b):
        return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i"
                               else jnp.float32) for k, v in b.items()}

    for name in names:
        arch, shape, S = CASES[name]
        jcfg, jm, params = models[arch]
        mesh = mesh_of(shape)
        res = {}
        with mesh, jshd.axis_rules(mesh, RULES):
            p = jax.device_put(params, param_shardings(mesh, jm, params))
            batch = jbatch(_batch(jcfg, S))
            logits, cache = jax.jit(make_prefill_step(jm, S + NEW))(p, batch)
            res["prefill"] = np.asarray(logits)
            res.update({f"cache{k}": np.asarray(v)
                        for k, v in jtfm._iter_paths(cache)})
            memory = None
            if jcfg.is_encoder_decoder:
                memory = jax.jit(lambda q, e: jtfm.encode(q, jcfg, e))(
                    p, batch["enc_embeds"])
            decode = jax.jit(make_decode_step(jm))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            toks = [np.asarray(tok)]
            for i in range(NEW):
                lg, cache = decode(p, tok, jnp.asarray(S + i, jnp.int32),
                                   jnp.full((1,), S + i + 1, jnp.int32),
                                   cache, memory)
                res[f"decode{i}"] = np.asarray(lg)
                tok = jnp.argmax(lg, -1).astype(jnp.int32)
                toks.append(np.asarray(tok))
            res["tokens"] = np.stack(toks, 1)
            (loss, _), g = jax.jit(jax.value_and_grad(
                jm.loss, has_aux=True))(p, jbatch(_batch(jcfg, S, extra=1)))
            res["loss"] = np.asarray(loss)
            res.update({f"g{k}": np.asarray(v)
                        for k, v in jtfm._iter_paths(g)})
        np.savez(os.path.join(out, f"{name}.npz"), **res)

    def error_of(fn):
        try:
            fn()
            return ""
        except Exception as e:  # noqa: BLE001 -- the type is the result
            return type(e).__name__
    errors = {}
    if int(group) == 0:
        jcfg, jm, params = models["mixtral-8x7b"]
        for what, shape, rules, B in (
                ("prefill_seq_model", (1, 2), {"seq": "model"}, 1),
                ("train_seq_model", (1, 2), {"seq": "model"}, 1),
                ("prefill_batch_divides", (2, 1), RULES, 2)):
            mesh = mesh_of(shape)

            def call():
                with mesh, jshd.axis_rules(mesh, rules):
                    p = jax.device_put(params,
                                       param_shardings(mesh, jm, params))
                    if what.startswith("train"):
                        jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
                            p, {"tokens": jnp.zeros((B, 33), jnp.int32)})
                    else:
                        jax.jit(make_prefill_step(jm, 36))(
                            p, {"tokens": jnp.zeros((B, 32), jnp.int32)})
            errors[what] = error_of(call)
    else:
        jcfg, jm, params = models["seamless-m4t-large-v2"]
        mesh = mesh_of((1, 2))

        def encode():
            with mesh, jshd.axis_rules(mesh, {"seq": "model"}):
                p = jax.device_put(params, param_shardings(mesh, jm, params))
                memory = jax.jit(lambda q, e: jtfm.encode(q, jcfg, e))(
                    p, jbatch(_batch(jcfg, 32))["enc_embeds"])
            np.save(os.path.join(out, "encode_seq_model.npy"),
                    np.asarray(memory))
        errors["encode_seq_model"] = error_of(encode)
    pathlib.Path(out, f"errors{group}.json").write_text(json.dumps(errors))


def _env(**extra):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    env.update(extra)
    return env


def _spawn(args, **env):
    return subprocess.Popen(
        [sys.executable, __file__] + [str(a) for a in args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(ROOT), env=_env(**env))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's two subprocesses, the ranks of both worlds and one
    process, side by side (the ranks and one process start their work
    once the reference has written its initial parameters)."""
    tmp = tmp_path_factory.mktemp("cp_prefill")
    jax_out, out, one = tmp / "jax", tmp / "ranks", tmp / "one"
    for d in (jax_out, out, one):
        d.mkdir()
    procs = [_spawn(["jax", jax_out, g],
                    XLA_FLAGS="--xla_force_host_platform_device_count=4")
             for g in range(len(JAX_GROUPS))]
    procs.append(_spawn(["one", one, jax_out]))
    for world in (2, 4):
        procs += [_spawn(["worker", world, r, tmp / f"rdv{world}", out,
                          jax_out]) for r in range(world)]
    logs = [p.communicate(timeout=900)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    res = {}
    for world in (2, 4):
        res[world] = [json.loads((out / f"rank{world}_{r}.json")
                                 .read_text()) for r in range(world)]
    errors = {}
    for g in range(len(JAX_GROUPS)):
        errors.update(json.loads((jax_out / f"errors{g}.json").read_text()))
    return {"jax": jax_out, "ranks": out, "one": one, "res": res,
            "errors": errors}


def _load(path):
    return {k: v for k, v in np.load(path).items()}


def _near(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


def _ranks(case):
    return range(CASES[case][1][0] * CASES[case][1][1])


def _reference(case, runs):
    """The reference's figures by the port's names: the cache by
    ``cache/layer/part/name`` (a body leaf's period axis unstacked), the
    gradients by ``g/<parameter>``."""
    from repro_torch.models import convert
    from repro_torch.models import transformer as tfm
    cfg = _cfg(CASES[case][0])
    npz = _load(runs["jax"] / f"{case}.npz")
    prefix, kinds, _ = tfm.layer_layout(cfg)
    out = {k: v for k, v in npz.items()
           if not k.startswith(("cache/", "g/"))}
    for k, v in npz.items():
        if not k.startswith("cache/"):
            continue
        part = k.split("/")[1:]
        if part[0] == "prefix":
            out["cache/" + "/".join([part[1]] + part[2:])] = v
            continue
        j = int(part[1])
        for t in range(v.shape[0]):
            out["cache/" + "/".join([str(prefix + t * len(kinds) + j)]
                                    + part[2:])] = v[t]
    tree = {}
    for key, v in npz.items():
        if key.startswith("g/"):
            *parents, leaf = key[2:].split("/")
            node = tree
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = v
    out.update({f"g/{n}": w for n, _, w in convert._targets(tree, cfg)})
    return out


SERVED = ("prefill", "tokens", "generate") + tuple(
    f"decode{i}" for i in range(NEW))


def _hold_served(got, want, what):
    for k in [k for k in want if k in SERVED or k.startswith("cache/")]:
        if k in ("tokens", "generate"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=what)
        else:
            _near(got[k], want[k], 1e-5, (what, k))


@pytest.mark.parametrize("case", CASES)
def test_torch_cp_prefill_and_decode_match_the_reference(runs, case):
    """The prefill's last logits and the cache gathered back whole, the
    decode on the prefill's own cut cache, every token (and
    ``generate``'s, but the vision model's, whose ``generate`` takes text
    alone) against the reference jitted under the same rule."""
    want = _reference(case, runs)
    if _cfg(CASES[case][0]).frontend != "vision":
        want["generate"] = want["tokens"][:, :NEW]
    assert any(k.startswith("cache/") for k in want)
    for r in _ranks(case):
        got = _load(runs["ranks"] / f"{case}_{r}.npz")
        keys = [k for k in want if k in SERVED or k.startswith("cache/")]
        _hold_served(got, {k: want[k] for k in keys}, (case, r))


@pytest.mark.parametrize("case", CASES)
def test_torch_cp_prefill_and_decode_match_one_process(runs, case):
    base = case.replace("_2x2", "")
    want = _load(runs["one"] / f"{base}.npz")
    for r in _ranks(case):
        _hold_served(_load(runs["ranks"] / f"{case}_{r}.npz"), want,
                     (case, r))


def _hold_grads(got, want, what):
    _near(got["loss"], want["loss"], 1e-5, (what, "loss"))
    leaves = [k for k in want if k.startswith("g/")]
    assert leaves and set(leaves) == {k for k in got if k.startswith("g/")}
    for k in leaves:
        _near(got[k], want[k], 1e-4, (what, k))


@pytest.mark.parametrize("case", CASES)
def test_torch_cp_loss_and_gradients_match_the_reference(runs, case):
    """The loss (the whole sequence's mean on every rank) and every
    gradient leaf, averaged over ``data`` as the train step averages
    them, against ``jax.value_and_grad`` jitted under the rule."""
    want = _reference(case, runs)
    for r in _ranks(case):
        _hold_grads(_load(runs["ranks"] / f"{case}_{r}.npz"), want,
                    (case, r))


@pytest.mark.parametrize("case", CASES)
def test_torch_cp_loss_and_gradients_match_one_process(runs, case):
    want = _load(runs["one"] / f"{case.replace('_2x2', '')}.npz")
    for r in _ranks(case):
        _hold_grads(_load(runs["ranks"] / f"{case}_{r}.npz"), want,
                    (case, r))


@pytest.mark.parametrize("case", CASES)
def test_torch_cp_train_step_matches_one_process(runs, case):
    """One ``make_train_step(mesh=)`` step under the rule (the whole
    batch on every rank, the gradients averaged over ``data``): its loss
    and the parameters after it, made whole."""
    want = _load(runs["one"] / f"{case.replace('_2x2', '')}.npz")
    for r in _ranks(case):
        got = _load(runs["ranks"] / f"{case}_{r}.npz")
        _near(got["step_loss"], want["step_loss"], 1e-5, (case, r))
        params = [k for k in want if k.startswith("p/")]
        assert params
        for k in params:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{case} {r} {k}")


def _blocks(cfg, n):
    """The all-gathers of blocks a forward issues over the sequence's
    axis, and the state relays: each attention layer's keys and values
    (MLA: latent), each MoE layer's tokens, each Mamba layer's
    convolution halo, each RWKV-6 layer's two token-shift halos; the
    encoder's layers and the memory for an encoder-decoder; the MTP
    block's (the last layer's kind)."""
    from repro_torch.models import transformer as tfm
    kinds = [tfm._kind(cfg, i) for i in range(cfg.num_layers)]
    kinds += [tfm.ENC_KIND] * cfg.num_encoder_layers
    if cfg.mtp_depth:
        kinds.append(tfm.kind_for_layer(cfg, cfg.num_layers - 1))
    blocks = sum({"gqa": 1, "mla": 1, "mamba": 1, "rwkv": 2}[k.mixer] +
                 (k.mlp == "moe") for k in kinds)
    blocks += bool(cfg.num_encoder_layers)          # the memory
    relays = sum(k.mixer in ("mamba", "rwkv") for k in kinds)
    return blocks, relays


@pytest.mark.parametrize("case", CASES)
def test_torch_cp_collectives_over_the_sequence_axis(runs, case):
    """Over the ``data`` group, exact. A prefill: one all-gather a block
    (the prefill's forward runs no MTP), ``n`` rounds a relay (``n - 1``
    and the last block's final state), the last logits. A loss and its
    backward (remat ``"none"``): the forward's blocks and ``n - 1``
    rounds a relay, in the backward an all-reduce a block (the
    gathers' adjoint) and ``n - 1`` rounds a relay, and one all-reduce a
    loss term (the LM loss, and MTP's)."""
    arch, shape, _ = CASES[case]
    cfg = _cfg(arch)
    n = shape[0]
    blocks, relays = _blocks(cfg.replace(mtp_depth=0), n)
    prefill = {"all_gather": blocks + relays * n + 1}
    blocks, relays = _blocks(cfg, n)
    train = {"all_gather": blocks + 2 * relays * (n - 1),
             "all_reduce": blocks + 1 + (cfg.mtp_depth > 0)}
    world = shape[0] * shape[1]
    for r, res in enumerate(runs["res"][world]):
        assert res[case]["prefill"] == prefill, (r, res[case])
        assert res[case]["loss_and_backward"] == train, (r, res[case])


def test_torch_cp_remat_dots_is_bit_identical_to_none(runs):
    """Jamba's loss and gradients under the rule with remat ``"dots"``
    (each block's forward, its gathers and relays, recomputed in the
    backward on every rank alike) bit for bit those without remat."""
    for res in runs["res"][2]:
        assert res["extras"]["remat_bit_identical"]


def test_torch_cp_chunked_loss_matches_one_process(runs):
    """DeepSeek-V3's chunked loss (chunks of 6 over each rank's 16
    positions), MTP included, and its gradients against one process's
    chunked loss over the whole 32."""
    want = _load(runs["one"] / "extras.npz")
    for r in range(2):
        got = _load(runs["ranks"] / f"extras_{r}.npz")
        _near(got["chunked/loss"], want["chunked/loss"], 1e-5, r)
        for k in want:
            if k != "chunked/loss":
                _near(got[k], want[k], 1e-4, (r, k))


@pytest.mark.parametrize("what", ["prefill_seq_model", "train_seq_model",
                                  "prefill_batch_divides"])
def test_torch_cp_a_mesh_axis_mapped_twice_raises_as_the_reference(runs,
                                                                   what):
    """``seq -> model``: the logits' sequence and vocabulary on
    ``model``; ``seq -> data`` at batch 2: the batch and the sequence on
    ``data``. The reference raises ``DuplicateSpecError``, the port
    ``ValueError`` naming the axis."""
    assert runs["errors"][what] == "DuplicateSpecError"
    axis = "'data'" if what.endswith("divides") else "'model'"
    for res in runs["res"][2]:
        got = res["extras"][what]
        assert got.startswith("ValueError") and axis in got, got


def test_torch_cp_encode_under_seq_model_is_refused_naming_the_item(runs):
    """The encoder alone under ``seq -> model`` has no vocabulary to map
    twice: the reference runs it cut over ``model``, and so does the port
    (sequence parallelism: its 4 heads over ``model 2``), its memory on
    every rank within 1e-5 of the reference's. (Until the cut ran, the
    port refused it; the name is kept.)"""
    assert runs["errors"]["encode_seq_model"] == ""
    want = np.load(runs["jax"] / "encode_seq_model.npy")
    for r, res in enumerate(runs["res"][2]):
        assert res["extras"]["encode_seq_model_cut"] == ["model"]
        got = _load(runs["ranks"] / f"extras_{r}.npz")["encode_seq_model"]
        _near(got, want, 1e-5, ("encode_seq_model", r))


def test_torch_cp_a_length_the_axis_does_not_divide_stays_whole(runs):
    for res in runs["res"][2]:
        ex = res["extras"]
        assert ["seq", 21, 1] in ex["odd_fallbacks"], ex["odd_fallbacks"]
        assert ex["odd_bit_identical"]


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_oracle(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "one":
        _one_process(sys.argv[2], sys.argv[3])
    else:
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                sys.argv[5], sys.argv[6])
