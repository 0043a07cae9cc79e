"""The activations' sequence cut over ``model`` (sequence parallelism) and
over ``data`` beside a batch cut over ``pod``: prefill, the decode after
it, training and ``encode``, over worlds of ``gloo`` CPU ranks, on smoke
configurations in float32.

First cut, ``{"seq": "model"}`` on ``(data 1, model 3)``, where the
smoke configurations' 512-entry vocabulary falls back whole (so that no
spec maps ``model`` twice): a layer whose heads, channels or ``ff`` the
axis divides runs its shard on the gathered sequence and leaves through
a reduce-scatter; a layer that runs whole runs on the rank's block (its
keys and values gathered, its scans relayed, over the ``model`` group).
The cases mix the two: ``gqa`` (Qwen2 with 6 query heads and one KV
head, ``d_ff`` 384: every layer cut), ``straddle`` (Qwen2-VL with 6 query
heads over 2 KV heads, a vision prefill; its MLP whole), ``whole``
(Qwen2's smoke widths: every layer whole), ``rwkv6`` (192 wide, 3 heads:
the time mix cut, the channel mix whole), ``jamba`` (192 wide: Mamba
and the MoE, ``d_ff_expert`` 66, cut; attention and the dense MLP
whole), ``minicpm3`` (MLA with 6 heads cut, its MLP whole) and
``seamless`` (SeamlessM4T's smoke widths, every layer whole; the
encoder cut too, the memory gathered for cross attention).

Second cut, ``{"seq": "data"}`` on ``(pod 2, data 2, model 1)`` at
batch 2, which ``pod`` divides and ``pod x data`` does not: each rank
runs its ``pod``'s row and its block of the sequence; ``qwen2_pod``
(Qwen2) and ``jamba_pod`` (Jamba, whose MoE sees the whole batch's
tokens, as the reference's replicates them, and takes the whole batch's
aux loss with no mean).

As ``tests/test_torch_cp_prefill.py``: this file run as a script, one
process a rank at a ``file://`` rendezvous, each world meeting once and
running its cases in turn; one process with no mesh beside them; the
JAX reference in subprocesses over 4 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``), on
``AxisType.Auto`` meshes, which write each case's initial parameters
first and then run it jitted under the same rules, the parameters placed
by ``param_shardings``.

Held for each case, against the reference and against one process:
``make_prefill_step``'s last logits and the cache gathered back whole
(1e-5 of the largest value); the greedy decode on the prefill's own cut
cache (logits 1e-5, tokens equal); the loss (1e-5) and every gradient
leaf (1e-4 of its largest value) as the train step's gradient half
(``step.grads``) gives them (under the first cut each rank's gradient
is the whole loss's, under the second averaged over ``pod x data``);
``generate``'s tokens (but the vision model's, whose ``generate`` takes
text alone, against one process only); against one process also one
``make_train_step(mesh=)`` step (its loss 1e-5; the parameters after it
``rtol`` / ``atol`` 1e-5 of one process's but where the clipped
gradient is within a few ``eps`` of zero, and of AdamW's first step
with the ranks' gradient). Remat ``"dots"`` bit for bit with ``"none"``
under each cut; the second cut's collectives over ``data`` exact.
"""
import dataclasses
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
SEED = 0
# cut: (mesh shape, its axes, the rule, batch, prompt tokens, decode steps)
CUTS = {
    "model": ((1, 3), ("data", "model"), {"seq": "model"}, 1, 24, 3),
    "pod": ((2, 2, 1), ("pod", "data", "model"), {"seq": "data"}, 2, 32, 4),
}
# case: (arch, the smoke configuration's fields replaced, the cut)
CASES = {
    "gqa": ("qwen2-7b", dict(num_heads=6, num_kv_heads=1, head_dim=32,
                             d_ff=384), "model"),
    "straddle": ("qwen2-vl-2b", dict(num_heads=6, head_dim=32), "model"),
    "whole": ("qwen2-7b", {}, "model"),
    "rwkv6": ("rwkv6-3b", dict(d_model=192, num_heads=3), "model"),
    "jamba": ("jamba-v0.1-52b", dict(d_model=192, d_ff_expert=66), "model"),
    "minicpm3": ("minicpm3-4b", dict(num_heads=6), "model"),
    "seamless": ("seamless-m4t-large-v2", {}, "model"),
    "qwen2_pod": ("qwen2-7b", {}, "pod"),
    "jamba_pod": ("jamba-v0.1-52b", {}, "pod"),
}
# the reference's cases, over three subprocesses
JAX_GROUPS = (("gqa", "straddle", "whole"),
              ("rwkv6", "jamba", "minicpm3"),
              ("seamless", "qwen2_pod", "jamba_pod"))
S_ENC = 24
# a vision row's patches: on both sides of the block boundaries at 8 and
# 16, one counted from the end (-1: 23), one dropped (30)
PATCH_POSITIONS = [3, 7, 8, 9, 15, 16, -1, 30]
# the case of each cut whose gradients are held with remat "dots"
REMAT = {"model": "jamba", "pod": "jamba_pod"}


def _replace(base, kw):
    kw = dict(kw)
    if "d_ff_expert" in kw:
        kw["moe"] = dataclasses.replace(base.moe,
                                        d_ff_expert=kw.pop("d_ff_expert"))
    return base.replace(dtype="float32", param_dtype="float32", **kw)


def _cfg(case, **kw):
    from repro_torch import configs
    arch, fields, _ = CASES[case]
    return _replace(configs.get_model_config(arch, smoke=True),
                    dict(fields, **kw))


def _jcfg(case):
    from repro import configs as jconfigs
    arch, fields, _ = CASES[case]
    return _replace(jconfigs.get_model_config(arch, smoke=True), fields)


def _shape(case):
    """(batch, prompt tokens, decode steps) of the case's cut."""
    return CUTS[CASES[case][2]][3:]


def _batch(cfg, case, extra=0):
    """The prompt (``extra`` tokens more for a loss) and the modality
    inputs, from a seed: frame embeddings for the encoder-decoder,
    patches and M-RoPE positions for the vision model."""
    B, S, _ = _shape(case)
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


def _model(case, jax_dir, mesh=None, **kw):
    from repro_torch.models import convert
    return convert.params_from_jax(
        _tree(os.path.join(jax_dir, f"init_{case}.npz")), _cfg(case, **kw),
        device="cpu", mesh=mesh)


class _Rows:
    """Every rank's rows of an output, gathered in order where the batch
    is cut (over ``pod``); the identity elsewhere."""

    def __init__(self, mesh, B):
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.launch.steps import batch_cut
        axes, n, _ = ((), 1, 0) if mesh is None else batch_cut(mesh, B)
        self.group = mesh_lib.axes_group(mesh, axes) if n > 1 else None

    def whole(self, t):
        from repro_torch.launch import mesh as mesh_lib
        return t if self.group is None else \
            mesh_lib.all_gather(t.contiguous(), self.group, 0)


def _cache_leaves(cache, model, rows):
    """Copies of the cache's tensors by ``layer/part/name``, every row of
    the batch, each KV head, RWKV-6 state head and Mamba channel whole
    (gathered over ``model`` where a rank holds its own)."""
    from repro_torch.launch import sharding as shd
    cfg = model.cfg
    whole = {"k": (2, cfg.padded_kv_heads()), "v": (2, cfg.padded_kv_heads()),
             "state": (1, cfg.num_heads)}
    if cfg.ssm is not None:
        din = cfg.ssm.expand * cfg.d_model
        whole.update(conv=(2, din), h=(1, din))
    out = {}
    with model.bound():
        for i, layer in enumerate(cache):
            for part, leaves in layer.items():
                for n, t in leaves.items():
                    dim, width = whole.get(n, (0, 0))
                    if t.shape[dim] < width:
                        t = shd.gather_from_model(t, dim)
                    out[f"{i}/{part}/{n}"] = rows.whole(t).clone()
    return out


class _Counter:
    """The collectives the port issues over one process group, by kind,
    while entered (``launch.mesh.collective_counts(group)``)."""

    def __init__(self, group):
        self.group, self.counts = group, {}

    def __enter__(self):
        from repro_torch.launch import mesh as mesh_lib
        mesh_lib.reset_collective_counts()
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import mesh as mesh_lib
        self.counts = mesh_lib.collective_counts(self.group)


def _grads(step, model, lb):
    """The loss of ``lb`` and every leaf's gradient, as the train step's
    gradient half takes them (``step.grads``: under a batch cut averaged
    over the batch axes), made whole over ``model``."""
    g, metrics = step.grads(lb)
    out = {"loss": metrics["loss"]}
    out.update({f"g/{n}": model.gather(n, t) for n, t in g.items()})
    return out


def _run(model, case, mesh=None, count=None):
    """A case on ``model``: (with ``mesh``) under its cut's rule, the
    prefill of the global batch through ``make_prefill_step`` (each rank
    its rows), the cache gathered back whole, the greedy decode steps on
    the prefill's cache, ``generate``'s tokens, the loss and every
    gradient leaf through the train step's gradient half, then one
    ``make_train_step`` step: its loss and the parameters after it. With
    ``count`` (a group) the collectives over it of the prefill and of
    the gradient half."""
    import contextlib
    from repro_torch.configs import OptimizerConfig
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import (make_decode_step,
                                          make_prefill_step, make_train_step,
                                          rank_slice)
    from repro_torch.optim import init_opt_state
    cfg = model.cfg
    arch, _, cut = CASES[case]
    B, S, new = _shape(case)
    out, counts = {}, {}
    rules = contextlib.nullcontext() if mesh is None else \
        shd.axis_rules(mesh, CUTS[cut][2])
    counted = (lambda: _Counter(count)) if count is not None else \
        contextlib.nullcontext
    rows = _Rows(mesh, B)
    batch = _torch(_batch(cfg, case))
    with rules:
        with torch.no_grad():
            with counted() as c:
                logits, cache = make_prefill_step(
                    model, S + new, backend="torch", mesh=mesh)(batch)
            if c is not None:
                counts["prefill"] = c.counts
            out["prefill"] = rows.whole(logits)
            whole = model.gather_cache(cache) if mesh is not None else cache
            out.update({f"cache/{k}": t for k, t in
                        _cache_leaves(whole, model, rows).items()})
            memory = None
            if cfg.is_encoder_decoder:
                with rank_slice(batch, mesh) as local:
                    memory = model.encode(local["enc_embeds"],
                                          backend="torch")
            decode = make_decode_step(model, backend="torch", mesh=mesh)
            tok = logits.argmax(-1)
            toks = [tok]
            for i in range(new):
                kv_len = torch.full(tok.shape, S + i + 1, dtype=torch.int32)
                lg, cache = decode(tok, S + i, kv_len, cache, memory)
                out[f"decode{i}"] = rows.whole(lg)
                tok = lg.argmax(-1)
                toks.append(tok)
            out["tokens"] = rows.whole(torch.stack(toks, 1))
        with torch.no_grad():
            gen, _ = generate(arch=arch, prompt_tokens=batch["tokens"],
                              max_new_tokens=new, model=model,
                              backend="torch", enc_embeds=batch.get(
                                  "enc_embeds"), mesh=mesh)
        out["generate"] = gen[:, S:]
        lb = _torch(_batch(cfg, case, extra=1))
        model.requires_grad_(True)
        params = dict(model.params.named_parameters())
        opt = OptimizerConfig(warmup_steps=1, total_steps=4)
        step = make_train_step(model, opt, backend="torch", mesh=mesh)
        with counted() as c:
            out.update(_grads(step, model, lb))
        if c is not None:
            counts["grads"] = c.counts
        state = init_opt_state(opt, params, step.zero)
        _, metrics = step(state, lb)
        out["step_loss"] = metrics["loss"]
        for n, p in params.items():
            out[f"p/{n}"] = model.gather(n, p.detach())
        model.requires_grad_(False)
    return out, counts


def _remat(case, jax_dir, mesh):
    """Whether the case's loss and gradients under its rule with remat
    ``"dots"`` are bit for bit those without remat."""
    from repro_torch.configs import OptimizerConfig
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import make_train_step
    lb = _torch(_batch(_cfg(case), case, extra=1))
    got = []
    for remat in ("none", "dots"):
        model = _model(case, jax_dir, mesh, remat=remat)
        model.requires_grad_(True)
        step = make_train_step(model, OptimizerConfig(), backend="torch",
                               mesh=mesh)
        with shd.axis_rules(mesh, CUTS[CASES[case][2]][2]):
            got.append(_grads(step, model, lb))
    return all(torch.equal(got[0][k], got[1][k]) for k in got[0])


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


def _make_mesh(cut):
    from repro_torch.launch import mesh as mesh_lib
    shape, axes = CUTS[cut][:2]
    return mesh_lib.make_mesh(mesh_lib.MeshConfig(shape, axes),
                              device_type="cpu")


def _worker(cut, rank, rdv, out, jax_dir):
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    torch.set_num_threads(1)
    world = int(np.prod(CUTS[cut][0]))
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    try:
        mesh = _make_mesh(cut)
        count = mesh_lib.axes_group(mesh, ("data",)) if cut == "pod" \
            else None
        _wait_for(_init_done(jax_dir), "no initial parameters")
        res = {}
        for name, (_, _, c) in CASES.items():
            if c != cut:
                continue
            got, counts = _run(_model(name, jax_dir, mesh), name, mesh,
                               count)
            _save(os.path.join(out, f"{name}_{rank}.npz"), got)
            res[name] = counts
        res["remat_bit_identical"] = _remat(REMAT[cut], jax_dir, mesh)
        with open(os.path.join(out, f"rank_{cut}_{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _one_process(out, jax_dir):
    """Each case with no mesh."""
    torch.set_num_threads(1)
    _wait_for(_init_done(jax_dir), "no initial parameters")
    for name in CASES:
        got, _ = _run(_model(name, jax_dir), name)
        _save(os.path.join(out, f"{name}.npz"), got)


def _jax_oracle(out, group):
    """The reference's initial parameters of the group's cases (then
    ``init<group>.done``), then each case under its cut's rule on its
    mesh: the prefill, the cache, the greedy decode after it, the loss
    and its gradients."""
    import jax
    import jax.numpy as jnp
    from repro.launch import sharding as jshd
    from repro.launch.steps import (make_decode_step, make_prefill_step,
                                    param_shardings)
    from repro.models import transformer as jtfm
    from repro.models.api import build_model as jbuild
    assert len(jax.devices()) == 4
    names = JAX_GROUPS[int(group)]
    models = {}
    for name in names:
        jcfg = _jcfg(name)
        jm = jbuild(jcfg)
        params = jm.init(jax.random.PRNGKey(SEED))
        np.savez(os.path.join(out, f"init_{name}.npz"), **{
            p.strip("/"): np.asarray(v) for p, v in jtfm._iter_paths(params)})
        models[name] = (jcfg, jm, params)
    pathlib.Path(out, f"init{group}.done").touch()

    def jbatch(b):
        return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i"
                               else jnp.float32) for k, v in b.items()}

    for name in names:
        jcfg, jm, params = models[name]
        shape, axes, rules, B, S, new = CUTS[CASES[name][2]]
        mesh = jax.make_mesh(
            shape, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(axes),
            devices=jax.devices()[:int(np.prod(shape))])
        res = {}
        with mesh, jshd.axis_rules(mesh, rules):
            p = jax.device_put(params, param_shardings(mesh, jm, params))
            batch = jbatch(_batch(jcfg, name))
            logits, cache = jax.jit(make_prefill_step(jm, S + new))(p, batch)
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
            for i in range(new):
                lg, cache = decode(p, tok, jnp.asarray(S + i, jnp.int32),
                                   jnp.full((B,), S + i + 1, jnp.int32),
                                   cache, memory)
                res[f"decode{i}"] = np.asarray(lg)
                tok = jnp.argmax(lg, -1).astype(jnp.int32)
                toks.append(np.asarray(tok))
            res["tokens"] = np.stack(toks, 1)
            (loss, _), g = jax.jit(jax.value_and_grad(
                jm.loss, has_aux=True))(p, jbatch(_batch(jcfg, name,
                                                         extra=1)))
            res["loss"] = np.asarray(loss)
            res.update({f"g{k}": np.asarray(v)
                        for k, v in jtfm._iter_paths(g)})
        np.savez(os.path.join(out, f"{name}.npz"), **res)


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
    """The reference's subprocesses, the ranks of both worlds and one
    process, side by side (the ranks and one process start their work
    once the reference has written its initial parameters)."""
    tmp = tmp_path_factory.mktemp("sp_prefill")
    jax_out, out, one = tmp / "jax", tmp / "ranks", tmp / "one"
    for d in (jax_out, out, one):
        d.mkdir()
    procs = [_spawn(["jax", jax_out, g],
                    XLA_FLAGS="--xla_force_host_platform_device_count=4")
             for g in range(len(JAX_GROUPS))]
    procs.append(_spawn(["one", one, jax_out]))
    for cut, spec in CUTS.items():
        procs += [_spawn(["worker", cut, r, tmp / f"rdv_{cut}", out,
                          jax_out]) for r in range(int(np.prod(spec[0])))]
    logs = [p.communicate(timeout=900)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    res = {cut: [json.loads((out / f"rank_{cut}_{r}.json").read_text())
                 for r in range(int(np.prod(spec[0])))]
           for cut, spec in CUTS.items()}
    return {"jax": jax_out, "ranks": out, "one": one, "res": res}


def _load(path):
    return {k: v for k, v in np.load(path).items()}


def _near(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


def _ranks(case):
    return range(int(np.prod(CUTS[CASES[case][2]][0])))


def _reference(case, runs):
    """The reference's figures by the port's names: the cache by
    ``cache/layer/part/name`` (a body leaf's period axis unstacked), the
    gradients by ``g/<parameter>``."""
    from repro_torch.models import convert
    from repro_torch.models import transformer as tfm
    cfg = _cfg(case)
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


def _served(case):
    new = _shape(case)[2]
    return ("prefill", "tokens", "generate") + tuple(
        f"decode{i}" for i in range(new))


def _hold_served(got, want, case, what):
    for k in [k for k in want if k in _served(case)
              or k.startswith("cache/")]:
        if k in ("tokens", "generate"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=what)
        else:
            _near(got[k], want[k], 1e-5, (what, k))


@pytest.mark.parametrize("case", CASES)
def test_torch_sp_prefill_and_decode_match_the_reference(runs, case):
    """The prefill's last logits and the cache gathered back whole, the
    decode on the prefill's own cut cache, every token (and
    ``generate``'s, but the vision model's) against the reference jitted
    under the same rule on the same mesh."""
    want = _reference(case, runs)
    new = _shape(case)[2]
    if _cfg(case).frontend != "vision":
        want["generate"] = want["tokens"][:, :new]
    assert any(k.startswith("cache/") for k in want)
    for r in _ranks(case):
        got = _load(runs["ranks"] / f"{case}_{r}.npz")
        _hold_served(got, want, case, (case, r))


@pytest.mark.parametrize("case", CASES)
def test_torch_sp_prefill_and_decode_match_one_process(runs, case):
    want = _load(runs["one"] / f"{case}.npz")
    for r in _ranks(case):
        _hold_served(_load(runs["ranks"] / f"{case}_{r}.npz"), want, case,
                     (case, r))


def _hold_grads(got, want, what):
    _near(got["loss"], want["loss"], 1e-5, (what, "loss"))
    leaves = [k for k in want if k.startswith("g/")]
    assert leaves and set(leaves) == {k for k in got if k.startswith("g/")}
    for k in leaves:
        _near(got[k], want[k], 1e-4, (what, k))


@pytest.mark.parametrize("case", CASES)
def test_torch_sp_loss_and_gradients_match_the_reference(runs, case):
    """The loss (the whole sequence's mean on every rank) and every
    gradient leaf made whole (under ``seq -> data`` beside ``pod``
    averaged over ``pod x data`` as the step averages them) against
    ``jax.value_and_grad`` jitted under the rule."""
    want = _reference(case, runs)
    for r in _ranks(case):
        _hold_grads(_load(runs["ranks"] / f"{case}_{r}.npz"), want,
                    (case, r))


@pytest.mark.parametrize("case", CASES)
def test_torch_sp_loss_and_gradients_match_one_process(runs, case):
    want = _load(runs["one"] / f"{case}.npz")
    for r in _ranks(case):
        _hold_grads(_load(runs["ranks"] / f"{case}_{r}.npz"), want,
                    (case, r))


def _plain_step(case, runs, grads):
    """AdamW's first step (the port's ``adamw_update``, one process, no
    mesh) from the case's initial parameters with ``grads``."""
    from repro_torch.configs import OptimizerConfig
    from repro_torch.optim import adamw_update, decay_mask, init_opt_state
    model = _model(case, runs["jax"])
    params = dict(model.params.named_parameters())
    opt = OptimizerConfig(warmup_steps=1, total_steps=4)
    with torch.no_grad():
        adamw_update(opt, params, {n: torch.from_numpy(grads[f"g/{n}"])
                                   for n in params},
                     init_opt_state(opt, params),
                     decay_mask(model.cfg, params))
    return {f"p/{n}": p.detach().numpy() for n, p in params.items()}


# Adam's first update of an element is ``lr * g / (|g| + eps)`` of its
# clipped gradient ``g``: within a few ``eps`` of zero a rounding
# difference in ``g`` moves it by a share of ``lr``. The step is held to
# one process's at 1e-5 on every element but those whose one-process
# clipped gradient is not zero and within ``STEP_NEAR_ZERO_EPS`` ``eps``
# of it (78 to 1,934 elements of a case, 0.02 % to 0.13 % of them).
STEP_NEAR_ZERO_EPS = 4


def _near_zero(want, opt):
    """Per parameter, the elements whose one-process gradient, clipped by
    the global norm as ``adamw_update`` clips it, is not zero and within
    ``STEP_NEAR_ZERO_EPS * eps`` of it."""
    leaves = [k for k in want if k.startswith("g/")]
    norm = np.sqrt(sum((want[k].astype(np.float64) ** 2).sum()
                       for k in leaves))
    scale = min(1.0, opt.grad_clip / (norm + 1e-9))
    return {f"p/{k[2:]}": (want[k] != 0) & (np.abs(want[k] * scale)
                                            <= STEP_NEAR_ZERO_EPS * opt.eps)
            for k in leaves}


@pytest.mark.parametrize("case", CASES)
def test_torch_sp_train_step_matches_one_process(runs, case):
    """One ``make_train_step(mesh=)`` step under the rule, handed the
    global batch: its loss within 1e-5 of one process's step, and the
    parameters after it, made whole, ``rtol`` / ``atol`` 1e-5 of one
    process's after its step on every element but those whose
    one-process clipped gradient is within ``STEP_NEAR_ZERO_EPS`` ``eps``
    of zero and not zero (at most 1 % of them, held within ``lr``), and
    of AdamW's first step from the same weights with the ranks' own
    gradient on every element."""
    from repro_torch.configs import OptimizerConfig
    opt = OptimizerConfig(warmup_steps=1, total_steps=4)
    want = _load(runs["one"] / f"{case}.npz")
    near = _near_zero(want, opt)
    masked = sum(int(m.sum()) for m in near.values())
    total = sum(m.size for m in near.values())
    assert 100 * masked <= total, (case, masked, total)
    for r in _ranks(case):
        got = _load(runs["ranks"] / f"{case}_{r}.npz")
        _near(got["step_loss"], want["step_loss"], 1e-5, (case, r))
        plain = _plain_step(case, runs, got)
        params = [k for k in want if k.startswith("p/")]
        assert params and set(params) == set(plain) == set(near)
        for k in params:
            far = ~near[k]
            np.testing.assert_allclose(
                got[k][far], want[k][far], rtol=1e-5, atol=1e-5,
                err_msg=f"{case} {r} {k}: {int(near[k].sum())} of "
                        f"{near[k].size} elements near zero not held")
            assert np.abs(got[k] - want[k]).max() <= opt.lr, (case, r, k)
            np.testing.assert_allclose(got[k], plain[k], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{case} {r} {k}")


@pytest.mark.parametrize("cut", CUTS)
def test_torch_sp_remat_dots_is_bit_identical_to_none(runs, cut):
    """The loss and gradients of ``REMAT[cut]`` under its rule with remat
    ``"dots"`` (each block's forward, its gathers, relays and the
    sequence-parallel entry and exit, recomputed in the backward) bit for
    bit those without remat."""
    for res in runs["res"][cut]:
        assert res["remat_bit_identical"]


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][2] == "pod"])
def test_torch_sp_pod_collectives_over_the_data_axis(runs, case):
    """Under ``seq -> data`` beside ``pod``, over the ``data`` group,
    exact, as ``tests/test_torch_cp_prefill.py`` counts them: a prefill
    one all-gather a block (each attention layer's keys and values, each
    MoE layer's tokens, each Mamba layer's convolution halo), ``n``
    rounds a relay and the last logits; the train step's gradient half
    the forward's blocks and ``n - 1`` rounds a relay, in the backward an
    all-reduce a block and ``n - 1`` rounds a relay, one all-reduce for
    the loss, then the step's mean over ``data`` of each gradient leaf
    and each of the loss's metrics (one all-reduce each). The MoE's
    gather of the batch's rows and the mean over ``pod`` are over
    ``pod``, not counted here."""
    from repro_torch.models import transformer as tfm
    cfg = _cfg(case)
    n = CUTS["pod"][0][1]
    kinds = [tfm._kind(cfg, i) for i in range(cfg.num_layers)]
    blocks = sum({"gqa": 1, "mla": 1, "mamba": 1, "rwkv": 2}[k.mixer] +
                 (k.mlp == "moe") for k in kinds)
    relays = sum(k.mixer in ("mamba", "rwkv") for k in kinds)
    leaves = len(tfm.param_shapes(cfg))
    metrics = 2 + (cfg.moe is not None) + (cfg.mtp_depth > 0)
    prefill = {"all_gather": blocks + relays * n + 1}
    train = {"all_gather": blocks + 2 * relays * (n - 1),
             "all_reduce": blocks + 1 + leaves + metrics}
    for r, res in enumerate(runs["res"]["pod"]):
        assert res[case]["prefill"] == prefill, (r, res[case])
        assert res[case]["grads"] == train, (r, res[case])


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_oracle(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "one":
        _one_process(sys.argv[2], sys.argv[3])
    else:
        _worker(sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5],
                sys.argv[6])
