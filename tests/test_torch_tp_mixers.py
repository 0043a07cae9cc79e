"""Tensor-parallel serving with the MLA, RWKV-6, Mamba and cross-attention
mixers, and those mixers as modules, over meshes of ``gloo`` CPU ranks,
on smoke configurations in float32.

As ``tests/test_torch_tp.py``: this file run as a script, one process a
rank, at a ``file://`` rendezvous; a world of 2 over ``(data 1, model
2)`` and a world of 4 over ``(data 1, model 4)`` and ``(data 2, model
2)``; the JAX reference in a subprocess a configuration with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, its
``Model.prefill`` and ``decode_step`` (and ``transformer.encode``)
jitted with ``param_shardings`` on the same meshes, of ``AxisType.Auto``
axes. The reference writes its initial parameters first, and the ranks,
and one process with no mesh (a subprocess of its own), start on them
while it runs its meshes.

Held, for ``minicpm3-4b`` and ``deepseek-v3-671b`` (MLA; DeepSeek-V3's
sigmoid-routed MoE and shared expert), ``rwkv6-3b``, ``jamba-v0.1-52b``
(Mamba, GQA with a KV head a rank at ``model 4``, the MoE) and
``seamless-m4t-large-v2`` (the encoder, and cross attention over its
memory) on all three meshes, against one process (the same weights, no
mesh) and against the reference: the prefill's logits and 4 greedy decode
steps' logits within 1e-5 of the largest logit, every token equal (the
encoder-decoder's memory too). ``mla_apply``, ``rwkv_tmix_apply``,
``rwkv_cmix_apply``, ``mamba_apply`` and ``cross_apply`` at ``(1, 2)``,
forward (1e-5) and gradients of the input and of every leaf (1e-4 of
each leaf's largest), each rank holding only its shards; every leaf's
shape on a rank (``tp_param_spec``: Mamba's ``in_proj`` cut half by
half, the channel mix's ``wv`` row-parallel and ``wr`` whole); the
collectives of an encode, a prefill and a decode step, counted;
``generate(mesh=)`` at ``(1, 2)``, seeded; the smoke RWKV-6's 2 heads at
``model 4`` running whole on every rank; ``require_supported`` taking
all ten configurations at ``model`` 2, 4, 8 and 16.
"""
import json
import os
import pathlib
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("minicpm3-4b", "deepseek-v3-671b", "rwkv6-3b", "jamba-v0.1-52b",
         "seamless-m4t-large-v2")
MESHES = {2: ((1, 2),), 4: ((1, 4), (2, 2))}
B, S, NEW, SEED = 4, 24, 4, 0
S_ENC = 16
ALL_ARCHS = ("qwen2-7b", "stablelm-12b", "starcoder2-15b", "mixtral-8x7b",
             "jamba-v0.1-52b", "rwkv6-3b", "minicpm3-4b", "deepseek-v3-671b",
             "qwen2-vl-2b", "seamless-m4t-large-v2")


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


def _model(arch, init=None, mesh=None):
    """The smoke model: the reference's initial parameters (``init``, a
    flat ``.npz`` by tree path), or seeded; on ``mesh`` this rank's
    shards."""
    from repro_torch.models import convert
    from repro_torch.models.api import build_model
    if init is not None:
        return convert.params_from_jax(_tree(init), _cfg(arch),
                                       device="cpu", mesh=mesh)
    m = build_model(_cfg(arch), device="cpu", mesh=mesh)
    m.init(SEED)
    return m


def _prompts():
    rng = np.random.default_rng(SEED)
    return rng.integers(0, 512, size=(B, S)).astype(np.int64)


def _frames(d_model):
    rng = np.random.default_rng(SEED + 3)
    return (rng.standard_normal((B, S_ENC, d_model)) * 0.02).astype(
        np.float32)


def greedy(model, counts=None):
    """The encoder's memory (an encoder-decoder's), the prefill's logits,
    each of ``NEW`` greedy decode steps' logits and the tokens; with
    ``counts`` the collectives of the encode, the prefill and the first
    decode step are recorded in it."""
    from repro_torch.launch import mesh as mesh_lib
    out = {}
    batch = {"tokens": torch.from_numpy(_prompts())}
    memory = None
    with torch.no_grad():
        if model.cfg.is_encoder_decoder:
            mesh_lib.reset_collective_counts()
            memory = model.encode(torch.from_numpy(_frames(
                model.cfg.d_model)), backend="torch")
            if counts is not None:
                counts["encode"] = mesh_lib.collective_counts()
            out["memory"] = batch["memory"] = memory
        mesh_lib.reset_collective_counts()
        logits, cache = model.prefill(batch, S + NEW, backend="torch")
        if counts is not None:
            counts["prefill"] = mesh_lib.collective_counts()
        out["prefill"] = logits
        tok = logits.argmax(-1)
        toks = [tok]
        for i in range(NEW):
            mesh_lib.reset_collective_counts()
            lg, cache = model.decode_step(tok, S + i, cache, memory=memory,
                                          backend="torch")
            if counts is not None and i == 0:
                counts["decode"] = mesh_lib.collective_counts()
            out[f"decode{i}"] = lg
            tok = lg.argmax(-1)
            toks.append(tok)
    out["tokens"] = torch.stack(toks, 1)
    return out


def module_cases(model):
    """The tensor-parallel mixers of the smoke model on seeded inputs:
    each one's output and the gradients of a seeded projection of it,
    with respect to its inputs and to each of its parameters, made whole
    (``Model.gather``). Runs the same with and without a mesh."""
    from repro_torch.models import attention as attn
    from repro_torch.models import ssm as ssmm
    from repro_torch.models.rope import positions_for
    cfg = model.cfg
    gen = torch.Generator().manual_seed(SEED + 2)
    D = cfg.d_model
    x0 = torch.randn(B, S, D, generator=gen)
    cot = torch.randn(B, S, D, generator=gen)
    mem0 = torch.randn(B, S_ENC, D, generator=gen)
    pos = positions_for(B, S)
    p = model.params
    named = dict(p.named_parameters())
    out = {}

    def run(tag, i, part, fn, *extra):
        x = x0.clone().requires_grad_(True)
        ins = [x] + [t.clone().requires_grad_(True) for t in extra]
        y = fn(p.blocks[i][part], *ins)
        (y * cot).sum().backward()
        out[tag] = y.detach()
        for j, t in enumerate(ins):
            out[f"{tag}/d_in{j}"] = t.grad.detach().clone()
        for k in p.blocks[i][part].keys():
            n = f"blocks.{i}.{part}.{k}"
            out[f"{tag}/{n}"] = model.gather(n, named[n].grad)
            named[n].grad = None

    model.requires_grad_(True)
    with model.bound():
        if cfg.attn_type == "mla":
            run("mla", 0, "mixer", lambda q, x: attn.mla_apply(
                q, x, cfg=cfg, positions=pos, backend="torch")[0])
        if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
            run("rwkv_tmix", 0, "mixer", lambda q, x: ssmm.rwkv_tmix_apply(
                q, x, cfg=cfg, backend="torch")[0])
            run("rwkv_cmix", 0, "mlp", lambda q, x: ssmm.rwkv_cmix_apply(
                q, x, cfg=cfg)[0])
        if cfg.ssm is not None and cfg.ssm.kind == "mamba":
            run("mamba", 0, "mixer", lambda q, x: ssmm.mamba_apply(
                q, x, cfg=cfg, backend="torch")[0])
        if cfg.is_encoder_decoder:
            run("cross", 0, "cross", lambda q, x, m: attn.cross_apply(
                q, x, m, cfg=cfg, backend="torch"), mem0)
    model.requires_grad_(False)
    return out


def _save(path, tensors):
    np.savez(path, **{k: v.float().numpy() for k, v in tensors.items()})


def _local_mesh(shape):
    from repro_torch.launch import mesh as mesh_lib
    return mesh_lib.make_mesh(mesh_lib.MeshConfig(shape, ("data", "model")),
                              device_type="cpu")


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


def _generate(arch, model, mesh=None):
    from repro_torch.launch.serve import generate
    cfg = model.cfg
    enc = _frames(cfg.d_model) if cfg.is_encoder_decoder else None
    toks, _ = generate(arch=arch, model=model, prompt_tokens=_prompts(),
                       max_new_tokens=NEW, backend="torch", mesh=mesh,
                       enc_embeds=enc)
    return toks


# ---------------------------------------------------------------------------
# the workers (this file run as a script)
# ---------------------------------------------------------------------------


def _worker(world, rank, rdv, out, jax_dir):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    try:
        res = {}
        for shape in MESHES[world]:
            mesh = _local_mesh(shape)
            for arch in ARCHS:
                model = _model(arch, os.path.join(jax_dir,
                                                  f"init_{arch}.npz"), mesh)
                counts = {}
                _save(os.path.join(out, f"{arch}_{_tag(shape)}_{rank}.npz"),
                      greedy(model, counts))
                res[f"{arch}_{_tag(shape)}"] = counts
                res[f"{arch}_{_tag(shape)}_shapes"] = {
                    n: list(t.shape)
                    for n, t in model.params.named_parameters()}
                if shape == (1, 2):
                    _save(os.path.join(out, f"mod_{arch}_{rank}.npz"),
                          module_cases(model))
                    _save(os.path.join(out, f"gen_{arch}_{rank}.npz"),
                          {"tokens": _generate(arch, _model(arch, mesh=mesh),
                                               mesh)})
            if shape == (1, 4):
                _save(os.path.join(out, f"whole_mod_{rank}.npz"),
                      module_cases(_model("rwkv6-3b", mesh=mesh)))
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _one_process(out, jax_dir):
    """One process, no mesh, beside the ranks: each model's greedy run
    and modules on the reference's initial parameters, its ``generate``
    seeded, and the seeded RWKV-6's modules."""
    for arch in ARCHS:
        model = _model(arch, os.path.join(jax_dir, f"init_{arch}.npz"))
        _save(os.path.join(out, f"{arch}.npz"), greedy(model))
        _save(os.path.join(out, f"mod_{arch}.npz"), module_cases(model))
        _save(os.path.join(out, f"gen_{arch}.npz"),
              {"tokens": _generate(arch, _model(arch))})
    _save(os.path.join(out, "whole_mod.npz"),
          module_cases(_model("rwkv6-3b")))


def _jax_oracle(out, arch):
    """The reference's initial parameters for ``arch`` (then the file
    ``init_<arch>.done``), then its encode, prefill and greedy decode
    steps on each mesh, of Auto axes, with the parameters placed by
    ``param_shardings``."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.launch import sharding as jshd
    from repro.launch.steps import (make_decode_step, make_prefill_step,
                                    param_shardings)
    from repro.models import transformer as jtfm
    from repro.models.api import build_model as jbuild
    assert len(jax.devices()) == 4
    jcfg = jconfigs.get_model_config(arch, smoke=True).replace(
        dtype="float32", param_dtype="float32")
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(SEED))
    np.savez(os.path.join(out, f"init_{arch}.npz"), **{
        p.strip("/"): np.asarray(v) for p, v in jtfm._iter_paths(params)})
    pathlib.Path(out, f"init_{arch}.done").touch()
    for shape in MESHES[2] + MESHES[4]:
        mesh = jax.make_mesh(
            shape, ("data", "model"),
            axis_types=(jax.sharding.AxisType.Auto,) * 2,
            devices=jax.devices()[:shape[0] * shape[1]])
        res = {}
        with mesh, jshd.axis_rules(mesh):
            p = jax.device_put(params, param_shardings(mesh, jm, params))
            batch = {"tokens": jnp.asarray(_prompts(), jnp.int32)}
            memory = None
            if jcfg.is_encoder_decoder:
                memory = jax.jit(lambda q, e: jtfm.encode(q, jcfg, e))(
                    p, jnp.asarray(_frames(jcfg.d_model)))
                res["memory"] = np.asarray(memory)
                batch["memory"] = memory
            prefill = jax.jit(make_prefill_step(jm, max_len=S + NEW))
            decode = jax.jit(make_decode_step(jm))
            logits, cache = prefill(p, batch)
            res["prefill"] = np.asarray(logits)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            toks = [np.asarray(tok)]
            for i in range(NEW):
                lg, cache = decode(p, tok, jnp.asarray(S + i, jnp.int32),
                                   jnp.full((B,), S + i + 1, jnp.int32),
                                   cache, memory)
                res[f"decode{i}"] = np.asarray(lg)
                tok = jnp.argmax(lg, -1).astype(jnp.int32)
                toks.append(np.asarray(tok))
            res["tokens"] = np.stack(toks, 1)
        np.savez(os.path.join(out, f"{arch}_{_tag(shape)}.npz"), **res)


def _env(**extra):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    env.update(extra)
    return env


def _launch(world, args, tmp):
    """This file as ``world`` rank processes with ``args``."""
    return [subprocess.Popen(
        [sys.executable, __file__, "worker", str(world), str(r),
         str(tmp / f"rdv{world}")] + [str(a) for a in args],
        env=_env(), cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _jax(args):
    """This file as a subprocess over 4 host devices: the JAX oracle, or
    the one-process runs."""
    return subprocess.Popen(
        [sys.executable, __file__] + [str(a) for a in args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(ROOT), env=_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=4"))


def _wait(procs):
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's oracle, a process a configuration; once they have
    written their initial parameters, the ranks of both worlds and one
    process beside them, each a single-threaded process."""
    tmp = tmp_path_factory.mktemp("tp_mixers")
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
    one = tmp / "one"
    one.mkdir()
    procs = jax_procs + [_jax(["one", one, jax_out])]
    for w, d in dirs.items():
        d.mkdir()
        procs += _launch(w, [d, jax_out], tmp)
    _wait(procs)
    return {"jax": jax_out, "one": one, **dirs}


def _load(path):
    return {k: v for k, v in np.load(path).items()}


def _json(path):
    return json.loads(pathlib.Path(path).read_text())


def _near(got, want, tol, what):
    """|got - want| within ``tol`` of want's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


def _hold_greedy(got, want, what, tol=1e-5):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k in want:
        if k == "tokens":
            np.testing.assert_array_equal(got[k], want[k], err_msg=what)
        else:
            _near(got[k], want[k], tol, f"{what} {k}")


ALL_SHAPES = MESHES[2] + MESHES[4]


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_torch_tp_mixers_serving_matches_one_process(runs, arch, shape):
    want = _load(runs["one"] / f"{arch}.npz")
    world = shape[0] * shape[1]
    for r in range(world):
        got = _load(runs[world] / f"{arch}_{_tag(shape)}_{r}.npz")
        _hold_greedy(got, want, f"{arch} {shape} rank {r}")


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_torch_tp_mixers_serving_matches_the_reference_on_its_mesh(
        runs, arch, shape):
    want = _load(runs["jax"] / f"{arch}_{_tag(shape)}.npz")
    world = shape[0] * shape[1]
    got = _load(runs[world] / f"{arch}_{_tag(shape)}_0.npz")
    _hold_greedy(got, want, f"{arch} {shape}")


def _whole_spec(arch):
    """The whole leaves' shapes on the meta device."""
    from repro_torch.models import transformer as tfm
    with torch.device("meta"):
        return {n: list(t.shape) for n, t in tfm.init_params(
            _cfg(arch), torch.Generator(),
            device="meta").named_parameters()}


def _cut(arch, name, shape, tp):
    """The shape the port holds of leaf ``name`` on a ``model`` axis of
    ``tp``, written out by hand from the slice's rules."""
    cfg = _cfg(arch)
    parts = name.split(".")
    leaf, part = parts[-1], parts[-2] if len(parts) > 1 else None
    cut = lambda d: [n // tp if i == d else n for i, n in enumerate(shape)]
    if name in ("embed",):
        return cut(0)
    if name == "lm_head":
        return cut(1)
    if part == "cross" or (part == "mixer" and cfg.attn_type != "mla"
                           and cfg.ssm is None) or (
            part == "mixer" and leaf in ("wq", "wk", "wv", "wo", "bq", "bk",
                                         "bv") and cfg.ssm is not None
            and cfg.ssm.kind == "mamba"):
        if not cfg.padded_heads() % tp == 0:
            return shape
        if leaf in ("wk", "wv", "bk", "bv") and cfg.padded_kv_heads() % tp:
            return shape
        return cut(0) if leaf == "wo" or leaf.startswith("b") and \
            len(shape) == 1 else cut(1)
    if part == "mixer" and cfg.attn_type == "mla":
        if cfg.padded_heads() % tp:
            return shape
        return {"wq_b": cut(1), "wkv_b": cut(1), "wq": cut(1),
                "wo": cut(0)}.get(leaf, shape)
    if part == "mixer" and cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        if cfg.num_heads % tp:
            return shape
        return {"wr": cut(1), "wk": cut(1), "wv": cut(1), "wg": cut(1),
                "wo": cut(0)}.get(leaf, shape)
    if part == "mixer" and cfg.ssm is not None:
        return {"in_proj": cut(1), "conv_w": cut(1), "conv_b": cut(0),
                "x_proj": cut(0), "dt_proj": cut(1), "A_log": cut(0),
                "D": cut(0), "out_proj": cut(0)}.get(leaf, shape)
    if part == "mlp" and cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        return {"wk": cut(1), "wv": cut(0)}.get(leaf, shape)
    if part in ("mlp", "shared"):
        if leaf in ("w_gate", "w_up", "b_up"):
            return cut(len(shape) - 1)
        if leaf == "w_down":
            return cut(len(shape) - 2)
    return shape


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_torch_tp_mixers_each_rank_holds_only_its_shards(runs, arch, shape):
    """Every leaf on rank 0 is the shape the slice's rules give it: MLA
    cut on heads in ``wq_b`` / ``wkv_b`` and ``wo``, its latent leaves
    whole; RWKV-6's ``wr`` / ``wk`` / ``wv`` / ``wg`` / ``wo`` on heads
    (all whole at ``model 4``, which does not divide its 2 heads), the
    channel mix's ``wk`` and ``wv`` on ``d_ff``; Mamba's channels; cross
    attention on heads; and something is cut on every mixer."""
    whole = _whole_spec(arch)
    world = shape[0] * shape[1]
    held = _json(runs[world] / "rank0.json")[f"{arch}_{_tag(shape)}_shapes"]
    assert set(held) == set(whole)
    for n, w in whole.items():
        assert held[n] == _cut(arch, n, w, shape[1]), n
    mixer_cut = {n.split(".")[2] for n, w in whole.items()
                 if n.startswith("blocks.") and held[n] != w}
    assert "mixer" in mixer_cut or (arch == "rwkv6-3b" and shape[1] == 4)


def test_torch_tp_mixers_mamba_in_proj_is_cut_half_by_half():
    """``tp_param_spec`` gives Mamba's ``in_proj`` a ``Halves`` entry: a
    rank's shard is its channels of ``x`` beside its channels of ``z``,
    where the reference's contiguous cut would hand one rank all of ``x``;
    the channel mix's ``wv`` is row-parallel (the reference's spec cuts
    its output columns) and ``wr`` whole."""
    from repro_torch.launch import sharding as shd
    from repro_torch.models import transformer as tfm
    stand = types.SimpleNamespace(shape={"data": 1, "model": 2})
    spec = tfm.tp_param_spec(_cfg("jamba-v0.1-52b"), stand)
    e = spec["blocks.0.mixer.in_proj"][1]
    assert isinstance(e, shd.Halves) and e == "model"
    with shd.axis_rules(stand):
        ref = tfm.param_spec({"blocks.0.mixer.in_proj": torch.empty(
            128, 512, device="meta")}, _cfg("jamba-v0.1-52b"))
    assert ref["blocks.0.mixer.in_proj"] == (None, "model")
    rwkv = tfm.tp_param_spec(_cfg("rwkv6-3b"), stand)
    assert rwkv["blocks.0.mlp.wv"] == ("model", None)
    assert rwkv["blocks.0.mlp.wr"] == (None, None)
    assert rwkv["blocks.0.mlp.wk"] == (None, "model")
    assert rwkv["blocks.0.mixer.u"] == (None, None)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
def test_torch_tp_mixers_a_cut_expert_stack_keeps_no_whole_draw(dtype):
    """``params.trunc_normal(cut=)``, which draws a MoE's expert stacks on
    a rank, returns a tensor that owns its storage, at the cut's size, in
    either dtype (in float32 a view of the draw would keep the whole stack
    alive beside the rank's shard), holding the cut of the same seeded
    draw made whole."""
    from repro_torch.models import params as prm
    shape = (4, 8, 12)
    cut = lambda w: w.narrow(2, 6, 6)
    got = prm.trunc_normal(torch.Generator().manual_seed(3), shape, std=0.5,
                           dtype=dtype, cut=cut)
    whole = prm.trunc_normal(torch.Generator().manual_seed(3), shape,
                             std=0.5, dtype=dtype)
    assert got.untyped_storage().nbytes() == got.numel() * got.element_size()
    assert got.dtype == dtype and torch.equal(got, cut(whole))


def _hold_modules(got, want, what):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, w in want.items():
        _near(got[k], w, 1e-4 if "/" in k else 1e-5, f"{what} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_torch_tp_mixers_modules_match_one_process(runs, arch):
    """The slice's mixers at ``(1, 2)``: outputs within 1e-5, gradients
    (of the inputs and of every parameter, made whole) within 1e-4 of
    their largest value, on both ranks."""
    want = _load(runs["one"] / f"mod_{arch}.npz")
    mods = {"minicpm3-4b": {"mla"}, "deepseek-v3-671b": {"mla"},
            "rwkv6-3b": {"rwkv_tmix", "rwkv_cmix"},
            "jamba-v0.1-52b": {"mamba"}, "seamless-m4t-large-v2": {"cross"}}
    assert {k for k in want if "/" not in k} == mods[arch]
    for r in range(2):
        _hold_modules(_load(runs[2] / f"mod_{arch}_{r}.npz"), want,
                      f"{arch} rank {r}")


def _layer_collectives(cfg, tp):
    """The all-reduces of one decoder layer's forward: one for a mixer's
    row-parallel product (two for Mamba's: ``x_proj`` and ``out_proj``;
    none for a mixer that runs whole), one for cross attention's ``wo``,
    one for the MLP's (``w_down``, the MoE's sum or the channel mix's
    ``wv``) and one more for a MoE's shared experts' ``w_down``."""
    from repro_torch.models import transformer as tfm
    total = 0
    for i in range(cfg.num_layers):
        k = tfm._kind(cfg, i)
        whole = (k.mixer == "rwkv" and cfg.num_heads % tp) or \
            (k.mixer in ("gqa", "mla") and cfg.padded_heads() % tp)
        total += 0 if whole else (2 if k.mixer == "mamba" else 1)
        total += int(k.cross) + 1
        total += int(k.mlp == "moe" and cfg.moe.num_shared_experts > 0)
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_torch_tp_mixers_collectives_of_a_prefill_and_a_decode_step(
        runs, arch):
    """An all-reduce for the embedding and :func:`_layer_collectives` a
    layer, then one all-gather of the last position's logits, in the
    prefill and in every decode step; an encode, two all-reduces an
    encoder layer (``wo`` and ``w_down``) and nothing else."""
    cfg = _cfg(arch)
    for world, shapes in MESHES.items():
        for shape in shapes:
            want = {"all_reduce": 1 + _layer_collectives(cfg, shape[1]),
                    "all_gather": 1}
            calls = {"prefill": want, "decode": want}
            if cfg.is_encoder_decoder:
                calls["encode"] = {"all_reduce": 2 * cfg.num_encoder_layers}
            for r in range(world):
                got = _json(runs[world] / f"rank{r}.json")[
                    f"{arch}_{_tag(shape)}"]
                assert got == calls, (shape, r, got)


def test_torch_tp_mixers_rwkv_heads_the_axis_does_not_divide_run_whole(
        runs):
    """The smoke RWKV-6's 2 heads at ``(1, 4)``: every rank holds the
    whole time mix and runs it whole, with no collective (one all-reduce a
    layer, the channel mix's), against one process: the serving checks of
    :func:`test_torch_tp_mixers_serving_matches_one_process` and the time
    and channel mixes' outputs (1e-5) and gradients (1e-4), seeded."""
    cfg = _cfg("rwkv6-3b")
    assert cfg.num_heads % 4
    assert _layer_collectives(cfg, 4) == cfg.num_layers
    want = _load(runs["one"] / "whole_mod.npz")
    whole = _whole_spec("rwkv6-3b")
    for r in range(4):
        _hold_modules(_load(runs[4] / f"whole_mod_{r}.npz"), want,
                      f"rank {r}")
        held = _json(runs[4] / f"rank{r}.json")["rwkv6-3b_1x4_shapes"]
        for n, w in whole.items():
            if ".mixer." in n:
                assert held[n] == w, n
        assert held["blocks.0.mlp.wk"] == [cfg.d_model, cfg.d_ff // 4]


@pytest.mark.parametrize("arch", ARCHS)
def test_torch_tp_mixers_generate_at_model_2_matches_one_process(runs, arch):
    """``generate(mesh=)`` at ``(1, 2)``, seeded (SeamlessM4T with
    ``enc_embeds``), against one process's greedy tokens."""
    want = _load(runs["one"] / f"gen_{arch}.npz")["tokens"]
    for r in range(2):
        got = _load(runs[2] / f"gen_{arch}_{r}.npz")["tokens"]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tp", (2, 4, 8, 16))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_torch_tp_mixers_every_configuration_runs_under_a_model_axis(
        arch, tp):
    """``require_supported`` takes each of the ten full configurations at
    ``model`` 2, 4, 8 and 16, and ``tp_param_spec`` cuts every mixer whose
    heads (Mamba: channels) the axis divides and keeps whole the rest."""
    from repro_torch import configs
    from repro_torch.models import transformer as tfm
    cfg = configs.get_model_config(arch)
    stand = types.SimpleNamespace(shape={"data": 1, "model": tp})
    tfm.require_supported(stand, cfg)
    assert tfm.TP_KINDS == tfm.SUPPORTED_KINDS
    spec = tfm.tp_param_spec(cfg, stand)
    for i in range(cfg.num_layers):
        kind = tfm._kind(cfg, i)
        width = cfg.ssm.expand * cfg.d_model if kind.mixer == "mamba" else \
            cfg.num_heads if kind.mixer == "rwkv" else cfg.padded_heads()
        cut = any(e is not None
                  for n, sp in spec.items()
                  if n.startswith(f"blocks.{i}.mixer.") for e in sp)
        assert cut == (width % tp == 0), (i, kind, width)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_oracle(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "one":
        _one_process(sys.argv[2], sys.argv[3])
    else:
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
                sys.argv[6])
