"""Tensor-parallel serving and the tensor-parallel modules, over meshes of
``gloo`` CPU ranks, on smoke configurations in float32.

The ranks are separate processes (this file run as a script, one process
a rank, meeting at a ``file://`` rendezvous): a world of 2 over a
``(data 1, model 2)`` mesh, and a world of 4 over ``(data 1, model 4)``
(the smoke Qwen2's 2 KV heads fall back to every rank keeping the whole
KV projection and reading its group's head) and ``(data 2, model 2)``.
The JAX reference runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (set before it
imports jax, never in the pytest process): its ``Model.prefill`` and
``decode_step`` jitted with ``param_shardings`` on the same meshes, of
``AxisType.Auto`` axes.

Held, against one process (the same weights, no mesh) and against the
reference: the prefill's logits and 4 greedy decode steps' logits within
1e-5 of the largest logit, every token equal, for ``qwen2-7b``,
``starcoder2-15b`` (QKV and MLP biases, gelu) and ``mixtral-8x7b`` (the
F-sharded MoE) on all three meshes; ``stablelm-12b`` and ``qwen2-vl-2b``
(a vision prefill with M-RoPE positions: 2 query heads and 1 KV head a
rank) at ``(1, 2)`` against one process; ``gqa_apply``, ``mlp_apply``,
``moe_apply``, the vocab-parallel embedding, head and both cross
entropies, forward (1e-5) and gradients (1e-4 of each leaf's largest),
each rank holding only its shards; ``generate(mesh=)`` at ``(1, 2)``
for all five configurations and at ``(2, 2)``;
``REPRO_BF16_TP`` on and off; the collectives of a prefill and of a
decode step, counted; every rank returning the same; query heads that
``model 4`` does not divide (six) running whole on every rank against
one process; the layer kinds that had no tensor-parallel path
before ``tests/test_torch_tp_mixers.py``'s taken; and the widths the
axis does not divide taken (``tests/test_torch_tp_fallback.py`` runs
them), but a MoE's expert width, refused as the reference refuses it.
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
JAX_ARCHS = ("qwen2-7b", "starcoder2-15b", "mixtral-8x7b")
SEED_ARCHS = ("stablelm-12b", "qwen2-vl-2b")
MESHES = {2: ((1, 2),), 4: ((1, 4), (2, 2))}
B, S, NEW, SEED = 4, 24, 4, 0
VISION_SIDE = 4
# six query heads, which a model axis of 4 does not divide: the attention
# runs whole on every rank
WHOLE_HEADS = dict(num_heads=6, num_kv_heads=2, head_dim=32)


def _cfg(arch, dtype="float32", **kw):
    from repro_torch import configs
    return configs.get_model_config(arch, smoke=True).replace(
        dtype=dtype, param_dtype=dtype, **kw)


def _tree(npz):
    tree = {}
    for path, a in np.load(npz).items():
        *parents, leaf = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree


def _model(arch, init=None, mesh=None, dtype="float32", **kw):
    """The smoke model (``kw`` replacing fields of its configuration): the
    reference's initial parameters (``init``, a flat ``.npz`` by tree
    path), or seeded; on ``mesh`` this rank's shards."""
    from repro_torch.models import convert
    from repro_torch.models.api import build_model
    if init is not None:
        return convert.params_from_jax(_tree(init), _cfg(arch, dtype, **kw),
                                       device="cpu", mesh=mesh)
    m = build_model(_cfg(arch, dtype, **kw), device="cpu", mesh=mesh)
    m.init(SEED)
    return m


def _prompts():
    rng = np.random.default_rng(SEED)
    return rng.integers(0, 512, size=(B, S)).astype(np.int64)


def _vision(cfg):
    """A vision prefill's batch: one VISION_SIDE x VISION_SIDE block of
    patch embeddings a request at a seeded offset and its M-RoPE
    positions (the text after the block from its largest position + 1)."""
    rng = np.random.default_rng(SEED + 1)
    n = VISION_SIDE * VISION_SIDE
    starts = rng.integers(0, S - n + 1, size=B)
    pp = np.stack([s0 + np.arange(n) for s0 in starts])
    mrope = np.broadcast_to(np.arange(S), (3, B, S)).copy()
    row, col = np.divmod(np.arange(n), VISION_SIDE)
    for b, s0 in enumerate(starts):
        mrope[:, b, s0:s0 + n] = np.stack([np.full(n, s0), s0 + row,
                                           s0 + col])
        mrope[:, b, s0 + n:] += VISION_SIDE - n
    pe = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32) * 0.02
    return {"tokens": torch.from_numpy(_prompts()),
            "patch_embeds": torch.from_numpy(pe),
            "patch_positions": torch.from_numpy(pp),
            "mrope_positions": torch.from_numpy(mrope)}


def greedy(model, batch, counts=None):
    """The prefill's logits, each of ``NEW`` greedy decode steps' logits
    and the tokens; with ``counts`` the collectives of the prefill and of
    the first decode step are recorded in it."""
    from repro_torch.launch import mesh as mesh_lib
    out = {}
    with torch.no_grad():
        mesh_lib.reset_collective_counts()
        logits, cache = model.prefill(batch, S + NEW, backend="torch")
        if counts is not None:
            counts["prefill"] = mesh_lib.collective_counts()
        out["prefill"] = logits
        tok = logits.argmax(-1)
        toks = [tok]
        for i in range(NEW):
            mesh_lib.reset_collective_counts()
            lg, cache = model.decode_step(tok, S + i, cache, backend="torch")
            if counts is not None and i == 0:
                counts["decode"] = mesh_lib.collective_counts()
            out[f"decode{i}"] = lg
            tok = lg.argmax(-1)
            toks.append(tok)
    out["tokens"] = torch.stack(toks, 1)
    return out


def module_cases(model):
    """Each tensor-parallel module of block 0 (and the embedding, the
    head and both cross entropies) on seeded inputs: its output and the
    gradients of a seeded projection of it, with respect to its input and
    to each of its parameters, made whole (``Model.gather``). Runs the
    same with and without a mesh."""
    from repro_torch.launch import sharding as shd
    from repro_torch.models import attention as attn
    from repro_torch.models import mlp as mlpm
    from repro_torch.models import transformer as tfm
    from repro_torch.models.rope import positions_for
    cfg = model.cfg
    gen = torch.Generator().manual_seed(SEED + 2)
    D = cfg.d_model
    x0 = torch.randn(B, S, D, generator=gen)
    cot = torch.randn(B, S, D, generator=gen)
    tokens = torch.from_numpy(_prompts())
    labels = torch.roll(tokens, -1, 1)
    valid = torch.ones(B, S)
    valid[0, :5] = 0.0
    pos = positions_for(B, S)
    p = model.params
    out = {}

    def grads(tag, names, *extra):
        for t, name in extra:
            out[f"{tag}/d{name}"] = t.grad.detach().clone()
        for n in names:
            prm = dict(p.named_parameters())[n]
            out[f"{tag}/{n}"] = model.gather(n, prm.grad)
            prm.grad = None

    model.requires_grad_(True)
    with model.bound():
        blk = p.blocks[0]
        x = x0.clone().requires_grad_(True)
        y, _ = attn.gqa_apply(blk["mixer"], x, cfg=cfg, positions=pos,
                              backend="torch")
        (y * cot).sum().backward()
        out["gqa"] = y.detach()
        grads("gqa", [f"blocks.0.mixer.{k}" for k in blk["mixer"]],
              (x, "x"))
        x = x0.clone().requires_grad_(True)
        if cfg.moe is not None:
            y, aux = mlpm.moe_apply(blk["mlp"], x, cfg=cfg)
            ((y * cot).sum() + aux).backward()
            out["moe"], out["moe_aux"] = y.detach(), aux.detach()
            grads("moe", [f"blocks.0.mlp.{k}" for k in blk["mlp"]], (x, "x"))
        else:
            y = mlpm.mlp_apply(blk["mlp"], x, cfg=cfg)
            (y * cot).sum().backward()
            out["mlp"] = y.detach()
            grads("mlp", [f"blocks.0.mlp.{k}" for k in blk["mlp"]], (x, "x"))
        e = tfm._embed(p, cfg, tokens, pos, backend="torch")
        (e * cot).sum().backward()
        out["embed"] = e.detach()
        grads("embed", ["embed"])
        h = x0.clone().requires_grad_(True)
        logits = tfm._head(p, cfg, h)
        vcot = torch.randn(B, S, cfg.padded_vocab(), generator=gen)
        (logits * shd.shard_of(vcot, (None, None, "model"), model.mesh)
         if model.mesh is not None else logits * vcot).sum().backward()
        out["head"] = shd.gather_from_model(logits.detach())
        head = "lm_head" if p.lm_head is not None else "embed"
        grads("head", [head], (h, "x"))
        for tag, chunk in (("xent", 0), ("xent_chunked", 10)):
            h = x0.clone().requires_grad_(True)
            if chunk:
                loss = tfm._xent_chunked(
                    p, cfg.replace(loss_chunk=chunk), h, labels, valid)
            else:
                loss = tfm._xent(tfm._head(p, cfg, h), labels, valid,
                                 cfg.vocab_size)
            loss.backward()
            out[tag] = loss.detach()
            grads(tag, [head], (h, "x"))
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


# ---------------------------------------------------------------------------
# the workers (this file run as a script)
# ---------------------------------------------------------------------------


def _worker(world, rank, rdv, out, jax_dir):
    import torch.distributed as dist
    from repro_torch.launch.serve import generate
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    try:
        res = {}
        for shape in MESHES[world]:
            mesh = _local_mesh(shape)
            for arch in JAX_ARCHS:
                model = _model(arch, os.path.join(jax_dir,
                                                  f"init_{arch}.npz"), mesh)
                counts = {}
                _save(os.path.join(out, f"{arch}_{_tag(shape)}_{rank}.npz"),
                      greedy(model, {"tokens": torch.from_numpy(_prompts())},
                             counts))
                res[f"{arch}_{_tag(shape)}"] = counts
                if shape == (1, 2):
                    _save(os.path.join(out, f"mod_{arch}_{rank}.npz"),
                          module_cases(model))
                    res[f"{arch}_shapes"] = {
                        n: list(t.shape)
                        for n, t in model.params.named_parameters()}
            if shape == (1, 2):
                for arch in JAX_ARCHS + SEED_ARCHS:
                    toks, _ = generate(arch=arch, model=_model(arch,
                                                               mesh=mesh),
                                       prompt_tokens=_prompts(),
                                       max_new_tokens=NEW, backend="torch",
                                       mesh=mesh)
                    _save(os.path.join(out, f"gen_{arch}_{rank}.npz"),
                          {"tokens": toks})
                for arch in SEED_ARCHS:
                    model = _model(arch, mesh=mesh)
                    batch = _vision(model.cfg) if arch == "qwen2-vl-2b" \
                        else {"tokens": torch.from_numpy(_prompts())}
                    _save(os.path.join(out, f"{arch}_{rank}.npz"),
                          greedy(model, batch))
                for flag in ("", "1"):
                    os.environ["REPRO_BF16_TP"] = flag
                    for dtype in ("float32", "bfloat16"):
                        model = _model("qwen2-7b", mesh=mesh, dtype=dtype)
                        _save(os.path.join(
                            out, f"bf16tp{flag or 0}_{dtype}_{rank}.npz"),
                            greedy(model, {"tokens": torch.from_numpy(
                                _prompts())}))
                os.environ["REPRO_BF16_TP"] = ""
            if shape == (1, 4):
                model = _model("qwen2-7b", mesh=mesh, **WHOLE_HEADS)
                counts = {}
                _save(os.path.join(out, f"whole_heads_{rank}.npz"),
                      greedy(model, {"tokens": torch.from_numpy(_prompts())},
                             counts))
                _save(os.path.join(out, f"whole_heads_mod_{rank}.npz"),
                      module_cases(model))
                res["whole_heads"] = counts
                res["whole_heads_shapes"] = {
                    n: list(t.shape)
                    for n, t in model.params.named_parameters()}
            if shape == (2, 2):
                toks, _ = generate(arch="qwen2-7b", prompt_tokens=_prompts(),
                                   max_new_tokens=NEW, device="cpu",
                                   backend="torch", mesh=mesh)
                _save(os.path.join(out, f"generate_{rank}.npz"),
                      {"tokens": toks})
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _jax_oracle(out):
    """The reference's initial parameters for each of ``JAX_ARCHS`` and
    its prefill and greedy decode steps on each mesh, of Auto axes, with
    the parameters placed by ``param_shardings``."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.launch import sharding as jshd
    from repro.launch.steps import (make_decode_step, make_prefill_step,
                                    param_shardings)
    from repro.models import transformer as jtfm
    from repro.models.api import build_model as jbuild
    assert len(jax.devices()) == 4
    for arch in JAX_ARCHS:
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
            res = {}
            with mesh, jshd.axis_rules(mesh):
                p = jax.device_put(params, param_shardings(mesh, jm, params))
                prefill = jax.jit(make_prefill_step(jm, max_len=S + NEW))
                decode = jax.jit(make_decode_step(jm))
                logits, cache = prefill(p, {"tokens": jnp.asarray(
                    _prompts(), jnp.int32)})
                res["prefill"] = np.asarray(logits)
                tok = jnp.argmax(logits, -1).astype(jnp.int32)
                toks = [np.asarray(tok)]
                for i in range(NEW):
                    lg, cache = decode(p, tok, jnp.asarray(S + i, jnp.int32),
                                       jnp.full((B,), S + i + 1, jnp.int32),
                                       cache)
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
    procs = [subprocess.Popen(
        [sys.executable, __file__, "worker", str(world), str(r),
         str(tmp / f"rdv{world}")] + [str(a) for a in args],
        env=_env(), cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    return procs


def _jax(args):
    """This file's JAX oracle as a subprocess over 4 host devices."""
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
    """The reference's oracle (and its initial parameters) first, then
    the ranks of both worlds, side by side."""
    tmp = tmp_path_factory.mktemp("tp")
    jax_out = tmp / "jax"
    jax_out.mkdir()
    _wait([_jax(["jax", jax_out])])
    dirs = {w: tmp / f"w{w}" for w in MESHES}
    procs = []
    for w, d in dirs.items():
        d.mkdir()
        procs += _launch(w, [d, jax_out], tmp)
    _wait(procs)
    return {"jax": jax_out, **dirs}


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
    for k in want:
        if k == "tokens":
            np.testing.assert_array_equal(got[k], want[k], err_msg=what)
        else:
            _near(got[k], want[k], tol, f"{what} {k}")


def _one_process(arch, runs):
    init = runs["jax"] / f"init_{arch}.npz"
    return {k: v.float().numpy() for k, v in greedy(
        _model(arch, init), {"tokens": torch.from_numpy(_prompts())}).items()}


@pytest.mark.parametrize("shape", MESHES[2] + MESHES[4], ids=_tag)
@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_torch_tp_serving_matches_one_process(runs, arch, shape):
    want = _one_process(arch, runs)
    world = shape[0] * shape[1]
    for r in range(world):
        got = _load(runs[world] / f"{arch}_{_tag(shape)}_{r}.npz")
        _hold_greedy(got, want, f"{arch} {shape} rank {r}")


@pytest.mark.parametrize("shape", MESHES[2] + MESHES[4], ids=_tag)
@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_torch_tp_serving_matches_the_reference_on_its_mesh(runs, arch,
                                                            shape):
    want = _load(runs["jax"] / f"{arch}_{_tag(shape)}.npz")
    world = shape[0] * shape[1]
    got = _load(runs[world] / f"{arch}_{_tag(shape)}_0.npz")
    _hold_greedy(got, want, f"{arch} {shape}")


@pytest.mark.parametrize("arch", SEED_ARCHS)
def test_torch_tp_seeded_serving_matches_one_process(runs, arch):
    """Seeded on the mesh, each rank drawing every leaf whole and keeping
    its shard, against the same seed in one process; Qwen2-VL through a
    vision prefill."""
    model = _model(arch)
    batch = _vision(model.cfg) if arch == "qwen2-vl-2b" else \
        {"tokens": torch.from_numpy(_prompts())}
    want = {k: v.float().numpy() for k, v in greedy(model, batch).items()}
    for r in range(2):
        _hold_greedy(_load(runs[2] / f"{arch}_{r}.npz"), want,
                     f"{arch} rank {r}")


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_torch_tp_each_rank_holds_only_its_shards(runs, arch):
    """At ``(1, 2)`` every leaf is its ``param_spec`` shard (the model
    axis halves the sharded dim), the smoke Qwen2's KV projection split
    at head granularity (one KV head a rank)."""
    from repro_torch.launch import sharding as shd
    from repro_torch.models import transformer as tfm
    cfg = _cfg(arch)
    with torch.device("meta"):
        whole = dict(tfm.init_params(cfg, torch.Generator(),
                                     device="meta").named_parameters())
    stand = types.SimpleNamespace(shape={"data": 1, "model": 2})
    with shd.axis_rules(stand):
        spec = tfm.param_spec(whole, cfg)
    held = _json(runs[2] / "rank0.json")[f"{arch}_shapes"]
    assert set(held) == set(whole)
    split = 0
    for n, t in whole.items():
        want = [d // 2 if e == "model" else d for d, e in zip(t.shape,
                                                              spec[n])]
        assert held[n] == want, n
        split += want != list(t.shape)
    assert split > 0
    assert held["blocks.0.mixer.wk"][1] == cfg.resolved_head_dim()


def test_torch_tp_kv_heads_fall_back_to_whole_at_model_4():
    """At ``model 4`` the smoke Qwen2's 2 KV heads do not divide: its
    ``param_spec`` splits the flat 64 columns of ``wk`` in four (half a
    head a rank), and the port keeps the whole projection on every rank
    instead; each rank's one query head reads its group's KV head."""
    from repro_torch.launch import sharding as shd
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm
    cfg = _cfg("qwen2-7b")
    stand = types.SimpleNamespace(shape={"data": 1, "model": 4})
    with torch.device("meta"):
        whole = dict(tfm.init_params(cfg, torch.Generator(),
                                     device="meta").named_parameters())
    with shd.axis_rules(stand):
        assert tfm.param_spec(whole, cfg)["blocks.0.mixer.wk"] == \
            (None, "model")
    spec = tfm.tp_param_spec(cfg, stand)
    for k in ("wk", "wv", "bk", "bv"):
        assert set(spec[f"blocks.0.mixer.{k}"]) == {None}
    assert spec["blocks.0.mixer.wq"] == (None, "model")
    assert not attn.kv_sharded(cfg, 4) and attn.kv_sharded(cfg, 2)
    heads = [attn.local_heads(cfg, shd.ModelAxis(4, r, None))
             for r in range(4)]
    assert heads == [(1, 1, 0), (1, 1, 0), (1, 1, 1), (1, 1, 1)]


def _hold_modules(got, want, what):
    for k, w in want.items():
        tol = 1e-4 if "/" in k else 1e-5
        _near(got[k], w, tol, f"{what} {k}")


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_torch_tp_modules_match_one_process(runs, arch):
    """gqa_apply, mlp_apply / moe_apply (with its aux loss), the
    embedding, the head and both cross entropies at ``(1, 2)``: outputs
    within 1e-5, gradients (of the input and of every parameter, made
    whole) within 1e-4 of their largest value, on both ranks."""
    model = _model(arch, runs["jax"] / f"init_{arch}.npz")
    want = {k: v.float().numpy() for k, v in module_cases(model).items()}
    assert {"gqa", "embed", "head", "xent", "xent_chunked"} <= set(want)
    assert ("moe" if arch == "mixtral-8x7b" else "mlp") in want
    for r in range(2):
        got = _load(runs[2] / f"mod_{arch}_{r}.npz")
        assert set(got) == set(want)
        _hold_modules(got, want, f"{arch} rank {r}")


def test_torch_tp_generate_on_a_data_and_model_mesh(runs):
    """``generate(mesh=)`` at ``(2, 2)``, seeded: each data rank serves
    half the requests and every rank returns the whole batch, equal to
    one process's."""
    from repro_torch.launch.serve import generate
    want, _ = generate(arch="qwen2-7b", prompt_tokens=_prompts(),
                       max_new_tokens=NEW, device="cpu", backend="torch")
    for r in range(4):
        got = _load(runs[4] / f"generate_{r}.npz")["tokens"]
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("arch", JAX_ARCHS + SEED_ARCHS)
def test_torch_tp_generate_at_model_2_matches_one_process(runs, arch):
    """``generate(mesh=)`` at ``(1, 2)`` for every configuration this
    slice ports, seeded, against one process's greedy tokens."""
    from repro_torch.launch.serve import generate
    want, _ = generate(arch=arch, model=_model(arch),
                       prompt_tokens=_prompts(), max_new_tokens=NEW,
                       backend="torch")
    for r in range(2):
        got = _load(runs[2] / f"gen_{arch}_{r}.npz")["tokens"]
        np.testing.assert_array_equal(got, want.numpy())


def test_torch_tp_bf16_tp_on_and_off(runs):
    """``REPRO_BF16_TP`` picks the row-parallel sum's dtype: in float32
    both give the same bits; in bfloat16 both stay within 2e-2 of the
    largest logit of one process, and the first tokens agree."""
    for dtype in ("float32", "bfloat16"):
        model = _model("qwen2-7b", dtype=dtype)
        want = {k: v.float().numpy() for k, v in greedy(
            model, {"tokens": torch.from_numpy(_prompts())}).items()}
        on = _load(runs[2] / f"bf16tp1_{dtype}_0.npz")
        off = _load(runs[2] / f"bf16tp0_{dtype}_0.npz")
        if dtype == "float32":
            for k in on:
                np.testing.assert_array_equal(on[k], off[k])
        for got in (on, off):
            _near(got["prefill"], want["prefill"], 2e-2, dtype)
            np.testing.assert_array_equal(got["tokens"][:, 0],
                                          want["tokens"][:, 0])


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_torch_tp_collectives_of_a_prefill_and_a_decode_step(runs, arch):
    """One all-reduce for the embedding and two a layer (``wo`` and
    ``w_down``, or the MoE's sum), then one all-gather of the last
    position's logits, in the prefill and in every decode step."""
    L = _cfg(arch).num_layers
    want = {"all_reduce": 1 + 2 * L, "all_gather": 1}
    for world, shapes in MESHES.items():
        for shape in shapes:
            for r in range(world):
                got = _json(runs[world] / f"rank{r}.json")[
                    f"{arch}_{_tag(shape)}"]
                assert got == {"prefill": want, "decode": want}, (shape, r)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v3-671b",
                                  "rwkv6-3b", "jamba-v0.1-52b",
                                  "seamless-m4t-large-v2"])
def test_torch_tp_layer_kinds_without_a_path_are_refused(arch):
    """These five configurations' layer kinds (MLA, RWKV-6, Mamba, cross
    attention) were refused on a ``model`` axis of 2 until they had a
    tensor-parallel path; they have one now, so each is taken:
    ``require_supported`` passes, ``build_model`` builds on the mesh, and
    its spec cuts the mixer's leaves (``tests/test_torch_tp_mixers.py``
    runs them on ranks)."""
    from repro_torch import configs
    from repro_torch.models import transformer as tfm
    from repro_torch.models.api import build_model
    cfg = configs.get_model_config(arch, smoke=True)
    tp = types.SimpleNamespace(shape={"data": 1, "model": 2})
    tfm.require_supported(tp, cfg)
    spec = build_model(cfg, device="cpu", mesh=tp).spec
    leaf = {"minicpm3-4b": "blocks.0.mixer.wq_b",
            "deepseek-v3-671b": "blocks.0.mixer.wkv_b",
            "rwkv6-3b": "blocks.0.mixer.wr",
            "jamba-v0.1-52b": "blocks.0.mixer.conv_w",
            "seamless-m4t-large-v2": "blocks.0.cross.wq"}[arch]
    assert spec[leaf] == (None, "model")
    # a model axis of 1 refuses nothing
    tfm.require_supported(
        types.SimpleNamespace(shape={"data": 2, "model": 1}), cfg)


@pytest.mark.parametrize("what", ["d_ff", "KV heads", "vocabulary",
                                  "d_ff_expert"])
def test_torch_tp_widths_the_model_axis_does_not_divide_are_refused(what):
    """Of the widths that a ``model`` axis of 4 does not divide, only a
    MoE's expert width is refused, with ``ValueError``, as the reference's
    ``shard_map`` refuses it. An MLP width, KV heads that neither divide
    nor are divided by the axis and the padded vocabulary, refused until
    the divisibility fallback was ported, are taken: ``build_model``
    builds on the mesh, the leaves that carry them whole on every rank
    (``tests/test_torch_tp_fallback.py`` runs them on ranks; query heads
    the axis does not divide run whole too:
    ``test_torch_tp_query_heads_the_axis_does_not_divide_run_whole``)."""
    from repro_torch import configs
    from repro_torch.models import transformer as tfm
    from repro_torch.models.api import build_model
    stand = types.SimpleNamespace(shape={"data": 1, "model": 4})
    if what == "d_ff_expert":
        cfg = configs.get_model_config("mixtral-8x7b", smoke=True)
        cfg = cfg.replace(moe=cfg.moe.__class__(
            **dict(cfg.moe.__dict__, d_ff_expert=62)))
        with pytest.raises(ValueError, match="not evenly divisible"):
            tfm.require_supported(stand, cfg)
        with pytest.raises(ValueError, match="not evenly divisible"):
            build_model(cfg, device="cpu", mesh=stand)
        return
    kw, leaf = {"d_ff": (dict(d_ff=250), "blocks.0.mlp.w_down"),
                "KV heads": (dict(num_heads=12, num_kv_heads=3),
                             "blocks.0.mixer.wk"),
                "vocabulary": (dict(vocab_size=510, pad_vocab_to=1),
                               "embed")}[what]
    cfg = _cfg("qwen2-7b", **kw)
    tfm.require_supported(stand, cfg)
    spec = build_model(cfg, device="cpu", mesh=stand).spec
    assert set(spec[leaf]) == {None}
    assert spec["blocks.0.mixer.wq"] == (None, "model")


def test_torch_tp_query_heads_the_axis_does_not_divide_run_whole(runs):
    """Six query heads at ``(1, 4)``: every rank holds the whole
    attention (``wq``, ``wk``, ``wv``, ``wo`` and their biases) and runs
    it whole with no collective, as the reference's divisibility fallback
    replicates it; the MLP and the vocabulary stay sharded. Seeded,
    against one process: the prefill and decode logits within 1e-5,
    tokens equal, the modules' outputs (1e-5) and gradients (1e-4); a
    call's collectives: the embedding's all-reduce and one a layer for
    ``w_down``, the logits' all-gather."""
    from repro_torch.models import transformer as tfm
    cfg = _cfg("qwen2-7b", **WHOLE_HEADS)
    stand = types.SimpleNamespace(shape={"data": 1, "model": 4})
    tfm.require_supported(stand, cfg)
    model = _model("qwen2-7b", **WHOLE_HEADS)
    want = {k: v.float().numpy() for k, v in greedy(
        model, {"tokens": torch.from_numpy(_prompts())}).items()}
    mods = {k: v.float().numpy() for k, v in module_cases(model).items()}
    whole = {n: list(t.shape) for n, t in model.params.named_parameters()}
    L = cfg.num_layers
    for r in range(4):
        _hold_greedy(_load(runs[4] / f"whole_heads_{r}.npz"), want,
                     f"rank {r}")
        _hold_modules(_load(runs[4] / f"whole_heads_mod_{r}.npz"), mods,
                      f"rank {r}")
        res = _json(runs[4] / f"rank{r}.json")
        calls = {"all_reduce": 1 + L, "all_gather": 1}
        assert res["whole_heads"] == {"prefill": calls, "decode": calls}
        held = res["whole_heads_shapes"]
        for n, shape in whole.items():
            if ".mixer." in n:
                assert held[n] == shape, n
        assert held["blocks.0.mlp.w_up"] == [cfg.d_model, cfg.d_ff // 4]
        assert held["embed"][0] == cfg.padded_vocab() // 4


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_oracle(sys.argv[2])
    else:
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
                sys.argv[6])
