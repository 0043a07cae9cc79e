"""The divisibility fallback under a ``model`` axis, over meshes of
``gloo`` CPU ranks, on smoke configurations in float32.

Where the ``model`` axis does not divide a width, the reference's
``resolve_spec`` replicates the leaves that carry it and GSPMD runs their
layer whole; the port holds those leaves whole on every rank and runs the
layer whole, with no collective: a dense MLP's ``d_ff``, RWKV-6's channel
mix's ``d_ff``, and the padded vocabulary (the embedding, the head, tied
or not, and the cross entropy). KV heads that neither divide nor are
divided by the axis are kept whole and read as each rank's query heads
need them, a rank straddling two or more KV groups, not always evenly
(12 query heads, 3 KV heads at ``model 4``: rank 1's heads 3-5 read
``[0, 1, 1]``), in prefill, decode and cross attention. A MoE's expert
width that the axis does not divide has no fallback in the reference:
its ``shard_map`` raises ``ValueError``, and so does the port.

As ``tests/test_torch_tp.py``: this file run as a script, one process a
rank, at a ``file://`` rendezvous: a world of 4 over ``(data 1, model
4)`` and then ``(data 2, model 2)``, and a world of 3 over ``(data 1,
model 3)`` (Qwen2-VL with 6 query heads and 2 KV heads, whose ``d_ff``
and vocabulary fall back too: the card's ``tp_fallback`` cut at smoke
size, through a vision prefill with M-RoPE). The JAX reference runs in
subprocesses with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(set before it imports jax, never in the pytest process), two of them,
each with half the cases: each draws its cases' initial parameters and
then, beside the ranks, runs
``Model.prefill``, ``decode_step`` and ``jax.value_and_grad(Model.loss)``
jitted with ``param_shardings`` on the same meshes (``AxisType.Auto``
axes). The dry run's traces of a rank's prefill and decode step (meta
device, a fake process group) run in a subprocess a world beside them.

Held, for every case: the prefill's and each greedy decode step's logits
within 1e-5 of the largest logit and every token equal, against one
process (the same weights, no mesh) and against the reference; the loss
within 1e-5 and every gradient leaf, made whole, within 1e-4 of its
largest value, against both; ``Model.fallbacks()`` equal to the
reference's ``shd.fallbacks()`` after ``param_shardings``; the leaves
that fall back held whole on every rank; a prefill's and a decode step's
collectives, as ``chip_smoke._tp_expected`` and the dry run count them. At
``(2, 2)``: ZeRO-1 on and off give the same bits over 2
steps, with leaves that fall back beside sharded ones. A MoE whose
``d_ff_expert`` the axis does not divide raises ``ValueError`` on both
sides.
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
B, S, S_ENC, NEW, SEED = 4, 16, 12, 3, 0
VOCAB_TOKENS = 500               # prompts below every case's vocabulary
VISION_SIDE = 2
# case -> (arch, fields replaced in its smoke configuration, world)
CASES = {
    "ff": ("qwen2-7b", dict(d_ff=250), 4),
    "vocab": ("qwen2-7b", dict(vocab_size=510, pad_vocab_to=1), 4),
    "vocab_tied": ("qwen2-7b", dict(vocab_size=510, pad_vocab_to=1,
                                    tie_embeddings=True), 4),
    "straddle": ("qwen2-7b", dict(num_heads=12, num_kv_heads=3,
                                  head_dim=16), 4),
    "cross": ("seamless-m4t-large-v2", dict(num_heads=12, num_kv_heads=3,
                                            head_dim=16), 4),
    "cmix": ("rwkv6-3b", dict(d_ff=250), 4),
    "mla_vocab": ("minicpm3-4b", dict(vocab_size=510, pad_vocab_to=1), 4),
    "vl3": ("qwen2-vl-2b", dict(num_heads=6, head_dim=32), 3),
}
SHAPE = {4: (1, 4), 3: (1, 3)}
# the leaves each case keeps whole on every rank (block 0's, by name)
WHOLE = {
    "ff": ("blocks.0.mlp.w_gate", "blocks.0.mlp.w_up", "blocks.0.mlp.w_down"),
    "vocab": ("embed", "lm_head"),
    "vocab_tied": ("embed",),
    "straddle": ("blocks.0.mixer.wk", "blocks.0.mixer.wv",
                 "blocks.0.mixer.bk", "blocks.0.mixer.bv"),
    "cross": ("blocks.0.cross.wk", "blocks.0.cross.wv",
              "blocks.0.mixer.wk", "enc_blocks.0.mixer.wv"),
    "cmix": ("blocks.0.mlp.wk", "blocks.0.mlp.wv", "blocks.0.mlp.wr"),
    "mla_vocab": ("embed", "lm_head"),
    "vl3": ("embed", "lm_head", "blocks.0.mlp.w_down", "blocks.0.mixer.wk"),
}
# the MoE whose expert width the axis does not divide
MOE_ARCH, MOE_D_FF = "mixtral-8x7b", 62
ZERO_CASE, ZERO_STEPS = "ff", 2
OPT = dict(warmup_steps=1, total_steps=4)
JAX_PARTS = 2                    # the reference's processes, a half each


def _cfg(case):
    from repro_torch import configs
    arch, kw, _ = CASES[case]
    return configs.get_model_config(arch, smoke=True).replace(
        dtype="float32", param_dtype="float32", **kw)


def _jcfg(case):
    from repro import configs as jconfigs
    arch, kw, _ = CASES[case]
    return jconfigs.get_model_config(arch, smoke=True).replace(
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


def _model(case, init, mesh=None):
    """The case's model from the reference's initial parameters (a flat
    ``.npz`` by tree path); on ``mesh`` this rank's shards."""
    from repro_torch.models import convert
    return convert.params_from_jax(_tree(init), _cfg(case), device="cpu",
                                   mesh=mesh)


def _prompts(n=S):
    rng = np.random.default_rng(SEED)
    return rng.integers(0, VOCAB_TOKENS, size=(B, n)).astype(np.int64)


def _frames(d_model):
    rng = np.random.default_rng(SEED + 3)
    return (rng.standard_normal((B, S_ENC, d_model)) * 0.02).astype(
        np.float32)


def _vision(d_model):
    """A vision prefill's extra inputs: one VISION_SIDE x VISION_SIDE block
    of patch embeddings a request at a seeded offset and its M-RoPE
    positions (the text after it from its largest position + 1)."""
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
    pe = rng.standard_normal((B, n, d_model)).astype(np.float32) * 0.02
    return {"patch_embeds": pe, "patch_positions": pp.astype(np.int64),
            "mrope_positions": mrope.astype(np.int64)}


def _serve_batch(cfg):
    """The prefill's inputs (numpy), the encoder's frames apart."""
    batch = {"tokens": _prompts()}
    if cfg.frontend == "vision":
        batch.update(_vision(cfg.d_model))
    return batch


def _loss_batch(cfg):
    """The first training step's batch (numpy): tokens (B, S + 1), and an
    encoder-decoder's frames."""
    batch = {"tokens": _prompts(S + 1)}
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = _frames(cfg.d_model)
    return batch


def greedy(model, counts=None):
    """The encoder's memory (an encoder-decoder's), the prefill's logits,
    ``NEW`` greedy decode steps' logits and the tokens; with ``counts`` the
    collectives of the encode, the prefill and the first decode step."""
    from repro_torch.launch import mesh as mesh_lib
    cfg = model.cfg
    out = {}
    batch = {k: torch.from_numpy(v) for k, v in _serve_batch(cfg).items()}
    memory = None
    with torch.no_grad():
        if cfg.is_encoder_decoder:
            mesh_lib.reset_collective_counts()
            memory = model.encode(torch.from_numpy(_frames(cfg.d_model)),
                                  backend="torch")
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


def loss_and_grads(model):
    """The first step's loss and every gradient leaf made whole."""
    model.requires_grad_(True)
    batch = {k: torch.from_numpy(v)
             for k, v in _loss_batch(model.cfg).items()}
    loss, _ = model.loss(batch, backend="torch")
    loss.backward()
    out = {"loss": loss.detach()}
    for n, p in model.params.named_parameters():
        out[f"g/{n}"] = model.gather(n, p.grad)
        p.grad = None
    model.requires_grad_(False)
    return out


def zero1_steps(model, mesh, zero1):
    """``ZERO_STEPS`` of ``make_train_step(mesh=)``: the metrics, the
    parameters and moments made whole, and the moments as held."""
    from repro_torch.configs import OptimizerConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import init_opt_state
    ocfg = OptimizerConfig(zero1=zero1, **OPT)
    model.requires_grad_(True)
    params = dict(model.params.named_parameters())
    step = make_train_step(model, ocfg, backend="torch", mesh=mesh)
    state = init_opt_state(ocfg, params, step.zero)
    src = SyntheticLM(vocab_size=VOCAB_TOKENS, seq_len=S, global_batch=B,
                      seed=SEED)
    met = []
    for s in range(ZERO_STEPS):
        state, m = step(state, {"tokens": torch.from_numpy(
            src.batch(s)["tokens"])})
        met.append({k: float(v) for k, v in m.items()})
    zero = step.zero

    def whole(n, t):
        return model.gather(n, t if zero is None else zero.gather(n, t))
    snap = {f"p/{n}": model.gather(n, p).clone() for n, p in params.items()}
    for which, tree in (("mu", state.mu), ("nu", state.nu)):
        snap.update({f"{which}/{n}": whole(n, t).clone()
                     for n, t in tree.items()})
    held = {n: t.clone() for n, t in state.mu.items()}
    return met, snap, held, None if zero is None else zero.dims


def _save(path, tensors):
    np.savez(path, **{k: v.float().numpy() for k, v in tensors.items()})


def _local_mesh(shape):
    from repro_torch.launch import mesh as mesh_lib
    return mesh_lib.make_mesh(mesh_lib.MeshConfig(shape, ("data", "model")),
                              device_type="cpu")


# ---------------------------------------------------------------------------
# the workers (this file run as a script)
# ---------------------------------------------------------------------------


def _worker(world, rank, rdv, out, jax_dir):
    import torch.distributed as dist
    from repro_torch.models.api import build_model
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    try:
        res = {}
        mesh = _local_mesh(SHAPE[world])
        for case, (_, _, w) in CASES.items():
            if w != world:
                continue
            model = _model(case, os.path.join(jax_dir, f"init_{case}.npz"),
                           mesh)
            counts = {}
            _save(os.path.join(out, f"{case}_{rank}.npz"),
                  greedy(model, counts))
            _save(os.path.join(out, f"g_{case}_{rank}.npz"),
                  loss_and_grads(model))
            res[case] = {
                "counts": counts, "fallbacks": model.fallbacks(),
                "shapes": {n: list(t.shape)
                           for n, t in model.params.named_parameters()}}
        if world == 4:
            try:
                build_model(_moe_cfg(), device="cpu", mesh=mesh)
                res["moe"] = None
            except ValueError as e:
                res["moe"] = f"ValueError: {e}"
            mesh = _local_mesh((2, 2))
            for zero1 in (True, False):
                model = _model(ZERO_CASE,
                               os.path.join(jax_dir, f"init_{ZERO_CASE}.npz"),
                               mesh)
                met, snap, held, dims = zero1_steps(model, mesh, zero1)
                tag = f"z{int(zero1)}"
                _save(os.path.join(out, f"s_{tag}_{rank}.npz"), snap)
                _save(os.path.join(out, f"held_{tag}_{rank}.npz"), held)
                res[f"steps_{tag}"] = met
                res[f"dims_{tag}"] = dims
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _dry(world, out):
    """The dry run's part: one rank's prefill and decode step of each case
    of ``world`` traced on the meta device over a fake process group on
    the case's mesh (``launch.steps.lower_prefill_step`` /
    ``lower_decode_step``, as ``launch.dryrun`` traces a cell), at the
    ranks' batch and length: the collectives each trace counts and the
    fallbacks the dry run records (``launch.dryrun._fallbacks``)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import lower_decode_step, lower_prefill_step
    from repro_torch.models.api import build_model
    dryrun.fake_group(world)
    mesh = mesh_lib.make_local_mesh(SHAPE[world][1], device_type="cpu")
    res = {}
    for case, (_, _, w) in CASES.items():
        if w != world:
            continue
        cfg = _cfg(case)
        with shd.axis_rules(mesh):
            model = build_model(cfg, device="meta", mesh=mesh)
            res[case] = {
                "prefill": lower_prefill_step(model, mesh, ShapeConfig(
                    "p", S, B, "prefill")).to_dict()["collectives"]["counts"],
                "decode": lower_decode_step(model, mesh, ShapeConfig(
                    "d", S + NEW, B, "decode")).to_dict()["collectives"][
                    "counts"],
                "fallbacks": dryrun._fallbacks(model)}
    with open(os.path.join(out, f"dry{world}.json"), "w") as f:
        json.dump(res, f)


def _moe_cfg(jax=False):
    if jax:
        from repro import configs
    else:
        from repro_torch import configs
    cfg = configs.get_model_config(MOE_ARCH, smoke=True)
    return cfg.replace(dtype="float32", param_dtype="float32",
                       moe=cfg.moe.__class__(**dict(cfg.moe.__dict__,
                                                    d_ff_expert=MOE_D_FF)))


def _jax_oracle(out, part):
    """For every other case from ``part`` (0 or 1): the reference's initial
    parameters (``init<part>.done`` marks them written), then the
    reference on the case's mesh, of Auto axes, the parameters placed by
    ``param_shardings``: its fallbacks, its prefill and greedy decode
    steps, its first loss and gradients; with part 1, the MoE's error."""
    import jax
    import jax.numpy as jnp
    from repro.launch import sharding as jshd
    from repro.launch.steps import (make_decode_step, make_prefill_step,
                                    param_shardings)
    from repro.models import transformer as jtfm
    from repro.models.api import build_model as jbuild
    assert len(jax.devices()) == 4
    meta, inits = {}, {}
    cases = list(CASES)[part::JAX_PARTS]
    for case in cases:
        inits[case] = jbuild(_jcfg(case)).init(jax.random.PRNGKey(SEED))
        np.savez(os.path.join(out, f"init_{case}.npz"), **{
            p.strip("/"): np.asarray(v)
            for p, v in jtfm._iter_paths(inits[case])})
    pathlib.Path(out, f"init{part}.done").touch()

    def mesh_of(shape):
        return jax.make_mesh(shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2,
                             devices=jax.devices()[:shape[0] * shape[1]])

    for case in cases:
        world = CASES[case][2]
        jcfg = _jcfg(case)
        jm = jbuild(jcfg)
        params = inits.pop(case)
        res = {}
        with mesh_of(SHAPE[world]) as mesh, jshd.axis_rules(mesh):
            p = jax.device_put(params, param_shardings(mesh, jm, params))
            meta[case] = sorted(set(jshd.fallbacks()))
            batch = {k: jnp.asarray(v) for k, v in
                     _serve_batch(jcfg).items()}
            batch["tokens"] = batch["tokens"].astype(jnp.int32)
            memory = None
            if jcfg.is_encoder_decoder:
                memory = jax.jit(lambda q, e: jtfm.encode(q, jcfg, e))(
                    p, jnp.asarray(_frames(jcfg.d_model)))
                res["memory"] = np.asarray(memory)
                batch["memory"] = memory
            logits, cache = jax.jit(make_prefill_step(jm, max_len=S + NEW))(
                p, batch)
            res["prefill"] = np.asarray(logits)
            decode = jax.jit(make_decode_step(jm))
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
            lb = {k: jnp.asarray(v) for k, v in _loss_batch(jcfg).items()}
            lb["tokens"] = lb["tokens"].astype(jnp.int32)
            (loss, _), g = jax.jit(jax.value_and_grad(
                jm.loss, has_aux=True))(p, lb)
            res["loss"] = np.asarray(loss)
            res.update({f"g{path}": np.asarray(v)
                        for path, v in jtfm._iter_paths(g)})
        np.savez(os.path.join(out, f"ref_{case}.npz"), **res)
    if part == JAX_PARTS - 1:
        meta["moe"] = _jax_moe(mesh_of((1, 4)))
    with open(os.path.join(out, f"meta{part}.json"), "w") as f:
        json.dump(meta, f)


def _jax_moe(mesh):
    """The reference's error on the MoE at ``mesh``: ``ValueError: ...``,
    or ``None`` where it ran."""
    import jax
    import jax.numpy as jnp
    from repro.launch import sharding as jshd
    from repro.launch.steps import make_prefill_step, param_shardings
    from repro.models.api import build_model as jbuild
    jm = jbuild(_moe_cfg(jax=True))
    params = jm.init(jax.random.PRNGKey(SEED))
    with mesh, jshd.axis_rules(mesh):
        try:
            p = jax.device_put(params, param_shardings(mesh, jm, params))
            jax.jit(make_prefill_step(jm, max_len=S + NEW))(
                p, {"tokens": jnp.asarray(_prompts(), jnp.int32)})
        except ValueError as e:
            return f"ValueError: {e}"
    return None


def _env(**extra):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    env.update(extra)
    return env


def _spawn(args):
    return subprocess.Popen(
        [sys.executable, __file__] + [str(a) for a in args],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _finish(procs):
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's initial parameters first; then the ranks of both
    worlds beside the rest of the reference's oracle."""
    tmp = tmp_path_factory.mktemp("tp_fallback")
    jax_out = tmp / "jax"
    jax_out.mkdir()
    procs = [_spawn(["jax", jax_out, part]) for part in range(JAX_PARTS)]
    deadline = time.monotonic() + 300
    while not all((jax_out / f"init{part}.done").exists()
                  for part in range(JAX_PARTS)):
        if any(p.poll() is not None for p in procs) or \
                time.monotonic() > deadline:
            _finish(procs)
            pytest.fail("the reference drew no initial parameters")
        time.sleep(0.2)
    for w in (4, 3):
        d = tmp / f"w{w}"
        d.mkdir()
        procs += [_spawn(["worker", w, r, tmp / f"rdv{w}", d, jax_out])
                  for r in range(w)]
        procs.append(_spawn(["dry", w, tmp]))
    _finish(procs)
    meta = {}
    for part in range(JAX_PARTS):
        meta.update(_json(jax_out / f"meta{part}.json"))
    return {"jax": jax_out, 4: tmp / "w4", 3: tmp / "w3", "meta": meta,
            "dry": {**_json(tmp / "dry4.json"), **_json(tmp / "dry3.json")}}


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
        elif not k.startswith("g") and k != "loss":
            _near(got[k], want[k], tol, f"{what} {k}")


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


def _ranks(case):
    return range(CASES[case][2])


def _one_process(runs, case):
    model = _model(case, runs["jax"] / f"init_{case}.npz")
    return {k: v.float().numpy() for k, v in greedy(model).items()}, \
        {k: v.float().numpy() for k, v in loss_and_grads(model).items()}


IDS = list(CASES)


@pytest.mark.parametrize("case", IDS)
def test_torch_tp_fallback_serving_matches_one_process(runs, case):
    want, _ = _one_process(runs, case)
    for r in _ranks(case):
        got = _load(runs[CASES[case][2]] / f"{case}_{r}.npz")
        assert set(got) == set(want)
        _hold_greedy(got, want, f"{case} rank {r}")


@pytest.mark.parametrize("case", IDS)
def test_torch_tp_fallback_serving_matches_the_reference(runs, case):
    want = _load(runs["jax"] / f"ref_{case}.npz")
    got = _load(runs[CASES[case][2]] / f"{case}_0.npz")
    _hold_greedy(got, want, case)


@pytest.mark.parametrize("case", IDS)
def test_torch_tp_fallback_loss_and_gradients_match_one_process(runs, case):
    _, want = _one_process(runs, case)
    for r in _ranks(case):
        got = _load(runs[CASES[case][2]] / f"g_{case}_{r}.npz")
        assert set(got) == set(want)
        for k, w in want.items():
            _near(got[k], w, 1e-5 if k == "loss" else 1e-4,
                  f"{case} rank {r} {k}")


@pytest.mark.parametrize("case", IDS)
def test_torch_tp_fallback_loss_and_gradients_match_the_reference(runs,
                                                                 case):
    ref = _load(runs["jax"] / f"ref_{case}.npz")
    want = _reference_grads(ref, _cfg(case))
    got = _load(runs[CASES[case][2]] / f"g_{case}_0.npz")
    assert set(want) == {k for k in got if k != "loss"}
    _near(got["loss"], ref["loss"], 1e-5, f"{case} loss")
    for k, w in want.items():
        _near(got[k], w, 1e-4, f"{case} {k}")


@pytest.mark.parametrize("case", IDS)
def test_torch_tp_fallback_fallbacks_are_the_references(runs, case):
    """``Model.fallbacks()`` on each rank, and the dry run's record of
    them, equal the reference's ``shd.fallbacks()`` after
    ``param_shardings`` on the same mesh (none for the straddled KV
    heads, whose flat ``KV * Dh`` columns the axis divides: the reference
    replicates them at the activations' ``kv_heads`` constraint)."""
    want = [tuple(f) for f in runs["meta"][case]]
    assert bool(want) == (case not in ("straddle", "cross")), want
    for r in _ranks(case):
        got = _json(runs[CASES[case][2]] / f"rank{r}.json")[case]
        assert [tuple(f) for f in got["fallbacks"]] == want, r


@pytest.mark.parametrize("case", IDS)
def test_torch_tp_fallback_leaves_are_whole_on_every_rank(runs, case):
    """The leaves a case falls back on are held whole on every rank, and
    ``tp_param_spec`` says ``None`` throughout for them."""
    from repro_torch.models import transformer as tfm
    cfg = _cfg(case)
    whole = tfm.param_shapes(cfg)
    world = CASES[case][2]
    spec = tfm.tp_param_spec(cfg, types.SimpleNamespace(
        shape={"data": 1, "model": world}))
    for r in _ranks(case):
        held = _json(runs[world] / f"rank{r}.json")[case]["shapes"]
        for n in WHOLE[case]:
            assert held[n] == list(whole[n]), (r, n)
            assert set(spec[n]) == {None}, n
        assert any(held[n] != list(whole[n]) for n in held), r


def _expected_counts(case):
    """A prefill's and a decode step's collectives on a rank: one
    all-reduce for each row-parallel product that runs cut (a mixer's
    ``wo``, cross attention's, an MLP's ``w_down``, the channel mix's
    ``wv``), and for the embedding and one all-gather of the logits where
    the vocabulary is cut; none for what runs whole."""
    from repro_torch.models import transformer as tfm
    cfg = _cfg(case)
    tp = CASES[case][2]
    vocab = cfg.padded_vocab() % tp == 0
    mixer_cut = (cfg.num_heads if cfg.ssm else cfg.padded_heads()) % tp == 0
    ar = int(vocab)
    for i in range(cfg.num_layers):
        kind = tfm._kind(cfg, i)
        ar += int(mixer_cut) + int(kind.cross and mixer_cut) + \
            int(cfg.d_ff % tp == 0)
    coll = {"all_reduce": ar}
    if vocab:
        coll["all_gather"] = 1
    return {"prefill": coll, "decode": coll}


@pytest.mark.parametrize("case", IDS)
def test_torch_tp_fallback_collectives_of_a_prefill_and_a_decode_step(
        runs, case):
    want = _expected_counts(case)
    for r in _ranks(case):
        got = _json(runs[CASES[case][2]] / f"rank{r}.json")[case]["counts"]
        assert {c: {k: v for k, v in n.items() if v}
                for c, n in got.items() if c != "encode"} == want, (case, r)


@pytest.mark.parametrize("case", IDS)
def test_torch_tp_fallback_the_dry_run_traces_the_cut(runs, case):
    """The dry run's trace of a rank's prefill and decode step on the
    case's mesh (meta device, fake process group) counts the collectives
    the ranks issued (an encoder-decoder's prefill with its encode), and
    records the reference's fallbacks."""
    dry = runs["dry"][case]
    ranks = _json(runs[CASES[case][2]] / "rank0.json")[case]["counts"]
    want = dict(ranks["prefill"])
    for k, n in ranks.get("encode", {}).items():
        want[k] = want.get(k, 0) + n
    assert {k: v for k, v in dry["prefill"].items() if v} == want
    assert {k: v for k, v in dry["decode"].items() if v} == ranks["decode"]
    assert [tuple(f) for f in dry["fallbacks"]] == \
        [tuple(f) for f in runs["meta"][case]]


@pytest.mark.parametrize("case", IDS)
def test_torch_tp_fallback_chip_smoke_expects_these_collectives(runs, case):
    """``chip_smoke._tp_expected``, which the card's tensor-parallel
    phases are held to, gives each case's collectives as the ranks issued
    them: no embedding all-reduce and no logits all-gather at a vocabulary
    that falls back, no MLP all-reduce at a width that does."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = smoke._tp_expected(_cfg(case), CASES[case][2])
    for r in _ranks(case):
        got = _json(runs[CASES[case][2]] / f"rank{r}.json")[case]["counts"]
        assert got["prefill"] == want["prefill"]["collectives"], r
        assert got["decode"] == want["decode_step"]["collectives"], r
        if "encode" in want:
            assert got["encode"] == want["encode"]["collectives"], r


def test_torch_tp_fallback_a_moe_width_the_axis_does_not_divide_raises(runs):
    """A MoE whose ``d_ff_expert`` (62) ``model 4`` does not divide: the
    reference's ``shard_map`` raises ``ValueError`` (not evenly divisible
    by the mesh axis sizes), and the port's ``build_model(mesh=)`` raises
    it too, on every rank."""
    ref = runs["meta"]["moe"]
    assert ref is not None and ref.startswith("ValueError"), ref
    assert "not evenly divisible" in ref
    for r in range(4):
        got = _json(runs[4] / f"rank{r}.json")["moe"]
        assert got is not None and got.startswith("ValueError"), got
        assert "not evenly divisible by the corresponding mesh axis sizes" \
            in got


def test_torch_tp_fallback_zero1_beside_leaves_that_fall_back(runs):
    """At ``(2, 2)`` ZeRO-1 on and off give the same bits over
    ``ZERO_STEPS`` steps (the metrics, every parameter and moment made
    whole), ZeRO-1 slicing the whole MLP leaves that fall back over
    ``data`` beside the sharded attention; each rank holds its ``data``
    slice of the moments."""
    res = _json(runs[4] / "rank0.json")
    assert res["steps_z1"] == res["steps_z0"]
    dims, whole_leaves = res["dims_z1"], WHOLE[ZERO_CASE]
    assert res["dims_z0"] is None
    assert all(dims[n] is not None for n in whole_leaves)
    assert dims["blocks.0.mixer.wq"] is not None
    for r in range(4):
        a = _load(runs[4] / f"s_z1_{r}.npz")
        b = _load(runs[4] / f"s_z0_{r}.npz")
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        held = _load(runs[4] / f"held_z1_{r}.npz")
        full = _load(runs[4] / f"held_z0_{r}.npz")
        data = r // 2
        for n, d in dims.items():
            w = full[n]
            if d is not None:
                k = w.shape[d] // 2
                w = np.take(w, range(data * k, (data + 1) * k), axis=d)
            np.testing.assert_array_equal(held[n], w, err_msg=n)


@pytest.mark.parametrize("rank,reads", [
    (0, (0, 1, None)), (1, (0, 2, (0, 1, 1))), (2, (1, 3, (0, 0, 1))),
    (3, (2, 3, None))])
def test_torch_tp_fallback_kv_heads_a_rank_reads(rank, reads):
    """12 query heads over 3 KV heads at ``model 4``: a rank's 3 query
    heads read KV heads unevenly where they straddle two groups (gathered
    one a query head), and one group's head elsewhere; at 12 over 2 and
    ``model 3`` (Qwen2-VL-2B) rank 1's 4 heads read 2 KV heads evenly (K4's
    uniform group of 2), the others one head."""
    from repro_torch import configs
    from repro_torch.launch import sharding as shd
    from repro_torch.models import attention as attn
    cfg = _cfg("straddle")
    assert attn.kv_read(cfg, shd.ModelAxis(4, rank, None)) == reads
    assert attn.local_heads(cfg, shd.ModelAxis(4, rank, None)) == \
        (3, 3, None)
    vl = configs.get_model_config("qwen2-vl-2b")
    if rank < 3:
        assert attn.kv_read(vl, shd.ModelAxis(3, rank, None)) == \
            ((0, 1, None), (0, 2, None), (1, 2, None))[rank]


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_oracle(sys.argv[2], int(sys.argv[3]))
    elif sys.argv[1] == "dry":
        _dry(int(sys.argv[2]), sys.argv[3])
    else:
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                sys.argv[5], sys.argv[6])
