"""Context-parallel decode: the ``seq`` axis rule bound to ``data`` (the
``long_500k`` cells) and to ``model`` (the ``seqkv`` variant), over a
world of 2 ``gloo`` CPU ranks, on smoke configurations in float32.

As ``tests/test_torch_tp_mixers.py``: this file run as a script, one
process a rank, at a ``file://`` rendezvous, the ranks meeting once; the
JAX reference in one subprocess over 2 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=2``), of
``AxisType.Auto`` axes, which writes its initial parameters first. Both
run the prefill under the default rules, then put the cache onto its
spec under the override (the port: ``Model.cut_cache``; the reference:
``device_put`` by ``Model.cache_spec``) and decode greedily at batch 1.

Held, against the reference's decode under the same rules (1e-5 of the
largest logit, every token equal) and against one process with no mesh
(the same): ``mixtral-8x7b`` (an 80-token prompt in a 64-slot window, so
the ring has wrapped and the new tokens land in rank 0's half) and
``jamba-v0.1-52b`` on ``(data 2, model 1)`` under ``seq -> data``;
``minicpm3-4b`` (MLA: 2 of 4 heads and half the latent slots a rank) and
``qwen2-7b`` with one KV head (2 query heads a rank, the KV whole, ``q``
gathered over ``model``) on ``(1, 2)`` under ``seq -> model``, the
latter also with a 20-token prompt, so that rank 1's block stays masked
throughout. The merge's collectives a step, exact; each step's slot
written on its owner only; the whole cache gathered back from the
blocks. On one process: the partials of a fully masked block weigh
exactly 0 in the merge. A capacity the axis does not divide stays whole
on both ranks, the fallback recorded, its decode bit-identical to the
decode without the rule; Qwen2-7B's two KV heads at ``(1, 2)`` under
``seq -> model`` raise ``ValueError`` where the reference raises
``DuplicateSpecError``; a prefill, a train step and their ``lower_*``
builders under ``seq -> data`` run, context parallel (their sequence cut
into a block a rank: ``tests/test_torch_cp_prefill.py`` holds their
numbers), and under ``seq -> model`` raise ``ValueError``, where the
reference's logits constraint maps ``model`` twice; RWKV-6's decode under
``seq -> data`` bit-identical to its decode without the rule.
"""
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED, NEW = 0, 4
# name: (arch, mesh (data, model), rules, config changes, prompt tokens)
CASES = {
    "mixtral": ("mixtral-8x7b", (2, 1), {"seq": "data"}, {}, 80),
    "jamba": ("jamba-v0.1-52b", (2, 1), {"seq": "data"}, {}, 80),
    "minicpm3": ("minicpm3-4b", (1, 2), {"seq": "model"}, {}, 80),
    "qwen2_kv1": ("qwen2-7b", (1, 2), {"seq": "model"},
                  {"num_kv_heads": 1}, 80),
    "qwen2_kv1_short": ("qwen2-7b", (1, 2), {"seq": "model"},
                        {"num_kv_heads": 1}, 20),
}
# a cache longer than the prompt and its new tokens: rank 1's block of
# 32 slots (of 64) stays masked in every step
SLOTS = {"qwen2_kv1_short": 64}
# the merge's all-reduces a decode step (a max and a sum per attention
# layer) beside the tensor-parallel ones; the q gathers over model
EXPECTED_DECODE = {
    "mixtral": {"all_reduce": 4},
    "jamba": {"all_reduce": 4},
    # embedding 1, wo and the MLP's 2 a layer, the merge's 2 a layer;
    # the q gather a layer and the logits' gather
    "minicpm3": {"all_reduce": 9, "all_gather": 3},
    "qwen2_kv1": {"all_reduce": 9, "all_gather": 3},
    "qwen2_kv1_short": {"all_reduce": 9, "all_gather": 3},
}


ATTN_LEAVES = ("k", "v", "c", "kr")


def _cfg(arch, kw):
    from repro_torch import configs
    return configs.get_model_config(arch, smoke=True).replace(
        dtype="float32", param_dtype="float32", **kw)


def _init_name(arch, kw):
    return arch + "".join(f"_{k}{v}" for k, v in sorted(kw.items()))


def _prompt(S):
    rng = np.random.default_rng(SEED)
    return rng.integers(0, 512, size=(1, S)).astype(np.int64)


def _tree(npz):
    tree = {}
    for path, a in np.load(npz).items():
        *parents, leaf = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree


def _model(arch, kw, jax_dir, mesh=None):
    from repro_torch.models import convert
    return convert.params_from_jax(
        _tree(os.path.join(jax_dir, f"init_{_init_name(arch, kw)}.npz")),
        _cfg(arch, kw), device="cpu", mesh=mesh)


def _leaves(cache):
    return {f"{i}/{part}/{n}": t for i, layer in enumerate(cache)
            for part, leaves in layer.items() for n, t in leaves.items()}


def _greedy(model, S, mesh=None, rules=None, log=None, slots=None):
    """The prefill's logits under the default rules, then ``NEW`` greedy
    decode steps (with ``mesh`` and ``rules``: the cache cut to the rank's
    blocks first, the rules bound around the steps); with ``log``, each
    step's collectives, the slots it changed on this rank and the cache
    gathered whole after the last."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as shd
    out = {}
    with torch.no_grad():
        logits, cache = model.prefill({"tokens": torch.from_numpy(
            _prompt(S))}, slots or S + NEW, backend="torch")
        out["prefill"] = logits
        ctx = shd.axis_rules(mesh, rules) if rules else None
        if ctx is not None:
            ctx.__enter__()
        try:
            if rules:
                whole = _leaves(cache)
                cache = model.cut_cache(cache)
                if log is not None:
                    log["cut_exact"] = all(
                        torch.equal(t, whole[k].narrow(
                            1, _start(t, whole[k]), t.shape[1]))
                        for k, t in _leaves(cache).items())
            tok = logits.argmax(-1)
            toks = [tok]
            for i in range(NEW):
                before = {k: t.clone() for k, t in _leaves(cache).items()}
                mesh_lib.reset_collective_counts()
                lg, cache = model.decode_step(tok, S + i, cache,
                                              backend="torch")
                if log is not None:
                    log.setdefault("collectives", []).append(
                        mesh_lib.collective_counts())
                    log.setdefault("changed", []).append(
                        _changed(before, _leaves(cache)))
                out[f"decode{i}"] = lg
                tok = lg.argmax(-1)
                toks.append(tok)
            if rules and log is not None:
                log["gathered"] = {
                    k: t.shape[1] for k, t in
                    _leaves(model.gather_cache(cache)).items()
                    if k.rsplit("/", 1)[1] in ATTN_LEAVES}
        finally:
            if ctx is not None:
                ctx.__exit__(None, None, None)
    out["tokens"] = torch.stack(toks, 1)
    return out


def _start(block, whole):
    """This rank's first slot: its block's index on the cut axis times
    the block's length (``0`` where the leaf is whole)."""
    from repro_torch.launch import sharding as shd
    if block.shape[1] == whole.shape[1]:
        return 0
    mesh = shd.active_mesh()
    axis = "data" if mesh.shape[0] > 1 else "model"
    return mesh.get_local_rank(axis) * block.shape[1]


def _changed(before, after):
    """Per attention leaf of the rank, the local slots a step changed."""
    out = {}
    for k, t in after.items():
        if k.rsplit("/", 1)[1] not in ATTN_LEAVES:
            continue
        diff = (t != before[k]).reshape(t.shape[0], t.shape[1], -1)
        out[k] = torch.nonzero(diff.any(-1).any(0)).flatten().tolist()
    return out


def _save(path, tensors):
    np.savez(path, **{k: v.float().numpy() for k, v in tensors.items()})


# ---------------------------------------------------------------------------
# the ranks (this file run as a script)
# ---------------------------------------------------------------------------


def _refusals(mesh2x1, mesh1x2, jax_dir):
    """The rules' refusals and fallbacks on the ranks: a capacity the
    axis does not divide, the duplicate axis, the prefill and train
    steps and their lower_* builders under ``seq -> data`` (they run) and
    ``seq -> model`` (``ValueError``), RWKV-6 bit for bit."""
    from repro_torch.configs import OptimizerConfig, ShapeConfig
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import (lower_prefill_step,
                                          lower_train_step,
                                          make_prefill_step)
    from repro_torch.models.api import build_model
    res = {}
    rules = {"seq": "data"}
    # a capacity of 25 slots, which 2 does not divide: whole on both
    # ranks, the fallback recorded, the decode bit-identical
    model = _model("qwen2-7b", {}, jax_dir, mesh2x1)
    plain = _greedy(model, 21)
    with shd.axis_rules(mesh2x1, rules):
        cache = model.init_cache(1, 25)
        res["whole_slots"] = cache[0]["attn"]["k"].shape[1]
        res["fallbacks"] = [list(f) for f in shd.fallbacks()]
    ruled = _greedy(model, 21, mesh2x1, rules)
    res["whole_bit_identical"] = all(torch.equal(plain[k], ruled[k])
                                     for k in plain)
    # the prefill and the train step cut their sequence over data and
    # run; over model the logits' spec maps model twice
    dup = _model("qwen2-7b", {}, jax_dir, mesh1x2)
    for what, call in (
            ("prefill", lambda m, mesh: make_prefill_step(
                m, 20, backend="torch", mesh=mesh)(
                {"tokens": torch.zeros((1, 16), dtype=torch.long)})),
            ("loss", lambda m, mesh: m.loss(
                {"tokens": torch.zeros((1, 17), dtype=torch.long)},
                backend="torch"))):
        with shd.axis_rules(mesh2x1, rules):
            call(model, mesh2x1)
            res[what] = "ran"
        with shd.axis_rules(mesh1x2, {"seq": "model"}):
            try:
                call(dup, mesh1x2)
                res[what + "_model"] = ""
            except ValueError as e:
                res[what + "_model"] = str(e)
    # the batch and the sequence both cut on data
    with shd.axis_rules(mesh2x1, rules):
        try:
            model.init_cache(2, 24)
            res["batch_and_seq"] = ""
        except ValueError as e:
            res["batch_and_seq"] = str(e)
    for what, lower in (("lower_prefill", lambda m, mesh: lower_prefill_step(
            m, mesh, ShapeConfig("p", 16, 1, "prefill"))),
            ("lower_train", lambda m, mesh: lower_train_step(
                m, OptimizerConfig(), mesh,
                ShapeConfig("t", 16, 1, "train")))):
        for mesh, r, key in ((mesh2x1, rules, what),
                             (mesh1x2, {"seq": "model"}, what + "_model")):
            with shd.axis_rules(mesh, r):
                meta = build_model(_cfg("qwen2-7b", {}), device="meta",
                                   mesh=mesh)
                try:
                    lower(meta, mesh)
                    res[key] = "ran"
                except ValueError as e:
                    res[key] = str(e)
    # Qwen2-7B's 2 KV heads and the sequence both on model
    with torch.no_grad():
        _, cache = dup.prefill({"tokens": torch.from_numpy(_prompt(20))},
                               24, backend="torch")
        with shd.axis_rules(mesh1x2, {"seq": "model"}):
            try:
                dup.cut_cache(cache)
                res["seqkv_duplicate"] = ""
            except ValueError as e:
                res["seqkv_duplicate"] = str(e)
    # RWKV-6 has no sequence in its cache: bit for bit
    from repro_torch.models.api import build_model as build
    rwkv = build(_cfg("rwkv6-3b", {}), device="cpu", mesh=mesh2x1)
    rwkv.init(SEED)
    a, b = _greedy(rwkv, 24), _greedy(rwkv, 24, mesh2x1, rules)
    res["rwkv_bit_identical"] = all(torch.equal(a[k], b[k]) for k in a)
    return res


def _worker(rank, rdv, out, jax_dir):
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=2, rank=rank)
    try:
        meshes = {shape: mesh_lib.make_mesh(
            mesh_lib.MeshConfig(shape, ("data", "model")),
            device_type="cpu") for shape in ((2, 1), (1, 2))}
        deadline = time.monotonic() + 300
        while not pathlib.Path(jax_dir, "init.done").exists():
            assert time.monotonic() < deadline, "no initial parameters"
            time.sleep(0.2)
        res = {}
        for name, (arch, shape, rules, kw, S) in CASES.items():
            mesh = meshes[shape]
            log = {}
            got = _greedy(_model(arch, kw, jax_dir, mesh), S, mesh, rules,
                          log, SLOTS.get(name))
            _save(os.path.join(out, f"{name}_{rank}.npz"), got)
            res[name] = log
            if rank == 0:
                _save(os.path.join(out, f"{name}_one.npz"),
                      _greedy(_model(arch, kw, jax_dir), S,
                              slots=SLOTS.get(name)))
        res["refusals"] = _refusals(meshes[(2, 1)], meshes[(1, 2)], jax_dir)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _jax_oracle(out):
    """The reference's initial parameters (then ``init.done``), then each
    case: the prefill under the default rules, the cache put onto its
    spec under the case's rules, the greedy decode steps jitted under
    them; and the duplicate spec's error."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.launch import sharding as jshd
    from repro.launch.steps import (make_decode_step, make_prefill_step,
                                    param_shardings)
    from repro.models import transformer as jtfm
    from repro.models.api import build_model as jbuild
    from jax.sharding import NamedSharding, PartitionSpec as P
    assert len(jax.devices()) == 2
    models = {}
    for arch, _, _, kw, _ in list(CASES.values()) + [
            ("qwen2-7b", None, None, {}, None)]:
        name = _init_name(arch, kw)
        if name in models:
            continue
        jcfg = jconfigs.get_model_config(arch, smoke=True).replace(
            dtype="float32", param_dtype="float32", **kw)
        jm = jbuild(jcfg)
        params = jm.init(jax.random.PRNGKey(SEED))
        np.savez(os.path.join(out, f"init_{name}.npz"), **{
            p.strip("/"): np.asarray(v) for p, v in jtfm._iter_paths(params)})
        models[name] = (jm, params)
    pathlib.Path(out, "init.done").touch()

    def on(mesh, shape, rules, jm, params, S, slots=None):
        with jshd.axis_rules(mesh):
            p = jax.device_put(params, param_shardings(mesh, jm, params))
            logits, cache = jax.jit(make_prefill_step(
                jm, max_len=slots or S + NEW))(
                p, {"tokens": jnp.asarray(_prompt(S), jnp.int32)})
        res = {"prefill": np.asarray(logits)}
        with jshd.axis_rules(mesh, rules):
            spec = jm.cache_spec(cache)
            cache = jax.device_put(cache, jax.tree.map(
                lambda s: NamedSharding(mesh, s), spec,
                is_leaf=lambda x: isinstance(x, P)))
            decode = jax.jit(make_decode_step(jm))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            toks = [np.asarray(tok)]
            for i in range(NEW):
                lg, cache = decode(p, tok, jnp.asarray(S + i, jnp.int32),
                                   jnp.full((1,), S + i + 1, jnp.int32),
                                   cache)
                res[f"decode{i}"] = np.asarray(lg)
                tok = jnp.argmax(lg, -1).astype(jnp.int32)
                toks.append(np.asarray(tok))
        res["tokens"] = np.stack(toks, 1)
        return res

    for name, (arch, shape, rules, kw, S) in CASES.items():
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        with mesh:
            res = on(mesh, shape, rules, *models[_init_name(arch, kw)], S,
                     SLOTS.get(name))
        np.savez(os.path.join(out, f"{name}.npz"), **res)
    mesh = jax.make_mesh((1, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    try:
        with mesh:
            on(mesh, (1, 2), {"seq": "model"}, *models["qwen2-7b"], 20)
        err = ""
    except Exception as e:  # noqa: BLE001 -- the error's type is the result
        err = type(e).__name__
    pathlib.Path(out, "duplicate.txt").write_text(err)


def _env(**extra):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's oracle and the two ranks, side by side (the ranks
    start once the reference has written its initial parameters)."""
    tmp = tmp_path_factory.mktemp("context_parallel")
    jax_out, out = tmp / "jax", tmp / "ranks"
    jax_out.mkdir()
    out.mkdir()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "jax", str(jax_out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(ROOT), env=_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=2"))]
    procs += [subprocess.Popen(
        [sys.executable, __file__, "worker", str(r), str(tmp / "rdv"),
         str(out), str(jax_out)],
        env=_env(), cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return {"jax": jax_out, "ranks": out,
            "res": [json.loads((out / f"rank{r}.json").read_text())
                    for r in range(2)]}


def _load(path):
    return {k: v for k, v in np.load(path).items()}


def _hold(got, want, what, tol=1e-5):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k in want:
        if k == "tokens":
            np.testing.assert_array_equal(got[k], want[k], err_msg=what)
            continue
        g, w = got[k].astype(np.float64), want[k].astype(np.float64)
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= tol, (what, k, err)


@pytest.mark.parametrize("case", CASES)
def test_torch_cp_decode_matches_the_reference_under_the_rule(runs, case):
    want = _load(runs["jax"] / f"{case}.npz")
    for r in range(2):
        _hold(_load(runs["ranks"] / f"{case}_{r}.npz"), want,
              f"{case} rank {r}")


@pytest.mark.parametrize("case", CASES)
def test_torch_cp_decode_matches_one_process(runs, case):
    want = _load(runs["ranks"] / f"{case}_one.npz")
    for r in range(2):
        _hold(_load(runs["ranks"] / f"{case}_{r}.npz"), want,
              f"{case} rank {r}")


@pytest.mark.parametrize("case", CASES)
def test_torch_cp_collectives_writes_and_blocks(runs, case):
    """The merge's collectives each step, exact; each step's slot written
    on its owner only (the other rank's blocks unchanged, bit for bit);
    the blocks cut from the whole cache exactly, and gathered back to
    the whole capacity."""
    arch, shape, _, kw, S = CASES[case]
    cfg = _cfg(arch, kw)
    C = SLOTS.get(case, S + NEW)
    C = min(cfg.sliding_window or C, C)
    L = C // 2
    for r, res in enumerate(runs["res"]):
        log = res[case]
        assert log["collectives"] == [EXPECTED_DECODE[case]] * NEW, r
        assert log["cut_exact"], r
        assert set(log["gathered"].values()) == {C}
        for i, changed in enumerate(log["changed"]):
            slot = (S + i) % C
            mine = [slot - r * L] if r * L <= slot < (r + 1) * L else []
            assert changed and all(v == mine for v in changed.values()), \
                (r, i, changed)


def test_torch_cp_a_rank_whose_block_stays_masked_is_not_written(runs):
    """The 20-token prompt's new tokens all land on rank 0 (slots 20-23
    of its 0-31): rank 1's block is masked in every step and changes in
    none, and the logits still hold (the tests above)."""
    log = runs["res"][1]["qwen2_kv1_short"]
    assert all(v == [] for step in log["changed"] for v in step.values())
    assert all(v == [i + 20] for i, step in enumerate(
        runs["res"][0]["qwen2_kv1_short"]["changed"]) for v in step.values())


def test_torch_cp_capacity_the_axis_does_not_divide_stays_whole(runs):
    for res in runs["res"]:
        ref = res["refusals"]
        assert ref["whole_slots"] == 25
        assert ["seq", 25, 1] in ref["fallbacks"]
        assert ref["whole_bit_identical"]


def test_torch_cp_a_mesh_axis_mapped_twice_raises_as_the_reference(runs):
    assert (runs["jax"] / "duplicate.txt").read_text() == \
        "DuplicateSpecError"
    for res in runs["res"]:
        ref = res["refusals"]
        assert "'model'" in ref["seqkv_duplicate"], ref
        assert "'data'" in ref["batch_and_seq"], ref


@pytest.mark.parametrize("what", ["prefill", "loss", "lower_prefill",
                                  "lower_train"])
def test_torch_cp_prefill_and_train_under_the_rule_are_refused(runs, what):
    """Under ``seq -> data`` at batch 1 they run, context parallel; under
    ``seq -> model`` they raise the ``ValueError`` of ``model`` mapped
    twice (the sequence and the vocabulary), where the reference raises
    ``DuplicateSpecError``; nothing names the old item 14.4."""
    for res in runs["res"]:
        ref = res["refusals"]
        assert ref[what] == "ran", ref[what]
        assert "'model'" in ref[what + "_model"], ref[what + "_model"]
        assert "14.4" not in ref[what] + ref[what + "_model"]


def test_torch_cp_rwkv6_decode_is_bit_identical_under_the_rule(runs):
    assert all(res["refusals"]["rwkv_bit_identical"] for res in runs["res"])


# ---------------------------------------------------------------------------
# the partials and their merge, in one process
# ---------------------------------------------------------------------------


class _FakeGroup:
    """An in-place all-reduce between threads, one a rank."""

    def __init__(self, n):
        self.n, self.parts = n, [None] * n
        self.barrier = threading.Barrier(n)

    def reduce(self, rank):
        def fn(t, op):
            self.parts[rank] = t.clone()
            self.barrier.wait()
            stack = torch.stack(self.parts)
            t.copy_(stack.amax(0) if op == "max" else stack.sum(0))
            self.barrier.wait()
            return t
        return fn


def _merged(q, k, v, kv_len, n):
    from repro_torch.kernels import chunked
    L = k.shape[1] // n
    group, outs = _FakeGroup(n), [None] * n
    parts = [chunked.decode_partial(q, k[:, r * L:(r + 1) * L],
                                    v[:, r * L:(r + 1) * L], kv_len=kv_len,
                                    offset=r * L) for r in range(n)]

    def rank(r):
        outs[r] = chunked.decode_merge(*parts[r], group.reduce(r))
    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return parts, outs


@pytest.mark.parametrize("kv_len", [1, 13, 31, 32, 64])
def test_torch_cp_merge_matches_the_whole_softmax(kv_len):
    """Each rank's partial merged over 4 ranks against
    ``chunked.decode_attention`` over the whole cache (1e-6 of the
    largest output), every rank with the same result; a block whose every
    slot is masked weighs exactly 0."""
    from repro_torch.kernels import chunked
    gen = torch.Generator().manual_seed(SEED)
    q = torch.randn(2, 1, 4, 16, generator=gen)
    k = torch.randn(2, 64, 2, 16, generator=gen)
    v = torch.randn(2, 64, 2, 16, generator=gen)
    lens = torch.tensor([kv_len, min(64, kv_len + 7)], dtype=torch.int32)
    want = chunked.decode_attention(q, k, v, kv_len=lens)
    parts, outs = _merged(q, k, v, lens, 4)
    for out in outs:
        torch.testing.assert_close(out, outs[0], rtol=0, atol=0)
        err = (out - want).abs().max() / want.abs().max()
        assert err <= 1e-6, err
    M = torch.stack([m for _, m, _ in parts]).amax(0)
    for r, (o, m, l) in enumerate(parts):
        masked = (r * 16 >= lens).tolist()
        for b, dead in enumerate(masked):
            if dead:
                assert bool((m[b] == -1e30).all())
                assert bool((torch.exp(m[b] - M[b]) == 0).all())


def test_torch_cp_a_fully_masked_block_contributes_nothing():
    """Two blocks, the second masked whole: the merge is the first
    block's own softmax, bit for bit."""
    from repro_torch.kernels import chunked
    gen = torch.Generator().manual_seed(SEED + 1)
    q = torch.randn(1, 1, 2, 8, generator=gen)
    k = torch.randn(1, 32, 1, 8, generator=gen)
    v = torch.randn(1, 32, 1, 8, generator=gen)
    lens = torch.tensor([9], dtype=torch.int32)
    parts, outs = _merged(q, k, v, lens, 2)
    o, m, l = parts[0]
    torch.testing.assert_close(outs[1], o / l.permute(0, 2, 1, 3),
                               rtol=0, atol=0)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_oracle(sys.argv[2])
    else:
        _worker(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
