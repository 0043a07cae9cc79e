"""Data-parallel training over a mesh of ``gloo`` CPU ranks, ZeRO-1, the
elastic restore, and the compressed cross-pod step, on the smoke
``qwen2-7b`` in float32.

The ranks are separate processes (this file run as a script, one process
a rank, meeting at a ``file://`` rendezvous): a world of 2 over a
``(data 2, model 1)`` mesh and a world of 4 over ``(pod 2, data 2,
model 1)``. The JAX reference runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (set before it
imports jax, never in the pytest process).

Held, at world size 2: ``make_train_step(mesh=)`` against one process on
the same global batch (losses and parameters within 1e-5 / 1e-4); ZeRO-1
on and off giving the same bits (losses, parameters, the moments gathered
from their slices), each rank's moments a slice of the whole and every
rank's parameters the same; microbatches 2 against 1 (1e-5 / 1e-4) and
the ZeRO-1 accumulator's slice giving the same bits as the whole one;
``train(mesh=, ckpt_dir=, ckpt_every=)`` saving whole leaves from rank 0
that restore bit-equal at world size 1 (no mesh) and, cut to a rank's
slice, at world size 4; RWKV-6 on a ``model`` axis of 2 taking a step
(its loss one process's). At world size 4:
the compressed step (int8 ring over ``pod``) against the reference's
``make_compressed_train_step``, run on a mesh whose axes are
``AxisType.Auto`` (on the default ``Explicit`` axes its sharding
constraints fail under this jax, as ``train()``'s do): the first step's
metrics equal and each rank's parameters within a tenth of the learning
rate, four steps' metrics and parameters at the tolerances
:func:`test_torch_compressed_step_matches_the_reference` gives with their
cause, the loss falling, and the pods' parameters diverging (non-zero,
printed).
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen2-7b"
B, S, STEPS, SEED = 8, 16, 3, 0
OPT = dict(warmup_steps=1, total_steps=4)
CKPT_STEP = 2


def _cfg():
    from repro_torch import configs
    return configs.get_model_config(ARCH, smoke=True).replace(
        dtype="float32", param_dtype="float32")


def _rwkv_cfg():
    from repro_torch import configs
    return configs.get_model_config("rwkv6-3b", smoke=True).replace(
        dtype="float32", param_dtype="float32")


def _model(params_npz=None):
    """The smoke model in float32: seeded, or the reference's initial
    parameters (a flat ``.npz`` by tree path)."""
    from repro_torch.models import convert
    from repro_torch.models.api import build_model
    if params_npz is None:
        m = build_model(_cfg(), device="cpu")
        m.init(SEED)
    else:
        tree = {}
        for path, a in np.load(params_npz).items():
            *parents, leaf = path.split("/")
            node = tree
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = a
        m = convert.params_from_jax(tree, _cfg(), device="cpu")
    m.requires_grad_(True)
    return m


def _batches():
    from repro_torch.data import SyntheticLM
    src = SyntheticLM(vocab_size=_cfg().vocab_size, seq_len=S,
                      global_batch=B, seed=SEED)
    return [{"tokens": torch.from_numpy(src.batch(s)["tokens"])}
            for s in range(STEPS + 1)]


def run_steps(mesh=None, zero1=True, microbatches=1, params_npz=None,
              steps=STEPS):
    """``steps`` steps of the train step; returns (metrics per step, the
    parameters, the moments made whole, the moments as held, the state
    after ``CKPT_STEP`` steps)."""
    from repro_torch.configs import OptimizerConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import init_opt_state
    model = _model(params_npz)
    ocfg = OptimizerConfig(zero1=zero1, **OPT)
    params = dict(model.params.named_parameters())
    step = make_train_step(model, ocfg, microbatches=microbatches,
                           backend="torch", mesh=mesh)
    state = init_opt_state(ocfg, params, step.zero)
    out, at_ckpt = [], None
    whole = (lambda n, t: t) if step.zero is None else step.zero.gather
    for s, batch in enumerate(_batches()[:steps]):
        state, met = step(state, batch)
        out.append({k: float(v) for k, v in met.items()})
        if s + 1 == CKPT_STEP:
            at_ckpt = _snapshot(params, state, whole)
    return out, _snapshot(params, state, whole), \
        {k: v.clone() for k, v in state.mu.items()}, at_ckpt


def _snapshot(params, state, whole):
    snap = {f"p/{n}": p.detach().clone() for n, p in params.items()}
    for which, tree in (("mu", state.mu), ("nu", state.nu)):
        snap.update({f"{which}/{n}": whole(n, t).clone()
                     for n, t in tree.items()})
    snap["step"] = state.step.clone()
    return snap


def _save(path, tensors):
    np.savez(path, **{k: v.numpy() for k, v in tensors.items()})


# ---------------------------------------------------------------------------
# the workers (this file run as a script)
# ---------------------------------------------------------------------------


def _world2(rank, rdv, out):
    import torch.distributed as dist
    from repro_torch.configs import OptimizerConfig
    from repro_torch.models.api import build_model
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train
    from repro_torch.optim import init_opt_state
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=2, rank=rank)
    try:
        mesh = mesh_lib.make_local_mesh(device_type="cpu")
        res = {}
        for zero1 in (True, False):
            for mb in (1, 2):
                met, snap, held, ck = run_steps(mesh, zero1, mb)
                tag = f"z{int(zero1)}_mb{mb}"
                res[tag] = met
                _save(os.path.join(out, f"{tag}_rank{rank}.npz"), snap)
                _save(os.path.join(out, f"{tag}_held{rank}.npz"), held)
                if tag == "z1_mb1":
                    _save(os.path.join(out, f"ckpt_rank{rank}.npz"), ck)
        res["collectives_per_step"] = _collectives_per_step(mesh)
        model = _model()
        r = train(arch=ARCH, model=model, steps=CKPT_STEP, seq_len=S,
                  global_batch=B, seed=SEED, log_every=0, device="cpu",
                  backend="torch", opt_cfg=OptimizerConfig(**OPT),
                  mesh=mesh, ckpt_dir=os.path.join(out, "ckpt"),
                  ckpt_every=CKPT_STEP)
        res["train_losses"] = r.losses
        tp = mesh_lib.make_local_mesh(model_parallel=2, device_type="cpu")
        # RWKV-6 on a model axis of 2: built on it, one step taken
        rwkv = build_model(_rwkv_cfg(), device="cpu", mesh=tp)
        rwkv.init(SEED)
        rwkv.requires_grad_(True)
        try:
            ocfg = OptimizerConfig(**OPT)
            step = make_train_step(rwkv, ocfg, backend="torch", mesh=tp)
            _, m = step(init_opt_state(ocfg, dict(
                rwkv.params.named_parameters()), step.zero), _batches()[0])
            res["tp_refused"] = ""
            res["tp_loss"] = float(m["loss"])
        except NotImplementedError as e:
            res["tp_refused"] = str(e)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _collectives_per_step(mesh):
    """The collectives one ZeRO-1 step issues, by kind."""
    from repro_torch.configs import OptimizerConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import init_opt_state
    model = _model()
    ocfg = OptimizerConfig(**OPT)
    step = make_train_step(model, ocfg, backend="torch", mesh=mesh)
    state = init_opt_state(ocfg, dict(model.params.named_parameters()),
                           step.zero)
    mesh_lib.reset_collective_counts()
    step(state, _batches()[0])
    return mesh_lib.collective_counts()


def _world4(rank, rdv, out, params_npz, ckpt_dir):
    import torch.distributed as dist
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import OptimizerConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.compressed import make_compressed_train_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import _zero_placement
    from repro_torch.models import convert
    from repro_torch.optim import init_opt_state
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=4, rank=rank)
    try:
        mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(
            (2, 2, 1), ("pod", "data", "model")), device_type="cpu")
        assert mesh_lib.coordinate(mesh, ("pod", "data")) == rank
        model = _model(params_npz)
        ocfg = OptimizerConfig(**OPT)
        params = dict(model.params.named_parameters())
        step = make_compressed_train_step(model, ocfg, mesh,
                                          backend="torch")
        state = init_opt_state(ocfg, params)
        met = []
        for s, batch in enumerate(_batches()[:STEPS + 1]):
            state, m = step(state, batch)
            met.append({k: float(v) for k, v in m.items()})
            if rank == 0:
                print(f"pod divergence {met[-1]['pod_divergence']:.3e}",
                      flush=True)
            if s in (0, STEPS):
                _save(os.path.join(out, f"compressed{s}_rank{rank}.npz"),
                      {n: p.detach() for n, p in params.items()})
        # the world-2 checkpoint, restored under ZeRO-1 at world size 4
        model = _model()
        params = dict(model.params.named_parameters())
        zstep = make_train_step(model, ocfg, backend="torch", mesh=mesh)
        zstate = init_opt_state(ocfg, params, zstep.zero)
        CheckpointManager(ckpt_dir).restore(
            CKPT_STEP, convert.train_state_tree(params, zstate, _cfg()),
            placement_fn=_zero_placement(params, zstep.zero, _cfg()))
        _save(os.path.join(out, f"restored_rank{rank}.npz"),
              {**{f"mu/{n}": t for n, t in zstate.mu.items()},
               **{f"p/{n}": p.detach() for n, p in params.items()}})
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump({"compressed": met, "dims": zstep.zero.dims}, f)
    finally:
        dist.destroy_process_group()


def _jax_oracle(out):
    """The reference's initial parameters and its compressed step on a
    (pod 2, data 2, model 1) mesh of Auto axes: the metrics per step and
    each device's parameters."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.data import SyntheticLM as JSyntheticLM
    from repro.launch.compressed import make_compressed_train_step
    from repro.models import transformer as jtfm
    from repro.models.api import build_model as jbuild
    from repro.optim import init_opt_state
    assert len(jax.devices()) == 4
    jcfg = jconfigs.get_model_config(ARCH, smoke=True).replace(
        dtype="float32", param_dtype="float32")
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(SEED))
    np.savez(os.path.join(out, "init.npz"), **{
        p.strip("/"): np.asarray(v) for p, v in jtfm._iter_paths(params)})
    auto = (jax.sharding.AxisType.Auto,) * 3
    mesh = jax.make_mesh((2, 2, 1), ("pod", "data", "model"),
                         axis_types=auto)
    ocfg = jconfigs.OptimizerConfig(zero1=False, **OPT)
    state = init_opt_state(ocfg, params)
    step = jax.jit(make_compressed_train_step(jm, ocfg, mesh))
    src = JSyntheticLM(vocab_size=jcfg.vocab_size, seq_len=S,
                       global_batch=B, seed=SEED)
    met = []
    flat = np.asarray(mesh.devices).reshape(-1).tolist()
    with mesh:
        for s in range(STEPS + 1):
            batch = {k: jnp.asarray(v) for k, v in src.batch(s).items()}
            params, state, m = step(params, state, batch)
            met.append({k: float(v) for k, v in m.items()})
            if s not in (0, STEPS):
                continue
            per_rank = {}
            for path, leaf in jtfm._iter_paths(params):
                for shard in leaf.addressable_shards:
                    r = flat.index(shard.device)
                    per_rank[f"{r}{path}"] = np.asarray(shard.data)
            np.savez(os.path.join(out, f"compressed{s}.npz"), **per_rank)
    with open(os.path.join(out, "metrics.json"), "w") as f:
        json.dump(met, f)


def _env(**extra):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    env.update(extra)
    return env


def _launch(world, args, tmp):
    """This file as ``world`` rank processes with ``args``; their logs."""
    procs = [subprocess.Popen(
        [sys.executable, __file__, f"world{world}", str(r),
         str(tmp / f"rdv{world}")] + [str(a) for a in args],
        env=_env(), cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    jax_out = tmp / "jax"
    jax_out.mkdir()
    proc = subprocess.run(
        [sys.executable, __file__, "jax", str(jax_out)], capture_output=True,
        text=True, cwd=str(ROOT), timeout=600, env=_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    w2, w4 = tmp / "w2", tmp / "w4"
    w2.mkdir()
    w4.mkdir()
    _launch(2, [w2], tmp)
    logs = _launch(4, [w4, jax_out / "init.npz", w2 / "ckpt"], tmp)
    return {"tmp": tmp, "jax": jax_out, "w2": w2, "w4": w4, "logs4": logs}


def _load(path):
    return {k: torch.from_numpy(v) for k, v in np.load(path).items()}


def _json(path):
    return json.loads(pathlib.Path(path).read_text())


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4, err_msg=what)


def test_torch_dp_world2_matches_one_process_on_the_global_batch(runs):
    met, snap, _, _ = run_steps()
    res = _json(runs["w2"] / "rank0.json")
    for a, b in zip(res["z1_mb1"], met):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    got = _load(runs["w2"] / "z1_mb1_rank0.npz")
    for k, v in snap.items():
        if k.startswith("p/"):
            _close(got[k].numpy(), v.numpy(), k)
    # every rank holds the same parameters and metrics
    other = _load(runs["w2"] / "z1_mb1_rank1.npz")
    assert all(torch.equal(other[k], got[k]) for k in got)
    assert _json(runs["w2"] / "rank1.json")["z1_mb1"] == res["z1_mb1"]


@pytest.mark.parametrize("mb", [1, 2])
def test_torch_dp_zero1_on_and_off_give_the_same_bits(runs, mb):
    res = _json(runs["w2"] / "rank0.json")
    assert res[f"z1_mb{mb}"] == res[f"z0_mb{mb}"]
    on = _load(runs["w2"] / f"z1_mb{mb}_rank0.npz")
    off = _load(runs["w2"] / f"z0_mb{mb}_rank0.npz")
    assert set(on) == set(off)
    for k in on:
        assert torch.equal(on[k], off[k]), k
    # each rank keeps its slice of the moments; with ZeRO-1 off, all
    for r in (0, 1):
        held = _load(runs["w2"] / f"z1_mb{mb}_held{r}.npz")
        whole = _load(runs["w2"] / f"z0_mb{mb}_held{r}.npz")
        sliced = 0
        for n, t in held.items():
            w = whole[n]
            if t.shape != w.shape:
                d = next(i for i, (a, b) in enumerate(zip(t.shape, w.shape))
                         if a != b)
                assert w.shape[d] == 2 * t.shape[d]
                assert torch.equal(t, w.narrow(d, r * t.shape[d],
                                               t.shape[d]))
                sliced += 1
            else:
                assert torch.equal(t, w)
        assert sliced > 0


def test_torch_dp_microbatches_2_against_1(runs):
    res = _json(runs["w2"] / "rank0.json")
    for a, b in zip(res["z1_mb2"], res["z1_mb1"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    one = _load(runs["w2"] / "z1_mb1_rank0.npz")
    two = _load(runs["w2"] / "z1_mb2_rank0.npz")
    for k in one:
        if k.startswith("p/"):
            _close(two[k].numpy(), one[k].numpy(), k)
    # and one process with 2 microbatches, on the same global batch
    met, snap, _, _ = run_steps(microbatches=2)
    for k, v in snap.items():
        if k.startswith("p/"):
            _close(two[k].numpy(), v.numpy(), k)


def test_torch_dp_a_zero1_step_issues_its_collectives(runs):
    """A plain ZeRO-1 step at world size 2: an all-reduce a gradient leaf
    and 3 for the metrics (loss, lm_loss, and the aux loss when there is
    one: not here), an all-gather a sharded leaf."""
    res = _json(runs["w2"] / "rank0.json")
    counts = res["collectives_per_step"]
    model = _model()
    n_leaves = len(list(model.params.parameters()))
    held = _load(runs["w2"] / "z1_mb1_held0.npz")
    whole = _load(runs["w2"] / "z0_mb1_held0.npz")
    sharded = sum(held[n].shape != whole[n].shape for n in held)
    assert counts["all_gather"] == sharded
    metrics = len(res["z1_mb1"][0]) - 2          # less grad_norm and lr
    assert counts["all_reduce"] == n_leaves + metrics


def test_torch_dp_checkpoint_at_world2_restores_at_world1(runs):
    """``train(mesh=)`` under ZeRO-1 at world size 2 wrote whole leaves
    (rank 0); restored with no mesh they are the state the step reached
    at the save, bit for bit."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import OptimizerConfig
    from repro_torch.models import convert
    from repro_torch.optim import init_opt_state
    res = _json(runs["w2"] / "rank0.json")
    assert res["train_losses"] == [m["loss"] for m in
                                   res["z1_mb1"][:CKPT_STEP]]
    want = _load(runs["w2"] / "ckpt_rank0.npz")
    model = _model()
    params = dict(model.params.named_parameters())
    state = init_opt_state(OptimizerConfig(**OPT), params)
    _, meta = CheckpointManager(str(runs["w2"] / "ckpt")).restore(
        CKPT_STEP, convert.train_state_tree(params, state, _cfg()))
    assert meta == {"next_step": CKPT_STEP, "arch": ARCH}
    got = _snapshot(params, state, lambda n, t: t)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_torch_dp_checkpoint_at_world2_restores_at_world4(runs):
    """The same checkpoint restored under ZeRO-1 at world size 4: each
    rank's moments are its quarter of the whole leaf."""
    want = _load(runs["w2"] / "ckpt_rank0.npz")
    dims = _json(runs["w4"] / "rank0.json")["dims"]
    assert any(d is not None for d in dims.values())
    for r in range(4):
        got = _load(runs["w4"] / f"restored_rank{r}.npz")
        for n, d in dims.items():
            w = want[f"mu/{n}"]
            if d is not None:
                k = w.shape[d] // 4
                w = w.narrow(d, r * k, k)
            assert torch.equal(got[f"mu/{n}"], w), (r, n)
            assert torch.equal(got[f"p/{n}"], want[f"p/{n}"]), (r, n)


def test_torch_dp_a_model_axis_of_2_is_refused(runs):
    """RWKV-6 had no tensor-parallel path and was refused on a ``model``
    axis of 2; it has one now: built on the world-2 ``(1, 2)`` mesh it
    takes a step, whose loss is one process's within 1e-5."""
    from repro_torch.configs import OptimizerConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim import init_opt_state
    res = _json(runs["w2"] / "rank0.json")
    assert res["tp_refused"] == ""
    rwkv = build_model(_rwkv_cfg(), device="cpu")
    rwkv.init(SEED)
    rwkv.requires_grad_(True)
    ocfg = OptimizerConfig(**OPT)
    _, m = make_train_step(rwkv, ocfg, backend="torch")(init_opt_state(
        ocfg, dict(rwkv.params.named_parameters())), _batches()[0])
    np.testing.assert_allclose(res["tp_loss"], float(m["loss"]), rtol=1e-5)


def _reference_rank(npz, r):
    """Rank ``r``'s parameters from the reference's per-device ``.npz``,
    by the port's names."""
    from repro_torch.models import convert
    tree = {}
    for key in npz.files:
        if key.startswith(f"{r}/"):
            *parents, leaf = key[2:].split("/")
            node = tree
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = npz[key]
    return {n: w for n, _, w in convert._targets(tree, _cfg())}


def test_torch_compressed_step_matches_the_reference(runs):
    """The first step from the same parameters gives the same metrics.
    Adam's first step moves each element by the learning rate, with its
    gradient's sign: an element whose gradient is at rounding level in
    both packages may go either way (2 lr apart; one ``bq`` element of 128
    here), so the parameters are held elementwise within 2 lr, and all
    but 1 % of the tree's elements within a tenth of it (as
    ``test_torch_train.py`` holds a step). Later, the pods' parameters
    differ from the reference's in their last bits (the ring's FMA,
    ``test_torch_compress.py``), and a gradient value on the other side of
    a rounding tie moves by a whole int8 step of its block (its largest
    value / 127), which Adam turns into up to a learning rate either way
    for an element small in its block: after 4 steps every element is
    held within 2 lr a step, the loss (1e-5) and gradient norm (5e-5; 2e-5
    seen) a step as the streams that show it."""
    from repro_torch.configs import OptimizerConfig
    lr = OptimizerConfig().lr
    want_met = _json(runs["jax"] / "metrics.json")
    first = np.load(runs["jax"] / "compressed0.npz")
    last = np.load(runs["jax"] / f"compressed{STEPS}.npz")
    for r in range(4):
        met = _json(runs["w4"] / f"rank{r}.json")["compressed"]
        assert {k: met[0][k] for k in want_met[0]} == want_met[0]
        for a, b in zip(met, want_met):
            for k, tol in (("loss", 1e-5), ("grad_norm", 5e-5),
                           ("lr", 1e-7)):
                np.testing.assert_allclose(a[k], b[k], rtol=tol, err_msg=k)
        for s, npz in ((0, first), (STEPS, last)):
            got = _load(runs["w4"] / f"compressed{s}_rank{r}.npz")
            far, total = 0, 0
            for n, w in _reference_rank(npz, r).items():
                d = np.abs(got[n].numpy() - w)
                assert d.max() <= 2 * (s + 1) * lr * (1 + 1e-5), \
                    (s, r, n, d.max())
                far += int((d > 0.1 * lr).sum())
                total += d.size
            if s == 0:
                assert far <= 0.01 * total, (r, far, total)


def test_torch_compressed_step_trains_and_the_pods_diverge(runs):
    met = _json(runs["w4"] / "rank0.json")["compressed"]
    assert met[-1]["loss"] < met[0]["loss"]
    div = [m["pod_divergence"] for m in met]
    assert all(d > 0 for d in div), div
    assert all(_json(runs["w4"] / f"rank{r}.json")["compressed"] == met
               for r in range(4))
    assert "pod divergence" in runs["logs4"][0]
    # the data ranks of a pod agree, the pods do not
    p = [_load(runs["w4"] / f"compressed{STEPS}_rank{r}.npz")
         for r in range(4)]
    assert all(torch.equal(p[0][k], p[1][k]) and
               torch.equal(p[2][k], p[3][k]) for k in p[0])
    assert max(float((p[0][k] - p[2][k]).abs().max()) for k in p[0]) == \
        pytest.approx(div[-1])


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_oracle(sys.argv[2])
    elif sys.argv[1] == "world2":
        _world2(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        _world4(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5],
                sys.argv[6])
