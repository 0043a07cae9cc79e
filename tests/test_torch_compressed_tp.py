"""The compressed cross-pod step under tensor parallelism: the int8 ring
over ``pod`` on each ``model`` shard, at ``(pod 2, data 1, model 2)`` on
four ``gloo`` CPU ranks, for the smoke ``qwen2-7b`` and ``mixtral-8x7b``
in float32.

As ``tests/test_torch_train_dp.py``: this file run as a script, one
process a rank, at a ``file://`` rendezvous; the reference in a
subprocess over 4 host devices, its ``make_compressed_train_step``
jitted bare on a mesh of ``AxisType.Auto`` axes (on ``Explicit`` axes
its sharding constraints fail under this jax), from the same initial
parameters, each rank's model built on the mesh from them
(``convert.params_from_jax(mesh=)``). A third subprocess traces the same
cell on the meta device over a fake process group of 4 ranks
(``lower_compressed_train_step``).

Held: the first step's metrics (loss, lm_loss, aux_loss where there is
one, grad_norm, lr) against the reference's at
``test_torch_train_dp.py``'s tolerances (loss 1e-5, grad norm 5e-5, lr
1e-7), and each pod's parameters after it made
whole over ``model`` within 2 lr of the reference's pod, all but 1 % of
the elements within a tenth of it (that file's reasons: Adam's first step
moves an element by lr with its gradient's sign); the ring's wire bytes
those of each rank's shards, blocks laid on the shard (fewer than the
whole leaves'), and the reference's compiled HLO sending those of its
leaves' shards as ``collective-permute`` (its stacked leaves pad once,
the port's per-layer ones a layer at a time); the pods' divergence non-zero and
the same on every rank; the ranks' collective counts and operand bytes
of a step equal, exactly, to the fake-group trace's.
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("qwen2-7b", "mixtral-8x7b")
B, S, STEPS, SEED = 8, 16, 2, 0
OPT = dict(warmup_steps=1, total_steps=4)
SHAPE = (2, 1, 2)
AXES = ("pod", "data", "model")


def _cfg(arch):
    from repro_torch import configs
    return configs.get_model_config(arch, smoke=True).replace(
        dtype="float32", param_dtype="float32")


def _tree(npz):
    tree = {}
    for path, a in np.load(npz).items():
        *parents, leaf = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree


def _batches():
    from repro_torch.data import SyntheticLM
    src = SyntheticLM(vocab_size=_cfg(ARCHS[0]).vocab_size, seq_len=S,
                      global_batch=B, seed=SEED)
    return [{"tokens": torch.from_numpy(src.batch(s)["tokens"])}
            for s in range(STEPS)]


def _mesh():
    from repro_torch.launch import mesh as mesh_lib
    return mesh_lib.make_mesh(mesh_lib.MeshConfig(SHAPE, AXES),
                              device_type="cpu")


# ---------------------------------------------------------------------------
# the workers (this file run as a script)
# ---------------------------------------------------------------------------


def _worker(rank, rdv, out, jax_dir):
    import torch.distributed as dist
    from repro_torch.configs import OptimizerConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.compressed import make_compressed_train_step
    from repro_torch.models import convert
    from repro_torch.optim import compress, init_opt_state
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=4, rank=rank)
    try:
        mesh = _mesh()
        res = {}
        for arch in ARCHS:
            model = convert.params_from_jax(
                _tree(os.path.join(jax_dir, f"init_{arch}.npz")), _cfg(arch),
                device="cpu", mesh=mesh)
            model.requires_grad_(True)
            params = dict(model.params.named_parameters())
            ocfg = OptimizerConfig(**OPT)
            step = make_compressed_train_step(model, ocfg, mesh,
                                              backend="torch")
            state = init_opt_state(ocfg, params)
            met = []
            for s, batch in enumerate(_batches()):
                mesh_lib.reset_collective_counts()
                compress.reset_wire_bytes()
                state, m = step(state, batch)
                met.append({k: float(v) for k, v in m.items()})
                if s:
                    continue
                res[arch] = {"counts": mesh_lib.collective_counts(),
                             "bytes": mesh_lib.collective_bytes(),
                             "wire": compress.wire_bytes(),
                             "shard": {n: p.numel()
                                       for n, p in params.items()},
                             "whole": {n: math.prod(model.shapes[n])
                                       for n in params}}
                whole = {n: model.gather(n, p) for n, p in params.items()}
                np.savez(os.path.join(out, f"{arch}_step0_rank{rank}.npz"),
                         **{n: t.numpy() for n, t in whole.items()})
            res[arch]["metrics"] = met
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _traced(out):
    """The same cell traced on the meta device over a fake group of 4."""
    from repro_torch.configs import OptimizerConfig, ShapeConfig
    from repro_torch.launch.compressed import lower_compressed_train_step
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.models.api import build_model
    fake_group(4)
    mesh = _mesh()
    res = {}
    for arch in ARCHS:
        tr = lower_compressed_train_step(
            build_model(_cfg(arch), device="meta", mesh=mesh),
            OptimizerConfig(**OPT), mesh, ShapeConfig("t", S, B, "train"),
            divergence=True)
        res[arch] = {"counts": tr.collectives["counts"],
                     "bytes": tr.collectives["bytes_by_op"]}
    pathlib.Path(out).write_text(json.dumps(res))


def _jax_oracle(out):
    """The reference's initial parameters, its compressed step's metrics
    and each pod's parameters after the first step (made whole from its
    devices' shards), and the collective-permute bytes of its compiled
    step."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from jax.sharding import PartitionSpec as P
    from repro.launch import sharding as jshd
    from repro.launch.compressed import make_compressed_train_step
    from repro.launch.roofline import parse_collective_bytes
    from repro.models import transformer as jtfm
    from repro.models.api import build_model as jbuild
    from repro.optim import init_opt_state
    assert len(jax.devices()) == 4
    batches = [{"tokens": jnp.asarray(b["tokens"].numpy(), jnp.int32)}
               for b in _batches()]
    mesh = jax.make_mesh(SHAPE, AXES,
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    flat = np.asarray(mesh.devices).reshape(-1).tolist()
    res = {}
    for arch in ARCHS:
        jcfg = jconfigs.get_model_config(arch, smoke=True).replace(
            dtype="float32", param_dtype="float32")
        jm = jbuild(jcfg)
        params = jm.init(jax.random.PRNGKey(SEED))
        np.savez(os.path.join(out, f"init_{arch}.npz"), **{
            p.strip("/"): np.asarray(v) for p, v in jtfm._iter_paths(params)})
        ocfg = jconfigs.OptimizerConfig(zero1=False, **OPT)
        state = init_opt_state(ocfg, params)
        met = []
        with mesh:
            # compiled once: its HLO text is read, and it runs the steps
            step = jax.jit(make_compressed_train_step(jm, ocfg, mesh)).lower(
                params, state, batches[0]).compile()
            hlo = step.as_text()
            for s, batch in enumerate(batches):
                params, state, m = step(params, state, batch)
                met.append({k: float(v) for k, v in m.items()})
                if s:
                    continue
                pods = {}
                for path, leaf in jtfm._iter_paths(params):
                    for pod in range(SHAPE[0]):
                        full = np.zeros(leaf.shape, np.float32)
                        for shard in leaf.addressable_shards:
                            if flat.index(shard.device) // SHAPE[2] == pod:
                                full[shard.index] = np.asarray(shard.data)
                        pods[f"{pod}{path}"] = full
                np.savez(os.path.join(out, f"{arch}_step0.npz"), **pods)
        with mesh, jshd.axis_rules(mesh):
            pspec = jm.param_spec(params)
        sizes = dict(zip(AXES, SHAPE))
        shard = []
        for leaf, spec in zip(jax.tree.leaves(params), jax.tree.leaves(
                pspec, is_leaf=lambda x: isinstance(x, P))):
            n = leaf.size
            for e in spec:
                for a in ((e,) if isinstance(e, str) else (e or ())):
                    n //= sizes[a]
            shard.append(n)
        res[arch] = {"metrics": met, "shard": shard,
                     "whole": [leaf.size for leaf in jax.tree.leaves(params)],
                     "permute": parse_collective_bytes(hlo)["bytes_by_op"][
                         "collective-permute"]}
    with open(os.path.join(out, "reference.json"), "w") as f:
        json.dump(res, f)


def _env(**extra):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    env.update(extra)
    return env


def _run(procs):
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]


def _spawn(args, **env):
    return subprocess.Popen(
        [sys.executable, __file__] + [str(a) for a in args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(ROOT), env=_env(**env))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compressed_tp")
    jax_out, ranks = tmp / "jax", tmp / "ranks"
    jax_out.mkdir()
    ranks.mkdir()
    traced = _spawn(["traced", tmp / "traced.json"])
    _run([_spawn(["jax", jax_out],
                 XLA_FLAGS="--xla_force_host_platform_device_count=4")])
    _run([_spawn(["worker", r, tmp / "rdv", ranks, jax_out])
          for r in range(4)] + [traced])
    return {"jax": jax_out, "ranks": ranks,
            "traced": json.loads((tmp / "traced.json").read_text()),
            "ref": json.loads((jax_out / "reference.json").read_text()),
            "rank": [json.loads((ranks / f"rank{r}.json").read_text())
                     for r in range(4)]}


def _reference_pod(npz, pod, cfg):
    """Pod ``pod``'s whole parameters by the port's names."""
    from repro_torch.models import convert
    tree = {}
    for key in npz.files:
        if key.startswith(f"{pod}/"):
            *parents, leaf = key[2:].split("/")
            node = tree
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = npz[key]
    return {n: w for n, _, w in convert._targets(tree, cfg)}


@pytest.mark.parametrize("arch", ARCHS)
def test_torch_compressed_tp_first_step_matches_the_reference(runs, arch):
    want = runs["ref"][arch]["metrics"][0]
    for r in range(4):
        got = runs["rank"][r][arch]["metrics"][0]
        assert set(want) <= set(got)
        for k in want:
            tol = {"grad_norm": 5e-5, "lr": 1e-7}.get(k, 1e-5)
            np.testing.assert_allclose(got[k], want[k], rtol=tol,
                                       err_msg=(r, k))


@pytest.mark.parametrize("arch", ARCHS)
def test_torch_compressed_tp_pods_params_match_the_reference(runs, arch):
    from repro_torch.configs import OptimizerConfig
    lr = OptimizerConfig().lr
    npz = np.load(runs["jax"] / f"{arch}_step0.npz")
    for r in range(4):
        got = np.load(runs["ranks"] / f"{arch}_step0_rank{r}.npz")
        want = _reference_pod(npz, r // SHAPE[2], _cfg(arch))
        assert set(got.files) == set(want)
        far, total = 0, 0
        for n, w in want.items():
            d = np.abs(got[n] - w)
            assert d.max() <= 2 * lr * (1 + 1e-5), (r, n, d.max())
            far += int((d > 0.1 * lr).sum())
            total += d.size
        assert far <= 0.01 * total, (r, far, total)


@pytest.mark.parametrize("arch", ARCHS)
def test_torch_compressed_tp_ring_sends_each_rank_its_shard(runs, arch):
    from repro_torch.optim.compress import BLOCK

    def wire(numels):
        blocks = sum(-(-n // BLOCK) for n in numels)
        return (SHAPE[0] - 1) * (blocks * BLOCK + 4 * blocks)

    for r in range(4):
        res = runs["rank"][r][arch]
        assert res["wire"] == wire(res["shard"].values())
        assert res["wire"] < wire(res["whole"].values())
        assert res["bytes"]["collective-permute"] == res["wire"]
        assert any(res["shard"][n] < res["whole"][n] for n in res["shard"])
    # the reference's compiled step sends its (stacked) leaves' shards;
    # the port's per-layer leaves pad each layer to a block, so its count
    # is that many partial blocks larger
    ref = runs["ref"][arch]
    assert ref["permute"] == wire(ref["shard"]) < wire(ref["whole"])
    assert sum(ref["shard"]) == sum(res["shard"].values())
    assert 0 <= res["wire"] - ref["permute"] < \
        len(res["shard"]) * (BLOCK + 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_torch_compressed_tp_pods_diverge(runs, arch):
    div = [m["pod_divergence"] for m in runs["rank"][0][arch]["metrics"]]
    assert all(d > 0 for d in div), div
    for r in range(4):
        assert runs["rank"][r][arch]["metrics"] == \
            runs["rank"][0][arch]["metrics"]
    p = [np.load(runs["ranks"] / f"{arch}_step0_rank{r}.npz")
         for r in range(4)]
    worst = max(float(np.abs(p[0][n] - p[2][n]).max()) for n in p[0].files)
    assert worst == pytest.approx(div[0], rel=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_torch_compressed_tp_collectives_equal_the_traced_step(runs, arch):
    want = runs["traced"][arch]
    for r in range(4):
        got = runs["rank"][r][arch]
        assert got["counts"] == want["counts"], r
        assert got["bytes"] == want["bytes"], r
    assert want["counts"]["p2p"] == 4 * len(runs["rank"][0][arch]["shard"])


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_oracle(sys.argv[2])
    elif sys.argv[1] == "traced":
        _traced(sys.argv[2])
    else:
        _worker(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
