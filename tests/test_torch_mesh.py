"""The mesh, the logical sharding rules, the parameter and optimizer-state
specs and ``sample_locality``, held against the JAX package on the CPU.

Held: ``resolve_spec`` (through ``param_spec``), its ``fallbacks``,
``param_spec`` and ``opt_state_spec`` (ZeRO-1 on and off) against the
reference's for every leaf of all ten configurations' full shapes, at the
production meshes' sizes, ``AbstractMesh((16, 16))`` and
``AbstractMesh((2, 16, 16))``, and at ``(pod 2, data 2, model 1)``, on
the JAX side (no devices), a stand-in
with the same ordered axis sizes on the port's. The port's per-layer
leaves have no period axis: a stacked leaf's spec is the reference's
without its leading entry, and where the reference's ZeRO-1 rule shards
the period axis, the port's is the reference's rule applied to the
per-layer leaf (``opt_state_spec`` of a one-leaf tree). Also: the MoE
expert-stack rule, ``logical``'s rank check, ``named_sharding``'s
placements, ``batch_axes`` / ``dp_size`` / ``mesh_config_for``,
``make_local_mesh()`` refusing to run without a process group, a
``model`` axis larger than 1 taken for RWKV-6 and by the compressed
step on a model built on the mesh, ``sample_locality`` with and
without a group, a one-rank ``gloo`` mesh, and the collectives counted
and, when asked, timed.
"""
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.launch import mesh as jmesh
from repro.launch import sharding as jshd
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw

from repro_torch import configs as tconfigs
from repro_torch.core import sample_locality
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd
from repro_torch.models import convert
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw

MESHES = {"single pod": ((16, 16), ("data", "model")),
          "multi pod": ((2, 16, 16), ("pod", "data", "model")),
          # data parallel over 4 ranks, as the port's tests run it
          "pod 2 data 2": ((2, 2, 1), ("pod", "data", "model"))}


def stand_in(shape, axes):
    """Anything with an ordered ``shape`` mapping stands for a mesh."""
    return types.SimpleNamespace(shape=dict(zip(axes, shape)))


def _meta(cfg):
    with torch.device("meta"):
        p = tfm.init_params(cfg, torch.Generator(), device="meta")
    return dict(p.named_parameters())


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_torch_param_and_opt_state_specs_match_the_references(arch, mesh):
    shape, axes = MESHES[mesh]
    jcfg, cfg = (jconfigs.get_model_config(arch),
                 tconfigs.get_model_config(arch))
    shapes = jax.eval_shape(lambda: jtfm.init_params(
        jcfg, jax.random.PRNGKey(0)))
    params = _meta(cfg)
    amesh = jax.sharding.AbstractMesh(shape, axes)
    for zero1 in (True, False):
        jo = jconfigs.OptimizerConfig(zero1=zero1)
        to = tconfigs.OptimizerConfig(zero1=zero1)
        with jshd.axis_rules(amesh):
            jp = jtfm.param_spec(shapes)
            jfb = set(jshd.fallbacks())
            jos = jadamw.opt_state_spec(jo, shapes, jp)
            jp = dict(jtfm._iter_paths(jp))
            jos = dict(jtfm._iter_paths(jos.mu))

            def per_layer_rule(shape_, spec):
                leaf = jax.ShapeDtypeStruct(shape_, np.float32)
                return tuple(jadamw.opt_state_spec(
                    jo, {"x": leaf}, {"x": P(*spec)}).mu["x"])

            with shd.axis_rules(stand_in(shape, axes)):
                tp = tfm.param_spec(params, cfg)
                tfb = set(shd.fallbacks())
                tos = adamw.opt_state_spec(to, params, tp)
                seen, period = set(), 0
                for n, p in params.items():
                    path, stacked = convert.jax_path(n, cfg)
                    want_p = tuple(jp[path])
                    want_o = tuple(jos[path])
                    if stacked:
                        assert want_p[0] is None
                        want_p = want_p[1:]
                        period += want_o[0] is not None
                        want_o = want_o[1:] if want_o[0] is None else \
                            per_layer_rule(tuple(p.shape), want_p)
                    assert tp[n] == want_p, (n, tp[n], want_p)
                    assert tos.mu[n] == tos.nu[n] == want_o, \
                        (zero1, n, tos.mu[n], want_o)
                    seen.add(path)
                assert seen == set(jp)
                if zero1 and arch == "qwen2-7b" and mesh == "pod 2 data 2":
                    assert period > 0       # 4 divides its 28 periods
        assert tfb == jfb


def test_torch_param_spec_shards_expert_stacks_on_ff():
    """The MoE rule: an expert stack (an mlp with a router) shards its ff
    dim over ``model``; a dense MLP its own way."""
    cfg = tconfigs.get_model_config("jamba-v0.1-52b")
    params = _meta(cfg)
    with shd.axis_rules(stand_in((16, 16), ("data", "model"))):
        spec = tfm.param_spec(params, cfg)
    assert spec["blocks.1.mlp.w_gate"] == (None, None, "model")
    assert spec["blocks.1.mlp.w_down"] == (None, "model", None)
    assert spec["blocks.0.mlp.w_gate"] == (None, "model")
    assert spec["blocks.0.mlp.w_down"] == ("model", None)


def test_torch_resolve_spec_falls_back_as_the_reference():
    """28 heads on a 16-way model axis replicate; a batch of 8 on (pod 2,
    data 16) drops data and keeps pod; both recorded."""
    shape, axes = MESHES["multi pod"]
    cases = [((28, 128), ("heads", None)), ((8, 1024), ("batch", None)),
             ((64, 3584), ("batch", "embed")), ((3584, 18944), (None, "ff"))]
    with jshd.axis_rules(jax.sharding.AbstractMesh(shape, axes)):
        want = [tuple(jshd.resolve_spec(s, sp)) for s, sp in cases]
        jfb = jshd.fallbacks()
    with shd.axis_rules(stand_in(shape, axes)):
        got = [shd.resolve_spec(s, sp) for s, sp in cases]
        assert shd.fallbacks() == jfb
    assert got == want
    assert got[0] == (None, None) and got[1] == ("pod", None)
    assert shd.active_mesh() is None


def test_torch_logical_checks_rank_and_is_the_identity():
    x = torch.zeros(2, 3)
    assert shd.logical(x, "batch") is x               # no rules bound
    with shd.axis_rules(stand_in((2, 1), ("data", "model"))):
        assert shd.logical(x, "batch", "embed") is x
        with pytest.raises(ValueError, match="rank"):
            shd.logical(x, "batch")


def test_torch_named_sharding_gives_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard
    with shd.axis_rules(stand_in((2, 4, 2), ("pod", "data", "model"))):
        assert shd.named_sharding((8, 6), ("batch", "ff")) == \
            (Shard(0), Shard(0), Shard(1))
        assert shd.named_sharding((8, 5), (None, "ff")) == \
            (Replicate(), Replicate(), Replicate())


@pytest.mark.parametrize("mesh", list(MESHES))
def test_torch_mesh_helpers_match_the_references(mesh):
    shape, axes = MESHES[mesh]
    amesh = jax.sharding.AbstractMesh(shape, axes)
    stand = stand_in(shape, axes)
    assert mesh_lib.batch_axes(stand) == jmesh.batch_axes(amesh)
    assert mesh_lib.dp_size(stand) == jmesh.dp_size(amesh)
    assert mesh_lib.mesh_config_for(stand) == tconfigs.base.MeshConfig(
        shape, axes)


def test_torch_make_local_mesh_without_a_group_raises():
    import torch.distributed as dist
    assert not dist.is_initialized()
    for make in (mesh_lib.make_local_mesh,
                 lambda: mesh_lib.make_mesh(tconfigs.base.SMOKE_MESH),
                 lambda: mesh_lib.make_production_mesh(multi_pod=True)):
        with pytest.raises(RuntimeError, match="no process group"):
            make()


def test_torch_a_model_axis_larger_than_1_is_refused():
    """A layer kind that had no tensor-parallel path (RWKV-6's) on a mesh
    whose ``model`` axis is 2 is taken now: ``require_supported`` passes,
    the model builds on the mesh with its time mix cut on heads, and
    ``make_train_step`` refuses only a model not built on that mesh. The
    compressed step takes a ``model`` axis now (``tests/
    test_torch_compressed_tp.py`` runs it on a model built on the mesh)
    and refuses, as ``make_train_step`` does, a model not built on it; it
    still refuses a mesh without a ``pod`` axis larger than 1."""
    from repro_torch.launch.compressed import make_compressed_train_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.api import build_model
    cfg = tconfigs.get_model_config("rwkv6-3b", smoke=True)
    m = build_model(cfg, device="cpu")
    m.init(0)
    m.requires_grad_(True)
    tp = stand_in((2, 2, 2), ("pod", "data", "model"))
    tfm.require_supported(tp, cfg)
    spec = build_model(cfg, device="cpu", mesh=tp).spec
    assert spec["blocks.0.mixer.wr"] == (None, "model")
    assert spec["blocks.0.mixer.wo"] == ("model", None)
    with pytest.raises(ValueError, match="built on it"):
        make_train_step(m, tconfigs.OptimizerConfig(), backend="torch",
                        mesh=tp)
    with pytest.raises(ValueError, match="built on it"):
        make_compressed_train_step(m, tconfigs.OptimizerConfig(), tp,
                                   backend="torch")
    with pytest.raises(ValueError, match="multi-pod"):
        make_compressed_train_step(m, tconfigs.OptimizerConfig(),
                                   stand_in((4, 1), ("data", "model")),
                                   backend="torch")


def test_torch_sample_locality(tmp_path):
    import torch.distributed as dist
    info = sample_locality((0, 1))
    assert info.process_index == 0 and info.mesh_coords == (0, 1)
    if torch.cuda.is_available():
        assert info.num_local_devices == torch.cuda.device_count()
    else:
        assert (info.device_kind, info.num_local_devices) == ("cpu", 1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        assert sample_locality().process_index == 0
        mesh = mesh_lib.make_local_mesh(device_type="cpu")
        assert mesh_lib.mesh_shape(mesh) == {"data": 1, "model": 1}
        assert mesh_lib.coordinate(mesh, ("data",)) == 0
        assert mesh_lib.batch_axes(mesh) == ("data",)
        assert mesh_lib.axes_group(mesh, ("data",)) is not None
        assert mesh_lib.mesh_config_for(mesh) == tconfigs.base.MeshConfig(
            (1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


def test_torch_collectives_are_counted_and_timed_when_asked(tmp_path):
    """``all_reduce`` (sum and max) and ``all_gather`` over a one-rank
    ``gloo`` group: their results, their counts, and the host's time in
    them only while ``time_collectives`` is on."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        x = torch.arange(6.0).reshape(2, 3)
        mesh_lib.reset_collective_counts()
        mesh_lib.time_collectives(True)
        try:
            assert torch.equal(mesh_lib.all_reduce(x.clone(), group), x)
            assert torch.equal(mesh_lib.all_reduce(x.clone(), group, "max"),
                               x)
            assert torch.equal(mesh_lib.all_gather(x, group, 1), x)
        finally:
            mesh_lib.time_collectives(False)
        timed = mesh_lib.collective_seconds()
        assert timed > 0
        assert mesh_lib.collective_counts() == {"all_reduce": 2,
                                                "all_gather": 1}
        mesh_lib.all_reduce(x.clone(), group)
        assert mesh_lib.collective_seconds() == timed
        assert mesh_lib.collective_counts()["all_reduce"] == 3
    finally:
        dist.destroy_process_group()
