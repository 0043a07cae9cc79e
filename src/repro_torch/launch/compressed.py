"""Cross-pod int8 gradient reduction step.

The counterpart of ``repro.launch.compressed``. On a multi-pod mesh the
``pod`` axis is the oversubscribed tier, the paper's problem tier. Each
rank takes its slice of the global batch by its coordinate on ``(pod,
data)``; the gradients are averaged over ``data`` inside each pod in full
precision, then each leaf goes through the int8 ring over ``pod``
(``optim.compress.hierarchical_grad_reduce``), and AdamW updates the
parameters. As in the reference's lowered variant there is no error
feedback and ZeRO-1 is off (the moments mirror the parameters), and the
metrics are averaged over ``pod``.

Under a ``model`` axis larger than 1 (tensor parallelism) the model must
be built on the mesh, as for ``make_train_step(mesh=)``: the gradients are
computed as that step computes them, each rank's gradient of a sharded
leaf is its shard's, and the ring runs over ``pod`` on that shard, so the
quantization blocks lie on the shard and the wire payload is shard-sized,
as the reference's ``ring_leaf`` binds ``data`` and ``model`` manual
around it; a leaf that every rank keeps whole (a norm, or one the
divisibility fallback replicates) goes through the ring whole, its
gradient the same on every rank of ``model``. The clip norm sums the sharded leaves' squares over ``model``
(``optim.adamw.ModelShards``).

The ring leaves each pod with a different gradient (each adds its own at
full precision), so the pods' parameters drift apart, as the reference's
do behind its ``P()`` out-spec: the step reports the largest difference
between the pods' values of any parameter element after its update, the
largest over ``model`` too, as ``metrics["pod_divergence"]`` (two float32
all-reduces of every parameter over ``pod``: the reference's step has no
such diagnostic, and ``divergence=False`` leaves it out). The ring's true
wire bytes are in ``optim.compress``'s docstring (1.97x fewer than bf16
at ``pod = 2``, not 3.9x). As the reference's step binds ``pod`` manual
around its loss, the port's marks it manual (``launch.sharding.manual``):
a layer that averages over the batch axes (the MoE's aux loss, on a model
built on the mesh) leaves ``pod`` to the step.

:func:`lower_compressed_train_step` traces one rank's step on the meta
device for the dry run (``launch.steps.lower_train_step``'s counterpart).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.configs.base import OptimizerConfig, ShapeConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd
from repro_torch.launch.steps import (_batch_size, _grads, batch_cut,
                                      rank_slice, require_model_on,
                                      trace_train)
from repro_torch.models import transformer as tfm
from repro_torch.models.api import Model
from repro_torch.optim import adamw_update, decay_mask
from repro_torch.optim.adamw import model_shards
from repro_torch.optim.compress import hierarchical_grad_reduce


def make_compressed_train_step(model: Model, opt_cfg: OptimizerConfig,
                               mesh, backend: str = "cuda",
                               divergence: bool = True):
    """Train step with the int8 ring over the ``pod`` axis; maps
    ``(opt_state, global batch)`` to ``(opt_state, metrics)`` and updates
    the model's parameters in place. Requires ``pod > 1``, and a model
    built on the mesh where its ``model`` axis is larger than 1. Build the
    state with ``init_opt_state(cfg, params)`` (no ZeRO-1)."""
    shape = mesh_lib.mesh_shape(mesh)
    if shape.get("pod", 1) <= 1:
        raise ValueError(f"the compressed step targets a multi-pod mesh; "
                         f"this mesh is {shape}")
    tfm.require_supported(mesh, model.cfg)
    require_model_on(model, mesh)
    opt_cfg = dataclasses.replace(opt_cfg, zero1=False)
    params = dict(model.params.named_parameters())
    if not all(p.requires_grad for p in params.values()):
        raise ValueError("the model's parameters do not require grad: call "
                         "model.requires_grad_(True) before training")
    decay = decay_mask(model.cfg, params)
    shards = model_shards(model.spec, mesh)
    pod_group = mesh_lib.axes_group(mesh, ("pod",))
    model_group = None if shards is None else shards.group

    def step(opt_state, batch):
        B = _batch_size(batch)
        if "pod" not in batch_cut(mesh, B)[0]:
            # the reference's shard_map takes the batch cut on 'pod'
            raise ValueError(f"a batch of {B} does not split over the "
                             f"{shape['pod']} ranks of 'pod'")
        with rank_slice(batch, mesh) as local, shd.manual(("pod",)):
            grads, metrics = _grads(model, params, local, backend)
        # the pod's gradient (its data-axis mean), then the int8 pod ring,
        # each on this rank's shard
        grads = hierarchical_grad_reduce(grads, mesh=mesh)
        _, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state,
                                        decay, None, shards)
        metrics = hierarchical_grad_reduce(dict(metrics, **om), mesh=mesh,
                                           compress="none")
        if divergence:
            metrics["pod_divergence"] = _pod_divergence(params, pod_group,
                                                        model_group)
        return opt_state, metrics

    return step


@torch.no_grad()
def _pod_divergence(params, group, model_group=None) -> torch.Tensor:
    """The largest difference between the pods' values of any parameter
    element (0 when the pods agree), the largest over ``model_group``
    too when there is one."""
    worst = None
    for p in params.values():
        hi, lo = p.detach().float().clone(), p.detach().float().clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        mesh_lib.count("all_reduce", 2, op="all-reduce",
                       nbytes=2 * mesh_lib.nbytes(hi))
        d = (hi - lo).max()
        worst = d if worst is None else torch.maximum(worst, d)
    if model_group is not None:
        mesh_lib.all_reduce(worst, model_group, op="max")
    return worst


def lower_compressed_train_step(model: Model, opt_cfg: OptimizerConfig,
                                mesh, shape: ShapeConfig, *,
                                divergence: bool = False):
    """Trace one rank's compressed step on the meta device (the
    reference's AOT lowering on the multi-pod mesh): the model built on
    ``mesh`` on the meta device, ZeRO-1 off as the reference forces, the
    pod divergence left out unless asked for (the reference's step has
    none). Returns ``launch.steps.StepTrace``."""
    opt_cfg = dataclasses.replace(opt_cfg, zero1=False)
    return trace_train(
        model, opt_cfg, mesh, shape,
        lambda: make_compressed_train_step(model, opt_cfg, mesh,
                                           backend="torch",
                                           divergence=divergence))
