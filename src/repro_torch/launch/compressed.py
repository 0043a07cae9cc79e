"""Cross-pod int8 gradient reduction step.

The counterpart of ``repro.launch.compressed.make_compressed_train_step``.
On a multi-pod mesh the ``pod`` axis is the oversubscribed tier, the
paper's problem tier. Each rank takes its slice of the global batch by
its coordinate on ``(pod, data)``; the gradients are averaged over
``data`` inside each pod in full precision, then each leaf goes through
the int8 ring over ``pod`` (``optim.compress.hierarchical_grad_reduce``), and
AdamW updates the parameters. As in the reference's lowered variant there
is no error feedback and ZeRO-1 is off (the moments are whole on every
rank), and the metrics are averaged over ``pod``.

The ring leaves each pod with a different gradient (each adds its own at
full precision), so the pods' parameters drift apart, as the reference's
do behind its ``P()`` out-spec: the step reports the largest difference
between the pods' parameters after its update as
``metrics["pod_divergence"]``. The ring's true wire bytes are in
``optim.compress``'s docstring (1.97x fewer than bf16 at ``pod = 2``, not
3.9x). ``lower_compressed_train_step`` (AOT lowering) comes with the
dry-run (``ROADMAP.md`` Queue 1 item 12). As the reference's step binds
``pod`` manual around its loss, the port's marks it manual
(``launch.sharding.manual``): a layer that averages over the batch axes
(the MoE's aux loss, on a model built on the mesh) leaves ``pod`` to the
step. A mesh whose ``model`` axis is larger than 1 is refused: the ring
under tensor parallelism is not ported.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.configs.base import OptimizerConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd
from repro_torch.launch.steps import _grads, _local
from repro_torch.models.api import Model
from repro_torch.optim import adamw_update, decay_mask
from repro_torch.optim.compress import hierarchical_grad_reduce


def make_compressed_train_step(model: Model, opt_cfg: OptimizerConfig,
                               mesh, backend: str = "cuda"):
    """Train step with the int8 ring over the ``pod`` axis; maps
    ``(opt_state, global batch)`` to ``(opt_state, metrics)`` and updates
    the model's parameters in place. Requires ``pod > 1``. Build the state
    with ``init_opt_state(cfg, params)`` (no ZeRO-1)."""
    shape = mesh_lib.mesh_shape(mesh)
    mesh_lib.refuse_model_axis(mesh, "the compressed step")
    if shape.get("pod", 1) <= 1:
        raise ValueError(f"the compressed step targets a multi-pod mesh; "
                         f"this mesh is {shape}")
    opt_cfg = dataclasses.replace(opt_cfg, zero1=False)
    params = dict(model.params.named_parameters())
    if not all(p.requires_grad for p in params.values()):
        raise ValueError("the model's parameters do not require grad: call "
                         "model.requires_grad_(True) before training")
    decay = decay_mask(model.cfg, params)
    axes = mesh_lib.batch_axes(mesh)
    dp, idx = mesh_lib.dp_size(mesh), mesh_lib.coordinate(mesh, axes)
    pod_group = mesh_lib.axes_group(mesh, ("pod",))

    def step(opt_state, batch):
        with shd.manual(("pod",)):
            grads, metrics = _grads(model, params, _local(batch, dp, idx),
                                    backend)
        # the pod's gradient (its data-axis mean), then the int8 pod ring
        grads = hierarchical_grad_reduce(grads, mesh=mesh)
        _, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state,
                                        decay)
        metrics = hierarchical_grad_reduce(dict(metrics, **om), mesh=mesh,
                                           compress="none")
        metrics["pod_divergence"] = _pod_divergence(params, pod_group)
        return opt_state, metrics

    return step


@torch.no_grad()
def _pod_divergence(params, group) -> torch.Tensor:
    """The largest difference between the pods' values of any parameter
    element (0 when the pods agree)."""
    worst = None
    for p in params.values():
        hi, lo = p.detach().float().clone(), p.detach().float().clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        mesh_lib.count("all_reduce", 2)
        d = (hi - lo).max()
        worst = d if worst is None else torch.maximum(worst, d)
    return worst
