"""Step factories: train (plain and gradient accumulation), prefill and
decode.

The counterpart of ``repro.launch.steps`` (``make_train_step``,
``make_prefill_step``, ``make_decode_step``, whose decode step takes the
encoder-decoder's ``memory``). There is no ``jit``: a step is the model
call with the kernel backend bound. The train step holds no parameters
of its own: the model does, and the step updates them in place (the
reference's jitted step donates them and returns new ones), so it maps
``(opt_state, batch)`` to ``(opt_state, metrics)``.

Under a ``mesh`` (``launch.mesh``) every rank is handed the same global
batch and takes its slice by its coordinate on ``batch_axes(mesh)``, as
GSPMD shards the batch; the gradients are averaged over ``pod x data``
(``optim.compress.hierarchical_grad_reduce(compress="none")``) and the
loss metrics over the ranks, over one rank too (its all-reduces are
issued, and change no bit). That is the global batch's gradient when
each rank's share of the loss's tokens is equal (no ``loss_mask``; a MoE
aux loss is averaged over the ranks, as the reference's ``shard_map``
``pmean`` takes it). With ``opt_cfg.zero1`` the moments keep this rank's
ZeRO-1 slice (``optim.adamw.Zero1``, the step's ``zero`` attribute: build
the state with ``init_opt_state(cfg, params, step.zero)``).

A bound ``seq`` rule (``launch.sharding.axis_rules(mesh, {"seq":
"data"})`` or ``{"seq": "model"}``, around the steps) is context
parallelism. The prefill and train steps are handed the global batch
and take the rank's slice of it by its resolved spec
(:func:`rank_slice`): at a batch that ``pod x data`` does not divide,
the whole batch, or its ``pod``'s rows where ``pod`` divides it, as the
reference's resolution drops the trailing axes; the global batch's size
stays bound while the rank runs its slice, and the cut and a MoE's
tokens are resolved on it. A prefill or train step then cuts
the sequence into a block a rank (``models.transformer.forward``): the
prefill returns the last position's logits on every rank and the rank's
blocks of the attention caches, which the decode step runs on, and the
train step's loss is the whole sequence's on every rank. Over ``data``
each rank's gradient is its blocks' share of ``n`` times it, so that
the average over ``pod x data`` is the whole batch's gradient. Over
``model``, which is no batch axis, each rank's gradient is the whole
loss's, leaf by leaf: a layer whose width the axis cuts runs its shard
on the gathered sequence, whose gradient the tensor-parallel
collectives sum, and a leaf that every rank keeps whole but applies to
its block (a norm, the embedding and head at a vocabulary that falls
back, a layer that runs whole) is summed over ``model`` where it enters
(``launch.sharding.block_leaf``); the step's mean over ``pod x data``
is then the data-parallel one. A prefill or train step raises
``ValueError`` wherever the reference's spec maps one axis twice
(``launch.sharding.activation_axes``): ``seq -> model`` beside a
vocabulary the axis divides, ``seq -> data`` beside a batch it cuts.

A ``model`` axis larger than 1 is tensor parallelism: the model must be
built on the same mesh (``build_model(cfg, mesh=)``: it holds this rank's
shards and runs its layers tensor parallel), and a MoE expert width the
axis does not divide is refused, as the reference refuses it
(``models.transformer.require_supported``). A sharded
leaf's gradient is this rank's shard's, and a replicated leaf's (a norm's,
the router's, or one the divisibility fallback keeps whole: an MLP's
whose width the axis does not divide, ``embed`` and ``lm_head`` at such a
vocabulary) comes out equal on every model rank, so both are reduced
over the batch axes only, and ZeRO-1 slices either over ``pod x data``;
the global norm for clipping sums the sharded leaves' squares over
``model`` (``optim.adamw.ModelShards``). The
collectives of a step are counted by ``mesh.collective_counts``, those a
remat recompute issues again included.

:func:`lower_train_step`, :func:`lower_prefill_step`,
:func:`lower_decode_step` and :func:`lower_step_for` are the dry run's
counterparts of the reference's AOT lowering: each traces one rank's
step on the meta device (``launch.step_trace``), the model built on the
mesh on the meta device (``build_model(cfg, device="meta", mesh=mesh)``;
its parameters are :meth:`Model.abstract_params`), the inputs the
reference's specs (``models.api.input_specs``), the kernel backend
``"torch"``, and returns a ``StepTrace``. A serving step is handed its
rank's slice of the batch over ``pod x data`` (the whole batch where that
does not divide it, as the reference replicates it).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable

import torch

from repro_torch.configs.base import OptimizerConfig, ShapeConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd
from repro_torch.launch.step_trace import StepTrace, trace_step
from repro_torch.models import transformer as tfm
from repro_torch.models.api import Model, input_specs
from repro_torch.optim import (adamw_update, decay_mask, init_opt_state,
                               zero1_layout)
from repro_torch.optim.adamw import model_shards
from repro_torch.optim.compress import hierarchical_grad_reduce


def _split(batch: Dict[str, torch.Tensor], k: int):
    """The batch as ``k`` microbatches along its batch axis: dimension 1
    of ``mrope_positions`` (3, B, S), dimension 0 of every other input; a
    scalar goes to every microbatch."""
    out = [dict() for _ in range(k)]
    for name, v in batch.items():
        if v.dim() == 0:
            parts = [v] * k
        elif name == "mrope_positions":
            parts = v.chunk(k, 1)
        else:
            parts = v.chunk(k, 0)
        if len(parts) != k or len({p.shape for p in parts}) != 1:
            raise ValueError(f"{name} {tuple(v.shape)} does not split into "
                             f"{k} equal microbatches")
        for mb, part in zip(out, parts):
            mb[name] = part
    return out


def _local(batch: Dict[str, torch.Tensor], n: int, idx: int):
    """This rank's slice ``idx`` of ``n`` of the batch (see :func:`_split`)."""
    return _split(batch, n)[idx] if n > 1 else batch


def batch_cut(mesh, batch_size: int):
    """(the axes of ``mesh`` that the batch's resolved ``("batch",)`` spec
    cuts a batch of ``batch_size`` on, under the bound rules (the mesh's
    default rules where none are bound on it), their size, this rank's
    index on them): ``pod x data`` where they divide the batch, fewer
    where the divisibility fallback drops trailing axes, none where none
    divides it (the whole batch on every rank, as the reference
    replicates it)."""
    bound = shd.active_mesh() is mesh
    with (contextlib.nullcontext() if bound else shd.axis_rules(mesh)):
        axes = shd.batch_axes_of(batch_size)
    shape = mesh_lib.mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= shape[a]
    return axes, n, mesh_lib.coordinate(mesh, axes) if axes else 0


def _batch_size(batch: Dict[str, torch.Tensor]) -> int:
    """The size of the first input with a dimension (``mrope_positions``'
    dimension 1)."""
    return next(v.shape[1] if n == "mrope_positions" else v.shape[0]
                for n, v in batch.items() if v.dim())


def _rank_batch(batch: Dict[str, torch.Tensor], mesh):
    """This rank's slice of ``batch`` (:func:`batch_cut`)."""
    if mesh is None:
        return batch
    _, n, idx = batch_cut(mesh, _batch_size(batch))
    return _local(batch, n, idx)


@contextlib.contextmanager
def rank_slice(batch: Dict[str, torch.Tensor], mesh):
    """This rank's slice of the global ``batch`` (:func:`batch_cut`; the
    batch itself without ``mesh``), with the global batch's size bound
    while it is entered: the activations' sequence cut and a MoE's
    tokens are resolved on the global batch, as the reference resolves
    them (``launch.sharding.activation_axes``, ``replicated_rows``)."""
    if mesh is None:
        yield batch
        return
    with shd._global_batch(_batch_size(batch)):
        yield _rank_batch(batch, mesh)


def _grads(model: Model, params: Dict[str, torch.Tensor], batch, backend):
    """(every parameter's gradient of the batch's loss, the loss's metrics
    detached); a parameter the loss does not reach has a zero gradient,
    and the parameters hold no gradient after."""
    for p in params.values():
        p.grad = None
    loss, metrics = model.loss(batch, backend=backend)
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in params.items()}
    for p in params.values():
        p.grad = None
    return grads, {k: v.detach() for k, v in metrics.items()}


def make_train_step(model: Model, opt_cfg: OptimizerConfig,
                    microbatches: int = 1, backend: str = "cuda",
                    mesh=None):
    """Plain step (microbatches=1) or gradient-accumulation step.

    The plain step takes the loss's gradient with respect to every
    parameter (``loss.backward()``) and applies ``adamw_update``. With
    accumulation, the global batch is split into microbatches, each
    rank takes its slice of each, each microbatch's gradient (averaged
    over the mesh's ranks by an all-reduce, where the reference
    reduce-scatters it into the accumulator, moving half the bytes) is
    cast to float32 and added into a float32 accumulator (under ZeRO-1
    this rank's slice of it only, gathered whole before the update, so
    the global norm is the whole gradient's), the mean is cast to each
    parameter's dtype, and the loss and aux loss are the microbatches'
    means. The parameters must require grad
    (``model.requires_grad_(True)``); a parameter the loss does not reach
    has a zero gradient. Gradients are dropped after the update. The
    module's docstring says what ``mesh`` changes."""
    params = dict(model.params.named_parameters())
    if not all(p.requires_grad for p in params.values()):
        raise ValueError("the model's parameters do not require grad: call "
                         "model.requires_grad_(True) before training")
    decay = decay_mask(model.cfg, params)
    zero = shards = None
    if mesh is not None:
        tfm.require_supported(mesh, model.cfg)
        require_model_on(model, mesh)
        zero = zero1_layout(opt_cfg, params, model.cfg, mesh)
        shards = model_shards(model.spec, mesh)

    def reduce(tree, in_place=False):
        if mesh is None:
            return tree
        return hierarchical_grad_reduce(tree, mesh=mesh, compress="none",
                                        in_place=in_place)

    def grads_of(batch):
        with rank_slice(batch, mesh) as local:
            grads, metrics = _grads(model, params, local, backend)
        # the gradients are the step's own: their mean is taken in place
        return reduce(grads, in_place=True), metrics

    def train_step(opt_state, batch):
        grads, metrics = grads_of(batch)
        _, opt_state, opt_metrics = adamw_update(opt_cfg, params, grads,
                                                 opt_state, decay, zero,
                                                 shards)
        return opt_state, dict(reduce(metrics), **opt_metrics)

    def accum_step(opt_state, batch):
        k = microbatches
        shard = (lambda n, t: t) if zero is None else zero.shard
        acc = {n: torch.zeros(shard(n, p).shape, dtype=torch.float32,
                              device=p.device)
               for n, p in params.items()}
        dev = next(iter(params.values())).device
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for mb in _split(batch, k):
            g, metrics = grads_of(mb)
            for n in acc:
                acc[n] += shard(n, g[n]).float()
            del g
            loss_sum = loss_sum + metrics["loss"]
            aux_sum = aux_sum + metrics.get("aux_loss", 0.0)
        kt = torch.full((), float(k), dtype=torch.float32, device=dev)
        gather = (lambda n, t: t) if zero is None else zero.gather
        grads = {n: (gather(n, acc.pop(n)) / kt).to(p.dtype)
                 for n, p in params.items()}
        _, opt_state, opt_metrics = adamw_update(opt_cfg, params, grads,
                                                 opt_state, decay, zero,
                                                 shards)
        metrics = reduce({"loss": loss_sum / kt, "lm_loss": loss_sum / kt,
                          "aux_loss": aux_sum / kt})
        return opt_state, dict(metrics, **opt_metrics)

    def grads(batch):
        """The plain step's gradient half: (every leaf's gradient of the
        global ``batch``, reduced as the step reduces it, and the loss's
        metrics, averaged as the step averages them); no update."""
        g, metrics = grads_of(batch)
        return g, reduce(metrics)

    step = train_step if microbatches <= 1 else accum_step
    step.zero = zero
    step.grads = grads
    return step


def require_model_on(model: Model, mesh) -> None:
    """Raise ``ValueError`` when ``mesh`` has a ``model`` axis larger than
    1 and ``model`` was not built on it (it would hold whole leaves)."""
    if mesh is not None and mesh_lib.model_size(mesh) > 1 and \
            model.mesh is not mesh:
        raise ValueError(
            f"a mesh whose 'model' axis is {mesh_lib.model_size(mesh)} "
            f"needs the model built on it, holding its shards: "
            f"build_model(cfg, mesh=mesh) or convert.shard_params")


def make_prefill_step(model: Model, max_len: int, backend: str = "cuda",
                      mesh=None):
    """The prefill of the global ``batch``: under ``mesh`` (the model's)
    each rank prefills its slice of it (:func:`rank_slice`) and returns
    its rows of the last position's logits, gathered whole over
    ``model``, and its cache. ``memory``, an encoder-decoder's, is the
    encoder's output for the rank's rows (``Model.encode`` of its slice of
    the frames), as the decode step takes it; without it the batch's
    ``enc_embeds`` are encoded."""
    require_model_on(model, mesh)

    def prefill_step(batch, memory=None):
        with rank_slice(batch, mesh) as local:
            if memory is not None:
                local = dict(local, memory=memory)
            return model.prefill(local, max_len=max_len, backend=backend)
    return prefill_step


def make_decode_step(model: Model, backend: str = "cuda", mesh=None):
    """One decode step of the rank's rows, on the cache and ``memory``
    the prefill step gave it; under ``mesh`` (the model's) its logits are
    gathered whole over ``model``. A MoE routes the rows it is given:
    routing is per token and dropless, so the tokens are those the
    reference's step makes from the whole batch (whose aux loss serving
    leaves unused)."""
    require_model_on(model, mesh)

    def decode_step(token, pos, kv_len, cache, memory=None):
        logits, cache = model.decode_step(token, pos, cache, kv_len=kv_len,
                                          memory=memory, backend=backend)
        return logits, cache
    return decode_step


# ---------------------------------------------------------------------------
# the dry run: one rank's step traced on the meta device
# ---------------------------------------------------------------------------


def _on_meta(model: Model, mesh, train: bool) -> None:
    """Give ``model`` (built on ``mesh`` on the meta device) its abstract
    parameters, trainable for a train step."""
    require_model_on(model, mesh)
    if model.device.type != "meta":
        raise ValueError("a step is traced on a model built on the meta "
                         "device: build_model(cfg, device='meta', mesh=mesh)")
    if model.params is None:
        model.params = model.abstract_params()
    model.requires_grad_(train)


def _nbytes(tensors: Iterable[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def trace_train(model: Model, opt_cfg: OptimizerConfig, mesh,
                shape: ShapeConfig, make_step: Callable) -> StepTrace:
    """Trace the train step ``make_step()`` builds for ``model`` on the
    meta device, its optimizer state made by ``init_opt_state`` (with the
    step's ZeRO-1 layout), handed the global batch of ``shape``, of which
    the rank keeps its slice."""
    _on_meta(model, mesh, True)
    step = make_step()
    params = dict(model.params.named_parameters())
    state = init_opt_state(opt_cfg, params, getattr(step, "zero", None))
    batch = input_specs(model.cfg, shape)
    local = _rank_batch(batch, mesh)
    args = list(params.values()) + [state.step] + list(state.mu.values()) \
        + list(state.nu.values())
    return trace_step(lambda: step(state, batch), args,
                      kept=batch.values(), kept_bytes=_nbytes(local.values()))


def lower_train_step(model: Model, opt_cfg: OptimizerConfig, mesh,
                     shape: ShapeConfig, *, microbatches: int = 1
                     ) -> StepTrace:
    """Trace one rank's ``make_train_step(mesh=)`` on the meta device
    (under a bound ``seq`` rule, context parallel: the module's
    docstring)."""
    return trace_train(model, opt_cfg, mesh, shape, lambda: make_train_step(
        model, opt_cfg, microbatches=microbatches, backend="torch",
        mesh=mesh))


def _serve_len(model: Model, shape: ShapeConfig) -> int:
    return shape.seq_len // 2 if model.cfg.is_encoder_decoder \
        else shape.seq_len


@torch.no_grad()
def lower_prefill_step(model: Model, mesh, shape: ShapeConfig
                       ) -> StepTrace:
    """Trace one rank's prefill of its slice of ``shape``'s batch, the
    cache made for ``seq_len`` (half of it for an encoder-decoder); under
    a bound ``seq`` rule, context parallel (the module's docstring)."""
    _on_meta(model, mesh, False)
    specs = input_specs(model.cfg, shape)
    step = make_prefill_step(model, max_len=_serve_len(model, shape),
                             backend="torch", mesh=mesh)
    return trace_step(lambda: step(specs), model.params.parameters(),
                      kept=specs.values(),
                      kept_bytes=_nbytes(_rank_batch(specs, mesh).values()))


@torch.no_grad()
def lower_decode_step(model: Model, mesh, shape: ShapeConfig
                      ) -> StepTrace:
    """Trace one rank's decode step of its slice of ``shape``'s batch
    against a cache of ``seq_len`` (half of it for an encoder-decoder):
    under a bound ``seq`` rule, its block of each attention cache's
    sequence (``Model.abstract_cache``), the partials merged. A batch and
    a sequence that the rules would both cut on one axis raise
    ``ValueError``, as the reference's spec does."""
    _on_meta(model, mesh, False)
    shd.seq_cut((shape.global_batch, _serve_len(model, shape)),
                ("batch", "seq"))
    specs = input_specs(model.cfg, shape)
    local = _rank_batch(specs, mesh)
    cache = model.abstract_cache(local["token"].shape[0],
                                 _serve_len(model, shape))
    step = make_decode_step(model, backend="torch", mesh=mesh)
    leaves = [t for layer in cache for part in layer.values()
              for t in part.values()]
    return trace_step(
        lambda: step(local["token"], local["pos"], local["kv_len"], cache,
                     memory=local.get("memory")),
        list(model.params.parameters()) + leaves, kept=specs.values(),
        kept_bytes=_nbytes(local.values()))


def lower_step_for(model: Model, opt_cfg: OptimizerConfig, mesh,
                   shape: ShapeConfig) -> StepTrace:
    """Dispatch on the cell kind: train_step / prefill / decode."""
    if shape.kind == "train":
        return lower_train_step(model, opt_cfg, mesh, shape)
    if shape.kind == "prefill":
        return lower_prefill_step(model, mesh, shape)
    return lower_decode_step(model, mesh, shape)
