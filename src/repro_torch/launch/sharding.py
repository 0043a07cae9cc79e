"""Logical-axis sharding: models name tensor dims with logical axis names;
the launcher binds those names to physical mesh axes (MaxText-style rules).

The counterpart of ``repro.launch.sharding`` for the rules and their
resolution: ``DEFAULT_RULES``, ``axis_rules``, ``active_mesh``,
``fallbacks``, ``resolve_spec`` and ``named_sharding``. A spec is a tuple
with the reference's ``PartitionSpec`` entries: ``None``, a mesh axis
name, or a tuple of names. Resolution applies the same **divisibility
fallback**: when a dim is not divisible by the product of its mapped axes'
sizes, trailing axes are dropped until it is (else it replicates), and
every fallback is recorded as ``(logical name, dim, divisor)``; a spec
that maps one mesh axis to two dimensions raises ``ValueError``, where
the reference's ``PartitionSpec`` raises ``DuplicateSpecError``.
``axis_rules`` refuses an override that the port's layers do not carry
out (:func:`check_rules`).

Context parallelism: the ``seq`` rule bound to ``data`` (the dry run's
``long_500k`` cells) or to ``model`` (its ``seqkv`` variant) cuts a
decode cache's sequence, as the reference's cache spec does;
:func:`seq_cut` says how (the axes, this rank's block, their group), and
the attention layers read it (``models.attention``: each rank's partial
softmax over its block, merged over the axes). In a prefill or a train
step the rule cuts the activations' sequence, as the reference's
``logical(x, "batch", "seq", "embed")`` does:
:func:`activation_axes` resolves the cut as the reference's logits
constraint ``("batch", "seq", "vocab")`` would (``ValueError`` where it
maps one axis twice, the reference's ``DuplicateSpecError``), on the
global batch (bound by ``launch.steps.rank_slice``, which hands a rank
its slice of it), :func:`activation_cut` gives this
rank's :class:`SeqBlock`, and :func:`cut_sequence` binds it for the
layers (:func:`seq_block`). Two cuts run, as the reference runs them:

* over ``data`` (or beside a batch cut over ``pod``): a layer runs on
  the block and sees the rest of the sequence through
  :func:`gather_seq` (an all-gather whose backward sums the gradients
  over the axis), :func:`halo` (the previous block's last rows) and
  :func:`relay_scan` (a recurrence's state handed from block to block);
  each rank's gradient is its blocks' share of ``n`` times the whole
  loss's (:func:`sum_over_seq`), and the step's mean over ``pod x data``
  divides the ``n`` back out;
* over ``model`` (where the vocabulary falls back, and in the encoder):
  sequence parallelism. A layer whose width the axis cuts
  (:func:`tp_layer`) enters with the block all-gathered over ``model``
  and runs its shard on the whole sequence, tensor parallel as without
  the cut, then leaves through the row-parallel all-reduce and this
  rank's slice (a reduce-scatter); a layer that runs whole runs on the
  block as a cut over ``data`` does, over the ``model`` group. Each
  rank's gradient is the whole loss's (``model`` is no batch axis): a
  leaf that every rank keeps whole but applies to its block (the norms,
  the embedding and head at the whole vocabulary, a layer that runs
  whole) enters through :func:`block_leaf`, whose backward sums it over
  ``model``.
``resolve_spec`` reads only the mesh's axis sizes, so the bound mesh may
be a ``DeviceMesh`` or anything with an ordered ``shape`` mapping (the
production sizes, with no ranks behind them).

``logical(x, *spec)`` keeps the reference's rank check and is otherwise
the identity: each rank already holds its local slice, and the port has
no compiler to take a sharding constraint. ``named_sharding`` gives
DTensor placements (``Shard(dim)`` or ``Replicate()`` per mesh axis): a
description, which no code of the port places tensors by.

Tensor parallelism (a ``model`` axis larger than 1) is done by hand, in
the Megatron manner, with explicit shards and explicit collectives:
:func:`shard_of` / :func:`gather_full` cut a whole leaf to this rank's
shard by its resolved spec and make it whole again (a :class:`Halves`
entry cuts each half of a dim); :func:`model_axis` is
the bound mesh's ``model`` axis (its size, this rank's index, its group),
which the layers read; :func:`copy_to_model` (the identity, whose
backward all-reduces over ``model``) enters a column-parallel region,
:func:`reduce_from_model` (an all-reduce, whose backward is the identity)
leaves a row-parallel one, and :func:`tp_row_matmul` is the row-parallel
product. The reference's ``shard_map`` regions have one counterpart:
:func:`manual_axes`, the axes whose reduction an enclosing step already
owns (bound by :func:`manual`), which the layers read, as the
reference's ``moe_apply`` does, and then leave alone; :func:`runs_whole`
marks ``model`` so around a layer whose width the axis does not divide,
which then runs whole on every rank, as the reference's fallback
replicates it: a mixer whose heads (Mamba: inner channels) it does not
divide, a dense MLP or RWKV-6's channel mix whose ``d_ff`` it does not
divide, and the embedding, head and cross entropies at a padded
vocabulary it does not divide (``models.transformer``). KV heads that
neither divide nor are divided by it are kept whole and read as each
rank's query heads need them (``models.attention.kv_read``). The one
width the reference does not let fall back is a MoE's expert stacks,
whose ``shard_map`` raises ``ValueError``: so does the port
(``models.transformer.require_supported``). The reference's
``shard_map_mesh`` has none: each step of the port already runs per
rank, on the bound mesh.
:func:`current` / :func:`restored` carry the binding into a remat
recompute, which runs in the backward, outside the forward's context.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import (Any, Callable, Dict, FrozenSet, List, Optional,
                    Sequence, Tuple, Union)

import torch

from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import mesh_shape

LogicalSpec = Sequence[Union[str, None, Tuple[str, ...]]]
Spec = Tuple[Union[str, None, Tuple[str, ...]], ...]

# Default logical -> physical rules for the production meshes. "batch" spans
# the pure-DP axes; "model-ish" names map to the TP axis.
DEFAULT_RULES: Dict[str, Union[str, Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "ddp": ("pod", "data"),        # optimizer-state (ZeRO-1) sharding axis
    "model": "model",
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "embed": None,                 # d_model stays unsharded in activations
    "seq": None,                   # context parallelism binds this (hillclimb)
    "expert": None,                # EP binds this (hillclimb); baseline: F-shard
    "state": None,
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Optional[Dict[str, Union[str, Tuple[str, ...]]]] = None
        self.fallbacks: List[Tuple[str, int, int]] = []
        self.manual: FrozenSet[str] = frozenset()
        self.block: Optional["SeqBlock"] = None
        self.batch: Optional[int] = None


_ctx = _Ctx()


# the ROADMAP.md item of the overrides the layers do not carry out
_OTHER_ITEM = ("ROADMAP.md Queue 1 item 14.3 (axis-rule overrides the "
               "layers do not read)")
# the axes the 'seq' rule may bind: the cache's sequence cut over either
SEQ_AXES = ("data", "model")


def _bound_axes(rule, shape: Dict[str, int]) -> Tuple[str, ...]:
    """The axes of ``shape`` that a rule binds (an axis the mesh lacks
    drops out, as :func:`resolve_spec` drops it)."""
    if rule is None:
        return ()
    axes = (rule,) if isinstance(rule, str) else tuple(rule)
    return tuple(a for a in axes if a in shape)


def check_rules(mesh, rules: Optional[Dict]) -> None:
    """Raise ``NotImplementedError`` for an override in ``rules`` that the
    port's layers do not carry out on ``mesh``.

    The layers read two rules: ``seq``, which cuts a decode cache's
    sequence (:func:`seq_cut`; context-parallel decode), and none other:
    they cut by :func:`model_axis`, the step slices the batch over
    ``mesh.batch_axes`` (``pod`` and ``data``), ZeRO-1 slices the moments
    over the same axes (``optim.adamw.zero1_layout`` binds the default
    rules itself, and ``opt_state_spec`` reads ``batch_axes``, not the
    ``ddp`` rule), and ``transformer.tp_param_spec`` resolves the leaves'
    specs under the default rules. So the overrides the port honors are
    ``seq`` bound to ``data`` or to ``model``; ``expert`` bound to
    anything, which the reference reads nowhere either (its expert stacks
    are specified by ``ff``), so that it changes nothing; and those that
    bind a logical name to the axes its default binds on this mesh (an
    axis the mesh lacks counts as absent): e.g. ``{"batch": ("data",)}``
    on a ``(data, model)`` mesh, or ``{"heads": "model"}``. Every other
    override would have :func:`resolve_spec` describe a distribution the
    step does not run, and is refused: ``seq`` bound to ``pod`` or to two
    axes, ``heads`` / ``kv_heads`` / ``ff`` / ``vocab`` mapped to anything
    but ``model``, ``batch`` or ``ddp`` off ``pod x data``, ``embed`` or
    ``state`` bound to an axis. Under the rules the port honors, every
    width the resolved specs replicate by the divisibility fallback runs
    whole (the module's docstring), so a spec's fallback is carried out
    as the reference's is."""
    if not rules:
        return
    shape = mesh_shape(mesh)
    for name, rule in rules.items():
        if name == "expert":
            continue
        got = _bound_axes(rule, shape)
        if name == "seq" and len(got) <= 1 and set(got) <= set(SEQ_AXES):
            continue
        want = _bound_axes(DEFAULT_RULES.get(name), shape)
        if got != want:
            raise NotImplementedError(
                f"axis rule {name!r} -> {rule!r} (the port binds "
                f"{name!r} to {want or None} on this mesh): its layers "
                f"do not carry it out ({_OTHER_ITEM})")


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[Dict] = None):
    """Bind logical axis names to *mesh* for the duration of the context.
    ``rules`` overrides :data:`DEFAULT_RULES` only where the layers carry
    the override out (:func:`check_rules`, which raises
    ``NotImplementedError`` otherwise)."""
    check_rules(mesh, rules)
    prev = (_ctx.mesh, _ctx.rules)
    _ctx.mesh = mesh
    _ctx.rules = dict(DEFAULT_RULES, **(rules or {}))
    _ctx.fallbacks = []
    try:
        yield
    finally:
        _ctx.mesh, _ctx.rules = prev


def active_mesh():
    return _ctx.mesh


@contextlib.contextmanager
def manual(axes: Sequence[str]):
    """Mark ``axes`` manual for the duration of the context: an enclosing
    step owns their reduction (the reference's ``shard_map`` binds them
    ``Manual``), so the layers issue no collective over them."""
    prev = _ctx.manual
    _ctx.manual = prev | frozenset(axes)
    try:
        yield
    finally:
        _ctx.manual = prev


def manual_axes() -> FrozenSet[str]:
    """The axes an enclosing step has marked manual (:func:`manual`)."""
    return _ctx.manual


def runs_whole(width: int):
    """A context for a mixer of ``width`` (its query heads, or Mamba's
    inner channels) that the ``model`` axis does not divide: the
    reference's divisibility fallback replicates it, so the mixer runs
    whole on every rank of ``model``, :func:`model_axis` ``None`` inside
    (no shard, no collective). Nothing is bound where the axis divides
    ``width`` or there is none."""
    tp = model_axis()
    if tp is None or width % tp.size == 0:
        return contextlib.nullcontext()
    return manual(("model",))


def current() -> Tuple[Any, ...]:
    """The binding in force: (mesh, rules, manual axes, sequence block,
    global batch)."""
    return _ctx.mesh, _ctx.rules, _ctx.manual, _ctx.block, _ctx.batch


@contextlib.contextmanager
def restored(state: Tuple[Any, ...]):
    """Bind what :func:`current` returned, for the duration."""
    prev = current()
    _ctx.mesh, _ctx.rules, _ctx.manual, _ctx.block, _ctx.batch = state
    try:
        yield
    finally:
        _ctx.mesh, _ctx.rules, _ctx.manual, _ctx.block, _ctx.batch = prev


@contextlib.contextmanager
def _global_batch(size: Optional[int]):
    """Bind the size of the global batch of which a rank holds a slice,
    for the duration; only ``launch.steps.rank_slice``, which takes the
    slice, binds it. The activations' cut (:func:`activation_axes`) and a
    MoE's tokens (:func:`replicated_rows`) are resolved on it, as the
    reference resolves them on its global arrays. Unbound, the batch a
    layer sees is taken to be the global one."""
    prev = _ctx.batch
    _ctx.batch = size
    try:
        yield
    finally:
        _ctx.batch = prev


def fallbacks() -> List[Tuple[str, int, int]]:
    """(logical_name, dim_size, required_divisor) replication fallbacks seen."""
    return list(_ctx.fallbacks)


def _mesh_axes_for(name: Optional[str], shape: Dict[str, int]
                   ) -> Tuple[str, ...]:
    if name is None:
        return ()
    rule = _ctx.rules.get(name, None)
    if rule is None:
        return ()
    axes = (rule,) if isinstance(rule, str) else tuple(rule)
    # drop axes not present in the active mesh (e.g. "pod" on single-pod)
    return tuple(a for a in axes if a in shape)


def resolve_spec(shape: Sequence[int], spec: LogicalSpec) -> Spec:
    """Logical spec -> physical spec with divisibility fallback."""
    if _ctx.mesh is None:
        raise RuntimeError("resolve_spec needs a mesh bound by axis_rules")
    sizes = mesh_shape(_ctx.mesh)
    out: List = []
    for dim, names in zip(shape, spec):
        if names is None:
            out.append(None)
            continue
        logical_names = (names,) if isinstance(names, str) else tuple(names)
        phys: List[str] = []
        for nm in logical_names:
            phys.extend(_mesh_axes_for(nm, sizes))
        if not phys:
            out.append(None)
            continue
        div = 1
        for a in phys:
            div *= sizes[a]
        if dim % div != 0:
            # Try dropping trailing physical axes until divisible (partial
            # sharding beats full replication), else replicate.
            while phys and dim % div != 0:
                dropped = phys.pop()
                div //= sizes[dropped]
            _ctx.fallbacks.append(
                ("/".join(map(str, logical_names)), dim, div))
        if not phys:
            out.append(None)
        elif len(phys) == 1:
            out.append(phys[0])
        else:
            out.append(tuple(phys))
    seen = [a for e in out if e is not None
            for a in ((e,) if isinstance(e, str) else e)]
    for a in seen:
        if seen.count(a) > 1:
            # the reference's PartitionSpec raises DuplicateSpecError
            raise ValueError(
                f"mesh axis {a!r} is mapped to two dimensions of the spec "
                f"{tuple(spec)} on shape {tuple(shape)} (resolved "
                f"{tuple(out)})")
    return tuple(out)


def _resolve_unrecorded(shape: Sequence[int], spec: LogicalSpec) -> Spec:
    """:func:`resolve_spec` with its fallbacks left out of
    :func:`fallbacks`, for a question asked again on every call."""
    seen = len(_ctx.fallbacks)
    try:
        return resolve_spec(shape, spec)
    finally:
        del _ctx.fallbacks[seen:]


def _seq_bound(shape: Dict[str, int]) -> bool:
    """Whether the bound rules cut a sequence over an axis of the mesh
    larger than 1."""
    return any(shape[a] > 1 for a in _mesh_axes_for("seq", shape))


@dataclasses.dataclass(frozen=True)
class SeqAxis:
    """The mesh axes a decode cache's sequence is cut on (the ``seq``
    rule, resolved on the cache's whole shape): their size, this rank's
    index on them (it holds block ``index`` of ``size`` contiguous blocks)
    and their process group."""
    axes: Tuple[str, ...]
    size: int
    index: int
    group: Any


def seq_cut(shape: Sequence[int], spec: LogicalSpec, *,
            record: bool = True) -> Optional[SeqAxis]:
    """How the bound ``seq`` rule cuts dimension 1, the sequence, of a
    cache leaf of whole shape ``shape`` and logical ``spec``
    (:func:`resolve_spec`:
    a length the axes do not divide stays whole, the fallback recorded
    unless ``record`` is false, as a decode step asks again every call;
    a mesh axis mapped twice raises ``ValueError``). ``None`` where no
    mesh is bound, ``seq`` binds no axis larger than 1, or the dim stays
    whole."""
    mesh = _ctx.mesh
    if mesh is None or not _seq_bound(mesh_shape(mesh)):
        return None
    e = (resolve_spec if record else _resolve_unrecorded)(shape, spec)[1]
    if e is None:
        return None
    axes = (e,) if isinstance(e, str) else tuple(e)
    sizes = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    if n <= 1:
        return None
    return _seq_axis(mesh, axes)


def _seq_axis(mesh, axes: Tuple[str, ...]) -> SeqAxis:
    """The :class:`SeqAxis` over ``axes`` of ``mesh``, made once (its
    group: the first call for these axes must be made on every rank)."""
    held = mesh.__dict__.setdefault("_repro_seq_axes", {})
    if axes not in held:
        sizes = mesh_shape(mesh)
        n = 1
        for a in axes:
            n *= sizes[a]
        held[axes] = SeqAxis(axes, n, mesh_lib.coordinate(mesh, axes),
                             mesh_lib.axes_group(mesh, axes))
    return held[axes]


def activation_axes(batch: int, seq_len: int, vocab: Optional[int] = None
                    ) -> Optional[Tuple[str, ...]]:
    """The mesh axes the bound ``seq`` rule cuts the sequence of a prefill's
    or a train step's activations over, ``None`` where it stays whole.

    Resolved as the reference's constraints resolve it: the logits'
    ``("batch", "seq", "vocab")`` on ``(batch, seq_len, vocab)`` (without
    ``vocab``, the encoder's ``("batch", "seq", "embed")``), whenever the
    rule binds an axis of the mesh, of any size; ``batch`` is the global
    batch where ``launch.steps.rank_slice`` binds one. A length the axes
    do not divide stays whole, the fallback recorded; a mesh axis mapped twice
    raises ``ValueError`` (the reference's ``DuplicateSpecError``): the
    batch and the sequence on ``data`` where the batch divides, the
    sequence and the vocabulary on ``model`` where the vocabulary
    divides. Every other cut runs: the sequence over ``data`` beside a
    batch that falls back whole or is cut over ``pod``, and over
    ``model`` beside a vocabulary that falls back, or in the encoder."""
    mesh = _ctx.mesh
    if mesh is None:
        return None
    sizes = mesh_shape(mesh)
    if not _mesh_axes_for("seq", sizes):
        return None
    shape, spec = (_ctx.batch or batch, seq_len), ("batch", "seq")
    if vocab is not None:
        shape, spec = shape + (vocab,), spec + ("vocab",)
    e = resolve_spec(shape, spec)[1]
    axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
    n = 1
    for a in axes:
        n *= sizes[a]
    return axes if n > 1 else None


def batch_axes_of(batch: int) -> Tuple[str, ...]:
    """The mesh axes the bound rules cut a batch of ``batch`` on (its
    ``("batch",)`` spec resolved, the fallback not recorded); ``()`` where
    it is whole on every rank."""
    e = _resolve_unrecorded((batch,), ("batch",))[0]
    return () if e is None else ((e,) if isinstance(e, str) else tuple(e))


@dataclasses.dataclass(frozen=True)
class SeqBlock:
    """This rank's block of a sequence cut over ``axis``: positions
    ``[start, start + length)`` of ``total``."""
    axis: SeqAxis
    start: int
    length: int
    total: int


def activation_cut(batch: int, seq_len: int, vocab: Optional[int] = None
                   ) -> Optional[SeqBlock]:
    """This rank's :class:`SeqBlock` of the activations' sequence
    (:func:`activation_axes`), ``None`` where it stays whole."""
    axes = activation_axes(batch, seq_len, vocab)
    if axes is None:
        return None
    cut = _seq_axis(_ctx.mesh, axes)
    L = seq_len // cut.size
    return SeqBlock(cut, cut.index * L, L, seq_len)


def check_logits(batch: int, length: int, vocab: int) -> None:
    """Raise ``ValueError`` where the reference's constraint on logits of
    ``(batch, length, vocab)`` maps one mesh axis twice (a chunk of the
    chunked loss); nothing is recorded."""
    if _ctx.mesh is not None and \
            _mesh_axes_for("seq", mesh_shape(_ctx.mesh)):
        _resolve_unrecorded((_ctx.batch or batch, length, vocab),
                            ("batch", "seq", "vocab"))


@contextlib.contextmanager
def cut_sequence(block: Optional[SeqBlock]):
    """Bind ``block`` (or nothing) for the layers (:func:`seq_block`) for
    the duration."""
    prev = _ctx.block
    _ctx.block = block
    try:
        yield
    finally:
        _ctx.block = prev


def seq_block() -> Optional[SeqBlock]:
    """The sequence block bound by :func:`cut_sequence`, ``None`` where the
    activations run whole."""
    return _ctx.block


def block_rows(t: Optional[torch.Tensor], dim: int = 1
               ) -> Optional[torch.Tensor]:
    """This rank's rows of ``t``, a whole sequence's along ``dim`` (the
    positions), where a block is bound; ``t`` itself otherwise."""
    block = _ctx.block
    if t is None or block is None:
        return t
    return t.narrow(dim, block.start, block.length)


def _model_cut(block: Optional[SeqBlock]) -> bool:
    """Whether ``block`` is cut over ``model`` (sequence parallelism)."""
    return block is not None and "model" in block.axis.axes


class _EnterSeq(torch.autograd.Function):
    """Every rank's block concatenated along dim 1 (one all-gather); the
    backward keeps this rank's rows of a gradient that every rank holds
    whole and alike (the tensor-parallel layer's ``copy_to_model`` has
    summed it over ``model``)."""

    @staticmethod
    def forward(ctx, x, block):
        ctx.block = block
        return mesh_lib.all_gather(x, block.axis.group, 1)

    @staticmethod
    def backward(ctx, g):
        b = ctx.block
        return g.narrow(1, b.start, b.length), None


class _LeaveSeq(torch.autograd.Function):
    """This rank's rows (dim 1) of a whole sequence that every rank holds
    alike; the backward gathers every rank's rows' gradient (one
    all-gather), which is then whole and alike on every rank."""

    @staticmethod
    def forward(ctx, y, block):
        ctx.block = block
        return y.narrow(1, block.start, block.length).contiguous()

    @staticmethod
    def backward(ctx, g):
        return mesh_lib.all_gather(g, ctx.block.axis.group, 1), None


def enter_seq(x: torch.Tensor, block: SeqBlock) -> torch.Tensor:
    """The whole sequence from every rank's block ``x`` of a sequence cut
    over ``model``, for a tensor-parallel layer (:func:`tp_layer`) or the
    encoder's memory, whose gradient arrives whole on every rank: one
    all-gather, and in the backward this rank's rows, no collective."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _EnterSeq.apply(x, block)
    return mesh_lib.all_gather(x, block.axis.group, 1)


def leave_seq(y: torch.Tensor, block: SeqBlock) -> torch.Tensor:
    """This rank's block of ``y``, a whole sequence every rank of ``model``
    holds alike (the row-parallel product's all-reduce has summed it):
    with that all-reduce a reduce-scatter; the backward all-gathers the
    blocks' gradients."""
    if torch.is_grad_enabled() and y.requires_grad:
        return _LeaveSeq.apply(y, block)
    return y.narrow(1, block.start, block.length).contiguous()


def block_leaf(w: torch.Tensor) -> torch.Tensor:
    """``w``, a leaf (or a whole tensor: the encoder's memory) that every
    rank of ``model`` keeps whole and applies to its block of a sequence
    cut over ``model``, entered with a backward that sums its gradient
    over the axis, so that it is the whole sequence's on every rank. ``w``
    itself where no such block is bound, or no gradient is taken."""
    block = _ctx.block
    if not _model_cut(block) or not (torch.is_grad_enabled()
                                     and w.requires_grad):
        return w
    return _CopyToModel.apply(w, block.axis.group)


def tp_layer(width: int, fn: Callable, p, x: torch.Tensor, *whole,
             **kw):
    """``fn(p, x, *whole, **kw)``, a layer of ``width`` heads, channels or
    ``ff`` columns, on this rank, returning its output (with, as a tuple,
    what follows it: a cache, an aux loss). Where the ``model`` axis does
    not divide ``width`` the layer runs whole on every rank, ``model``
    manual inside (:func:`runs_whole`: the reference's fallback); on a
    block of a sequence cut over ``model`` its leaves and ``whole`` (the
    encoder's memory) then enter through :func:`block_leaf`. Where the
    axis divides ``width`` and the sequence is cut over it (sequence
    parallelism) the layer runs its shard on the whole sequence: ``x``
    gathered (:func:`enter_seq`), no block bound inside (its positions
    are the whole sequence's), and its output, which the row-parallel
    product has summed over ``model``, cut back to the block
    (:func:`leave_seq`). Otherwise ``fn`` as it is."""
    tp = model_axis()
    block = _ctx.block
    if tp is not None and width % tp.size == 0:
        if not _model_cut(block):
            return fn(p, x, *whole, **kw)
        with cut_sequence(None):
            out = fn(p, enter_seq(x, block), *whole, **kw)
        if isinstance(out, tuple):
            return (leave_seq(out[0], block),) + tuple(out[1:])
        return leave_seq(out, block)
    with runs_whole(width):
        if _model_cut(block):
            p = {k: block_leaf(v) for k, v in p.items()}
            whole = tuple(block_leaf(t) for t in whole)
        return fn(p, x, *whole, **kw)


def replicated_rows(batch: int) -> Optional[SeqAxis]:
    """Where the reference's MoE replicates its tokens over the batch
    axes (its ``shard_map`` cuts them over the axes that are not manual
    only where their product divides the global batch) but this rank
    holds a slice of ``batch`` rows of the global batch (bound by
    ``launch.steps.rank_slice``): the axes that slice was cut on, whose
    ranks' rows the MoE gathers. ``None`` elsewhere."""
    mesh, B = _ctx.mesh, _ctx.batch
    if mesh is None or B is None or B == batch:
        return None
    shape = mesh_shape(mesh)
    dp = 1
    for a in mesh_lib.batch_axes(mesh):
        if a not in manual_axes():
            dp *= shape[a]
    axes = batch_axes_of(B)
    if dp <= 1 or B % dp == 0 or not axes:
        return None
    return _seq_axis(mesh, axes)


def gather_rows(x: torch.Tensor, cut: SeqAxis) -> torch.Tensor:
    """Every rank's rows (dim 0) of ``x`` over ``cut``'s group, in order
    (one counted all-gather); differentiable, its backward one
    all-reduce over the group and this rank's rows."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherSeq.apply(x, cut, 0)
    return mesh_lib.all_gather(x, cut.group, 0)


class _GatherSeq(torch.autograd.Function):
    """Every rank's block concatenated along ``dim``; its backward is this
    rank's slice of the gradients summed over the group (an all-reduce,
    then the slice)."""

    @staticmethod
    def forward(ctx, x, cut, dim):
        ctx.cut, ctx.dim, ctx.n = cut, dim, x.shape[dim]
        return mesh_lib.all_gather(x, cut.group, dim)

    @staticmethod
    def backward(ctx, g):
        g = mesh_lib.all_reduce(g.contiguous().clone(), ctx.cut.group)
        return g.narrow(ctx.dim, ctx.cut.index * ctx.n, ctx.n), None, None


def gather_seq(x: torch.Tensor, block: SeqBlock, dim: int = 1
               ) -> torch.Tensor:
    """The whole sequence from every rank's block ``x`` along ``dim``
    (one counted all-gather); differentiable, its backward one all-reduce
    over the axis."""
    dim = dim % x.dim()
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherSeq.apply(x, block.axis, dim)
    return mesh_lib.all_gather(x, block.axis.group, dim)


def halo(x: torch.Tensor, k: int, block: SeqBlock
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` rows (along dim 1) just before this rank's block ``x``
    (zeros before the first block) and the whole sequence's last ``k``
    rows (zeros before its first), from one :func:`gather_seq` of each
    block's last ``k`` rows (the whole block where it is shorter). The
    gradient of each row goes back to the rank that sent it."""
    e = min(k, block.length)
    every = gather_seq(x[:, block.length - e:].contiguous(), block)
    pad = x.new_zeros((x.shape[0], k) + tuple(x.shape[2:]))
    before = torch.cat([pad, every[:, :block.axis.index * e]], 1)
    return before[:, -k:], torch.cat([pad, every], 1)[:, -k:]


class _Relay(torch.autograd.Function):
    """:func:`relay_scan` with a gradient: the forward's rounds, then the
    backward's in reverse, each rank's vjp given the cotangent of its
    final state by the next rank's."""

    @staticmethod
    def forward(ctx, fwd, vjp, cut, final, s_init, *inputs):
        y, s0, s_last = _relay_forward(fwd, cut, final, s_init, inputs)
        ctx.vjp, ctx.cut = vjp, cut
        ctx.save_for_backward(s0, *inputs)
        if s_last is not None:
            ctx.mark_non_differentiable(s_last)
        return y, s_last

    @staticmethod
    def backward(ctx, gy, _gs_last):
        s0, *inputs = ctx.saved_tensors
        cut = ctx.cut
        needs = tuple(ctx.needs_input_grad[5:])
        grads, gs = None, None
        for j in reversed(range(cut.size)):
            if j == cut.index:
                *grads, ds0 = ctx.vjp(*inputs, s0, gy, gs,
                                      needs + (j > 0,))
            if j > 0:
                sent = ds0 if j == cut.index else torch.zeros_like(s0)
                got = mesh_lib.all_gather(sent.contiguous(), cut.group, 0)
                if cut.index == j - 1:
                    gs = got.narrow(0, j * s0.shape[0], s0.shape[0])
        return (None, None, None, None, None, *grads)


def _relay_forward(fwd, cut, final, s_init, inputs):
    """The rounds of :func:`relay_scan`: (y, this rank's initial state,
    the last rank's final state or ``None``)."""
    n, me = cut.size, cut.index
    s0, y, s_out, s_last = s_init, None, None, None
    B = s_init.shape[0]
    for j in range(n if final else n - 1):
        if j == me:
            y, s_out = fwd(*inputs, s0)
        sent = s_out if j == me else torch.zeros_like(s_init)
        got = mesh_lib.all_gather(sent.contiguous(), cut.group, 0)
        got = got.narrow(0, j * B, B)
        if j == me - 1:
            s0 = got.to(s_init.dtype)
        if j == n - 1:
            s_last = got
    if y is None:                       # the last rank, without `final`
        y, _ = fwd(*inputs, s0)
    return y, s0, s_last


class _SumOverSeq(torch.autograd.Function):
    """The sums of ``total`` and ``count`` over the group (one all-reduce);
    the backward is the all-reduce's adjoint for a cotangent that every
    rank holds alike (the loss is the same on every rank): ``n`` times it,
    with no collective, where the group is a batch axis that the step
    averages over; the cotangent itself over ``model``, where each rank's
    gradient is the whole loss's; ``count`` takes none."""

    @staticmethod
    def forward(ctx, total, count, cut):
        ctx.n = 1 if "model" in cut.axes else cut.size
        both = torch.stack([total.float(), count.float()])
        mesh_lib.all_reduce(both, cut.group)
        return both[0].to(total.dtype), both[1].to(count.dtype)

    @staticmethod
    def backward(ctx, g, _gc):
        return g * ctx.n, None, None


def sum_over_seq(total: torch.Tensor, count: torch.Tensor, block: SeqBlock
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``total``, ``count``) summed over the sequence's axis: a loss's
    masked sum and its count of valid positions, so that their ratio is
    the whole sequence's mean on every rank. Over ``data`` the step
    averages the ranks' gradients, and each rank's is its blocks' share
    of ``n`` times the whole loss's: their mean is the whole loss's
    gradient. Over ``model`` each rank's is its block's share, and the
    collectives of the layers and :func:`block_leaf` make every leaf's
    the whole loss's."""
    return _SumOverSeq.apply(total, count.detach(), block.axis)


def relay_scan(fwd: Callable, vjp: Callable, inputs: Sequence[torch.Tensor],
               s_init: torch.Tensor, block: SeqBlock, *, final: bool
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A recurrence over a sequence cut into blocks: ``fwd(*inputs, s0) ->
    (y, s_out)`` runs on each rank's block once the state with which the
    previous rank's block ended has reached it (``s_init``, of the
    state's shape and dtype, on the first rank), one counted all-gather a
    round, ``n - 1`` rounds; with ``final`` one more, which gives every
    rank the last rank's final state. Returns (y, that state or ``None``).
    Differentiable in ``inputs`` (not ``s_init``, nor the final state):
    ``vjp(*inputs, s0, gy, gs, needs) -> (d inputs..., ds0)`` runs in the
    backward's ``n - 1`` rounds in reverse, each rank's ``ds0`` the
    previous rank's cotangent of its final state."""
    cut = block.axis
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _Relay.apply(fwd, vjp, cut, final, s_init, *inputs)
    y, _, s_last = _relay_forward(fwd, cut, final, s_init, tuple(inputs))
    return y, s_last


def logical(x: torch.Tensor, *spec: Union[str, None, Tuple[str, ...]]):
    """The reference's sharding constraint: the rank check, then the
    identity (see the module's docstring)."""
    if _ctx.mesh is None:
        return x
    if len(spec) != x.dim():
        raise ValueError(f"spec {spec} rank != array rank {x.dim()}")
    return x


def named_sharding(shape: Sequence[int], spec: LogicalSpec):
    """DTensor placements for the resolved spec: per mesh axis,
    ``Shard(d)`` for the tensor dim it shards, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    if _ctx.mesh is None:
        raise RuntimeError("named_sharding needs a mesh bound by axis_rules")
    phys = resolve_spec(shape, spec)
    by_axis = {}
    for d, e in enumerate(phys):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            by_axis[a] = d
    return tuple(Shard(by_axis[a]) if a in by_axis else Replicate()
                 for a in mesh_shape(_ctx.mesh))


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The ``model`` axis of the bound mesh: its size, this rank's index
    on it and its process group."""
    size: int
    index: int
    group: Any


def model_axis() -> Optional[ModelAxis]:
    """The bound mesh's ``model`` axis when it is larger than 1 and not
    manual; ``None`` otherwise (the layers then run whole, with no
    collective)."""
    mesh = _ctx.mesh
    if mesh is None or "model" in manual_axes() or \
            mesh_shape(mesh).get("model", 1) <= 1:
        return None
    held = mesh.__dict__.get("_repro_model_axis")
    if held is None:
        held = ModelAxis(mesh_shape(mesh)["model"],
                         mesh_lib.coordinate(mesh, ("model",)),
                         mesh_lib.axes_group(mesh, ("model",)))
        mesh.__dict__["_repro_model_axis"] = held
    return held


class _CopyToModel(torch.autograd.Function):
    """The identity; its backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return mesh_lib.all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the group, in ``dtype``, cast back to x's dtype; its
    backward is the identity."""

    @staticmethod
    def forward(ctx, x, group, dtype):
        y = x.to(dtype, copy=True).contiguous()
        mesh_lib.all_reduce(y, group)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _MeanFromBatch(torch.autograd.Function):
    """The mean over the group; its backward is the identity (the step's
    average of the gradients over the same ranks supplies the 1 / n)."""

    @staticmethod
    def forward(ctx, x, group, n):
        y = x.clone().contiguous()
        mesh_lib.all_reduce(y, group)
        return y / torch.full((), float(n), dtype=y.dtype, device=y.device)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Enter a column-parallel region: ``x`` (replicated over ``model``)
    as it is, with a backward that all-reduces the ranks' partial
    gradients over ``model``. The identity without a model axis, or when
    no gradient is taken."""
    tp = model_axis()
    if tp is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, tp.group)


def local_size(width: int) -> int:
    """This rank's share of ``width`` heads or channels that the
    ``model`` axis cuts: ``width / tp``, or ``width`` without a model axis
    (and inside :func:`runs_whole`)."""
    tp = model_axis()
    return width if tp is None else width // tp.size


def local_part(w: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's piece along ``dim`` of ``w``, a leaf (or activation)
    that every rank of ``model`` keeps whole but reads only at its own
    heads or channels: entered through :func:`copy_to_model`, so that its
    gradient, each rank's at its own piece, is summed over ``model``.
    ``w`` itself without a model axis."""
    tp = model_axis()
    if tp is None:
        return w
    k = w.shape[dim] // tp.size
    return copy_to_model(w).narrow(dim, tp.index * k, k)


def reduce_from_model(x: torch.Tensor, dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """Leave a row-parallel region: the sum of the ranks' partial ``x``
    over ``model`` (an all-reduce in ``dtype``, x's own by default), whose
    backward is the identity. The identity without a model axis."""
    tp = model_axis()
    if tp is None:
        return x
    return _ReduceFromModel.apply(x, tp.group, dtype or x.dtype)


def mean_over_batch(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the bound mesh's batch axes that are not
    manual (the reference's ``pmean``), with the identity for backward:
    the step averages the gradients over the same ranks. The identity
    when those axes have size 1."""
    mesh = _ctx.mesh
    if mesh is None:
        return x
    shape = mesh_shape(mesh)
    manual = manual_axes()
    axes = tuple(a for a in mesh_lib.batch_axes(mesh)
                 if a not in manual and shape[a] > 1)
    if not axes:
        return x
    n = 1
    for a in axes:
        n *= shape[a]
    return _MeanFromBatch.apply(x, mesh_lib.axes_group(mesh, axes), n)


def gather_from_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Every model rank's ``x`` concatenated along ``dim`` (no gradient);
    ``x`` without a model axis."""
    tp = model_axis()
    if tp is None:
        return x
    return mesh_lib.all_gather(x.detach(), tp.group, dim % x.dim())


def tp_row_matmul(h: torch.Tensor, w: torch.Tensor, shard_name: str = "ff"
                  ) -> torch.Tensor:
    """Row-parallel product: ``h`` (..., F / tp) times this rank's rows of
    ``w`` (F / tp, D), summed over ``model``; ``h @ w`` without a model
    axis. ``shard_name`` is the logical axis of the contraction, as in the
    reference's signature (``"heads"`` for ``wo``, ``"ff"`` for
    ``w_down``).

    Each rank's partial product is rounded to the product's dtype. Under
    ``REPRO_BF16_TP=1`` the partials are summed in that dtype (bf16 for a
    bf16 model: the reference's explicit ``shard_map`` ``psum``); the
    reference falls back to a plain matmul where the shapes do not divide
    the mesh, and so does the port: a layer whose contraction width the
    axis does not divide runs whole (:func:`runs_whole`), where
    :func:`model_axis` is ``None`` and this is ``h @ w``.
    Otherwise they are summed in float32 and the sum rounded back: the
    reference leaves this sum to GSPMD, and its compiled HLO at a
    ``(data 1, model 2)`` mesh (``jax.jit(...).lower(...).compile()`` of
    the bf16 smoke Qwen2's prefill on the CPU) all-reduces
    ``f32[B, S, D]``, each partial ``dot`` rounded to bf16 first."""
    if h.shape[-1] != w.shape[0]:
        raise ValueError(f"tp_row_matmul: h {tuple(h.shape)} and "
                         f"w {tuple(w.shape)} over '{shard_name}' differ")
    out = h @ w
    if model_axis() is None:
        return out
    bf16 = bool(os.environ.get("REPRO_BF16_TP"))
    return reduce_from_model(out, out.dtype if bf16 else torch.float32)


class Halves(str):
    """A spec entry for a dim made of two equal halves, each cut over the
    mesh axis it names: a rank holds its piece of the first half and its
    piece of the second, side by side (Mamba's ``in_proj`` columns
    ``[x | z]``, so that a rank's product splits into its own channels of
    ``x`` and of ``z``). It is the axis name (``Halves("model") ==
    "model"``) to every reader but :func:`shard_of` and
    :func:`gather_full`."""


def shard_of(full: torch.Tensor, spec: Sequence, mesh=None) -> torch.Tensor:
    """This rank's slice of the whole leaf ``full`` under its resolved
    ``spec`` (a view, but for a :class:`Halves` dim): each sharded dim cut
    into the product of its axes' sizes, the piece at this rank's flat
    coordinate on them (of each half, for a :class:`Halves` dim)."""
    mesh = mesh if mesh is not None else _ctx.mesh
    shape = mesh_shape(mesh)
    out = full
    for d, e in enumerate(spec):
        if e is None:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        n = 1
        for a in axes:
            n *= shape[a]
        at = mesh_lib.coordinate(mesh, axes)
        if isinstance(e, Halves):
            k = full.shape[d] // (2 * n)
            out = torch.cat([h.narrow(d, at * k, k)
                             for h in out.chunk(2, d)], d)
            continue
        k = full.shape[d] // n
        out = out.narrow(d, at * k, k)
    return out


def gather_full(local: torch.Tensor, spec: Sequence, mesh=None
                ) -> torch.Tensor:
    """The whole leaf from every rank's :func:`shard_of` slice: an
    all-gather over each sharded dim's axes (every rank of those axes
    joins), a :class:`Halves` dim's pieces put back in their halves."""
    mesh = mesh if mesh is not None else _ctx.mesh
    out = local.detach()
    for d, e in enumerate(spec):
        if e is None:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        pieces = out.shape[d]
        out = mesh_lib.all_gather(out, mesh_lib.axes_group(mesh, axes), d)
        if isinstance(e, Halves):
            parts = out.split(pieces, d)
            out = torch.cat([p.narrow(d, 0, pieces // 2) for p in parts] +
                            [p.narrow(d, pieces // 2, pieces // 2)
                             for p in parts], d)
    return out
