"""AdamW + cosine schedule + global-norm clipping, in PyTorch.

The counterpart of ``repro.optim.adamw`` on one card: ``OptState``,
``cosine_lr``, ``init_opt_state``, ``global_norm``,
``clip_by_global_norm``, the decay mask and ``adamw_update``. A parameter
tree is a dict from a parameter's name to its tensor
(``dict(model.params.named_parameters())``). Every rounding the
reference makes is kept: the clipped gradient is cast back to the
gradient's dtype, the update is computed in float32, the moments are
stored in ``cfg.state_dtype`` and the parameter is cast back to its dtype.
The scalars (step, learning rate, bias corrections, clip scale) are
float32 tensors made on the parameters' device, so the host never waits
for the device in a step, and a tensor is divided by a tensor, never by
a Python number (which PyTorch turns into a product with its
reciprocal).

Where the reference returns new trees, :func:`adamw_update` writes the
parameters and the moments in place, under ``torch.no_grad()``, a leaf at
a time and a slice of at most :data:`CHUNK` elements at a time: one
float32 copy of every parameter at once would not fit beside a 7B
model's state on one card.

ZeRO-1 (``cfg.zero1`` under a mesh): :func:`opt_state_spec` follows the
reference's rule (the moments shard the first unsharded dim that the
``pod x data`` size divides and that is larger than 1), and
:func:`zero1_layout` turns it into a :class:`Zero1`: each rank keeps
``mu`` and ``nu`` for its slice of that dim only, updates its slice of
the parameter from the reduced gradient (which every rank holds whole),
and the slices are all-gathered into the parameter. The global norm for
clipping is taken over the whole reduced gradients, and the update is
elementwise, so ZeRO-1 on and off give the same bits.

Tensor parallelism (a ``model`` axis larger than 1): each rank holds its
shard of a model-sharded leaf, and ZeRO-1 slices the shard over ``pod x
data`` on the dim the reference's rule picks on the whole leaf (an
unsharded dim, whose size the shard keeps). :func:`global_norm` takes
:class:`ModelShards`: the float32 sum of squares of the sharded leaves is
all-reduced over ``model`` and each replicated leaf counts once, so the
norm is the reference's, over the logical arrays. The port's
per-layer leaves have no period axis, so the dim a stacked leaf shards
may differ from the reference's choice on it (which may be the period
axis); the bits do not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd
from repro_torch.models.convert import jax_path

Tree = Dict[str, torch.Tensor]

# elements of a leaf updated at once (float32 temporaries of 64 MiB each)
CHUNK = 1 << 24


class OptState(NamedTuple):
    step: torch.Tensor                # int32 scalar
    mu: Tree                          # first moment
    nu: Tree                          # second moment


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a float32 scalar on ``like``'s device, made there (a fill,
    not a copy from the host, which would wait for the device)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def cosine_lr(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac * lr``."""
    step = step.float()
    warm = cfg.lr * step / _f32(max(1.0, cfg.warmup_steps), step)
    total = _f32(max(1.0, cfg.total_steps - cfg.warmup_steps), step)
    frac = torch.clamp((step - cfg.warmup_steps) / total, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1.0 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


@dataclasses.dataclass(frozen=True)
class Zero1:
    """The moments' ZeRO-1 layout on this rank: each leaf's sharded dim
    (``None``: the leaf is kept whole), this rank's index among the
    ``size`` ranks of ``pod x data`` and their process group."""
    dims: Dict[str, Optional[int]]
    index: int
    size: int
    group: Any

    def shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole leaf ``t`` (a view)."""
        d = self.dims[name]
        if d is None:
            return t
        k = t.shape[d] // self.size
        return t.narrow(d, self.index * k, k)

    def gather(self, name: str, part: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's slice (an all-gather)."""
        d = self.dims[name]
        if d is None:
            return part
        return mesh_lib.all_gather(part, self.group, d)


@dataclasses.dataclass(frozen=True)
class ModelShards:
    """The leaves split over the ``model`` axis, and its process group."""
    names: frozenset
    group: Any


def model_shards(spec: Optional[Dict[str, tuple]], mesh
                 ) -> Optional[ModelShards]:
    """The :class:`ModelShards` of parameters with ``spec`` (``Model.spec``)
    on ``mesh``; ``None`` when its ``model`` axis is 1."""
    if mesh is None or mesh_lib.model_size(mesh) <= 1:
        return None
    names = frozenset(n for n, sp in spec.items()
                      if any(e == "model" or (isinstance(e, tuple)
                                              and "model" in e) for e in sp))
    return ModelShards(names, mesh_lib.axes_group(mesh, ("model",)))


def opt_state_spec(cfg: OptimizerConfig, params: Tree,
                   pspec: Dict[str, tuple]) -> OptState:
    """Spec tree for the optimizer state under the bound axis rules.

    With ``zero1``, moments additionally shard the first dim that is
    unsharded, larger than 1 and divisible by the ``pod x data`` size over
    those axes; otherwise they mirror the parameter specs."""
    def zspec(leaf, spec):
        if not cfg.zero1:
            return spec
        mesh = shd.active_mesh()
        if mesh is None:
            return spec
        ddp_axes = mesh_lib.batch_axes(mesh)
        if not ddp_axes:
            return spec
        shape = mesh_lib.mesh_shape(mesh)
        ddp = 1
        for a in ddp_axes:
            ddp *= shape[a]
        entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
        # shard the first dim that is unsharded and divisible by ddp
        for i, e in enumerate(entries):
            if e is None and leaf.shape[i] % ddp == 0 and leaf.shape[i] > 1:
                entries[i] = ddp_axes if len(ddp_axes) > 1 else ddp_axes[0]
                return tuple(entries)
        return spec

    mspec = {n: zspec(p, pspec[n]) for n, p in params.items()}
    return OptState(step=(), mu=mspec, nu=dict(mspec))


def zero1_layout(cfg: OptimizerConfig, params: Tree, model_cfg: ModelConfig,
                 mesh) -> Optional[Zero1]:
    """The :class:`Zero1` layout of ``params`` (this rank's shards) on
    ``mesh`` (``None`` when ``cfg.zero1`` is off): the dim
    :func:`opt_state_spec` shards for each leaf, under the mesh's rules,
    from the specs of the whole leaves (``transformer.tp_param_spec``)."""
    if not cfg.zero1:
        return None
    from repro_torch.models.transformer import tp_param_spec
    pspec = tp_param_spec(model_cfg, mesh)
    with shd.axis_rules(mesh):
        ospec = opt_state_spec(cfg, params, pspec)
    dims = {}
    for n, p in params.items():
        before = list(pspec[n]) + [None] * (p.dim() - len(pspec[n]))
        after = list(ospec.mu[n]) + [None] * (p.dim() - len(ospec.mu[n]))
        dims[n] = next((i for i, (a, b) in enumerate(zip(before, after))
                        if a != b), None)
    axes = mesh_lib.batch_axes(mesh)
    return Zero1(dims=dims, index=mesh_lib.coordinate(mesh, axes),
                 size=mesh_lib.dp_size(mesh),
                 group=mesh_lib.axes_group(mesh, axes))


def init_opt_state(cfg: OptimizerConfig, params: Tree,
                   zero: Optional[Zero1] = None) -> OptState:
    """Zero moments in ``cfg.state_dtype``, step 0, on the parameters'
    device; under ``zero`` only this rank's slice of each moment."""
    dt = getattr(torch, cfg.state_dtype)
    dev = next(iter(params.values())).device
    shape = (lambda n, p: p.shape) if zero is None else \
        (lambda n, p: zero.shard(n, p).shape)
    zeros = lambda: {n: torch.zeros(shape(n, p), dtype=dt, device=p.device)
                     for n, p in params.items()}
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=zeros(), nu=zeros())


def global_norm(tree: Tree, shards: Optional[ModelShards] = None
                ) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares;
    with ``shards``, the sharded leaves' sum all-reduced over ``model``
    first."""
    ss = {n: torch.sum(torch.square(x.float())) for n, x in tree.items()}
    if shards is None:
        return torch.sqrt(torch.sum(torch.stack(list(ss.values()))))
    dev = next(iter(tree.values())).device
    part = [v for n, v in ss.items() if n in shards.names]
    whole = [v for n, v in ss.items() if n not in shards.names]
    total = torch.sum(torch.stack(part)) if part else \
        torch.zeros((), device=dev)
    mesh_lib.all_reduce(total, shards.group)
    if whole:
        total = total + torch.sum(torch.stack(whole))
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(_f32(max_norm, norm) / (norm + 1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The clipped gradient as the reference rounds it: scaled in float32
    and cast back to the gradient's dtype."""
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(tree: Tree, max_norm: float) -> Tuple[Tree,
                                                              torch.Tensor]:
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return {n: _clipped(g, scale) for n, g in tree.items()}, norm


_NO_DECAY_SUFFIXES = ("scale", "bias", "b_up", "b_down", "bq", "bk", "bv",
                      "dt_bias", "u", "w0", "mu_x", "mu_k", "mu_r",
                      "gn_scale", "gn_bias", "router_bias")


def decay_mask(cfg: ModelConfig, params: Tree) -> Dict[str, float]:
    """1.0 for matrices (decayed), 0.0 for norms, biases and gains, by the
    reference's rule on its own leaves: the leaf's name (the last part of
    its path) and its rank in the reference's tree, where the body's
    leaves carry a leading period axis (``models.convert.jax_path``). So a
    body layer's 1-D ``D`` (Mamba) or ``q_norm`` (MLA) is decayed, as
    there, and a prefix layer's is not."""
    out = {}
    for n, p in params.items():
        path, stacked = jax_path(n, cfg)
        leaf = path.split("/")[-1]
        ndim = p.dim() + stacked
        out[n] = 0.0 if leaf in _NO_DECAY_SUFFIXES or ndim <= 1 else 1.0
    return out


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params: Tree, grads: Tree,
                 state: OptState, decay: Dict[str, float],
                 zero: Optional[Zero1] = None,
                 shards: Optional[ModelShards] = None
                 ) -> Tuple[Tree, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place: the gradients clipped by their global
    norm, the step counted, ``cosine_lr`` at the new step, the bias
    corrections, then each leaf's moments and parameter written where
    they are. ``decay`` is :func:`decay_mask`'s. Under ``zero`` (the
    moments' ZeRO-1 layout) a sharded leaf's slice is updated and the
    slices gathered into the parameter; under ``shards`` the global norm
    is taken over the whole leaves (:func:`global_norm`). Returns (params,
    the new state, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads, shards)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(_f32(b1, lr), step.float())
    c2 = 1.0 - torch.pow(_f32(b2, lr), step.float())
    sdt = getattr(torch, cfg.state_dtype)
    for n, p in params.items():
        g, m, v = grads[n], state.mu[n], state.nu[n]
        wd = cfg.weight_decay * decay[n]
        if zero is not None and zero.dims[n] is not None:
            part = zero.shard(n, p).contiguous()
            _update_leaf(part, zero.shard(n, g), m, v, scale, lr, c1, c2,
                         wd, cfg, sdt)
            p.copy_(zero.gather(n, part))
        else:
            _update_leaf(p, g, m, v, scale, lr, c1, c2, wd, cfg, sdt)
    return params, OptState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}


def _update_leaf(p, g, m, v, scale, lr, c1, c2, wd, cfg, sdt) -> None:
    b1, b2 = cfg.b1, cfg.b2
    # views of p, m and v (written through); g is only read
    pieces = zip(*(t.view(-1).split(CHUNK) for t in (p, m, v)),
                 g.reshape(-1).split(CHUNK))
    for pc, mc, vc, gc in pieces:
        g32 = _clipped(gc, scale).float()
        m_new = b1 * mc.float() + (1 - b1) * g32
        v_new = b2 * vc.float() + (1 - b2) * torch.square(g32)
        del g32
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
        p32 = pc.float()
        delta += wd * p32
        pc.copy_(p32 - lr * delta)
        mc.copy_(m_new.to(sdt))
        vc.copy_(v_new.to(sdt))
