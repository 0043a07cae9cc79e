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
model's state on one card. The ZeRO-1 sharding of the moments
(``opt_state_spec``) and the int8 gradient compression
(``optim/compress.py``) wait for the mesh (``ROADMAP.md`` Queue 1 items
10b and 11).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig
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


def init_opt_state(cfg: OptimizerConfig, params: Tree) -> OptState:
    """Zero moments in ``cfg.state_dtype``, step 0, on the parameters'
    device."""
    dt = getattr(torch, cfg.state_dtype)
    dev = next(iter(params.values())).device
    zeros = lambda: {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                     for n, p in params.items()}
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=zeros(), nu=zeros())


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


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
                 state: OptState, decay: Dict[str, float]
                 ) -> Tuple[Tree, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place: the gradients clipped by their global
    norm, the step counted, ``cosine_lr`` at the new step, the bias
    corrections, then each leaf's moments and parameter written where
    they are. ``decay`` is :func:`decay_mask`'s. Returns (params, the new
    state, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
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
    return params, OptState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
