"""MLPs: dense (SwiGLU / GELU, optional bias) and dropless MoE.

The counterpart of ``repro.models.mlp``. Under a bound mesh whose
``model`` axis is larger than 1 both run tensor parallel, each rank
holding its F-shard of every weight as ``param_spec`` resolves it: the
dense MLP's ``w_gate`` / ``w_up`` / ``b_up`` columns and ``w_down`` rows,
entered with ``copy_to_model`` and left through the row-parallel
``tp_row_matmul`` (``b_down`` is added once, after the sum); the MoE's
expert stacks on their ``d_ff_expert`` dim, as the reference's
``shard_map`` branch holds them (F-sharded experts, no all-to-all: every
rank routes all its tokens, which are the same on every model rank, and
runs every expert's F-shard), the output summed over ``model`` in its
dtype (the reference's ``psum``), the shared expert F-sharded like a
dense MLP. A dense MLP whose width the axis does not divide runs whole
on every rank, with no collective, as the reference's divisibility
fallback replicates its leaves (``launch.sharding.tp_layer``); on a
sequence cut over ``model`` one the axis cuts runs on the gathered
sequence and leaves through a reduce-scatter, and one that runs whole
runs on the rank's block. The
expert stacks have no such fallback: the reference's ``shard_map`` in-specs
cut them on ``model`` whatever their width, and refuse one the axis does
not divide (``ValueError``), as ``transformer.require_supported`` does.

The MoE layer is the sort-based dropless formulation: the (token, choice)
pairs are sorted by expert with a stable sort, each expert's contiguous
slice goes through its weights, and the weighted results are added back to
their tokens. The reference computes the expert products with
``jax.lax.ragged_dot`` (XLA, not a Pallas kernel); here they are one
``torch.matmul`` per non-empty expert, which needs the group sizes on the
host: one synchronisation per MoE layer.

On the meta device (the dry run's trace, ``launch.steps.lower_*``) the
group sizes do not exist, so the expert products take the counterpart of
the reference's cost-mode branch (its ``REPRO_COST_MODE``): the sorted
pairs, zero-padded to a multiple of E, as E equal groups through
E-batched dense products (``torch.einsum``), which count the true
``2 x T k x D x F`` FLOPs a product (and the padding's) and read every
expert's weights once. The numbers differ from the dropless products'
(there are none on meta). There is no switch: tokens on a real device
always take the dropless path.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import sharding as shd
from repro_torch.models.params import (dense_init, param, trunc_normal,
                                       zeros)


def mlp_init(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None, *, device=None) -> nn.ParameterDict:
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    kw = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
    out_std = 1.0 / math.sqrt(2 * cfg.num_layers * Fd)
    if cfg.act == "swiglu":
        p = {
            "w_gate": dense_init(gen, D, Fd, **kw),
            "w_up": dense_init(gen, D, Fd, **kw),
            "w_down": dense_init(gen, Fd, D, std=out_std, **kw),
        }
    else:
        p = {
            "w_up": dense_init(gen, D, Fd, **kw),
            "w_down": dense_init(gen, Fd, D, std=out_std, **kw),
        }
    if cfg.mlp_bias:
        p["b_up"] = zeros((Fd,), **kw)
        p["b_down"] = zeros((D,), **kw)
    return nn.ParameterDict({k: param(v) for k, v in p.items()})


def dense_width(cfg: ModelConfig) -> int:
    """The dense MLP's width: a MoE configuration's ``d_ff_dense`` where it
    has one (its first dense layers), else ``d_ff``."""
    return cfg.moe.d_ff_dense if (cfg.moe and cfg.moe.d_ff_dense) \
        else cfg.d_ff


def mlp_apply(p: nn.ParameterDict, x: torch.Tensor, *, cfg: ModelConfig,
              d_ff: Optional[int] = None) -> torch.Tensor:
    """The MLP of width ``d_ff`` (:func:`dense_width` by default): column-
    then row-parallel under a model axis that divides the width, whole on
    every rank otherwise (``launch.sharding.tp_layer``)."""
    return shd.tp_layer(d_ff or dense_width(cfg), _mlp_apply, p, x, cfg=cfg)


def _mlp_apply(p: nn.ParameterDict, x: torch.Tensor, *, cfg: ModelConfig
               ) -> torch.Tensor:
    x = shd.copy_to_model(x)
    if cfg.act == "swiglu":
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        if cfg.mlp_bias:
            u = u + p["b_up"]
        h = F.silu(g) * u
    else:
        h = x @ p["w_up"]
        if cfg.mlp_bias:
            h = h + p["b_up"]
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    out = shd.tp_row_matmul(h, p["w_down"], "ff")
    if cfg.mlp_bias:
        out = out + p["b_down"]
    return out


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def moe_init(gen: torch.Generator, cfg: ModelConfig, *, device=None,
             cut: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
             ) -> nn.ParameterDict:
    """With ``cut(name, whole)`` each expert stack keeps only its cut
    part, taken from the float32 draw before the cast (a rank of a
    tensor-parallel mesh never holds a whole stack in ``param_dtype``)."""
    mo = cfg.moe
    D = cfg.d_model
    E = mo.num_experts
    Fd = mo.d_ff_expert
    kw = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
    out_std = 1.0 / math.sqrt(2 * cfg.num_layers * Fd)

    def expert_stack(name, d_in, d_out, std):
        return trunc_normal(gen, (E, d_in, d_out), std=std,
                            cut=None if cut is None else
                            functools.partial(cut, name), **kw)

    p = {
        # float32 whatever param_dtype is, as in the reference
        "router": dense_init(gen, D, E, std=0.02, dtype=torch.float32,
                             device=device),
        "w_gate": expert_stack("w_gate", D, Fd, 1.0 / math.sqrt(D)),
        "w_up": expert_stack("w_up", D, Fd, 1.0 / math.sqrt(D)),
        "w_down": expert_stack("w_down", Fd, D, out_std),
    }
    if mo.router == "sigmoid":
        p["router_bias"] = zeros((E,), dtype=torch.float32, device=device)
    out = nn.ParameterDict({k: param(v) for k, v in p.items()})
    if mo.num_shared_experts > 0:
        out["shared"] = mlp_init(gen, cfg, d_ff=Fd * mo.num_shared_experts,
                                 device=device)
    return out


def _route(p, x2: torch.Tensor, mo
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2: (T, D) tokens. Returns (weights (T,k) float32, ids (T,k), aux).
    ``topk`` returns its choices sorted by score, as ``lax.top_k`` does."""
    logits = x2.float() @ p["router"]                         # (T, E)
    k = mo.num_experts_per_tok
    if mo.router == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores + p["router_bias"]                      # bias for top-k
        _, ids = torch.topk(sel, k, dim=-1, sorted=True)
        w = torch.gather(scores, -1, ids)                    # weight w/o bias
        w = w / (w.sum(-1, keepdim=True) + 1e-9)
        probs = scores / (scores.sum(-1, keepdim=True) + 1e-9)
    else:
        probs = torch.softmax(logits, -1)
        w, ids = torch.topk(probs, k, dim=-1, sorted=True)
        w = w / (w.sum(-1, keepdim=True) + 1e-9)
    # load-balance aux (Switch-style): E * sum_e f_e * P_e
    E = logits.shape[-1]
    f = F.one_hot(ids, E).float().mean(dim=(0, 1)) * k
    pbar = probs.mean(dim=0)
    aux = E * (f * pbar).sum()
    return w, ids, aux


def _moe_local(p, x2: torch.Tensor, mo, act: str
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless MoE on the tokens x2 (T, D). Returns (out (T,D), aux).
    Under a model axis ``out`` is this rank's part of the sum over its
    experts' F-shards; the routing is every rank's, and the experts'
    gradients of the tokens and of the routing weights are partial, so
    both enter the experts through ``copy_to_model``."""
    T, D = x2.shape
    k = mo.num_experts_per_tok
    E = mo.num_experts
    w, ids, aux = _route(p, x2, mo)
    x2, w = shd.copy_to_model(x2), shd.copy_to_model(w)
    flat_ids = ids.reshape(-1)                               # (T*k,)
    order = torch.argsort(flat_ids, stable=True)
    token_of = order // k                                    # source token
    xs = x2[token_of]                                        # (T*k, D) sorted
    y = _cost_products(p, xs, E, act) if xs.is_meta else \
        _dropless_products(p, xs, flat_ids, E, act)
    wsort = w.reshape(-1)[order]                             # (T*k,)
    y = y * wsort[:, None].to(y.dtype)
    out = torch.zeros((T, D), dtype=y.dtype, device=y.device)
    out.index_add_(0, token_of, y)
    return out, aux


def _expert_act(g: torch.Tensor, u: torch.Tensor, act: str) -> torch.Tensor:
    return F.silu(g) * u if act == "swiglu" else \
        F.gelu(u + g, approximate="tanh")       # jax.nn.gelu's default


def _dropless_products(p, xs: torch.Tensor, flat_ids: torch.Tensor, E: int,
                       act: str) -> torch.Tensor:
    """The expert MLP of each sorted pair: one matmul per non-empty
    expert (the group sizes go to the host: one synchronisation)."""
    sizes = torch.bincount(flat_ids, minlength=E).tolist()
    y = torch.empty_like(xs)
    start = 0
    for e, n in enumerate(sizes):
        if n == 0:
            continue
        seg = xs[start:start + n]
        h = _expert_act(seg @ p["w_gate"][e], seg @ p["w_up"][e], act)
        y[start:start + n] = h @ p["w_down"][e]
        start += n
    return y


def _cost_products(p, xs: torch.Tensor, E: int, act: str) -> torch.Tensor:
    """The reference's cost-mode expert products (``_moe_local`` under
    ``REPRO_COST_MODE``): the pairs padded to E equal groups, E-batched."""
    Tk, D = xs.shape
    xe = F.pad(xs, (0, 0, 0, (-Tk) % E)).reshape(E, -1, D)
    h = _expert_act(torch.einsum("etd,edf->etf", xe, p["w_gate"]),
                    torch.einsum("etd,edf->etf", xe, p["w_up"]), act)
    y = torch.einsum("etf,efd->etd", h, p["w_down"])
    return y.reshape(-1, D)[:Tk]


def moe_apply(p, x: torch.Tensor, *, cfg: ModelConfig, mean_aux: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B,S,D), aux_loss scalar); the aux loss is computed
    and, in serving, unused, as in the reference. Under a bound mesh the
    output is summed over ``model`` and, with ``mean_aux``, the aux loss
    averaged over the batch axes that are not manual (``mean_over_batch``;
    its backward is the identity, since the step averages the gradients
    over them). Serving passes ``mean_aux=False``: the reference's compiler
    drops that unused collective. On a sequence cut over ``model`` it runs
    as ``launch.sharding.tp_layer`` runs a layer the axis cuts: on the
    gathered sequence, the sum over ``model`` cut back to the block (a
    reduce-scatter: each rank's partial covers every row).

    Where the reference's ``shard_map`` replicates the tokens (a global
    batch that the batch axes do not divide) and this rank holds a part
    of them, the tokens are gathered, as the reference's in-spec gathers
    them: a block of a sequence cut over ``data``
    (``launch.sharding.seq_block``) over the axis, and rows of a batch
    cut over ``pod`` (``launch.sharding.replicated_rows``) over theirs.
    Every rank then routes and computes every token and keeps its own
    rows, and the aux loss is the whole batch's, with no mean (the
    reference's ``pmean`` is over the batch axes that cut its tokens:
    none)."""
    return shd.tp_layer(cfg.moe.d_ff_expert, _moe_apply, p, x, cfg=cfg,
                        mean_aux=mean_aux)


def _moe_apply(p, x: torch.Tensor, *, cfg: ModelConfig, mean_aux: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    mo = cfg.moe
    block = shd.seq_block()
    rows = shd.replicated_rows(x.shape[0])
    xs = x if block is None else shd.gather_seq(x, block)
    if rows is not None:
        xs = shd.gather_rows(xs, rows)
    out, aux = _moe_local(p, xs.reshape(-1, x.shape[-1]), mo, cfg.act)
    out = out.reshape(xs.shape)
    if rows is not None:
        out = out.narrow(0, rows.index * x.shape[0], x.shape[0])
    if block is not None:
        out = out[:, block.start:block.start + block.length]
    out = shd.reduce_from_model(out)
    if mean_aux and block is None and rows is None:
        aux = shd.mean_over_batch(aux)
    if mo.num_shared_experts > 0:
        out = out + mlp_apply(p["shared"], x, cfg=cfg,
                              d_ff=mo.d_ff_expert * mo.num_shared_experts)
    return out, aux
