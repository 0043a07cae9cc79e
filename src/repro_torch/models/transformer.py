"""Model assembly: the transformer, its forward and its losses.

The counterpart of ``repro.models.transformer`` for every configuration
of the registry: stacks whose layers are GQA attention (RoPE, M-RoPE or
none), MLA or the Mamba mixer, each followed by a dense MLP or a dropless
MoE, with RMSNorm (``qwen2-7b``, ``stablelm-12b``, ``starcoder2-15b``,
``mixtral-8x7b``, ``jamba-v0.1-52b``, ``minicpm3-4b``,
``deepseek-v3-671b``, ``qwen2-vl-2b``); RWKV-6 time mix + channel mix with
LayerNorm and ``ln0`` (``rwkv6-3b``); and the encoder-decoder
(``seamless-m4t-large-v2``): learned positions (``pos_embed``), a
non-causal GQA encoder (``enc_blocks``, ``enc_norm``) and decoder layers
with cross attention over its output, all with LayerNorm. The frontends
are stubs, as in the reference: the vision model takes precomputed patch
embeddings scattered into the token stream and (3, B, S) M-RoPE
positions, the audio model precomputed frame embeddings
(``enc_embeds``). The reference stacks each period slot's parameters
``(n_periods, ...)`` and runs the depth as one ``lax.scan``; here each
layer is a block in an ``nn.ModuleList`` walked by a Python loop, and the
logical-sharding annotations drop out (``launch.sharding.logical`` is the
identity). Under a bound mesh whose ``model`` axis is larger than 1 the
model runs tensor parallel on this rank's shards (:func:`tp_param_spec`;
the layers' part is in ``models.attention``, ``models.ssm`` and
``models.mlp``; every layer kind has one, :data:`TP_KINDS`): the
embedding is vocab-parallel (each rank looks up the rows in its range,
zero elsewhere, and the ranks' rows are summed), so are the head (the
logits of ``forward`` are this rank's vocabulary columns) and both cross
entropies (:func:`_logits_nll`: the max, the sum of exponentials and the
target's logit each all-reduced over ``model``, in float32), and the
prefill's and decode step's logits are gathered whole before they are
returned, so a greedy argmax sees every column. Where the axis does not
divide the padded vocabulary, the reference's divisibility fallback
replicates ``embed`` and ``lm_head``: every rank holds them whole and
runs the embedding, the head and the cross entropies whole, with no
collective (:func:`_whole_vocab`). The same fallback replicates an MLP
(RWKV-6's channel mix too) whose width the axis does not divide
(``models.mlp``, ``models.ssm``), and a mixer whose heads it does not
divide (``models.attention``, ``models.ssm``). A
configuration with ``mtp_depth > 0`` (DeepSeek-V3) carries the
multi-token-prediction parameters, ``Params.mtp``, as the reference does;
serving does not use them, its loss does (:func:`_mtp_loss`: its
embedding vocab-parallel, ``proj`` whole, its block tensor parallel as
the stack's).
A layer kind outside :data:`SUPPORTED_KINDS` is refused when the model is
built (:func:`check_supported`).

Context parallelism: under a ``seq`` rule that cuts a train or prefill
pass's sequence (``launch.sharding.activation_cut``: ``seq -> data`` at
a batch that ``pod x data`` does not divide, whole or cut over ``pod``;
``seq -> model`` where the vocabulary falls back, and in the encoder)
each rank runs its block of the positions through the whole model
(:func:`forward`, :func:`encode`): the embedding, the norms and the head
on the block, each layer as ``launch.sharding.tp_layer`` runs it (on
the block, reaching the rest of the sequence through the axis's
collectives, or, over ``model`` where the axis cuts its width, its
shard on the gathered sequence); the prefill returns the last rank's
last logits on every rank and the rank's blocks of the cache, and the
losses are the whole sequence's means on every rank (:func:`loss_fn`).

Modes:
  * ``train``   -- full causal pass, logits, no cache; with grad enabled,
                   each block is checkpointed by the configuration's
                   ``remat`` (:func:`_remat_context`). The losses
                   (:func:`loss_fn`) take this pass, for every layer
                   kind: the attention, RMSNorm, WKV6 and Mamba ops are
                   differentiable on both kernel backends.
  * ``prefill`` -- causal pass that also fills the decode cache.
  * ``decode``  -- one new token against the cache (S == 1).

The cache is a list with one dict per decoder layer, written in place
(cross attention keeps none): ``{"attn": {"k", "v"}}`` for GQA, ``{"attn": {"c", "kr"}}`` for MLA,
``{"attn": {"conv", "h"}}`` for Mamba, ``{"attn": {"last_x", "state"},
"mlp": {"last_x"}}`` for RWKV-6.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpm
from repro_torch.models import ssm as ssmm
from repro_torch.models.params import (dense_init, embed_init, ones, param,
                                       trunc_normal, zeros)
from repro_torch.models.rope import positions_for

Cache = List[Dict[str, Any]]


# ---------------------------------------------------------------------------
# layer-kind layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerKind:
    mixer: str          # "gqa" | "mla" | "rwkv" | "mamba"
    mlp: str            # "dense" | "moe" | "cmix"
    cross: bool = False # decoder layer with cross attention (enc-dec)


def kind_for_layer(cfg: ModelConfig, i: int, *, cross: bool = False
                   ) -> LayerKind:
    if cfg.is_attention_layer(i):
        mixer = "mla" if cfg.attn_type == "mla" else "gqa"
    else:
        mixer = "rwkv" if (cfg.ssm and cfg.ssm.kind == "rwkv6") else "mamba"
    if cfg.ssm and cfg.ssm.kind == "rwkv6":
        ml = "cmix"
    elif cfg.is_moe_layer(i):
        ml = "moe"
    else:
        ml = "dense"
    return LayerKind(mixer, ml, cross)


def _try_layout(cfg: ModelConfig, prefix: int, P: int
                ) -> Optional[List[LayerKind]]:
    """Kinds for one period if layers [prefix:] repeat with period P."""
    body = cfg.num_layers - prefix
    if body <= 0 or body % P != 0:
        return None
    kinds = [kind_for_layer(cfg, prefix + j, cross=cfg.is_encoder_decoder)
             for j in range(P)]
    for j in range(body):
        if kind_for_layer(cfg, prefix + j,
                          cross=cfg.is_encoder_decoder) != kinds[j % P]:
            return None
    return kinds


def layer_layout(cfg: ModelConfig) -> Tuple[int, List[LayerKind], int]:
    """Returns (prefix_len, period_kinds, n_periods) of the reference's
    parameter tree: layer ``prefix + t * P + j`` is period ``t`` of body
    slot ``j`` (:mod:`repro_torch.models.convert` reads it this way)."""
    P = 1
    if cfg.attn_period > 0:
        P = math.lcm(P, cfg.attn_period)
    if cfg.moe is not None and cfg.moe.every_k > 1:
        P = math.lcm(P, cfg.moe.every_k)
    for prefix in (0, cfg.moe.first_k_dense if cfg.moe else 0):
        kinds = _try_layout(cfg, prefix, P)
        if kinds is not None:
            return prefix, kinds, (cfg.num_layers - prefix) // P
    # degenerate: everything in one unrolled period
    kinds = _try_layout(cfg, 0, cfg.num_layers)
    if kinds is None:
        raise ValueError(f"{cfg.name}: no layer layout")
    return 0, kinds, 1


SUPPORTED_KINDS = (LayerKind("gqa", "dense", False),
                   LayerKind("gqa", "dense", True),
                   LayerKind("gqa", "moe", False),
                   LayerKind("mla", "dense", False),
                   LayerKind("mla", "moe", False),
                   LayerKind("mamba", "dense", False),
                   LayerKind("mamba", "moe", False),
                   LayerKind("rwkv", "cmix", False))


ENC_KIND = LayerKind("gqa", "dense", False)     # every encoder layer


def _kind(cfg: ModelConfig, i: int) -> LayerKind:
    """The kind of decoder layer ``i``: with cross attention in an
    encoder-decoder."""
    return kind_for_layer(cfg, i, cross=cfg.is_encoder_decoder)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration with a layer kind
    outside :data:`SUPPORTED_KINDS` (a mixer and MLP pairing, with or
    without cross attention, that no configuration of the registry has)."""
    kinds = {_kind(cfg, i) for i in range(cfg.num_layers)}
    missing = [f"{k.mixer} mixer + {k.mlp} mlp"
               f"{' + cross attention' if k.cross else ''} layers"
               for k in sorted(kinds - set(SUPPORTED_KINDS), key=str)]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported; the port builds "
            f"the layer kinds {SUPPORTED_KINDS}")


# the layer kinds with a tensor-parallel path: every kind the port builds
TP_KINDS = SUPPORTED_KINDS


def require_supported(mesh, cfg: ModelConfig) -> None:
    """Raise ``ValueError`` where the reference refuses ``cfg`` on
    ``mesh``: a MoE's expert stacks (``d_ff_expert``), or its shared
    experts' width, that the ``model`` axis does not divide. The
    reference's MoE runs them under ``jax.shard_map`` with in-specs that
    cut them on ``model`` whatever their width, and ``shard_map`` raises
    ``ValueError`` for a width the axis does not divide (its wording is
    kept); the expert stacks have no divisibility fallback. Everything
    else runs: a layer kind of :data:`TP_KINDS`, and whatever the axis
    does not divide (a mixer's heads or channels, KV heads, an MLP's
    width, the padded vocabulary) runs whole on every rank or, for KV
    heads, is read as the rank's query heads need it, as the reference's
    divisibility fallback replicates it (``launch.sharding.runs_whole``,
    ``attention.kv_read``). Nothing is refused on a mesh whose ``model``
    axis is 1."""
    tp = mesh_lib.model_size(mesh)
    if tp <= 1 or cfg.moe is None:
        return
    widths = {"w_gate": cfg.moe.d_ff_expert}
    if cfg.moe.num_shared_experts:
        widths["shared/w_gate"] = \
            cfg.moe.d_ff_expert * cfg.moe.num_shared_experts
    for leaf, n in widths.items():
        if n % tp:
            raise ValueError(
                f"{cfg.name}: shard_map applied to the MoE's body was given "
                f"argument arrays with axis sizes that are not evenly "
                f"divisible by the corresponding mesh axis sizes: {leaf}'s "
                f"width {n} on a 'model' axis of {tp}")


# ---------------------------------------------------------------------------
# single block (norm -> mixer -> +res -> norm -> mlp -> +res)
# ---------------------------------------------------------------------------


def _norm_init(cfg: ModelConfig, with_bias: bool, *, device=None
               ) -> nn.ParameterDict:
    dt = getattr(torch, cfg.param_dtype)
    p = {"scale": param(ones((cfg.d_model,), dt, device))}
    if with_bias:
        p["bias"] = param(zeros((cfg.d_model,), dt, device))
    return nn.ParameterDict(p)


def _norm(p: nn.ParameterDict, x: torch.Tensor, eps: float, *,
          backend: str) -> torch.Tensor:
    """LayerNorm (RWKV) when the norm has a bias, as plain float32 torch
    ops (it is jnp, not a Pallas kernel, in the reference); RMSNorm (K5 on
    ``backend="cuda"``) otherwise.

    Under ``REPRO_NORM_BF16`` (set by the dry run's ``nf32`` variant) the
    statistics are taken in the activation dtype, as plain torch ops on
    every backend: the reference's probe of a norm that does not promote
    the preceding row-parallel sum to float32 (its numbers differ). On a
    block of a sequence cut over ``model`` the scale and bias enter
    through ``launch.sharding.block_leaf``."""
    scale = shd.block_leaf(p["scale"])
    bias = shd.block_leaf(p["bias"]) if "bias" in p else None
    if os.environ.get("REPRO_NORM_BF16"):
        mu = x.mean(-1, keepdim=True) if bias is not None else 0.0
        var = (x - mu).square().mean(-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + torch.full((), eps, dtype=x.dtype,
                                                    device=x.device))
        y = y * scale
        return y + bias if bias is not None else y
    if bias is not None:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * scale.float() + bias.float()).to(x.dtype)
    return ops.rmsnorm(x, scale, eps, backend=backend)


def _uses_ln_bias(cfg: ModelConfig) -> bool:
    return (cfg.ssm is not None and cfg.ssm.kind == "rwkv6") or \
        cfg.family == "encdec"


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: LayerKind, *,
               device=None,
               cut: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
               ) -> nn.ModuleDict:
    """A block's parameters; ``cut`` is handed to a MoE's
    ``mlp.moe_init``, which cuts its expert stacks as it draws them."""
    if kind not in SUPPORTED_KINDS:
        raise NotImplementedError(f"{kind} layers are not ported yet")
    b = _uses_ln_bias(cfg)
    p = {"norm1": _norm_init(cfg, b, device=device),
         "norm2": _norm_init(cfg, b, device=device)}
    if kind.mixer == "rwkv":
        p["mixer"] = ssmm.rwkv_tmix_init(gen, cfg, device=device)
    elif kind.mixer == "mamba":
        p["mixer"] = ssmm.mamba_init(gen, cfg, device=device)
    elif kind.mixer == "mla":
        p["mixer"] = attn.mla_init(gen, cfg, device=device)
    else:
        p["mixer"] = attn.gqa_init(gen, cfg, device=device)
    if kind.cross:
        p["cross_norm"] = _norm_init(cfg, b, device=device)
        p["cross"] = attn.cross_init(gen, cfg, device=device)
    if kind.mlp == "cmix":
        p["mlp"] = ssmm.rwkv_cmix_init(gen, cfg, device=device)
    elif kind.mlp == "moe":
        p["mlp"] = mlpm.moe_init(gen, cfg, device=device, cut=cut)
    else:
        p["mlp"] = mlpm.mlp_init(gen, cfg, d_ff=mlpm.dense_width(cfg),
                                 device=device)
    return nn.ModuleDict(p)


def block_cache(cfg: ModelConfig, kind: LayerKind, batch: int, max_len: int,
                *, device=None) -> Dict[str, Any]:
    """Decode cache for one block (zeros; filled by prefill). Cross
    attention adds nothing to it."""
    if kind not in SUPPORTED_KINDS:
        raise NotImplementedError(f"{kind} caches are not ported yet")
    if kind.mixer == "rwkv":
        # the last normed input of each mixer; the (K, K) state per head,
        # of this rank's heads
        with shd.runs_whole(cfg.num_heads):
            H = shd.local_size(cfg.num_heads)
        K = cfg.ssm.head_dim
        last_x = lambda: torch.zeros((batch, cfg.d_model),
                                     dtype=getattr(torch, cfg.dtype),
                                     device=device)
        return {"attn": {"last_x": last_x(),
                         "state": torch.zeros((batch, H, K, K),
                                              dtype=torch.float32,
                                              device=device)},
                "mlp": {"last_x": last_x()}}
    if kind.mixer == "mamba":
        # the last d_conv - 1 inputs of the convolution; the (Din, N)
        # state; this rank's channels
        s = cfg.ssm
        with shd.runs_whole(s.expand * cfg.d_model):
            Din = shd.local_size(s.expand * cfg.d_model)
        dt = getattr(torch, cfg.dtype)
        return {"attn": {
            "conv": torch.zeros((batch, s.d_conv - 1, Din), dtype=dt,
                                device=device),
            "h": torch.zeros((batch, Din, s.d_state), dtype=torch.float32,
                             device=device)}}
    if kind.mixer == "mla":
        return {"attn": attn.mla_init_cache(cfg, batch, max_len,
                                            device=device)}
    return {"attn": attn.gqa_init_cache(cfg, batch, max_len, device=device)}


def block_apply(
    p: nn.ModuleDict,
    x: torch.Tensor,                # (B, S, D)
    *,
    cfg: ModelConfig,
    kind: LayerKind,
    positions: torch.Tensor,
    pos0: Union[int, torch.Tensor],
    mode: str,
    cache: Optional[Dict[str, Any]],
    kv_len: Optional[torch.Tensor],
    memory: Optional[torch.Tensor] = None,           # (B, S_enc, D) enc-dec
    mrope_positions: Optional[torch.Tensor] = None,  # (3, B, S)
    causal: bool = True,
    backend: str = "cuda",
) -> Tuple[torch.Tensor, Optional[torch.Tensor],
           Optional[Dict[str, Any]]]:
    """Returns (x_out, aux_loss, new_cache), as the reference's: aux is
    the MoE's load-balance loss (serving drops it), and ``None`` for
    other MLPs (a zero there; here no kernel is launched for it).
    ``kv_len`` and ``pos0`` are unused by RWKV and Mamba layers, as in the
    reference. A layer with cross attention attends over ``memory`` after
    its mixer when it is given."""
    eps = cfg.norm_eps
    aux = None
    new_cache: Dict[str, Any] = {}
    h = _norm(p["norm1"], x, eps, backend=backend)
    if kind.mixer == "rwkv":
        out, nc = ssmm.rwkv_tmix_apply(
            p["mixer"], h, cfg=cfg, mode=mode,
            cache=cache["attn"] if cache else None, backend=backend)
    elif kind.mixer == "mamba":
        out, nc = ssmm.mamba_apply(
            p["mixer"], h, cfg=cfg, mode=mode,
            cache=cache["attn"] if cache else None, backend=backend)
    elif kind.mixer == "mla":
        out, nc = attn.mla_apply(
            p["mixer"], h, cfg=cfg, positions=positions, mode=mode,
            cache=cache["attn"] if cache else None, kv_len=kv_len, pos0=pos0,
            causal=causal, backend=backend)
    else:
        out, nc = attn.gqa_apply(
            p["mixer"], h, cfg=cfg, positions=positions, mode=mode,
            cache=cache["attn"] if cache else None, kv_len=kv_len, pos0=pos0,
            mrope_positions=mrope_positions, causal=causal, backend=backend)
    if nc is not None:
        new_cache["attn"] = nc
    x = x + out
    if kind.cross and memory is not None:
        hc = _norm(p["cross_norm"], x, eps, backend=backend)
        x = x + attn.cross_apply(p["cross"], hc, memory, cfg=cfg,
                                 backend=backend)
    h2 = _norm(p["norm2"], x, eps, backend=backend)
    if kind.mlp == "cmix":
        out, nc = ssmm.rwkv_cmix_apply(p["mlp"], h2, cfg=cfg, mode=mode,
                                       cache=cache["mlp"] if cache else None)
        if nc is not None:
            new_cache["mlp"] = nc
    elif kind.mlp == "moe":
        out, aux = mlpm.moe_apply(p["mlp"], h2, cfg=cfg,
                                  mean_aux=mode == "train")
    else:
        out = mlpm.mlp_apply(p["mlp"], h2, cfg=cfg)
    x = x + out
    return x, aux, (new_cache if new_cache else None)


# ---------------------------------------------------------------------------
# full-model parameters and cache
# ---------------------------------------------------------------------------


class MTP(nn.Module):
    """The multi-token-prediction head's parameters (the reference's
    ``p["mtp"]``): ``proj`` (2 D, D), ``norm_h``, ``norm_e``, one ``block``
    of the last layer's kind and ``final_norm``. Built and loaded, unused
    by serving, as in the reference's forward."""

    def __init__(self, proj: torch.Tensor, norm_h: nn.ParameterDict,
                 norm_e: nn.ParameterDict, block: nn.ModuleDict,
                 final_norm: nn.ParameterDict):
        super().__init__()
        self.proj = param(proj)
        self.norm_h = norm_h
        self.norm_e = norm_e
        self.block = block
        self.final_norm = final_norm


class Params(nn.Module):
    """The model's parameters: ``embed``, ``pos_embed`` (learned absolute
    positions, (max_seq_len, D): the encoder-decoder's), ``ln0`` (RWKV-6's
    norm of the embeddings), ``enc_blocks`` and ``enc_norm`` (the
    encoder-decoder's encoder), ``blocks`` (one per decoder layer),
    ``final_norm``, ``lm_head`` (absent with tied embeddings) and ``mtp``
    (with ``mtp_depth > 0`` only). Each optional part is ``None`` where
    the configuration has none."""

    def __init__(self, embed: torch.Tensor, blocks: List[nn.ModuleDict],
                 final_norm: nn.ParameterDict,
                 lm_head: Optional[torch.Tensor],
                 ln0: Optional[nn.ParameterDict] = None,
                 mtp: Optional[MTP] = None,
                 pos_embed: Optional[torch.Tensor] = None,
                 enc_blocks: Optional[List[nn.ModuleDict]] = None,
                 enc_norm: Optional[nn.ParameterDict] = None):
        super().__init__()
        self.embed = param(embed)
        self.pos_embed = param(pos_embed) if pos_embed is not None else None
        self.ln0 = ln0
        self.enc_blocks = nn.ModuleList(enc_blocks) \
            if enc_blocks is not None else None
        self.enc_norm = enc_norm
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        self.lm_head = param(lm_head) if lm_head is not None else None
        self.mtp = mtp


Keep = Callable[[str, torch.Tensor], torch.Tensor]


def _kept(keep: Optional[Keep], prefix: str, part):
    """``part`` (a tensor, or a module of parameters named under
    ``prefix``) with each leaf cut by ``keep(name, whole)``; a leaf
    ``keep`` cuts is copied out, so that its whole is freed. ``keep``
    returns a leaf that is cut already (a MoE's expert stack) as it is."""
    if keep is None or part is None:
        return part
    if isinstance(part, torch.Tensor):
        t = keep(prefix, part)
        return t.clone() if t.shape != part.shape else part
    for name, prm in part.named_parameters(prefix):
        t = keep(name, prm.data)
        if t.shape != prm.shape:
            prm.data = t.clone()
    return part


def init_params(cfg: ModelConfig, gen: torch.Generator, *, device=None,
                keep: Optional[Keep] = None) -> Params:
    """Seeded parameters, drawn whole in the reference's order. With
    ``keep(name, whole) -> part`` each leaf is cut to ``part`` as soon as
    its layer (or the embedding, or the head) is drawn, so a rank of a
    tensor-parallel mesh holds the same values as one process would, with
    one layer whole at a time; a MoE's expert stacks are cut as they are
    drawn (``mlp.moe_init``; DeepSeek-V3's are 7.5 GB each)."""
    check_supported(cfg)

    def block(prefix, kind):
        """The block under ``prefix``, drawn and cut."""
        cut = None if keep is None else \
            lambda name, whole: keep(f"{prefix}.mlp.{name}", whole)
        return _kept(keep, prefix, block_init(gen, cfg, kind, device=device,
                                              cut=cut))

    dt = getattr(torch, cfg.param_dtype)
    Vp = cfg.padded_vocab()
    D = cfg.d_model
    embed = _kept(keep, "embed", embed_init(gen, Vp, D, dtype=dt,
                                            device=device))
    pos_embed = None
    if cfg.is_encoder_decoder or (cfg.rope == "none" and cfg.ssm is None):
        # learned absolute positions for rope-free attention stacks
        pos_embed = _kept(keep, "pos_embed", trunc_normal(
            gen, (cfg.max_seq_len, D), std=0.02, dtype=dt, device=device))
    ln0 = None
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        ln0 = _kept(keep, "ln0", _norm_init(cfg, True, device=device))
    enc_blocks = enc_norm = None
    if cfg.is_encoder_decoder:
        # the encoder: uniform non-causal GQA blocks
        enc_blocks = [block(f"enc_blocks.{i}", ENC_KIND)
                      for i in range(cfg.num_encoder_layers)]
        enc_norm = _kept(keep, "enc_norm",
                         _norm_init(cfg, _uses_ln_bias(cfg), device=device))
    blocks = [block(f"blocks.{i}", _kind(cfg, i))
              for i in range(cfg.num_layers)]
    final_norm = _kept(keep, "final_norm",
                       _norm_init(cfg, _uses_ln_bias(cfg), device=device))
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = _kept(keep, "lm_head", dense_init(
            gen, D, Vp, std=1.0 / math.sqrt(D), dtype=dt, device=device))
    mtp = None
    if cfg.mtp_depth > 0:
        mtp = MTP(dense_init(gen, 2 * D, D, dtype=dt, device=device),
                  _norm_init(cfg, False, device=device),
                  _norm_init(cfg, False, device=device),
                  block("mtp.block", kind_for_layer(cfg, cfg.num_layers - 1)),
                  _norm_init(cfg, False, device=device))
        mtp = _kept(keep, "mtp", mtp)
    return Params(embed, blocks, final_norm, lm_head, ln0, mtp, pos_embed,
                  enc_blocks, enc_norm)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None
               ) -> Cache:
    return [block_cache(cfg, _kind(cfg, i), batch, max_len, device=device)
            for i in range(cfg.num_layers)]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _map_seq_caches(cache: Cache, fn) -> Cache:
    """``cache`` with ``fn`` applied to each layer's attention cache
    (``attention.SeqCache``); the SSM states, which have no sequence, as
    they are."""
    return [{part: fn(leaves) if isinstance(leaves, attn.SeqCache)
             else leaves for part, leaves in layer.items()}
            for layer in cache]


def cut_cache(cache: Cache, cfg: ModelConfig) -> Cache:
    """Each rank's block of a whole cache under the bound ``seq`` rule
    (``attention.cut_seq_cache``)."""
    return _map_seq_caches(cache, lambda c: attn.cut_seq_cache(cfg, c))


def gather_cache(cache: Cache, cfg: ModelConfig) -> Cache:
    """The whole cache from every rank's block under the bound ``seq``
    rule (``attention.gather_seq_cache``)."""
    return _map_seq_caches(cache, lambda c: attn.gather_seq_cache(cfg, c))


def _whole_vocab(cfg: ModelConfig):
    """A context in which the embedding, the head, the cross entropies and
    the logits' gather see no model axis where it does not divide the
    padded vocabulary: the reference's fallback replicates ``embed`` and
    ``lm_head``, and every rank reads the whole vocabulary."""
    return shd.runs_whole(cfg.padded_vocab())


def _lookup(p: Params, cfg: ModelConfig, tokens: torch.Tensor
            ) -> torch.Tensor:
    """The embedding rows of ``tokens`` in ``cfg.dtype``. The reference's
    jnp.take; as F.embedding, its gradient sums each row's contributions
    in float32 on the card and rounds once, where indexing's would round a
    bfloat16 row after every addition. Vocab-parallel under a model axis
    that divides the padded vocabulary (:func:`_whole_vocab`): this rank's
    rows, zero where the token is not in its range, summed over ``model``
    (one row is non-zero: exact). Whole on a block of a sequence cut over
    ``model`` (``launch.sharding.block_leaf``)."""
    dt = getattr(torch, cfg.dtype)
    with _whole_vocab(cfg):
        tp = shd.model_axis()
        if tp is None:
            return torch.nn.functional.embedding(
                tokens, shd.block_leaf(p.embed)).to(dt)
        rows = p.embed.shape[0]
        local = tokens - tp.index * rows
        hit = (local >= 0) & (local < rows)
        e = torch.nn.functional.embedding(local.clamp(0, rows - 1), p.embed)
        e = torch.where(hit[..., None], e, torch.zeros((), dtype=e.dtype,
                                                       device=e.device))
        return shd.reduce_from_model(e).to(dt)


def _embed(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
           positions: torch.Tensor, *, backend: str) -> torch.Tensor:
    dt = getattr(torch, cfg.dtype)
    x = _lookup(p, cfg, tokens)
    if p.pos_embed is not None:
        x = x + shd.block_leaf(p.pos_embed)[positions.to(
            device=x.device, dtype=torch.long)].to(dt)
    if p.ln0 is not None:
        x = _norm(p.ln0, x, cfg.norm_eps, backend=backend)
    return x


def scatter_patches(x: torch.Tensor, patch_embeds: torch.Tensor,
                    patch_positions: torch.Tensor,
                    block: Optional[shd.SeqBlock] = None) -> torch.Tensor:
    """The vision stub: ``x.at[bidx, patch_positions].set(patch_embeds)``
    of the reference, which writes row ``b``'s patch ``j`` at position
    ``patch_positions[b, j]`` of the token stream. A negative position
    counts from the end (-1 is S - 1); one outside [-S, S) is dropped, as
    JAX drops it, with no device-side assert: such patches are written to
    a spare row past the end, which is cut off. Positions within a row
    are taken to be distinct: for a repeated one neither package defines
    which patch is kept. With ``block`` ``x`` is this rank's block of the
    sequence: the rules above apply on the whole length, then only the
    patches that fall in the block are written. Returns a new (B, L, D)
    tensor."""
    B, S, D = x.shape
    lo, n = (0, S) if block is None else (block.start, block.total)
    pp = patch_positions.to(device=x.device, dtype=torch.long)
    pp = torch.where(pp < 0, pp + n, pp) - lo
    pp = torch.where((pp >= 0) & (pp < S), pp, S)
    xe = torch.cat([x, x.new_zeros((B, 1, D))], 1)
    xe[torch.arange(B, device=x.device)[:, None], pp] = \
        patch_embeds.to(device=x.device, dtype=x.dtype)
    return xe[:, :S].contiguous()


# the weight products, the ops whose outputs the remat policy "dots"
# saves: the set of the reference's dots_with_no_batch_dims_saveable (a
# product of activations with a 2-D weight is an mm or addmm here; the
# attention's batched products are bmm, recomputed)
SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in SAVED_BY_DOTS else \
        CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(cfg: ModelConfig):
    """The checkpoint ``context_fn`` of the configuration's ``remat``
    (``_remat_policy`` of the reference): ``None`` for ``"none"`` (no
    checkpoint), the default for ``"full"`` (nothing saved), and for
    ``"dots"`` a selective checkpoint that saves the weight products
    (:data:`SAVED_BY_DOTS`). Remat changes what is kept for the backward,
    not a number."""
    if cfg.remat == "none":
        return None
    if cfg.remat == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _dots_policy)
    if cfg.remat == "full":
        return noop_context_fn
    raise ValueError(f"remat {cfg.remat!r} not in ('none', 'dots', 'full')")


def _run_stack(p: Params, x: torch.Tensor, *, cfg: ModelConfig,
               positions: torch.Tensor, pos0, mode: str,
               cache: Optional[Cache], kv_len: Optional[torch.Tensor],
               backend: str, memory: Optional[torch.Tensor] = None,
               mrope_positions: Optional[torch.Tensor] = None,
               enc: bool = False
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                          Optional[Cache]]:
    """The decoder's layers in order, or with ``enc`` the encoder's
    (non-causal, no cache). In ``"train"`` mode with grad enabled each
    block is checkpointed by ``cfg.remat`` (the reference checkpoints
    each scanned period). Returns (x, the MoE aux losses' total, from a
    float32 zero as the reference's, or ``None`` for a configuration
    without an MoE, new_cache)."""
    blocks = p.enc_blocks if enc else p.blocks
    context = _remat_context(cfg) \
        if mode == "train" and torch.is_grad_enabled() else None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device) \
        if cfg.moe is not None and not enc else None
    new_cache = []
    for i, blk in enumerate(blocks):
        run = functools.partial(
            block_apply, blk, cfg=cfg,
            kind=ENC_KIND if enc else _kind(cfg, i), positions=positions,
            pos0=pos0, mode=mode, cache=cache[i] if cache else None,
            kv_len=kv_len, memory=memory, mrope_positions=mrope_positions,
            causal=not enc, backend=backend)
        if context is None:
            x, aux, nc = run(x)
        else:
            # the recompute runs in the backward: it binds the mesh again
            x, aux, nc = checkpoint(
                functools.partial(_under, shd.current(), run), x,
                use_reentrant=False, context_fn=context)
        if aux is not None:
            aux_total = aux_total + aux
        new_cache.append(nc)
    return x, aux_total, (new_cache if mode in ("prefill", "decode")
                          else None)


def _under(state, fn, *args):
    with shd.restored(state):
        return fn(*args)


@dataclasses.dataclass
class Output:
    logits: torch.Tensor                   # (B, S, Vp); normed hidden if
                                           # the head was not applied
    cache: Optional[Cache] = None
    aux_loss: Optional[torch.Tensor] = None    # scalar (MoE balance);
                                               # None without MoE layers
    hidden: Optional[torch.Tensor] = None      # pre-norm hidden (for MTP)
    block: Optional[shd.SeqBlock] = None       # this rank's block of the
                                               # sequence, None if whole


def _head(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The logits; under a model axis that cuts the vocabulary
    (:func:`_whole_vocab`) this rank's vocabulary columns (a tied head is
    its ``embed`` rows, transposed), else every column (on a block of a
    sequence cut over ``model``, through ``launch.sharding.block_leaf``)."""
    head = shd.block_leaf(p.lm_head if p.lm_head is not None else p.embed)
    head = head if p.lm_head is not None else head.T
    with _whole_vocab(cfg):
        return shd.copy_to_model(x) @ head


def _embed_frames(p: Params, cfg: ModelConfig, enc_embeds: torch.Tensor,
                  block: Optional[shd.SeqBlock] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder's input: frame embeddings (B, S_enc, D) in
    ``cfg.dtype`` + ``pos_embed`` (with ``block``, this rank's block of
    the frames at their global positions). Returns (x, the whole
    sequence's positions)."""
    if p.enc_blocks is None:
        raise ValueError(f"{cfg.name} has no encoder")
    B, S, _ = enc_embeds.shape
    dt = getattr(torch, cfg.dtype)
    positions = positions_for(B, S, device=p.embed.device)
    mine = positions
    if block is not None:
        enc_embeds = enc_embeds[:, block.start:block.start + block.length]
        mine = positions[:, block.start:block.start + block.length]
    x = enc_embeds.to(device=p.embed.device, dtype=dt)
    if p.pos_embed is not None:
        x = x + shd.block_leaf(p.pos_embed)[mine.long()].to(dt)
    return x, positions


def encode(p: Params, cfg: ModelConfig, enc_embeds: torch.Tensor, *,
           backend: str = "cuda") -> torch.Tensor:
    """The encoder from precomputed frame embeddings (B, S_enc, D) (the
    audio stub): + ``pos_embed``, the non-causal stack, ``enc_norm``.
    Returns the memory (B, S_enc, D) in ``cfg.dtype``. Under a ``seq``
    rule that cuts the frames (``launch.sharding.activation_cut``, the
    reference's ``logical(x, "batch", "seq", "embed")``) each rank runs
    its block through the stack as :func:`forward` runs it, and the
    memory is gathered whole at the end: over ``data`` by ``gather_seq``,
    over ``model`` by ``enter_seq`` (its gradient arrives whole on every
    rank: the cross attention sums its own over ``model``)."""
    B, S, _ = enc_embeds.shape
    block = shd.activation_cut(B, S)
    with shd.cut_sequence(block):
        x, positions = _embed_frames(p, cfg, enc_embeds, block)
        x, _, _ = _run_stack(p, x, cfg=cfg, positions=positions, pos0=0,
                             mode="train", cache=None, kv_len=None,
                             backend=backend, enc=True)
        x = _norm(p.enc_norm, x, cfg.norm_eps, backend=backend)
    if block is None:
        return x
    if "model" in block.axis.axes:
        return shd.enter_seq(x, block)
    return shd.gather_seq(x, block)


def forward(
    p: Params,
    batch: Dict[str, torch.Tensor],
    *,
    cfg: ModelConfig,
    mode: str = "train",
    cache: Optional[Cache] = None,
    pos0: Optional[Union[int, torch.Tensor]] = None,
    backend: str = "cuda",
    head: bool = True,
) -> Output:
    """batch keys: tokens (B,S); optional positions (B,S), kv_len (B,);
    the encoder-decoder's memory (B,S_enc,D), or enc_embeds (B,S_enc,D)
    to encode first; the vision model's patch_embeds (B,n_patch,D) and
    patch_positions (B,n_patch) (:func:`scatter_patches`) and
    mrope_positions (3,B,S). ``pos0`` is the position of ``tokens[:, 0]``
    for the cache write (read from ``positions`` when not given, 0
    without them). With ``head=False`` the logits are the normed hidden
    state (the chunked loss applies the head itself).

    Context parallelism: in a train or prefill pass a ``seq`` rule that
    cuts the sequence (``launch.sharding.activation_cut``, resolved as
    the reference's logits constraint) has each rank embed, run the
    stack, norm and project its block of the positions (their global
    positions; the patches that fall in it), and the logits, hidden state
    and ``Output.block`` are the block's; the layers take the whole
    sequence's positions and run as ``launch.sharding.tp_layer`` runs
    them (``models.attention``, ``models.ssm``, ``models.mlp``). ``pos0``
    stays the whole sequence's first position."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    block = None
    if mode != "decode":
        block = shd.activation_cut(B, S, cfg.padded_vocab() if head
                                   else None)
    positions = batch.get("positions")
    if positions is None:
        positions = positions_for(B, S, device=tokens.device)
        pos0 = 0 if pos0 is None else pos0
    elif pos0 is None:
        pos0 = int(positions[0, 0])
    mrope = batch.get("mrope_positions")
    memory = None
    if cfg.is_encoder_decoder:
        memory = batch.get("memory")
        if memory is None:
            memory = encode(p, cfg, batch["enc_embeds"], backend=backend)
    with shd.cut_sequence(block):
        x = _embed(p, cfg, shd.block_rows(tokens), shd.block_rows(positions),
                   backend=backend)
        if cfg.frontend == "vision" and "patch_embeds" in batch:
            x = scatter_patches(x, batch["patch_embeds"],
                                batch["patch_positions"], block)
        x, aux, new_cache = _run_stack(
            p, x, cfg=cfg, positions=positions, pos0=pos0, mode=mode,
            cache=cache, kv_len=batch.get("kv_len"), backend=backend,
            memory=memory, mrope_positions=mrope)
        hidden = x
        x = _norm(p.final_norm, x, cfg.norm_eps, backend=backend)
        logits = _head(p, cfg, x) if head else x
    return Output(logits=logits, cache=new_cache, aux_loss=aux,
                  hidden=hidden, block=block)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _logits_nll(logits: torch.Tensor, labels: torch.Tensor,
                vocab_size: int) -> torch.Tensor:
    """Per-position negative log-likelihood in float32, the padded
    vocabulary's columns masked to -1e30. Under a model axis ``logits``
    are this rank's columns: the largest logit, the sum of exponentials
    below it and the target's logit are each all-reduced over ``model``
    (the last two with the identity for backward). Where the vocabulary
    is whole the callers bind ``_whole_vocab``."""
    lg = logits.float()
    tp = shd.model_axis()
    V = lg.shape[-1]
    lo = 0 if tp is None else tp.index * V
    if lo + V > vocab_size:
        pad_mask = lo + torch.arange(V, device=lg.device) < vocab_size
        lg = torch.where(pad_mask, lg, torch.full((), -1e30,
                                                  device=lg.device))
    if tp is None:
        lse = torch.logsumexp(lg, -1)
        tgt = torch.gather(lg, -1, labels[..., None])[..., 0]
        return lse - tgt
    m = mesh_lib.all_reduce(lg.detach().amax(-1), tp.group, "max")
    sum_exp = shd.reduce_from_model(torch.exp(lg - m[..., None]).sum(-1))
    local = labels - lo
    hit = (local >= 0) & (local < V)
    tgt = torch.gather(lg, -1, local.clamp(0, V - 1)[..., None])[..., 0]
    tgt = shd.reduce_from_model(torch.where(hit, tgt, torch.zeros(
        (), device=lg.device)))
    return torch.log(sum_exp) + m - tgt


def _mean(total: torch.Tensor, count: torch.Tensor,
          block: Optional[shd.SeqBlock]) -> torch.Tensor:
    """``total / max(count, 1)``, both summed over the sequence's axis
    first where it is cut (``launch.sharding.sum_over_seq``)."""
    if block is not None:
        total, count = shd.sum_over_seq(total, count, block)
    return total / torch.clamp(count, min=1.0)


def _xent(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
          vocab_size: int, block: Optional[shd.SeqBlock] = None
          ) -> torch.Tensor:
    """Masked mean cross-entropy. logits (B,S,Vp) any dtype, labels (B,S)
    int64, valid (B,S) float32 (with ``block``, this rank's block of each,
    the mean the whole sequence's)."""
    nll = _logits_nll(logits, labels, vocab_size) * valid
    return _mean(nll.sum(), valid.sum(), block)


def _xent_chunked(p: Params, cfg: ModelConfig, hidden_normed: torch.Tensor,
                  labels: torch.Tensor, valid: torch.Tensor,
                  block: Optional[shd.SeqBlock] = None) -> torch.Tensor:
    """The same loss with the head applied one sequence chunk of
    ``cfg.loss_chunk`` positions at a time (then the remainder), summed
    in chunk order (with ``block``, the chunks of this rank's block)."""
    B, S, D = hidden_normed.shape
    C = min(cfg.loss_chunk, S)
    total = torch.zeros((), dtype=torch.float32,
                        device=hidden_normed.device)
    for a in range(0, S, C):
        b = min(a + C, S)
        logits = _head(p, cfg, hidden_normed[:, a:b])
        with _whole_vocab(cfg):
            nll = _logits_nll(logits, labels[:, a:b], cfg.vocab_size)
        total = total + (nll * valid[:, a:b]).sum()
    return _mean(total, valid.sum(), block)


def _mtp_loss(p: Params, cfg: ModelConfig, hidden: torch.Tensor,
              nxt: torch.Tensor, labels2: torch.Tensor,
              valid2: torch.Tensor, positions: torch.Tensor, *,
              backend: str, block: Optional[shd.SeqBlock] = None
              ) -> torch.Tensor:
    """DeepSeek-V3 MTP (depth 1): predict t+2 from [norm(h_t);
    norm(E(t+1))] through one block of the last layer's kind; ``nxt`` are
    the tokens t+1 (with ``block``, of this rank's block, the block bound
    throughout), ``positions`` the whole sequence's."""
    m = p.mtp
    eps = cfg.norm_eps
    with shd.cut_sequence(block):
        e = _lookup(p, cfg, nxt)
        h = torch.cat([_norm(m.norm_h, hidden, eps, backend=backend),
                       _norm(m.norm_e, e, eps, backend=backend)], -1)
        h = h @ shd.block_leaf(m.proj)
        h, _, _ = block_apply(m.block, h, cfg=cfg,
                              kind=kind_for_layer(cfg, cfg.num_layers - 1),
                              positions=positions, pos0=0, mode="train",
                              cache=None, kv_len=None, backend=backend)
        h = _norm(m.final_norm, h, eps, backend=backend)
        if cfg.loss_chunk > 0:
            return _xent_chunked(p, cfg, h, labels2, valid2, block)
        logits = _head(p, cfg, h)
        with _whole_vocab(cfg):
            return _xent(logits, labels2, valid2, cfg.vocab_size, block)


def loss_fn(p: Params, batch: Dict[str, torch.Tensor], *, cfg: ModelConfig,
            mtp_weight: float = 0.3, backend: str = "cuda"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token LM loss (+ MoE aux + MTP). batch["tokens"]: (B, S+1) --
    inputs are [:, :-1], labels are [:, 1:]; an optional loss_mask
    (B, S+1) masks the labels by its [:, 1:]. Returns (loss, metrics:
    lm_loss, aux_loss with an MoE, mtp_loss with MTP, loss).

    Where a ``seq`` rule cuts the sequence (:func:`forward`), each rank
    holds the whole sequence of its rows of the batch (all of them, or
    its ``pod``'s), takes the labels, the mask and the MTP's shifted
    tokens of its block from them (so the next block's first token needs
    no collective), and the losses are the whole sequence's means on
    every rank (``launch.sharding.sum_over_seq``); the chunked loss's
    chunks are checked on the whole length first, as the reference's
    constraint checks them."""
    toks = batch["tokens"].long()
    inputs, labels = toks[:, :-1], toks[:, 1:]
    fb = dict(batch)
    fb["tokens"] = inputs
    chunked = cfg.loss_chunk > 0
    if chunked:
        B, S = inputs.shape
        C = min(cfg.loss_chunk, S)
        for n in {C, S % C} - {0}:
            shd.check_logits(B, n, cfg.padded_vocab())
    out = forward(p, fb, cfg=cfg, mode="train", backend=backend,
                  head=not chunked)
    block = out.block
    valid = torch.ones(labels.shape, dtype=torch.float32,
                       device=labels.device)
    if "loss_mask" in batch:
        valid = batch["loss_mask"][:, 1:].float()

    def mine(t):
        return t if block is None else \
            t[:, block.start:block.start + block.length]
    if chunked:
        with shd.cut_sequence(block):
            loss = _xent_chunked(p, cfg, out.logits, mine(labels),
                                 mine(valid), block)
    else:
        with _whole_vocab(cfg):
            loss = _xent(out.logits, mine(labels), mine(valid),
                         cfg.vocab_size, block)
    metrics = {"lm_loss": loss}
    if cfg.moe is not None:
        metrics["aux_loss"] = out.aux_loss
        loss = loss + cfg.moe.aux_loss_coef * out.aux_loss
    if cfg.mtp_depth > 0:
        labels2 = torch.roll(labels, -1, 1)                  # token t+2
        valid2 = valid.clone()
        valid2[:, -1] = 0.0
        pos = batch.get("positions")
        if pos is None:
            pos = positions_for(*inputs.shape, device=inputs.device)
        nxt = torch.roll(inputs, -1, 1)                      # token t+1
        lm = _mtp_loss(p, cfg, out.hidden, mine(nxt), mine(labels2),
                       mine(valid2), pos, backend=backend, block=block)
        metrics["mtp_loss"] = lm
        loss = loss + mtp_weight * lm
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# serving entry points
# ---------------------------------------------------------------------------


def prefill(p: Params, batch: Dict[str, torch.Tensor], *, cfg: ModelConfig,
            max_len: int, backend: str = "cuda"
            ) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt, return (last-token logits (B,Vp), filled cache).
    The logits of every position are computed, as in the reference; only
    a copy of the last position's outlives the call (gathered over
    ``model`` under a model axis). Under a ``seq`` rule that cuts the
    prompt (:func:`forward`) the last position is the last rank's, given
    to every rank (one all-gather), and the cache is this rank's blocks
    of the attention caches (as ``cut_cache`` of one process's prefill
    would give) and the SSM states the whole sequence's."""
    B, S = batch["tokens"].shape
    cache = init_cache(cfg, B, max_len, device=batch["tokens"].device)
    out = forward(p, batch, cfg=cfg, mode="prefill", cache=cache,
                  backend=backend)
    last = out.logits[:, -1:]
    if out.block is not None:
        last = shd.gather_seq(last, out.block)[:, -1:]
    last = last[:, 0]
    with _whole_vocab(cfg):
        return (last.clone() if shd.model_axis() is None
                else shd.gather_from_model(last)), out.cache


def decode_step(
    p: Params,
    token: torch.Tensor,            # (B,) the newest token
    pos: Union[int, torch.Tensor],  # its absolute position
    cache: Cache,
    *,
    cfg: ModelConfig,
    kv_len: Optional[torch.Tensor] = None,
    memory: Optional[torch.Tensor] = None,
    backend: str = "cuda",
) -> Tuple[torch.Tensor, Cache]:
    """One decode step: logits for the next token + the updated cache
    (the same list, written in place). An encoder-decoder takes the
    encoder's ``memory``. The positions are ``pos`` on every stream: an
    M-RoPE model decodes with plain RoPE, as in the reference."""
    B = token.shape[0]
    batch = {"tokens": token[:, None],
             "positions": positions_for(B, 1, pos, device=token.device)}
    if kv_len is not None:
        batch["kv_len"] = kv_len
    if memory is not None:
        batch["memory"] = memory
    out = forward(p, batch, cfg=cfg, mode="decode", cache=cache, pos0=pos,
                  backend=backend)
    with _whole_vocab(cfg):
        return shd.gather_from_model(out.logits[:, 0]), out.cache


# ---------------------------------------------------------------------------
# parameter sharding specs (path-based logical rules)
# ---------------------------------------------------------------------------

# leaf name -> logical spec for the *trailing* dims (leading stack dims pad
# with None). Names not listed replicate.
_SPEC_BY_NAME: Dict[str, Tuple] = {
    # embeddings / head
    "embed": ("vocab", "embed"),
    "lm_head": ("embed", "vocab"),
    "pos_embed": (None, "embed"),
    # attention
    "wq": ("embed", "heads"),
    "wk": ("embed", "heads"),
    "wv": ("embed", "heads"),
    "wo": ("heads", "embed"),
    "bq": ("heads",),
    "bk": ("heads",),
    "bv": ("heads",),
    # mla
    "wq_a": ("embed", None),
    "wq_b": (None, "heads"),
    "wkv_a": ("embed", None),
    "wkv_b": (None, "heads"),
    # mlp
    "w_gate": ("embed", "ff"),
    "w_up": ("embed", "ff"),
    "w_down": ("ff", "embed"),
    "b_up": ("ff",),
    # rwkv
    "wr": ("embed", "heads"),
    "wg": ("embed", "heads"),
    "lora_a": ("embed", None),
    "decay_a": ("embed", None),
    # mamba
    "in_proj": ("embed", "ff"),
    "x_proj": ("ff", None),
    "dt_proj": (None, "ff"),
    "out_proj": ("ff", "embed"),
    "conv_w": (None, "ff"),
    "conv_b": ("ff",),
    "A_log": ("ff", None),
    "D": ("ff",),
    # mtp
    "proj": (None, "embed"),
}

# MoE expert stacks are 3-D (E, d_in, d_out): ff dim sharded over model.
_MOE_3D = {"w_gate": (None, None, "ff"), "w_up": (None, None, "ff"),
           "w_down": (None, "ff", None)}


def _leaf_logical_spec(path: str, ndim: int, moe_paths=frozenset()
                       ) -> Tuple:
    """The reference's logical spec of its leaf ``path`` of rank ``ndim``;
    ``moe_paths`` are the MoE mlp dicts (those with a ``router`` leaf),
    whose ``w_gate`` / ``w_up`` / ``w_down`` are expert stacks."""
    name = path.split("/")[-1]
    spec: Optional[Tuple] = None
    if name in ("w_gate", "w_up", "w_down"):
        # distinguish dense MLP (2-D trailing) from expert stacks (3-D)
        expert = any(path.startswith(m) for m in moe_paths)
        spec = _MOE_3D[name] if (ndim >= 3 and expert) \
            else _SPEC_BY_NAME[name]
    elif name in _SPEC_BY_NAME:
        spec = _SPEC_BY_NAME[name]
    if spec is None:
        return (None,) * ndim
    pad = ndim - len(spec)
    if pad < 0:                      # leaf smaller than spec (shouldn't happen)
        return (None,) * ndim
    return (None,) * pad + tuple(spec)


def param_spec(params: Dict[str, torch.Tensor], cfg: ModelConfig
               ) -> Dict[str, Tuple]:
    """Each parameter's resolved spec under the bound axis rules
    (``launch.sharding.axis_rules``), by the reference's rule on its own
    leaf (``convert.jax_path``): the logical spec of the leaf at its rank
    there, the leading period entry of a stacked leaf dropped (it is
    ``None``), then resolved on the port's per-layer shape. The MoE expert
    stacks are the ``w_gate`` / ``w_up`` / ``w_down`` of an mlp with a
    ``router``, as in the reference."""
    from repro_torch.models.convert import jax_path
    paths = {n: jax_path(n, cfg) for n in params}
    moe_paths = frozenset(path[:-len("router")] for path, _ in paths.values()
                          if path.endswith("/router"))
    out = {}
    for n, p in params.items():
        path, stacked = paths[n]
        spec = _leaf_logical_spec(path, p.dim() + stacked, moe_paths)
        out[n] = shd.resolve_spec(p.shape, spec[int(stacked):])
    return out


_CACHE_SPEC = {
    # gqa cache (B, C, KV, Dh); mla (B, C, lora) / (B, C, dr)
    "k": attn.KV_CACHE_SPEC,
    "v": attn.KV_CACHE_SPEC,
    "c": attn.LATENT_CACHE_SPEC,
    "kr": attn.LATENT_CACHE_SPEC,
    # ssm states
    "last_x": ("batch", "embed"),
    "state": ("batch", "heads", None, None),
    "conv": ("batch", None, "ff"),
    "h": ("batch", "ff", None),
}


def cache_spec(cache: Cache) -> List[Dict[str, Dict[str, Tuple]]]:
    """Each cache leaf's resolved spec under the bound axis rules, by the
    reference's rule on its leaf name (the list of per-layer dicts the
    cache is, with a spec in place of each tensor), on the leaf's whole
    shape (an attention cache's whole sequence: ``SeqCache.capacity``)."""
    def fn(name, leaf, capacity):
        spec = tuple(_CACHE_SPEC.get(name, ()))
        pad = leaf.dim() - len(spec)
        spec = (None,) * leaf.dim() if pad < 0 else (None,) * pad + spec
        shape = list(leaf.shape)
        if capacity is not None:
            shape[1] = capacity
        return shd.resolve_spec(shape, spec)
    return [{part: {n: fn(n, t, getattr(leaves, "capacity", None))
                    for n, t in leaves.items()}
             for part, leaves in layer.items()} for layer in cache]


def _block_kind(cfg: ModelConfig, name: str) -> Optional[LayerKind]:
    """The kind of the block that holds parameter ``name``, ``None`` for
    a parameter outside the blocks."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return _kind(cfg, int(parts[1]))
    if parts[0] == "enc_blocks":
        return ENC_KIND
    if parts[:2] == ["mtp", "block"]:
        return kind_for_layer(cfg, cfg.num_layers - 1)
    return None


def _tp_leaf(cfg: ModelConfig, kind: LayerKind, part: str, leaf: str,
             spec: Tuple, tp: int) -> Tuple:
    """The spec the port shards a block's leaf by on a ``model`` axis of
    ``tp``: ``spec`` (the reference's), or ``None`` throughout for a leaf
    every rank keeps whole, or the port's own cut."""
    whole = (None,) * len(spec)
    if part == "cross" or (part == "mixer" and kind.mixer == "gqa"):
        if not attn.heads_sharded(cfg, tp) or (
                leaf in ("wk", "wv", "bk", "bv")
                and not attn.kv_sharded(cfg, tp)):
            return whole
    elif part == "mixer" and kind.mixer == "mla":
        if not attn.heads_sharded(cfg, tp):
            return whole
    elif part == "mixer" and kind.mixer == "rwkv":
        if cfg.num_heads % tp:
            return whole
    elif part == "mixer" and kind.mixer == "mamba":
        if (cfg.ssm.expand * cfg.d_model) % tp:
            return whole
        if leaf == "in_proj":
            # [x | z]: the reference's ("embed", "ff") cuts contiguous
            # columns, which at model 2 would give one rank all of x and
            # the other all of z; the port cuts each half
            return (None, shd.Halves("model"))
    elif part == "mlp" and kind.mlp == "cmix":
        # the reference's name-keyed rules give the channel mix's wk / wv
        # the attention's ("embed", "heads"), which cuts wv's output
        # columns; the port runs wv row-parallel on d_ff, and wr whole;
        # all three whole where the axis does not divide d_ff (wk's
        # fallback in the reference)
        if cfg.d_ff % tp:
            return whole
        if leaf == "wv":
            return ("model", None)
        if leaf == "wr":
            return whole
    return spec


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Each parameter's whole shape, drawn on the meta device."""
    with torch.device("meta"):
        meta = init_params(cfg, torch.Generator(), device="meta")
    return {n: tuple(t.shape) for n, t in meta.named_parameters()}


def tp_param_spec(cfg: ModelConfig, mesh) -> Dict[str, Tuple]:
    """Each parameter's spec on ``mesh`` as the port shards it: the
    reference's (:func:`param_spec`, on the whole leaves' shapes, drawn
    on the meta device), except where :func:`_tp_leaf` departs: a mixer's
    leaves that every rank keeps whole where the ``model`` axis does not
    divide its heads (GQA, cross attention and MLA by
    ``attention.heads_sharded``, RWKV-6 by its heads) or Mamba's inner
    channels, and a GQA or cross attention's ``wk`` / ``wv`` / ``bk`` /
    ``bv`` where it does not divide the KV heads
    (``attention.kv_sharded``); Mamba's ``in_proj`` cut half by half
    (``launch.sharding.Halves``); the channel mix's ``wv`` row-parallel
    and ``wr`` whole, or all its leaves whole where the axis does not
    divide ``d_ff``. A dense MLP's leaves (``w_gate``, ``w_up``,
    ``w_down``, ``b_up``) and ``embed`` / ``lm_head`` whose width the axis
    does not divide are whole by the reference's own fallback, which
    ``launch.sharding.fallbacks`` records."""
    with torch.device("meta"):
        meta = init_params(cfg, torch.Generator(), device="meta")
    named = dict(meta.named_parameters())
    with shd.axis_rules(mesh):
        spec = param_spec(named, cfg)
    tp = mesh_lib.model_size(mesh)
    if tp <= 1:
        return spec
    for n in named:
        kind = _block_kind(cfg, n)
        if kind is not None:
            *_, part, leaf = n.split(".")
            spec[n] = _tp_leaf(cfg, kind, part, leaf, spec[n], tp)
    return spec
