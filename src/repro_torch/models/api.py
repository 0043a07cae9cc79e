"""Public model API: ``Model``, an ``nn.Module`` over the transformer
assembly, on an explicit device.

The counterpart of ``repro.models.api.Model``: ``init`` /
``init_cache`` / ``forward`` / ``loss`` / ``encode`` / ``prefill`` /
``decode_step``, and ``param_spec``.
``encode`` is the encoder-decoder's encoder (the reference's
``transformer.encode``, which its ``generate`` calls directly). The
reference's ``Model`` is a stateless facade whose methods take the
parameter pytree; here the module holds its parameters (``params``, set
by :meth:`Model.init` or :func:`repro_torch.models.convert.params_from_jax`)
and every execution method takes the kernel backend (``"cuda"``, the
default, or ``"torch"``; :mod:`repro_torch.kernels.ops`). Parameters are in
``cfg.param_dtype``, activations and the cache in ``cfg.dtype``. They
are built as serving parameters (``requires_grad=False``);
``model.requires_grad_(True)`` (``nn.Module``'s) makes them trainable, as
``launch.train.train`` does.

For the dry run (``launch.dryrun``) the module also holds the reference's
abstract half: :meth:`Model.abstract_params`, :meth:`Model.abstract_cache`
and :meth:`Model.cache_spec`, and the input specs
(:func:`train_input_specs`, :func:`prefill_input_specs`,
:func:`decode_input_specs`, :func:`input_specs`) as tensors on the meta
device at the reference's shapes and dtypes, with :func:`make_concrete`
to draw real ones.

``mesh`` (``launch.mesh``) is the mesh the model runs on: every method
binds it (``launch.sharding.axis_rules``) for its call, under the
default rules unless the caller has bound it with its own (a ``seq``
rule for context parallelism: under ``seq -> data`` at a batch that
``pod x data`` does not divide, whole or cut over ``pod``, and under
``seq -> model`` where the vocabulary falls back, and in the encoder,
:meth:`Model.prefill`, :meth:`Model.loss` and :meth:`Model.encode` run
each rank's block of the sequence, the prefill returning the rank's
blocks of the cache, which :meth:`Model.decode_step` takes as they are;
a cache a prefill made under the default rules is cut with
:meth:`Model.cut_cache`; a rank's slice of a global batch is taken by
``launch.steps.rank_slice``, which binds the global size). On a mesh
whose ``model`` axis is larger than 1 the model holds only this rank's shard
of each parameter, as :attr:`Model.spec` gives it
(``transformer.tp_param_spec``), and runs tensor parallel (every layer
kind has a tensor-parallel path); a leaf whose width the axis does not
divide (a mixer's heads, an MLP's width, the padded vocabulary) is held
whole and its layer runs whole on every rank, as the reference's
divisibility fallback replicates it, and a MoE's expert width that the
axis does not divide is refused with ``ValueError`` when the model is
built, as the reference's ``shard_map`` refuses it
(``transformer.require_supported``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import sharding as shd
from repro_torch.models import transformer as tfm


class Model(nn.Module):
    """``device=None`` is the card, and raises without one."""

    def __init__(self, cfg: ModelConfig, *, device=None, mesh=None):
        super().__init__()
        tfm.check_supported(cfg)
        if mesh is not None:
            tfm.require_supported(mesh, cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        # each parameter's spec on the mesh (None without one)
        self.spec: Optional[Dict[str, Tuple]] = None if mesh is None \
            else tfm.tp_param_spec(cfg, mesh)
        self.shapes: Optional[Dict[str, Tuple[int, ...]]] = None \
            if mesh is None else tfm.param_shapes(cfg)
        self.params: Optional[tfm.Params] = None

    # -- construction ------------------------------------------------------
    def init(self, seed: int = 0) -> tfm.Params:
        """Seeded random parameters at the configuration's widths, drawn
        on the model's device (a ``torch.Generator`` there). On a mesh
        each leaf is drawn whole, as one process draws it, and cut to this
        rank's shard at once (``transformer.init_params(keep=)``)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        keep = None if self.mesh is None else self.shard
        self.params = tfm.init_params(self.cfg, gen, device=self.device,
                                      keep=keep)
        return self.params

    def shard(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's shard of parameter ``name`` from its whole value
        (a view; the value itself without a mesh, or where its shape is
        no longer the whole's: it was cut as it was drawn)."""
        if self.mesh is None or tuple(whole.shape) != self.shapes[name]:
            return whole
        return shd.shard_of(whole, self.spec[name], self.mesh)

    def gather(self, name: str, part: torch.Tensor) -> torch.Tensor:
        """The whole value of parameter ``name`` from this rank's shard
        ``part`` (an all-gather over ``model`` for a sharded leaf: every
        rank of the mesh joins; ``part`` itself, detached, for a leaf that
        is not sharded)."""
        if self.mesh is None:
            return part.detach()
        return shd.gather_full(part, self.spec[name], self.mesh)

    def param_spec(self) -> Dict[str, Tuple]:
        """Each parameter's resolved spec: on a model built with a mesh,
        :attr:`spec`; otherwise under the bound axis rules
        (:func:`repro_torch.models.transformer.param_spec`)."""
        if self.spec is not None:
            return dict(self.spec)
        return tfm.param_spec(dict(self._p().named_parameters()), self.cfg)

    def fallbacks(self) -> List[Tuple[str, int, int]]:
        """The divisibility fallbacks ``(logical name, dim, divisor)`` the
        reference's rules make on this model's whole parameters, each
        once, sorted (``launch.sharding.fallbacks`` after
        :func:`repro_torch.models.transformer.param_spec`): under the bound
        rules where its mesh is bound, else the mesh's defaults; ``[]``
        without a mesh."""
        if self.mesh is None:
            return []
        with self.bound():
            seen = len(shd.fallbacks())
            tfm.param_spec({n: torch.empty(s, device="meta")
                            for n, s in self.shapes.items()}, self.cfg)
            return sorted(set(shd.fallbacks()[seen:]))

    def bound(self):
        """A context binding the model's mesh (nothing without one, or
        when it is bound already)."""
        if self.mesh is None or shd.active_mesh() is self.mesh:
            return contextlib.nullcontext()
        return shd.axis_rules(self.mesh)

    def abstract_params(self) -> tfm.Params:
        """This rank's parameters as meta tensors at their shard shapes
        (:attr:`shapes` cut by :attr:`spec` on a mesh), with
        ``requires_grad`` as :meth:`init` sets it (``False``). Nothing is
        drawn: the meta device holds no values (and takes no generator of
        its own, so :meth:`init` cannot serve). The model keeps its own
        ``params``; set them to the result to trace on the meta device."""
        keep = None if self.mesh is None else self.shard
        with torch.device("meta"):
            return tfm.init_params(self.cfg, torch.Generator(),
                                   device="meta", keep=keep)

    def abstract_cache(self, batch: int, max_len: int) -> tfm.Cache:
        """:meth:`init_cache` on the meta device: this rank's cache for
        ``batch`` sequences of ``max_len``."""
        with self.bound():
            return tfm.init_cache(self.cfg, batch, max_len, device="meta")

    def cache_spec(self, cache: tfm.Cache):
        """Each cache leaf's resolved spec (the reference's
        ``transformer.cache_spec`` rule by leaf name), under the model's
        mesh or, without one, the bound axis rules."""
        with self.bound():
            return tfm.cache_spec(cache)

    def init_cache(self, batch: int, max_len: int) -> tfm.Cache:
        """This rank's cache: its heads, and its block of each attention
        cache's sequence under a bound ``seq`` rule."""
        with self.bound():
            return tfm.init_cache(self.cfg, batch, max_len,
                                  device=self.device)

    def cut_cache(self, cache: tfm.Cache) -> tfm.Cache:
        """This rank's block of each attention cache's sequence under the
        bound ``seq`` rule, from the whole cache a prefill under the
        default rules made (``transformer.cut_cache``): the counterpart of
        the reference's ``jit(in_shardings=)`` resharding the prefill's
        cache for the decode step. Bind the rules around it and the
        decode steps: ``with axis_rules(mesh, {"seq": "data"}):``."""
        with self.bound():
            return tfm.cut_cache(cache, self.cfg)

    def gather_cache(self, cache: tfm.Cache) -> tfm.Cache:
        """The whole cache, as the default rules lay it out, from every
        rank's blocks under the bound ``seq`` rule (every rank of the
        cut's axes joins): the inverse of :meth:`cut_cache`."""
        with self.bound():
            return tfm.gather_cache(cache, self.cfg)

    def _p(self) -> tfm.Params:
        if self.params is None:
            raise RuntimeError("the model has no parameters: call init() or "
                               "load them with convert.params_from_jax")
        return self.params

    # -- execution ---------------------------------------------------------
    def forward(self, batch: Dict[str, torch.Tensor], mode: str = "train",
                cache: Optional[tfm.Cache] = None, *, backend: str = "cuda"
                ) -> tfm.Output:
        with self.bound():
            return tfm.forward(self._p(), batch, cfg=self.cfg, mode=mode,
                               cache=cache, backend=backend)

    def loss(self, batch: Dict[str, torch.Tensor], *, backend: str = "cuda"
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of the batch (tokens (B, S+1)):
        :func:`repro_torch.models.transformer.loss_fn`."""
        with self.bound():
            return tfm.loss_fn(self._p(), batch, cfg=self.cfg,
                               backend=backend)

    def prefill(self, batch: Dict[str, torch.Tensor], max_len: int, *,
                backend: str = "cuda") -> Tuple[torch.Tensor, tfm.Cache]:
        with self.bound():
            return tfm.prefill(self._p(), batch, cfg=self.cfg,
                               max_len=max_len, backend=backend)

    def encode(self, enc_embeds: torch.Tensor, *, backend: str = "cuda"
               ) -> torch.Tensor:
        """The encoder-decoder's memory (B, S_enc, D) from frame
        embeddings (B, S_enc, D)."""
        with self.bound():
            return tfm.encode(self._p(), self.cfg, enc_embeds,
                              backend=backend)

    def decode_step(self, token, pos, cache, kv_len=None, memory=None, *,
                    backend: str = "cuda") -> Tuple[torch.Tensor, tfm.Cache]:
        with self.bound():
            return tfm.decode_step(self._p(), token, pos, cache,
                                   cfg=self.cfg, kv_len=kv_len,
                                   memory=memory, backend=backend)


def build_model(cfg: ModelConfig, *, device=None, mesh=None) -> Model:
    """Raises ``NotImplementedError`` for a configuration with a layer kind
    the port does not build (every configuration of the registry has only
    built kinds), or, on a ``mesh`` whose ``model`` axis is larger than 1,
    one with an MLP width or a padded vocabulary that the axis does not
    divide; ``RuntimeError`` for
    ``device=None`` without a card."""
    return Model(cfg, device=device, mesh=mesh)


# ---------------------------------------------------------------------------
# abstract input specs per (arch family, shape cell)
# ---------------------------------------------------------------------------

# token, position and length tensors are int32, as the port's pipeline
# (``data.SyntheticLM``) and ``launch.serve`` make them and the reference's
# specs have them; the losses widen the tokens to int64 where they index
I32 = torch.int32
F32 = torch.float32


def _sds(shape, dtype=I32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape) -> Dict[str, torch.Tensor]:
    """Inputs for ``loss_fn``: tokens (B, S+1) plus modality extras."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        # budget: S_enc = S_dec = S/2 (DESIGN.md §4)
        Se = Sd = S // 2
        return {
            "tokens": _sds((B, Sd + 1)),
            "enc_embeds": _sds((B, Se, cfg.d_model), F32),
        }
    specs = {"tokens": _sds((B, S + 1))}
    if cfg.frontend == "vision":
        n_patch = max(1, S // 4)                 # stub: 25% image patches
        specs["patch_embeds"] = _sds((B, n_patch, cfg.d_model), F32)
        specs["patch_positions"] = _sds((B, n_patch))
    if cfg.rope == "mrope":
        specs["mrope_positions"] = _sds((3, B, S))
    return specs


def prefill_input_specs(cfg: ModelConfig, shape) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        Se = Sd = S // 2
        return {
            "tokens": _sds((B, Sd)),
            "enc_embeds": _sds((B, Se, cfg.d_model), F32),
        }
    specs = {"tokens": _sds((B, S))}
    if cfg.frontend == "vision":
        n_patch = max(1, S // 4)
        specs["patch_embeds"] = _sds((B, n_patch, cfg.d_model), F32)
        specs["patch_positions"] = _sds((B, n_patch))
    if cfg.rope == "mrope":
        specs["mrope_positions"] = _sds((3, B, S))
    return specs


def decode_input_specs(cfg: ModelConfig, shape) -> Dict[str, torch.Tensor]:
    """Inputs for one ``decode_step`` with a KV cache of ``seq_len``."""
    B = shape.global_batch
    specs = {
        "token": _sds((B,)),
        "pos": _sds(()),
        "kv_len": _sds((B,)),
    }
    if cfg.is_encoder_decoder:
        Se = shape.seq_len // 2
        specs["memory"] = _sds((B, Se, cfg.d_model), F32)
    return specs


def input_specs(cfg: ModelConfig, shape) -> Dict[str, torch.Tensor]:
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)


def make_concrete(specs: Dict[str, torch.Tensor], cfg: ModelConfig,
                  seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random concrete inputs matching ``specs``, on the CPU, drawn in
    order through one ``torch.Generator`` seeded with ``seed`` (the
    reference's distributions, not its bits)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    out = {}
    for name, s in specs.items():
        if name in ("tokens", "token"):
            out[name] = torch.randint(0, cfg.vocab_size, tuple(s.shape),
                                      generator=gen, dtype=s.dtype)
        elif name in ("patch_positions", "mrope_positions"):
            # distinct in-range positions per row
            n = s.shape[-1]
            out[name] = torch.arange(n, dtype=s.dtype).expand(
                tuple(s.shape)).clone()
        elif name == "pos":
            out[name] = torch.zeros((), dtype=s.dtype)
        elif name == "kv_len":
            out[name] = torch.ones(tuple(s.shape), dtype=s.dtype)
        else:
            out[name] = torch.randn(tuple(s.shape), generator=gen,
                                    dtype=s.dtype) * 0.02
    return out
