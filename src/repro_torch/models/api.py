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
``launch.train.train`` does. The abstract input specs of the dry-run
come with its port.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm


class Model(nn.Module):
    """``device=None`` is the card, and raises without one."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        tfm.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params: Optional[tfm.Params] = None

    # -- construction ------------------------------------------------------
    def init(self, seed: int = 0) -> tfm.Params:
        """Seeded random parameters at the configuration's widths, drawn
        on the model's device (a ``torch.Generator`` there)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = tfm.init_params(self.cfg, gen, device=self.device)
        return self.params

    def param_spec(self) -> Dict[str, Tuple]:
        """Each parameter's resolved spec under the bound axis rules
        (:func:`repro_torch.models.transformer.param_spec`)."""
        return tfm.param_spec(dict(self._p().named_parameters()), self.cfg)

    def init_cache(self, batch: int, max_len: int) -> tfm.Cache:
        return tfm.init_cache(self.cfg, batch, max_len, device=self.device)

    def _p(self) -> tfm.Params:
        if self.params is None:
            raise RuntimeError("the model has no parameters: call init() or "
                               "load them with convert.params_from_jax")
        return self.params

    # -- execution ---------------------------------------------------------
    def forward(self, batch: Dict[str, torch.Tensor], mode: str = "train",
                cache: Optional[tfm.Cache] = None, *, backend: str = "cuda"
                ) -> tfm.Output:
        return tfm.forward(self._p(), batch, cfg=self.cfg, mode=mode,
                           cache=cache, backend=backend)

    def loss(self, batch: Dict[str, torch.Tensor], *, backend: str = "cuda"
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of the batch (tokens (B, S+1)):
        :func:`repro_torch.models.transformer.loss_fn`. Raises
        ``NotImplementedError`` for a configuration with RWKV-6 or Mamba
        layers."""
        return tfm.loss_fn(self._p(), batch, cfg=self.cfg, backend=backend)

    def prefill(self, batch: Dict[str, torch.Tensor], max_len: int, *,
                backend: str = "cuda") -> Tuple[torch.Tensor, tfm.Cache]:
        return tfm.prefill(self._p(), batch, cfg=self.cfg, max_len=max_len,
                           backend=backend)

    def encode(self, enc_embeds: torch.Tensor, *, backend: str = "cuda"
               ) -> torch.Tensor:
        """The encoder-decoder's memory (B, S_enc, D) from frame
        embeddings (B, S_enc, D)."""
        return tfm.encode(self._p(), self.cfg, enc_embeds, backend=backend)

    def decode_step(self, token, pos, cache, kv_len=None, memory=None, *,
                    backend: str = "cuda") -> Tuple[torch.Tensor, tfm.Cache]:
        return tfm.decode_step(self._p(), token, pos, cache, cfg=self.cfg,
                               kv_len=kv_len, memory=memory, backend=backend)


def build_model(cfg: ModelConfig, *, device=None) -> Model:
    """Raises ``NotImplementedError`` for a configuration with a layer kind
    the port does not build (every configuration of the registry has only
    built kinds), ``RuntimeError`` for ``device=None`` without a card."""
    return Model(cfg, device=device)
