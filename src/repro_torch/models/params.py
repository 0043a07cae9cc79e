"""Parameter initialisation on an explicit ``torch.Generator`` and device.

The counterpart of ``repro.models.params``. The draws follow the
reference's distributions (a standard normal truncated at +-2, then
multiplied by ``std``), not its bits: ``jax.random`` and ``torch`` give
different numbers from one seed, so a test that compares the two packages
loads the JAX package's parameters (:mod:`repro_torch.models.convert`).
Each tensor is drawn in float32 on the target device and then cast, one at
a time, so a 7B model never holds all its parameters in float32 at once.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn


def trunc_normal(gen: torch.Generator, shape: Sequence[int], std=0.02,
                 dtype=torch.bfloat16, device=None,
                 cut: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                 ) -> torch.Tensor:
    """``truncated_normal(-2, 2) * std``: the bounds are in units of the
    standard normal, as ``jax.random.truncated_normal`` takes them. With
    ``cut`` only a copy of ``cut(whole)`` is kept, in ``dtype`` (the same
    values; neither the float32 draw nor a whole copy in ``dtype``
    outlives the call, where a float32 view would keep the draw)."""
    x = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    nn.init.trunc_normal_(x, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
    x.mul_(std)
    if cut is None:
        return x.to(dtype)
    return cut(x).to(dtype, copy=True)


def dense_init(gen, d_in, d_out, *, std: Optional[float] = None,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    std = std if std is not None else (1.0 / math.sqrt(d_in))
    return trunc_normal(gen, (d_in, d_out), std=std, dtype=dtype,
                        device=device)


def embed_init(gen, vocab, d, *, dtype=torch.bfloat16, device=None
               ) -> torch.Tensor:
    return trunc_normal(gen, (vocab, d), std=0.02, dtype=dtype, device=device)


def zeros(shape, dtype=torch.bfloat16, device=None) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones(shape, dtype=torch.bfloat16, device=None) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


def param(x: torch.Tensor) -> nn.Parameter:
    """A parameter as serving holds it, with ``requires_grad=False``;
    ``nn.Module.requires_grad_(True)`` on the model makes it trainable."""
    return nn.Parameter(x, requires_grad=False)

