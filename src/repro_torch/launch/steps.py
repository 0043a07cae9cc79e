"""Step factories for serving: prefill and decode.

The counterpart of the serve half of ``repro.launch.steps``
(``make_prefill_step`` / ``make_decode_step``, whose decode step takes
the encoder-decoder's ``memory``). There is no ``jit`` and no sharding to
attach on one card: a step is the model call with the kernel backend
bound. The train step, gradient accumulation and the dry-run lowering
come with their slices (``ROADMAP.md``).
"""
from __future__ import annotations

from repro_torch.models.api import Model


def make_prefill_step(model: Model, max_len: int, backend: str = "cuda"):
    def prefill_step(batch):
        logits, cache = model.prefill(batch, max_len=max_len, backend=backend)
        return logits, cache
    return prefill_step


def make_decode_step(model: Model, backend: str = "cuda"):
    def decode_step(token, pos, kv_len, cache, memory=None):
        logits, cache = model.decode_step(token, pos, cache, kv_len=kv_len,
                                          memory=memory, backend=backend)
        return logits, cache
    return decode_step
