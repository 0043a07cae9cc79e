"""Optimizer substrate: AdamW (cosine + warmup, global-norm clip, the
reference's decay mask) over a dict of parameters, updated in place. The
ZeRO-1 state sharding and the int8 gradient compression wait for the
mesh (``ROADMAP.md`` Queue 1 items 10b and 11)."""
from repro_torch.optim.adamw import (OptState, adamw_update,  # noqa: F401
                                     clip_by_global_norm, cosine_lr,
                                     decay_mask, global_norm, init_opt_state)
