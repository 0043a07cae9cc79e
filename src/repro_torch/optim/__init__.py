"""Optimizer substrate: AdamW (cosine + warmup, global-norm clip, the
reference's decay mask) over a dict of parameters, updated in place, with
the moments' ZeRO-1 layout under a mesh; and the int8 gradient
compression (``optim.compress``)."""
from repro_torch.optim.adamw import (OptState, Zero1,  # noqa: F401
                                     adamw_update, clip_by_global_norm,
                                     cosine_lr, decay_mask, global_norm,
                                     init_opt_state, opt_state_spec,
                                     zero1_layout)
