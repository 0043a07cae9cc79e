"""Rotary position embeddings: standard RoPE and Qwen2-VL's M-RoPE.

The counterpart of ``repro.models.rope``: ``rope_freqs``, ``apply_rope``,
``apply_mrope`` and ``positions_for``. Angles are float32, the rotation is
done in float32 and cast back to the input's dtype.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for the even half of the head dim. (head_dim//2,)"""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
            ) -> torch.Tensor:
    """x: (..., D) with D even, cos/sin broadcastable to (..., D//2)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_rope(
    x: torch.Tensor,               # (B, S, H, D)
    positions: torch.Tensor,       # (B, S) or (S,) integer
    theta: float = 10_000.0,
) -> torch.Tensor:
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, device=x.device)            # (D/2,)
    pos = positions.to(device=x.device, dtype=torch.float32)
    ang = pos[..., None] * freqs                             # (B,S,D/2) or (S,D/2)
    if ang.dim() == 2:                                       # (S, D/2)
        ang = ang[None]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    return _rotate(x, cos, sin)


def apply_mrope(
    x: torch.Tensor,               # (B, S, H, D)
    positions: torch.Tensor,       # (3, B, S): temporal, height, width
    theta: float = 10_000.0,
    sections: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the D/2 frequency channels are split into
    (t, h, w) sections, each rotated by its own position stream. By
    default the sections are ``t = D/2 // 4`` and ``h, w`` halves of the
    rest (16/24/24 at head dim 128). With three equal streams M-RoPE is
    RoPE."""
    D = x.shape[-1]
    half = D // 2
    if sections is None:
        t = half // 4
        hw = (half - t) // 2
        sections = (t, hw, half - t - hw)
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"{half}")
    freqs = rope_freqs(D, theta, device=x.device)            # (half,)
    pos = positions.to(device=x.device, dtype=torch.float32)
    ang = pos[..., None] * freqs                             # (3,B,S,half)
    # section i of the channels from stream i
    parts, off = [], 0
    for i, sec in enumerate(sections):
        parts.append(ang[i, :, :, off:off + sec])
        off += sec
    ang = torch.cat(parts, -1)                               # (B,S,half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    return _rotate(x, cos, sin)


def positions_for(batch: int, seq: int,
                  offset: Union[int, torch.Tensor] = 0, device=None
                  ) -> torch.Tensor:
    """(B, S) absolute positions starting at ``offset`` (scalar or (B,)).
    A Python offset is added on the device, with no host-to-device copy."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    if isinstance(offset, torch.Tensor):
        off = offset.to(device=pos.device, dtype=torch.int32)
        pos = pos + (off.reshape(-1, 1) if off.dim() else off)
    else:
        pos = pos + int(offset)
    return pos.expand(batch, seq)
