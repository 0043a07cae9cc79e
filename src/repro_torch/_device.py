"""The device an entry point of the port runs on."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device an entry point runs on. ``None`` means the card and
    raises when there is none — the CPU is used only when asked for by
    name, never as a stand-in."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device=None means 'cuda', and no CUDA device is available; "
                "pass device='cpu' explicitly to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested and no CUDA device is "
                f"available; pass device='cpu' explicitly to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
