"""Device resolution shared by the port's entry points.

Entry points run on the card by default.  A caller that wants the CPU
(the tests, a host without a GPU) says so with ``device="cpu"``; nothing
falls back to the CPU on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the first CUDA device.  Raises when CUDA is asked
    for (explicitly or by default) and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "blit_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_name(device: Optional[Union[str, torch.device]] = None) -> str:
    """The name of the device an entry point would run on (the card's
    ``torch.cuda.get_device_name``, or ``"cpu"``): what a remote agent
    reports about its own card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"
