"""The device a rule's state and kernels live on."""
from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device, None]


def resolve_device(device: Device) -> torch.device:
    """CUDA unless the caller names another device. Without a card, only an
    explicit `device="cpu"` runs; nothing falls back to the CPU on its own."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the rule on "
            "the CPU")
    return dev
