"""The device a rule's state and kernels live on, and the device list a
sharded rule's mesh is built from."""
from __future__ import annotations

from typing import List, Sequence, Union

import torch

Device = Union[str, torch.device, Sequence[Union[str, torch.device]], None]

#: where the port's mesh across more than one card is planned
_ITEM9 = ("a mesh across more than one card is not ported yet (ROADMAP "
          "Queue 1 item 9)")


def resolve_device(device: Device) -> torch.device:
    """CUDA unless the caller names another device. Without a card, only an
    explicit `device="cpu"` runs; nothing falls back to the CPU on its own.
    A device list (a sharded rule's, see resolve_devices) resolves to its
    first device, where the state lives."""
    if isinstance(device, (list, tuple)):
        return resolve_devices(device)[0]
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the rule on "
            "the CPU")
    return dev


def resolve_devices(device: Device) -> List[torch.device]:
    """The devices a rule may place a mesh on, the port's counterpart of
    what `jax.devices()` shows the reference's planner: None gives every
    visible card (cuda:0 ... cuda:n-1; raises without one), one device
    gives a list of it, a list is taken as it is. A list may name one
    device several times: ["cpu"] * 8, or ["cuda:0"] * 8 on one card, is
    the counterpart of the reference's 8-device virtual mesh
    (--xla_force_host_platform_device_count=8). A list of two different
    devices raises NotImplementedError: it is never run as a virtual
    mesh on one of them."""
    if device is None:
        if not torch.cuda.is_available():
            resolve_device(None)  # raises the port's no-card error
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if not isinstance(device, (list, tuple)):
        return [resolve_device(device)]
    devs = [resolve_device(d) for d in device]
    if not devs:
        raise ValueError("an empty device list")
    first = _canonical(devs[0])
    if any(_canonical(d) != first for d in devs[1:]):
        raise NotImplementedError(
            f"devices {sorted({str(d) for d in devs})}: {_ITEM9}")
    return devs


def _canonical(dev: torch.device) -> torch.device:
    """"cuda" names the current card: the same device as its index."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
