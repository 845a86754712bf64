"""Device resolution for the port: the one place that decides where
tensors live.

``None`` means the card: ``resolve_device(None)`` is ``cuda`` and raises
where ``torch.cuda.is_available()`` is false, so an entry point never
runs on the CPU without being asked. The CPU is a device the caller
names explicitly (``"cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


class NoCudaDevice(RuntimeError):
    """The card was asked for (explicitly or by default) and there is
    none."""


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a name or ``torch.device`` passes through.
    A CUDA device is checked for, never swapped for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDevice(
            "no CUDA device: torch.cuda.is_available() is false; pass "
            "device='cpu' to run on the CPU explicitly")
    return dev
