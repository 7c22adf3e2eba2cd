"""Explicit device selection.

The reference picks JAX's default backend. The port never chooses for the
caller: ``"cuda"`` means the GPU and raises when there is none, ``"cpu"``
means the plain PyTorch versions of every kernel. Nothing falls back from
one to the other.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | int = "cuda") -> torch.device:
    """``"cuda"``, ``"cuda:N"``, ``"cpu"``, a ``torch.device`` or a CUDA
    ordinal -> a concrete ``torch.device``. Raises ``RuntimeError`` when a
    CUDA device is asked for and none is usable."""
    if isinstance(device, int):
        device = torch.device("cuda", device)
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain PyTorch path"
        )
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {str(dev)!r} requested but only "
            f"{torch.cuda.device_count()} CUDA device(s) exist"
        )
    return torch.device("cuda", index)
