"""The device an entry point of the port puts its tensors on."""

from __future__ import annotations

import torch


def as_device(device=None) -> torch.device:
    """The device an entry point puts its tensors on: CUDA unless the
    caller names another.  Raises when CUDA is asked for and absent,
    instead of landing on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port's plain torch path on the CPU")
    return device
