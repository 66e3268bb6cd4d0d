"""Where the port's builders put what they build: on the card unless the
caller asks for the CPU by name (``device="cpu"``)."""

from __future__ import annotations

import torch

__all__ = ["target_device"]


def target_device(device) -> torch.device:
    """``device`` as a ``torch.device``. A CUDA device with no card raises
    ``RuntimeError``: a builder never falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is available; "
            "pass device='cpu' to build on the CPU"
        )
    return device
