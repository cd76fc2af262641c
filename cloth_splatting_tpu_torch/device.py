"""Device selection for the port's entry points.

Entry points that create tensors take ``device`` and default to ``"cuda"``;
they run on the CPU only when the caller asks for it (the tests do)."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def check_on(device: torch.device, **tensors: torch.Tensor) -> None:
    """Raise unless every named tensor lies on ``device``."""
    for name, t in tensors.items():
        if t.device.type != device.type:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work on a CUDA ``device``; nothing on the
    CPU. Host clocks around device work start and stop at one."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
