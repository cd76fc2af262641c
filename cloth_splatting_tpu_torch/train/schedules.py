"""Learning-rate schedules; counterpart of
``cloth_splatting_tpu/train/schedules.py``."""

from __future__ import annotations

import math

import torch


def expon_lr(step: torch.Tensor, lr_init: float, lr_final: float,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
             max_steps: int = 1_000_000) -> torch.Tensor:
    """Log-linear (exponential) decay from ``lr_init`` to ``lr_final`` over
    ``max_steps`` with an optional cosine delay; a float32 scalar on the
    step's device, computed there (no host sync)."""
    step = torch.as_tensor(step).to(torch.float32)
    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros_like(step)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1.0 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_init = torch.log(torch.tensor(lr_init, dtype=torch.float32, device=step.device))
    log_final = torch.log(torch.tensor(lr_final, dtype=torch.float32,
                                       device=step.device))
    lr = delay_rate * torch.exp(log_init * (1.0 - t) + log_final * t)
    return torch.where(step < 0, torch.zeros_like(lr), lr)
