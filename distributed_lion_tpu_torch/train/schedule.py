"""LR schedules: port of ``distributed_lion_tpu/train/schedule.py``.

Each schedule maps a step tensor to a float32 LR tensor on the step's
device, so the trainer's LR never leaves the card and a schedule costs no
host sync.
"""

from __future__ import annotations

import math

import torch


def cosine_schedule_with_warmup(peak_lr: float, warmup_steps: int,
                                total_steps: int, num_cycles: float = 0.5,
                                min_ratio: float = 0.0):
    """transformers.get_cosine_schedule_with_warmup: linear 0→peak over
    ``warmup_steps``, then cosine to ``min_ratio``·peak."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        cos = 0.5 * (1.0 + torch.cos(math.pi * num_cycles * 2.0 * progress))
        mult = torch.where(step < warmup_steps, warm, torch.clamp_min(cos, min_ratio))
        return peak_lr * mult

    return schedule


def linear_schedule_with_warmup(peak_lr: float, warmup_steps: int, total_steps: int):
    """transformers.get_linear_schedule_with_warmup."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = step / max(1.0, warmup_steps)
        decay = (total_steps - step) / max(1.0, total_steps - warmup_steps)
        return peak_lr * torch.where(step < warmup_steps, warm, torch.clamp_min(decay, 0.0))

    return schedule


def constant_schedule(peak_lr: float):
    def schedule(step: torch.Tensor) -> torch.Tensor:
        return torch.full((), peak_lr, dtype=torch.float32, device=step.device)

    return schedule
