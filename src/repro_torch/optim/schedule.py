"""LR schedules: linear-warmup + cosine, and WSD (warmup-stable-decay — the
MiniCPM schedule, arXiv:2404.06395 §4: stable high LR for most of training,
then a short exponential/linear decay phase; enables continual pretraining
from the stable phase).

float32 tensors on the step's device (the CPU for a Python int step).
Every division goes by a device tensor: CUDA divides by a host scalar as a
multiply by its reciprocal, one rounding away from ``repro``'s quotient.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    return like.new_full((), float(value))


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    step = _f32(step)
    warm = peak_lr * step / _const(step, max(warmup_steps, 1))
    prog = torch.clamp((step - warmup_steps) / _const(step, max(total_steps - warmup_steps, 1)), 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)


def wsd(step, *, peak_lr: float, warmup_steps: int, stable_steps: int, decay_steps: int, final_frac: float = 0.01):
    """Warmup-Stable-Decay.  decay phase: exponential from peak to final_frac."""
    step = _f32(step)
    warm = peak_lr * step / _const(step, max(warmup_steps, 1))
    decay_start = warmup_steps + stable_steps
    t = torch.clamp((step - decay_start) / _const(step, max(decay_steps, 1)), 0.0, 1.0)
    decay = peak_lr * torch.pow(final_frac, t)
    return torch.where(step < warmup_steps, warm,
                       torch.where(step < decay_start, _const(step, peak_lr), decay))


SCHEDULES = {"warmup_cosine": warmup_cosine, "wsd": wsd}
