"""LR schedules: cosine-with-warmup and WSD (warmup-stable-decay,
MiniCPM), computed in f32 as 0-d tensors (counterpart of
``repro/optim/schedules.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_with_warmup(step, *, peak_lr, warmup_steps, total_steps,
                       final_frac=0.1):
    step = _f32(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    progress = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0, 1)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(
        math.pi * progress))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)


def wsd(step, *, peak_lr, warmup_steps, total_steps, decay_frac=0.1,
        final_frac=0.01):
    """MiniCPM's Warmup-Stable-Decay: flat plateau, sharp final decay."""
    step = _f32(step)
    decay_steps = decay_frac * total_steps
    decay_start = total_steps - decay_steps
    warm = peak_lr * step / max(warmup_steps, 1)
    progress = torch.clamp((step - decay_start) / max(decay_steps, 1), 0, 1)
    # exponential decay to final_frac over the decay window
    log_final = float(np.log(np.float32(final_frac)))
    decay = peak_lr * torch.exp(log_final * progress)
    lr = torch.where(step < warmup_steps, warm, torch.full_like(step, peak_lr))
    return torch.where(step > decay_start, decay, lr)


def get_schedule(name: str):
    return {"cosine": cosine_with_warmup, "wsd": wsd}[name]
