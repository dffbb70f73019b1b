"""LR schedules: cosine and WSD (warmup-stable-decay, MiniCPM §4), the
reference's ``repro/optim/schedules.py`` in float32 torch.  ``step`` is a
number or a tensor; the result is a float32 scalar tensor on its device."""

from __future__ import annotations

import math

import torch


def _f32(step):
    return torch.as_tensor(step, dtype=torch.float32).float()


def cosine_schedule(step, *, peak_lr=3e-4, warmup=2000, total=100_000,
                    floor_frac=0.1):
    step = _f32(step)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = floor_frac * peak_lr + (1 - floor_frac) * peak_lr \
        * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)


def wsd_schedule(step, *, peak_lr=3e-4, warmup=2000, total=100_000,
                 decay_frac=0.1, floor_frac=0.1):
    """Warmup -> stable plateau -> short exponential-style decay tail.
    MiniCPM's WSD: decay over the last ~10% of steps."""
    step = _f32(step)
    decay_start = total * (1.0 - decay_frac)
    warm = peak_lr * step / max(warmup, 1)
    tail_prog = torch.clamp(
        (step - decay_start) / max(total - decay_start, 1), 0, 1)
    tail = peak_lr * torch.pow(torch.tensor(floor_frac, dtype=torch.float32,
                                            device=step.device), tail_prog)
    return torch.where(step < warmup, warm,
                       torch.where(step < decay_start,
                                   torch.full_like(step, peak_lr), tail))


def make_schedule(kind: str, **kw):
    if kind == "wsd":
        return lambda s: wsd_schedule(s, **kw)
    return lambda s: cosine_schedule(s, **kw)
