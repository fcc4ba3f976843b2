"""LR schedules: cosine and WSD (warmup-stable-decay, MiniCPM
[arXiv:2404.06395]).  Pure functions of the step: a Python number or a
0-d tensor in, a 0-d float32 tensor out (on the step's device), computed
in float32 as the reference computes them."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    step = _step(step)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, peak_lr * cos)


def wsd_schedule(step, *, peak_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1,
                 final_frac: float = 0.01) -> torch.Tensor:
    """Warmup -> Stable (constant) -> Decay (exponential-ish tail).
    The decay phase is the last `decay_frac` of training."""
    step = _step(step)
    decay_start = total * (1.0 - decay_frac)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - decay_start)
                       / max(total - decay_start, 1), 0, 1)
    decay = peak_lr * torch.exp(math.log(final_frac) * prog)
    return torch.where(step < warmup, warm,
                       torch.where(step < decay_start,
                                   torch.full_like(step, peak_lr), decay))


def get_schedule(name: str, **kw):
    return {"cosine": cosine_schedule, "wsd": wsd_schedule}[name], kw
