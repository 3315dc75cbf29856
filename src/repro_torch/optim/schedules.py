"""Learning-rate schedules."""
from __future__ import annotations

import math

from repro_torch.config import OptimConfig


def make_lr_schedule(cfg: OptimConfig, total_steps: int):
    """lr(step): linear warm-up over ``cfg.warmup`` steps, then constant or
    a cosine decay to 0 at ``total_steps``."""
    def lr(step) -> float:
        s = float(step)
        warm = min(1.0, (s + 1) / max(cfg.warmup, 1))
        if cfg.schedule == "cosine":
            frac = min(max((s - cfg.warmup)
                           / max(total_steps - cfg.warmup, 1), 0.0), 1.0)
            base = 0.5 * (1.0 + math.cos(math.pi * frac))
        else:
            base = 1.0
        return cfg.lr * warm * base
    return lr
