"""Open-loop arrivals: a Poisson process at ``params["rate"]`` requests a
second, conditioned on its count: ``arrivals(params, rng, seconds)`` gives
round(rate x seconds) offsets, in seconds from the window's start, each
uniform over the window (given its count, a Poisson process's arrival
times are independent and uniform).

The times come from the workload's own ``params["stream"]``, not from the
run's seed (``rng`` is not used): every seed offers the same arrivals, so
that runs differ by the prompts they carry and not by their bursts."""
from __future__ import annotations

import numpy as np


def arrivals(params: dict, rng, seconds: float) -> np.ndarray:
    n = int(round(float(params["rate"]) * seconds))
    fixed = np.random.default_rng([int(params["stream"]), 13])
    return np.sort(fixed.uniform(0.0, seconds, n))
