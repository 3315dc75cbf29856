"""Weights and noise drawn from a run's seed, on the device, in a few large
calls: one normal draw per module, cut into the parameters of a layout of
``perfbench.reference.model`` and scaled by each one's std."""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

# streams of one seed: weights of each module, and the noise of each group
DIT, TEXT, VAE, NOISE = 1, 2, 3, 4


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for stream ``keys`` of ``seed`` (any int)."""
    ss = np.random.SeedSequence([seed & (2 ** 64 - 1), *keys])
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))


def draw(layout: Iterable[Tuple[str, Tuple[int, ...], float]], seed: int,
         stream: int, device) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` in float32, one normal draw for the whole
    layout."""
    layout = list(layout)
    sizes = [int(np.prod(shape)) for _, shape, _ in layout]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, stream))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape, std), part in zip(layout, flat.split(sizes)):
        out[name] = part.view(shape).mul_(std)
    return out


def group_noise(seed: int, gid: int, shape, device) -> torch.Tensor:
    """Group ``gid``'s initial latent, standard normal, from the seed."""
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, NOISE, gid))
    return torch.randn(tuple(shape), generator=gen, device=device)
