"""Per-row scalar broadcasting shared by the sampler math and the step
kernels' plain versions (the JAX package's ``kernels/_tiles.py`` also
holds the TPU lane/sublane tiling, which the port does not need)."""
from __future__ import annotations

import torch


def bcast_rows(s, ndim: int, device=None) -> torch.Tensor:
    """Align a per-row step scalar for broadcasting against a (B, ...)
    latent of rank ``ndim``: a (B,) vector gains trailing singleton axes,
    a scalar becomes a 0-dim f32 tensor."""
    s = torch.as_tensor(s, dtype=torch.float32, device=device)
    if s.ndim == 0:
        return s
    return s.reshape(tuple(s.shape) + (1,) * (ndim - s.ndim))


def per_row_scalars(*scalars) -> bool:
    """True if any step scalar carries a batch axis — the predicate that
    selects the per-row launch over the broadcast one."""
    return any(isinstance(s, torch.Tensor) and s.ndim >= 1 for s in scalars)
