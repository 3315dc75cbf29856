"""ODE samplers over the VP schedule: DDIM (the paper's sampler).

``t``/``t_next`` may be 0-dim (every batch row at the same grid
position) or (B,) tensors (rows at different positions, the packed
serving path): gathered schedule values broadcast along the batch axis
via ``bcast_rows``, so the per-row update applies exactly the same
arithmetic per element as the scalar one.  DPM-Solver++(2M) and its
kernel come with the next slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.schedule import Schedule
from repro_torch.kernels._tiles import bcast_rows


def ddim_scalars(sched: Schedule, t: torch.Tensor, t_next: torch.Tensor):
    """Per-step (a_t, s_t, a_n, s_n) schedule gathers for one DDIM update,
    handed to the fused CFG+DDIM kernel as its scalar block."""
    return (sched.alpha(t), sched.sigma(t),
            sched.alpha(t_next), sched.sigma(t_next))


def ddim_step(sched: Schedule, z: torch.Tensor, t: torch.Tensor,
              t_next: torch.Tensor, eps: torch.Tensor,
              clip_x0: float = 0.0) -> torch.Tensor:
    """Deterministic DDIM update (eta=0):   [Song et al., 2020]

        z0_hat = (z - sigma_t eps) / alpha_t
        z'     = alpha_{t'} z0_hat + sigma_{t'} eps

    clip_x0 > 0 enables static x0-thresholding (SD's clip_sample).  The
    1e-6 guard on alpha_t is the JAX package's, kept exactly so the fused
    and reference paths stay aligned.
    """
    a_t, s_t, a_n, s_n = (bcast_rows(v, z.ndim) for v in
                          ddim_scalars(sched, t, t_next))
    z0 = (z - s_t * eps) / torch.clamp_min(a_t, 1e-6)
    if clip_x0:
        z0 = torch.clamp(z0, -clip_x0, clip_x0)
    return a_n * z0 + s_n * eps
