"""ODE samplers over the VP schedule: DDIM (the paper's sampler) and
DPM-Solver++(2M) as a faster alternative.

``t``/``t_next`` may be 0-dim (every batch row at the same grid
position) or (B,) tensors (rows at different positions, the packed
serving path): gathered schedule values broadcast along the batch axis
via ``bcast_rows``, so the per-row update applies exactly the same
arithmetic per element as the scalar one.  Every schedule gather and
log-SNR stays a tensor on the schedule's device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.schedule import Schedule
from repro_torch.kernels._tiles import bcast_rows


def ddim_scalars(sched: Schedule, t: torch.Tensor, t_next: torch.Tensor):
    """Per-step (a_t, s_t, a_n, s_n) schedule gathers for one DDIM update
    (the fused CFG+DDIM kernel gathers the same values itself)."""
    return (sched.alpha(t), sched.sigma(t),
            sched.alpha(t_next), sched.sigma(t_next))


def _log_snr(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """lambda = log(alpha / sigma), with the JAX package's guards."""
    return torch.log(torch.clamp_min(a, 1e-6) / torch.clamp_min(s, 1e-8))


def dpmpp_scalars(sched: Schedule, t: torch.Tensor, t_next: torch.Tensor,
                  t_prev: torch.Tensor):
    """Per-step scalars for one fused DPM-Solver++(2M) update:
    ``(a_t, s_t, a_n, s_n, lam, lam_p, lam_n)`` — the schedule gathers
    plus the three log-SNR points of the 2M extrapolation, computed on
    the schedule's device with the same guards as :func:`dpmpp_2m_step`."""
    a_t, s_t = sched.alpha(t), sched.sigma(t)
    a_n, s_n = sched.alpha(t_next), sched.sigma(t_next)
    a_p, s_p = sched.alpha(t_prev), sched.sigma(t_prev)
    return (a_t, s_t, a_n, s_n, _log_snr(a_t, s_t), _log_snr(a_p, s_p),
            _log_snr(a_n, s_n))


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


def dpmpp_2m_step(sched: Schedule, z: torch.Tensor, t: torch.Tensor,
                  t_next: torch.Tensor, eps: torch.Tensor,
                  eps_prev: Optional[torch.Tensor] = None,
                  t_prev: Optional[torch.Tensor] = None,
                  clip_x0: float = 0.0) -> torch.Tensor:
    """DPM-Solver++(2M) in eps-parameterisation (data prediction inside).
    [Lu et al., 2022]

        x0 = clip((z - sigma_t eps) / alpha_t),  h = lambda_n - lambda_t
        D  = x0 + (x0 - x0_prev) / (2 r),       r = (lambda_t - lambda_p) / h
        z' = (sigma_n / sigma_t) z - alpha_n expm1(-h) D

    ``eps_prev is None`` (or == eps) reduces to the first-order update.
    The guards (1e-6 on alpha, 1e-8 on sigma, on h and on r) are the JAX
    package's, kept exactly.
    """
    a_t, s_t, a_n, s_n = (bcast_rows(v, z.ndim) for v in
                          ddim_scalars(sched, t, t_next))
    lam, lam_n = _log_snr(a_t, s_t), _log_snr(a_n, s_n)
    h = lam_n - lam

    def pred_x0(e):
        x0 = (z - s_t * e) / torch.clamp_min(a_t, 1e-6)
        return torch.clamp(x0, -clip_x0, clip_x0) if clip_x0 else x0

    x0 = pred_x0(eps)
    if eps_prev is None:
        d = x0
    else:
        a_p = bcast_rows(sched.alpha(t_prev), z.ndim)
        s_p = bcast_rows(sched.sigma(t_prev), z.ndim)
        lam_p = _log_snr(a_p, s_p)
        # 2M: linear extrapolation of the data prediction in lambda space
        r = (lam - lam_p) / torch.where(h.abs() > 1e-8, h,
                                        torch.full_like(h, 1e-8))
        d = x0 + (x0 - pred_x0(eps_prev)) / (2.0 * torch.clamp_min(r, 1e-8))
    return ((s_n / torch.clamp_min(s_t, 1e-8)) * z
            - a_n * torch.expm1(-h) * d)
