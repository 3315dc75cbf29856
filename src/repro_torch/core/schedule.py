"""Noise schedules for the latent diffusion formulation (paper Eq. 1).

Variance-preserving: q_t(z_t|z_0) = N(alpha_t z_0, sigma_t^2 I) with
alpha_t^2 + sigma_t^2 = 1.  Discrete T=1000 training grid; DDIM uses an
evenly strided subset (paper: 30 steps).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Schedule:
    alphas: torch.Tensor       # (T+1,) f32 alpha_t, t=0..T  (alpha_0 = 1)
    sigmas: torch.Tensor       # (T+1,) f32
    T: int

    def alpha(self, t: torch.Tensor) -> torch.Tensor:
        return self.alphas[t]

    def sigma(self, t: torch.Tensor) -> torch.Tensor:
        return self.sigmas[t]

    def snr_weight(self, t: torch.Tensor) -> torch.Tensor:
        """w_t — min-SNR-style clamp of SNR (stable epsilon-loss weight)."""
        a, s = self.alpha(t), self.sigma(t)
        snr = (a / torch.clamp_min(s, 1e-5)) ** 2
        return torch.clamp_max(snr, 5.0) / 5.0

    def to(self, device) -> "Schedule":
        return Schedule(self.alphas.to(device), self.sigmas.to(device),
                        self.T)


def make_schedule(T: int = 1000, kind: str = "cosine",
                  device="cpu") -> Schedule:
    t = np.linspace(0.0, 1.0, T + 1)
    if kind == "cosine":
        f = np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        abar = np.clip(f / f[0], 1e-8, 1.0)
    elif kind == "linear":
        betas = np.linspace(1e-4, 2e-2, T + 1)
        betas[0] = 0.0
        abar = np.cumprod(1.0 - betas)
    else:
        raise ValueError(kind)
    alphas = np.sqrt(abar).astype(np.float32)
    sigmas = np.sqrt(1.0 - abar).astype(np.float32)
    return Schedule(torch.from_numpy(alphas).to(device),
                    torch.from_numpy(sigmas).to(device), T)


def ddim_timesteps(T: int, n_steps: int) -> np.ndarray:
    """Descending sample-time grid t_n, n = n_steps..1, plus terminal 0.

    Returns int array (n_steps+1,) from high noise to t=0."""
    return np.linspace(T, 0, n_steps + 1).round().astype(np.int64)
