"""Classifier-free guidance utilities."""
from __future__ import annotations

import torch


def cfg_combine(eps_uncond: torch.Tensor, eps_cond: torch.Tensor,
                scale: float) -> torch.Tensor:
    """eps = eps_u + w * (eps_c - eps_u).  (paper: w = 7.5, DDIM.)"""
    return eps_uncond + scale * (eps_cond - eps_uncond)
