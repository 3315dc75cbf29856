"""Plain PyTorch version of the fused CFG+DDIM kernel (the JAX package's
oracle, op for op).  Step scalars may be plain scalars or (B,) per-row
tensors (the packed serving path)."""
from __future__ import annotations

import torch

from repro_torch.kernels._tiles import bcast_rows


def fused_cfg_ddim_step_ref(z, eps_u, eps_c, guidance, a_t, s_t, a_n, s_n,
                            clip_x0: float = 0.0) -> torch.Tensor:
    a_t, s_t, a_n, s_n = (bcast_rows(v, z.ndim, z.device)
                          for v in (a_t, s_t, a_n, s_n))
    zf = z.float()
    eps = (eps_u + guidance * (eps_c - eps_u)).float()
    z0 = (zf - s_t * eps) / torch.clamp_min(a_t, 1e-6)
    if clip_x0:
        z0 = torch.clamp(z0, -clip_x0, clip_x0)
    return (a_n * z0 + s_n * eps).to(z.dtype)
