"""Plain PyTorch version of the fused CFG+DPM-Solver++(2M) kernel (the
JAX package's oracle, op for op): ``guidance.cfg_combine`` +
``samplers.dpmpp_2m_step`` from the per-step scalars the kernel receives
(``samplers.dpmpp_scalars``).  Step scalars, ``is_first`` included, may be
plain scalars or (B,) per-row tensors (the packed serving path)."""
from __future__ import annotations

import torch

from repro_torch.kernels._tiles import bcast_rows


def fused_cfg_dpmpp_step_ref(z, eps_u, eps_c, eps_prev, guidance,
                             a_t, s_t, a_n, s_n, lam, lam_p, lam_n,
                             is_first, clip_x0: float = 0.0):
    """Returns ``(z_next, eps_combined)`` in z's dtype, computed in f32;
    ``eps_combined`` is the next step's history carry."""
    a_t, s_t, a_n, s_n, lam, lam_p, lam_n, first = (
        bcast_rows(v, z.ndim, z.device)
        for v in (a_t, s_t, a_n, s_n, lam, lam_p, lam_n, is_first))
    zf = z.float()
    eu = eps_u.float()
    eps = eu + guidance * (eps_c.float() - eu)
    ep = torch.where(first != 0, eps, eps_prev.float())
    h = lam_n - lam
    r = (lam - lam_p) / torch.where(h.abs() > 1e-8, h,
                                    torch.full_like(h, 1e-8))

    def pred_x0(e):
        x0 = (zf - s_t * e) / torch.clamp_min(a_t, 1e-6)
        return torch.clamp(x0, -clip_x0, clip_x0) if clip_x0 else x0

    x0 = pred_x0(eps)
    d = x0 + (x0 - pred_x0(ep)) / (2.0 * torch.clamp_min(r, 1e-8))
    zn = (s_n / torch.clamp_min(s_t, 1e-8)) * zf - a_n * torch.expm1(-h) * d
    return zn.to(z.dtype), eps.to(z.dtype)
