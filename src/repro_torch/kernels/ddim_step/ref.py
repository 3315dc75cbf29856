"""Plain PyTorch version of the fused CFG+DDIM kernel: the schedule gathers
the kernel makes itself, then the JAX package's oracle, op for op.
``t`` / ``t_next`` may be 0-dim (one timestep for the stack) or (B,)
per-row tensors (the packed serving path)."""
from __future__ import annotations

import torch

from repro_torch.kernels._tiles import bcast_rows


def _gather(table: torch.Tensor, t) -> torch.Tensor:
    """``table[t]`` as PyTorch indexes it (a negative t counts from the
    end), through a 1-D index: indexing by a 0-dim tensor would read it on
    the host, a sync a CUDA graph cannot capture."""
    t = torch.as_tensor(t)
    return table[t.reshape(-1)].reshape(t.shape)


def fused_cfg_ddim_step_ref(z, eps_u, eps_c, guidance, alphas, sigmas, t,
                            t_next, clip_x0: float = 0.0) -> torch.Tensor:
    a_t, s_t, a_n, s_n = (bcast_rows(_gather(tab, i), z.ndim, z.device)
                          for tab, i in ((alphas, t), (sigmas, t),
                                         (alphas, t_next), (sigmas, t_next)))
    zf = z.float()
    eps = (eps_u + guidance * (eps_c - eps_u)).float()
    z0 = (zf - s_t * eps) / torch.clamp_min(a_t, 1e-6)
    if clip_x0:
        z0 = torch.clamp(z0, -clip_x0, clip_x0)
    return (a_n * z0 + s_n * eps).to(z.dtype)
