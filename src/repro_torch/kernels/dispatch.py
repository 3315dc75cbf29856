"""Kernel backend dispatch — one switch between the plain PyTorch math,
the chunked online-softmax loop and the hand-written CUDA kernels.

Routing follows the TENSOR's device, never what is installed: on a CUDA
tensor the ``kernel`` / ``fused`` routes launch the kernel or raise; on a
CPU tensor they run the kernel's plain version (``ref.py``).  The only
shapes the flash kernel does not take — ``head_dim > 256`` and
non-causal sliding windows — go to the chunked loop, as in the JAX
package.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.ddim_step.ops import fused_cfg_ddim_step
from repro_torch.kernels.ddim_step.ref import fused_cfg_ddim_step_ref
from repro_torch.kernels.flash_attention.ops import (MAX_HEAD_DIM,
                                                     flash_attention)
from repro_torch.models.layers import attend, attend_chunked, causal_mask

ATTN_IMPLS = ("naive", "chunked", "kernel")
STEP_IMPLS = ("reference", "fused")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              impl: str = "naive", causal: bool = False, window: int = 0,
              block: int = 1024,
              scale: Optional[float] = None) -> torch.Tensor:
    """Backend-dispatched attention.  q (B,Sq,H,hd), k/v (B,Sk,Hkv,hd)."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn impl {impl!r}; one of {ATTN_IMPLS}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if (impl == "kernel" and q.shape[-1] <= MAX_HEAD_DIM
            and (window == 0 or causal)):
        return flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)
    if impl in ("chunked", "kernel"):
        # kernel lands here only for head_dim > 256 / non-causal window
        return attend_chunked(q, k, v, causal=causal, window=window,
                              scale=scale, block=block)
    if causal:
        mask = causal_mask(q.shape[1], k.shape[1], window=window,
                           device=q.device)
    elif window:
        qi = torch.arange(q.shape[1], device=q.device)[:, None]
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = (ki > qi - window)[None, None, None]
    else:
        mask = None
    return attend(q, k, v, mask, scale)


def cfg_ddim_step(z: torch.Tensor, eps_u: torch.Tensor, eps_c: torch.Tensor,
                  *, guidance, a_t, s_t, a_n, s_n, clip_x0: float = 0.0,
                  impl: str = "reference") -> torch.Tensor:
    """CFG combine + DDIM update: the fused kernel (one pass: 3 reads, 1
    write) or the reference math."""
    if impl not in STEP_IMPLS:
        raise ValueError(f"unknown step impl {impl!r}; one of {STEP_IMPLS}")
    if impl == "fused":
        return fused_cfg_ddim_step(z, eps_u, eps_c, guidance, a_t, s_t,
                                   a_n, s_n, clip_x0=clip_x0)
    return fused_cfg_ddim_step_ref(z, eps_u, eps_c, guidance, a_t, s_t,
                                   a_n, s_n, clip_x0=clip_x0)
