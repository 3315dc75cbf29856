"""Plain PyTorch version of the flash-attention kernel: materialised
softmax attention in f32.  The CPU path of the wrapper and the oracle the
kernel is held against on the card."""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: float = 1.0) -> torch.Tensor:
    """q (B, Sq, H, D); k/v (B, Sk, Hkv, D), query head h reads K/V head
    h // (H // Hkv) -> (B, Sq, H, D) in q's dtype.  ``window > 0`` keeps
    keys with index > row - window (the kernel's causal sliding window)."""
    H, Hkv = q.shape[2], k.shape[2]
    g = H // Hkv
    qf = q.float().permute(0, 2, 1, 3)                        # (B, H, Sq, D)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    s = (qf @ kf.transpose(-1, -2)) * scale
    Sq, Sk = q.shape[1], k.shape[1]
    qi = torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(Sk, device=q.device)[None, :]
    valid = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        valid &= ki <= qi
    if window:
        valid &= ki > qi - window
    s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return (p @ vf).permute(0, 2, 1, 3).to(q.dtype)
