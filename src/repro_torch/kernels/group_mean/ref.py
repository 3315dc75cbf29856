"""Plain PyTorch version of the masked group-mean kernel (the JAX
package's oracle)."""
from __future__ import annotations

import torch


def masked_group_mean_ref(x: torch.Tensor, mask: torch.Tensor
                          ) -> torch.Tensor:
    """x (K, N, ...); mask (K, N) -> the masked mean over N, (K, ...), in
    x's dtype, summed in f32 with the count clamped at 1e-6."""
    m = mask.to(device=x.device, dtype=torch.float32)
    m = m.reshape(tuple(m.shape) + (1,) * (x.ndim - m.ndim))
    return ((x.float() * m).sum(dim=1)
            / torch.clamp_min(m.sum(dim=1), 1e-6)).to(x.dtype)
