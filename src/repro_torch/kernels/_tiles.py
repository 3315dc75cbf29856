"""Per-row scalar broadcasting shared by the sampler math and the step
kernels' plain versions, and the step kernels' vector width on the card
(the JAX package's ``kernels/_tiles.py`` holds the TPU lane/sublane
tiling instead, which the port does not need)."""
from __future__ import annotations

import torch


def bcast_rows(s, ndim: int, device=None) -> torch.Tensor:
    """Align a per-row step scalar for broadcasting against a (B, ...)
    latent of rank ``ndim``: a (B,) vector gains trailing singleton axes,
    a scalar becomes a 0-dim f32 tensor."""
    s = torch.as_tensor(s, dtype=torch.float32, device=device)
    if s.ndim == 0:
        return s
    return s.reshape(tuple(s.shape) + (1,) * (ndim - s.ndim))


def per_row_scalars(*scalars) -> bool:
    """True if any step scalar carries a batch axis — the predicate that
    selects the per-row launch over the broadcast one."""
    return any(isinstance(s, torch.Tensor) and s.ndim >= 1 for s in scalars)


def step_arrays(values, rows: int, device):
    """Step scalars as contiguous f32 device arrays for a step kernel, and
    the row stride the kernel reads them at: 1 when any value is per-row
    (every value is then expanded to (rows,)), else 0 (one value each).
    A tensor already on ``device`` (a schedule gather, a warm-up flag) is
    converted there, with no copy from the host."""
    per_row = per_row_scalars(*values)
    out = []
    for v in values:
        v = torch.as_tensor(v, dtype=torch.float32, device=device)
        if v.ndim and tuple(v.shape) != (rows,):
            raise ValueError(f"per-row step scalars must have shape "
                             f"({rows},), got {tuple(v.shape)}")
        out.append((v.expand(rows) if per_row else v).contiguous())
    return out, int(per_row)


# The step kernels' launches (``dpmpp_step``, ``group_mean``): one 16-byte
# vector a thread where the rows and pointers allow it.

#: a thread's vector: 4 f32 or 8 bf16, one 16-byte load
VECTOR_BYTES = 16
#: threads of a block at most (the kernels' ``__launch_bounds__``)
MAX_THREADS = 256


def aligned16(*tensors) -> bool:
    """True if every tensor's data starts on a 16-byte boundary (a vector
    load needs it)."""
    return all(t.data_ptr() % VECTOR_BYTES == 0 for t in tensors)
