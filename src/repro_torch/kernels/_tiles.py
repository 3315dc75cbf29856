"""Per-row scalar broadcasting shared by the sampler math and the step
kernels' plain versions, and the step kernels' vector width on the card
(the JAX package's ``kernels/_tiles.py`` holds the TPU lane/sublane
tiling instead, which the port does not need)."""
from __future__ import annotations

from typing import NamedTuple, Tuple

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


# The step kernels' launches (``ddim_step``, ``dpmpp_step``, ``group_mean``):
# one 16-byte vector a thread where the rows and pointers allow it.

#: a thread's vector: 4 f32 or 8 bf16, one 16-byte load
VECTOR_BYTES = 16
#: threads of a block at most (the kernels' ``__launch_bounds__``)
MAX_THREADS = 256


def aligned16(*tensors) -> bool:
    """True if every tensor's data starts on a 16-byte boundary (a vector
    load needs it)."""
    return all(t.data_ptr() % VECTOR_BYTES == 0 for t in tensors)


#: elements of a row-slice block (``ddim_step``, ``dpmpp_step``), one vector
#: (or element) a thread: the serving path's stacks of 8 and 2 rows of
#: 64x64x4 make 512 and 128 blocks, of 2 warps in f32 and 1 in bf16 (on the
#: card, blocks of 2 warps ran faster than of 4 or 8)
SLICE = 256


class LaunchPlan(NamedTuple):
    """One launch of a row-slice kernel: ``rows`` rows of ``n_per_row``
    elements, each cut into ``blocks_per_row`` slices of ``slice`` elements
    (the last one of a row may be shorter), one block a slice, ``threads``
    threads moving ``vec`` elements at once.  The kernel takes ``threads``
    and ``vec`` and works out the slices as the properties here do."""
    n_per_row: int
    rows: int
    vec: int
    threads: int

    @property
    def slice(self) -> int:
        return self.threads * self.vec

    @property
    def blocks_per_row(self) -> int:
        return -(-self.n_per_row // self.slice)

    @property
    def blocks(self) -> int:
        return self.rows * self.blocks_per_row

    def slice_of(self, block: int) -> Tuple[int, int]:
        """(first element, length) of ``block``'s slice, blocks counted
        row by row, as the kernels find it: ``dpmpp_step`` from a 1-D
        ``blockIdx.x``, ``ddim_step`` from its (slices, rows) grid."""
        row, j = divmod(block, self.blocks_per_row)
        start = j * self.slice
        return (row * self.n_per_row + start,
                min(self.slice, self.n_per_row - start))


def launch_plan(n: int, n_per_row: int, itemsize: int,
                aligned: bool) -> LaunchPlan:
    """The launch of ``n`` elements in rows of ``n_per_row`` (the step
    scalars' rows; ``n`` for a broadcast launch) of ``itemsize`` bytes.
    Rows whose length is a multiple of the 16-byte vector, on aligned
    pointers, take the vector path, the others the one-element path.  A
    block covers a slice of ``SLICE`` elements of one row, one vector (or
    element) a thread, so a block reads one row's step scalars."""
    if n_per_row < 1 or n % n_per_row:
        raise ValueError(f"{n} elements do not make rows of {n_per_row}")
    full = VECTOR_BYTES // itemsize
    vec = full if aligned and n_per_row % full == 0 else 1
    return LaunchPlan(n_per_row=n_per_row, rows=n // n_per_row, vec=vec,
                      threads=SLICE // vec)
