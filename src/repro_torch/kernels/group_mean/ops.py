"""Public wrapper of the masked group-mean kernel (``csrc/group_mean.cu``).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (``ref.py``).  The mask must lie on x's device: the serving path
moves it there once per segment, and a step copies nothing from the host.
The grid comes from :func:`launch_plan`: slices of a group's features, one
16-byte vector a thread, sized so that the serving path's stack fills the
card.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._tiles import MAX_THREADS, VECTOR_BYTES, aligned16
from repro_torch.kernels.ddim_step.ops import DTYPES
from repro_torch.kernels.group_mean.ref import masked_group_mean_ref

MAX_MEMBERS = 64       # the kernel's loop over members at run time
#: member counts the kernel unrolls, all loads ahead of the adds
UNROLLED = (1, 2, 4, 8)
#: blocks a plan aims for: about one per SM of the H100 (132), so that the
#: serving path's stack, (2, 4, 64x64x4), fills the card
TARGET_BLOCKS = 128


class LaunchPlan(NamedTuple):
    """One launch: grid (``blocks_x``, K), block (i, k) covering the
    features ``[i * threads * vec, ...)`` of group k, ``threads`` threads
    moving ``vec`` elements at once.  The kernel takes ``threads`` and
    ``vec`` and works out the grid and the unrolling as the properties here
    do."""
    K: int
    N: int
    F: int
    vec: int
    threads: int

    @property
    def blocks_x(self) -> int:
        return -(-self.F // (self.vec * self.threads))

    @property
    def unrolled(self) -> bool:
        """N's loads unrolled ahead of the adds (a template parameter)."""
        return self.vec > 1 and self.N in UNROLLED

    @property
    def blocks(self) -> int:
        return self.K * self.blocks_x

    def slice_of(self, block_x: int) -> Tuple[int, int]:
        """(first feature, length) of a block's slice of its group, as
        the kernel reads it from ``blockIdx.x``."""
        f0 = block_x * self.threads * self.vec
        return f0, min(self.threads * self.vec, self.F - f0)


def launch_plan(K: int, N: int, F: int, itemsize: int,
                aligned: bool) -> LaunchPlan:
    """The launch for x (K, N, F) of ``itemsize`` bytes.  F a multiple of
    the 16-byte vector, on aligned pointers, takes the vector path, and
    there an N of ``UNROLLED`` is unrolled; the rest loops over the
    members.  Blocks have a power of two of 32 to ``MAX_THREADS`` threads,
    one vector each, chosen so that the grid has about ``TARGET_BLOCKS``
    blocks."""
    if min(K, N, F) < 1:
        raise ValueError(f"empty group_mean launch (K, N, F) = "
                         f"{(K, N, F)}")
    full = VECTOR_BYTES // itemsize
    vec = full if aligned and F % full == 0 else 1
    per_block = max(K * -(-F // vec) // TARGET_BLOCKS, 1)
    threads = min(max(1 << (per_block.bit_length() - 1), 32), MAX_THREADS)
    return LaunchPlan(K=K, N=N, F=F, vec=vec, threads=threads)


def masked_group_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x (K, N, ...); mask (K, N) -> masked mean over N, (K, ...), in x's
    dtype, with the member count clamped at 1e-6."""
    if x.ndim < 2 or tuple(mask.shape) != tuple(x.shape[:2]):
        raise ValueError(f"mask {tuple(mask.shape)} does not match the "
                         f"(K, N) axes of x {tuple(x.shape)}")
    _build.forbid_grad("masked_group_mean", x, mask)
    if x.device.type == "cpu":
        return masked_group_mean_ref(x, mask)
    if x.device.type != "cuda":
        raise ValueError(f"no group_mean kernel for device {x.device}")
    if mask.device != x.device:
        raise ValueError(f"mask is on {mask.device}, x on {x.device}: move "
                         f"the mask to the device once, outside the step")
    if x.dtype not in DTYPES:
        raise TypeError(f"group_mean kernel takes float32/bfloat16, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group_mean kernel needs a contiguous x")
    K, N = x.shape[:2]
    if N > MAX_MEMBERS:
        raise ValueError(f"group_mean kernel takes at most {MAX_MEMBERS} "
                         f"members, got {N}")
    F = math.prod(x.shape[2:])
    out = torch.empty((K,) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    if K == 0 or F == 0:
        return out
    m = mask.to(torch.float32).contiguous()
    plan = launch_plan(K, N, F, x.element_size(), aligned16(x, out))
    lib = _build.load_library()
    rc = lib.sage_group_mean(x.data_ptr(), m.data_ptr(), out.data_ptr(), K,
                             N, F, plan.threads, plan.vec, DTYPES[x.dtype],
                             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "group_mean")
    masked_group_mean.launches += 1
    return out


masked_group_mean.launches = 0
