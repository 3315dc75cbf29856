"""Public wrapper of the masked group-mean kernel (``csrc/group_mean.cu``).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (``ref.py``).  The mask must lie on x's device: the serving path
moves it there once per segment, and a step copies nothing from the host.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ddim_step.ops import DTYPES
from repro_torch.kernels.group_mean.ref import masked_group_mean_ref

MAX_MEMBERS = 64       # the kernel keeps a group's mask row in shared memory


def masked_group_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x (K, N, ...); mask (K, N) -> masked mean over N, (K, ...), in x's
    dtype, with the member count clamped at 1e-6."""
    if x.ndim < 2 or tuple(mask.shape) != tuple(x.shape[:2]):
        raise ValueError(f"mask {tuple(mask.shape)} does not match the "
                         f"(K, N) axes of x {tuple(x.shape)}")
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
    lib = _build.load_library()
    rc = lib.sage_group_mean(x.data_ptr(), m.data_ptr(), out.data_ptr(), K,
                             N, F, DTYPES[x.dtype],
                             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "group_mean")
    masked_group_mean.launches += 1
    return out


masked_group_mean.launches = 0
