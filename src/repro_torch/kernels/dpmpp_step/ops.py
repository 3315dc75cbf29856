"""Public wrapper of the fused CFG+DPM-Solver++(2M) kernel
(``csrc/dpmpp_step.cu``).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (``ref.py``).  Step scalars with a batch axis ((B,) tensors, the
packed serving path, where one group may sit at its fork while another is
mid-branch) give every batch row its own values; 0-dim ones broadcast —
the JAX package's ``dpmpp_step_rows`` and ``dpmpp_step_2d`` launches,
which here are one kernel reading seven f32 step arrays at a row stride
of 1 or 0, and the warm-up flag as the caller's bool tensor at its own
stride, so that a launch on the serving path converts nothing.
``guidance`` and ``clip_x0`` are launch arguments.

The grid comes from ``_tiles.launch_plan``: slices of a row, one 16-byte
vector a thread, sized so that the serving path's stacks fill the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._tiles import aligned16, launch_plan, step_arrays
from repro_torch.kernels.ddim_step.ops import DTYPES
from repro_torch.kernels.dpmpp_step.ref import fused_cfg_dpmpp_step_ref


def fused_cfg_dpmpp_step(z, eps_u, eps_c, eps_prev, guidance,
                         a_t, s_t, a_n, s_n, lam, lam_p, lam_n, is_first,
                         clip_x0: float = 0.0):
    """CFG combine + DPM-Solver++(2M) update for latents (B, ...).
    Returns ``(z_next, eps_combined)``; the combined eps is the solver's
    history carry.  ``is_first`` (bool, 0-dim or (B,)) marks the warm-up
    step, where the history term is exactly zero."""
    if not (z.shape == eps_u.shape == eps_c.shape == eps_prev.shape):
        raise ValueError(f"shape mismatch: {tuple(z.shape)}, "
                         f"{tuple(eps_u.shape)}, {tuple(eps_c.shape)}, "
                         f"{tuple(eps_prev.shape)}")
    _build.forbid_grad("fused_cfg_dpmpp_step", z, eps_u, eps_c, eps_prev,
                       guidance, a_t, s_t, a_n, s_n, lam, lam_p, lam_n)
    if z.device.type == "cpu":
        return fused_cfg_dpmpp_step_ref(z, eps_u, eps_c, eps_prev, guidance,
                                        a_t, s_t, a_n, s_n, lam, lam_p,
                                        lam_n, is_first, clip_x0=clip_x0)
    if z.device.type != "cuda":
        raise ValueError(f"no dpmpp_step kernel for device {z.device}")
    for name, x in (("eps_u", eps_u), ("eps_c", eps_c),
                    ("eps_prev", eps_prev)):
        if x.device != z.device or x.dtype != z.dtype:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, z is "
                             f"{z.dtype} on {z.device}")
    if z.dtype not in DTYPES:
        raise TypeError(f"dpmpp_step kernel takes float32/bfloat16, "
                        f"got {z.dtype}")
    if not all(x.is_contiguous() for x in (z, eps_u, eps_c, eps_prev)):
        raise ValueError("dpmpp_step kernel needs contiguous tensors")
    if z.ndim == 0:
        raise ValueError("dpmpp_step needs a batch axis")
    rows, n = z.shape[0], z.numel()
    scal, stride = step_arrays((a_t, s_t, a_n, s_n, lam, lam_p, lam_n),
                               rows, z.device)
    first = torch.as_tensor(is_first, device=z.device)
    if first.dtype != torch.bool:
        first = first != 0
    if first.ndim and tuple(first.shape) != (rows,):
        raise ValueError(f"is_first must be 0-dim or ({rows},), got "
                         f"{tuple(first.shape)}")
    out, eps = torch.empty_like(z), torch.empty_like(z)
    if n == 0:
        return out, eps
    plan = launch_plan(n, n // rows if stride or first.ndim else n,
                       z.element_size(),
                       aligned16(z, eps_u, eps_c, eps_prev, out, eps))
    lib = _build.load_library()
    rc = lib.sage_dpmpp_step(
        z.data_ptr(), eps_u.data_ptr(), eps_c.data_ptr(), eps_prev.data_ptr(),
        out.data_ptr(), eps.data_ptr(), *(s.data_ptr() for s in scal),
        first.data_ptr(), float(guidance), float(clip_x0), n, plan.n_per_row,
        stride, first.stride(0) if first.ndim else 0, plan.threads, plan.vec,
        DTYPES[z.dtype], torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(rc, "dpmpp_step")
    fused_cfg_dpmpp_step.launches += 1
    return out, eps


fused_cfg_dpmpp_step.launches = 0
