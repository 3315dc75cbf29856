"""Public wrapper of the fused CFG+DDIM kernel (``csrc/ddim_step.cu``).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (``ref.py``).  The kernel gathers its own schedule values: it takes
the schedule's ``alphas`` / ``sigmas`` tables and the step's timesteps
``t`` / ``t_next``, so that a DDIM update on the serving path is one
kernel node of a replayed graph (the JAX package's jitted runner fuses
these gathers into its scalar block).  Timesteps with a batch axis ((B,)
tensors, the packed serving path) give every batch row its own values;
0-dim ones broadcast — the JAX package's ``ddim_step_rows`` and
``ddim_step_2d`` launches, which here are one kernel reading the
timesteps at a row stride of 1 or 0.  ``guidance`` and ``clip_x0`` are
launch arguments.

The grid comes from ``_tiles.launch_plan``: slices of a row, one 16-byte
vector a thread, sized so that the serving path's stacks fill the card,
laid out as (slices a row, rows), at most ``MAX_ROWS`` rows a launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._tiles import aligned16, launch_plan
from repro_torch.kernels.ddim_step.ref import fused_cfg_ddim_step_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: rows one launch covers at most (the kernel's grid.y limit)
MAX_ROWS = 65535


def launches(plan) -> int:
    """Kernel launches of a launch plan: one per ``MAX_ROWS`` rows."""
    return -(-plan.rows // MAX_ROWS)


def _timesteps(name, t, rows: int) -> torch.Tensor:
    """A timestep argument as an integer tensor, 0-dim or ``(rows,)``."""
    t = torch.as_tensor(t)
    if t.is_floating_point() or t.is_complex() or t.dtype == torch.bool:
        raise TypeError(f"{name} must hold integer timesteps, got {t.dtype}")
    if t.ndim and tuple(t.shape) != (rows,):
        raise ValueError(f"{name} must be 0-dim or ({rows},), got "
                         f"{tuple(t.shape)}")
    return t


def fused_cfg_ddim_step(z, eps_u, eps_c, guidance, alphas, sigmas, t, t_next,
                        clip_x0: float = 0.0) -> torch.Tensor:
    """z' = a_n * clip((z - s_t*eps)/max(a_t, 1e-6)) + s_n * eps with
    eps = eps_u + guidance*(eps_c - eps_u), a_t = alphas[t],
    s_t = sigmas[t], a_n = alphas[t_next], s_n = sigmas[t_next], for latents
    (B, ...); the tables are the schedule's (T+1,) f32 ones."""
    if not (z.shape == eps_u.shape == eps_c.shape):
        raise ValueError(f"shape mismatch: {tuple(z.shape)}, "
                         f"{tuple(eps_u.shape)}, {tuple(eps_c.shape)}")
    if z.ndim == 0:
        raise ValueError("ddim_step needs a batch axis")
    if alphas.ndim != 1 or alphas.shape != sigmas.shape:
        raise ValueError(f"the schedule tables must be 1-D of one length, "
                         f"got {tuple(alphas.shape)} and "
                         f"{tuple(sigmas.shape)}")
    rows = z.shape[0]
    t, t_next = (_timesteps(name, x, rows)
                 for name, x in (("t", t), ("t_next", t_next)))
    _build.forbid_grad("fused_cfg_ddim_step", z, eps_u, eps_c, guidance)
    if z.device.type == "cpu":
        return fused_cfg_ddim_step_ref(z, eps_u, eps_c, guidance, alphas,
                                       sigmas, t, t_next, clip_x0=clip_x0)
    if z.device.type != "cuda":
        raise ValueError(f"no ddim_step kernel for device {z.device}")
    for name, x in (("eps_u", eps_u), ("eps_c", eps_c)):
        if x.device != z.device or x.dtype != z.dtype:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, z is "
                             f"{z.dtype} on {z.device}")
    for name, x in (("alphas", alphas), ("sigmas", sigmas)):
        if (x.device != z.device or x.dtype != torch.float32
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 table on "
                             f"{z.device}, got {x.dtype} on {x.device}")
    if z.dtype not in DTYPES:
        raise TypeError(f"ddim_step kernel takes float32/bfloat16, "
                        f"got {z.dtype}")
    if not (z.is_contiguous() and eps_u.is_contiguous()
            and eps_c.is_contiguous()):
        raise ValueError("ddim_step kernel needs contiguous tensors")
    # the serving path's timesteps are int64 on the device: no conversion
    t, t_next = (x.to(z.device, torch.long) for x in (t, t_next))
    n = z.numel()
    out = torch.empty_like(z)
    if n == 0:
        return out
    plan = launch_plan(n, n // rows if t.ndim or t_next.ndim else n,
                       z.element_size(), aligned16(z, eps_u, eps_c, out))
    lib = _build.load_library()
    rc = lib.sage_ddim_step(
        z.data_ptr(), eps_u.data_ptr(), eps_c.data_ptr(), out.data_ptr(),
        alphas.data_ptr(), sigmas.data_ptr(), alphas.numel(), t.data_ptr(),
        t_next.data_ptr(), t.stride(0) if t.ndim else 0,
        t_next.stride(0) if t_next.ndim else 0, float(guidance),
        float(clip_x0), n, plan.n_per_row, plan.threads, plan.vec,
        DTYPES[z.dtype], torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(rc, "ddim_step")
    fused_cfg_ddim_step.launches += launches(plan)
    return out


fused_cfg_ddim_step.launches = 0
