"""Public wrapper of the fused CFG+DDIM kernel (``csrc/ddim_step.cu``).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (``ref.py``).  Schedule scalars with a batch axis ((B,) tensors,
the packed serving path) give every batch row its own values; 0-dim ones
broadcast — the JAX package's ``ddim_step_rows`` and ``ddim_step_2d``
launches, which here are one kernel reading the four schedule arrays at a
row stride of 1 or 0.  ``guidance`` and ``clip_x0`` are launch arguments.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._tiles import per_row_scalars
from repro_torch.kernels.ddim_step.ref import fused_cfg_ddim_step_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _schedule_arrays(values, rows: int, device):
    """(a_t, s_t, a_n, s_n) as contiguous f32 device arrays and the row
    stride the kernel reads them at: 1 when any value is per-row (every
    value is then (rows,)), else 0 (one value each)."""
    per_row = per_row_scalars(*values)
    out = []
    for v in values:
        v = torch.as_tensor(v, dtype=torch.float32, device=device)
        if v.ndim and tuple(v.shape) != (rows,):
            raise ValueError(f"per-row step scalars must have shape "
                             f"({rows},), got {tuple(v.shape)}")
        out.append((v.expand(rows) if per_row else v).contiguous())
    return out, int(per_row)


def fused_cfg_ddim_step(z, eps_u, eps_c, guidance, a_t, s_t, a_n, s_n,
                        clip_x0: float = 0.0) -> torch.Tensor:
    """z' = a_n * clip((z - s_t*eps)/max(a_t, 1e-6)) + s_n * eps with
    eps = eps_u + guidance*(eps_c - eps_u), for latents (B, ...)."""
    if not (z.shape == eps_u.shape == eps_c.shape):
        raise ValueError(f"shape mismatch: {tuple(z.shape)}, "
                         f"{tuple(eps_u.shape)}, {tuple(eps_c.shape)}")
    if z.device.type == "cpu":
        return fused_cfg_ddim_step_ref(z, eps_u, eps_c, guidance, a_t, s_t,
                                       a_n, s_n, clip_x0=clip_x0)
    if z.device.type != "cuda":
        raise ValueError(f"no ddim_step kernel for device {z.device}")
    for name, x in (("eps_u", eps_u), ("eps_c", eps_c)):
        if x.device != z.device or x.dtype != z.dtype:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, z is "
                             f"{z.dtype} on {z.device}")
    if z.dtype not in DTYPES:
        raise TypeError(f"ddim_step kernel takes float32/bfloat16, "
                        f"got {z.dtype}")
    if not (z.is_contiguous() and eps_u.is_contiguous()
            and eps_c.is_contiguous()):
        raise ValueError("ddim_step kernel needs contiguous tensors")
    if z.ndim == 0:
        raise ValueError("ddim_step needs a batch axis")
    rows, n = z.shape[0], z.numel()
    (a_t, s_t, a_n, s_n), stride = _schedule_arrays((a_t, s_t, a_n, s_n),
                                                    rows, z.device)
    out = torch.empty_like(z)
    if n == 0:
        return out
    lib = _build.load_library()
    rc = lib.sage_ddim_step(
        z.data_ptr(), eps_u.data_ptr(), eps_c.data_ptr(), out.data_ptr(),
        a_t.data_ptr(), s_t.data_ptr(), a_n.data_ptr(), s_n.data_ptr(),
        float(guidance), float(clip_x0), n, n // rows if stride else n,
        stride, DTYPES[z.dtype],
        torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(rc, "ddim_step")
    fused_cfg_ddim_step.launches += 1
    return out


fused_cfg_ddim_step.launches = 0
