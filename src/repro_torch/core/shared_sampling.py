"""Algorithm 1 — Shared Diffusion Sampling (the paper's inference scheme).

* shared phase: K latents, conditioned on the masked mean text features c̄,
  for t = T .. T* (``n_shared`` sampler steps);
* branch phase: latents broadcast K -> (K, N), each member continues with
  its own cⁿ for t = T* .. 0;
* CFG with a null-condition pass packed into the same denoiser batch.

The two phases are resumable segments over an explicit
:class:`SampleCarry` ``(z, eps_prev, step_idx)``, so the serving scheduler
advances groups a segment at a time and packs groups at different grid
positions into one call: ``step_idx`` (and ``branch_phase``'s
``fork_idx``) may be per-row (B,) tensors, and every schedule gather then
returns per-row values that broadcast along the batch axis.  The JAX
package's ``lax.scan`` over steps is a Python loop here.

Kernel routing: ``sage.step_impl == "fused"`` sends the CFG+DDIM update
through ``kernels.dispatch.cfg_ddim_step`` (the hand-written kernel on a
CUDA tensor); the denoiser's attention backend is ``ModelConfig.attn_impl``.

Not in this slice (they raise ``NotImplementedError``): the DPM-Solver++
sampler, per-row sampler mixes, 2-D per-row grids and the shared-uncond
CFG option.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.config import SageConfig
from repro_torch.core import samplers
from repro_torch.core.guidance import cfg_combine
from repro_torch.core.schedule import Schedule, ddim_timesteps
from repro_torch.kernels import dispatch

# eps_fn(z, t, cond) -> eps ; z (B,H,W,C), t (B,), cond (B,Lc,dc)
EpsFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def group_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the member axis.  x (K,N,...), mask (K,N)."""
    m = mask.to(device=x.device, dtype=torch.float32)
    m = m.reshape(tuple(m.shape) + (1,) * (x.ndim - m.ndim))
    return ((x.float() * m).sum(dim=1)
            / torch.clamp_min(m.sum(dim=1), 1e-6)).to(x.dtype)


def _check_supported(sage: SageConfig) -> None:
    if sage.sampler != "ddim":
        raise NotImplementedError(
            f"sampler {sage.sampler!r}: only ddim is ported so far")


def _grid(sched: Schedule, sage: SageConfig, grid, device) -> torch.Tensor:
    if grid is None:
        grid = ddim_timesteps(sched.T, sage.total_steps)
    grid = torch.as_tensor(grid, dtype=torch.long, device=device)
    if grid.ndim != 1:
        raise NotImplementedError("per-row 2-D step grids are not ported "
                                  "yet; pass one 1-D grid")
    return grid


def _eps_pair(eps_fn: EpsFn, z, t, cond, null_cond):
    """One batched denoiser call for the CFG pair -> (eps_u, eps_c)."""
    B = z.shape[0]
    zz = torch.cat([z, z], 0)
    tt = torch.cat([t, t], 0)
    cc = torch.cat([null_cond.expand(cond.shape).to(cond.dtype), cond], 0)
    eps = eps_fn(zz, tt, cc)
    return eps[:B], eps[B:]


def _step_update(sched: Schedule, sage: SageConfig, z, t, t_next,
                 eps_u, eps_c):
    """One CFG+DDIM update; returns (z_next, eps history carry).  The
    fused route returns eps_c as the history (as the JAX package does);
    DDIM never reads it."""
    if sage.step_impl == "fused":
        a_t, s_t, a_n, s_n = samplers.ddim_scalars(sched, t, t_next)
        z = dispatch.cfg_ddim_step(
            z, eps_u, eps_c, guidance=sage.guidance_scale, a_t=a_t, s_t=s_t,
            a_n=a_n, s_n=s_n, clip_x0=sage.clip_x0, impl="fused")
        return z, eps_c
    if sage.step_impl != "reference":
        raise ValueError(f"unknown step impl {sage.step_impl!r}; one of "
                         f"{dispatch.STEP_IMPLS}")
    eps = cfg_combine(eps_u, eps_c, sage.guidance_scale)
    return samplers.ddim_step(sched, z, t, t_next, eps,
                              clip_x0=sage.clip_x0), eps


class SampleCarry(NamedTuple):
    """Resumable sampler state between segment calls.

    ``z`` is (B, H, W, C) with B = K during the shared phase and B = K*N
    after :func:`fork_carry`; ``eps_prev`` (same shape) is the solver
    history; ``step_idx`` is the global position on the DDIM grid — a
    0-dim long tensor, or a per-row (B,) one in a packed stack."""
    z: torch.Tensor
    eps_prev: torch.Tensor
    step_idx: torch.Tensor


def init_carry(noise: torch.Tensor) -> SampleCarry:
    """Fresh trajectory start from ``noise`` (K, H, W, C): empty history,
    step 0."""
    z = noise.float().contiguous()
    return SampleCarry(z, torch.zeros_like(z),
                       torch.zeros((), dtype=torch.long, device=z.device))


def fork_carry(carry: SampleCarry, n_members: int) -> SampleCarry:
    """Branch point: broadcast the K group latents to (K*N) member rows.
    The history restarts at the fork, so ``eps_prev`` is zeroed."""
    K, H, W, C = carry.z.shape
    zb = carry.z[:, None].expand(K, n_members, H, W, C).reshape(
        K * n_members, H, W, C)
    return SampleCarry(zb, torch.zeros_like(zb), carry.step_idx)


def _step_index(carry: SampleCarry) -> torch.Tensor:
    return torch.as_tensor(carry.step_idx, dtype=torch.long,
                           device=carry.z.device)


def shared_phase(eps_fn: EpsFn, sched: Schedule, sage: SageConfig,
                 carry: SampleCarry, cbar: torch.Tensor,
                 null_cond: torch.Tensor, n_steps: int,
                 grid: Optional[torch.Tensor] = None) -> SampleCarry:
    """Advance the group-trunk phase ``n_steps`` sampler steps.

    carry.z (K, H, W, C); cbar (K, Lc, dc) group-mean text features.  The
    start position rides in ``carry.step_idx`` (0-dim, or per-row (K,))."""
    if n_steps <= 0:
        return carry
    _check_supported(sage)
    z, eps_prev = carry.z, carry.eps_prev
    i = _step_index(carry)
    K = z.shape[0]
    grid = _grid(sched, sage, grid, z.device)
    for _ in range(n_steps):
        t, t_next = grid[i], grid[i + 1]
        eps_u, eps_c = _eps_pair(eps_fn, z, t.expand(K), cbar, null_cond)
        z, eps_prev = _step_update(sched, sage, z, t, t_next, eps_u, eps_c)
        i = i + 1
    return SampleCarry(z, eps_prev, i)


def branch_phase(eps_fn: EpsFn, sched: Schedule, sage: SageConfig,
                 carry: SampleCarry, cond_flat: torch.Tensor,
                 mask: torch.Tensor, null_cond: torch.Tensor, n_steps: int,
                 fork_idx: Union[int, torch.Tensor],
                 grid: Optional[torch.Tensor] = None) -> SampleCarry:
    """Advance the per-member phase ``n_steps`` steps after a fork.

    carry.z (K*N, H, W, C) from :func:`fork_carry`; cond_flat
    (K*N, Lc, dc); mask (K, N).  ``fork_idx`` is the global step each row
    forked at (scalar or per-row); it marks where the DPM-Solver++
    history restarts, which DDIM does not read."""
    if n_steps <= 0:
        return carry
    _check_supported(sage)
    if sage.shared_uncond_cfg:
        raise NotImplementedError("shared_uncond_cfg is not ported yet")
    K, N = mask.shape
    z, eps_prev = carry.z, carry.eps_prev
    if z.shape[0] != K * N:
        raise ValueError(f"carry has {z.shape[0]} rows, mask {K}x{N}")
    del fork_idx
    i = _step_index(carry)
    grid = _grid(sched, sage, grid, z.device)
    for _ in range(n_steps):
        t, t_next = grid[i], grid[i + 1]
        eps_u, eps_c = _eps_pair(eps_fn, z, t.expand(K * N), cond_flat,
                                 null_cond)
        z, eps_prev = _step_update(sched, sage, z, t, t_next, eps_u, eps_c)
        i = i + 1
    return SampleCarry(z, eps_prev, i)


def phase_split(total_steps: int, beta: float) -> Tuple[int, int]:
    """THE branch-point rule: share-ratio bucket ``beta`` splits
    ``total_steps`` into ``(n_shared, n_branch)`` with
    ``n_branch = round(T * (1 - beta))``."""
    n_branch = int(round(total_steps * (1.0 - beta)))
    return total_steps - n_branch, n_branch


def shared_phase_nfe(K: int, n_steps: int) -> float:
    """Denoiser evals for ``n_steps`` shared steps: the CFG pair per group."""
    return 2.0 * K * n_steps


def branch_phase_nfe(mask, n_steps: int, shared_uncond: bool) -> float:
    """Denoiser evals for ``n_steps`` branch steps of a (K, N) packing:
    2 per member, or member + one group-level uncond with the shared-uncond
    CFG (padding rows are masked out of the count)."""
    K = mask.shape[0]
    n_members = float(mask.sum())
    per_step = (n_members + K) if shared_uncond else 2.0 * n_members
    return per_step * n_steps


def shared_sample(eps_fn: EpsFn, sched: Schedule, sage: SageConfig,
                  noise: torch.Tensor, cond_tokens: torch.Tensor,
                  mask: torch.Tensor, null_cond: torch.Tensor,
                  branch_point: Optional[int] = None, device="cuda"
                  ) -> Dict[str, Union[torch.Tensor, float]]:
    """Run Alg. 1 for packed groups: one shared segment over the whole
    trunk, one branch segment to t=0, on ``device`` (CUDA by default,
    raising without a GPU; ``eps_fn``'s model must live there too).

    noise (K, H, W, C); cond_tokens (K, N, Lc, dc); mask (K, N);
    null_cond (Lc, dc).  Returns {"latents": (K, N, H, W, C), "nfe": float}.
    """
    dev = resolve_device(device)
    sched = sched.to(dev)
    noise, cond_tokens, null_cond = (x.to(dev) for x in
                                     (noise, cond_tokens, null_cond))
    K, N = mask.shape
    T = sage.total_steps
    Ts = sage.branch_point if branch_point is None else branch_point
    n_shared = T - Ts
    cbar = group_mean(cond_tokens, mask)                    # (K, Lc, dc)
    carry = init_carry(noise)
    carry = shared_phase(eps_fn, sched, sage, carry, cbar, null_cond,
                         n_shared)
    carry = fork_carry(carry, N)
    cm = cond_tokens.reshape(K * N, *cond_tokens.shape[2:])
    carry = branch_phase(eps_fn, sched, sage, carry, cm, mask, null_cond,
                         T - n_shared, fork_idx=n_shared)
    nfe = (shared_phase_nfe(K, n_shared)
           + branch_phase_nfe(mask, Ts, sage.shared_uncond_cfg))
    H, W, C = noise.shape[1:]
    return {"latents": carry.z.reshape(K, N, H, W, C), "nfe": nfe}


def independent_sample(eps_fn: EpsFn, sched: Schedule, sage: SageConfig,
                       noise: torch.Tensor, cond_tokens: torch.Tensor,
                       null_cond: torch.Tensor, device="cuda"
                       ) -> Dict[str, Union[torch.Tensor, float]]:
    """Baseline: conventional independent sampling (Fig. 1a) on
    ``device``.  noise (M, H, W, C); cond_tokens (M, Lc, dc)."""
    _check_supported(sage)
    dev = resolve_device(device)
    sched = sched.to(dev)
    noise, cond_tokens, null_cond = (x.to(dev) for x in
                                     (noise, cond_tokens, null_cond))
    M = cond_tokens.shape[0]
    grid = _grid(sched, sage, None, noise.device)
    z = noise.float().contiguous()
    for i in range(sage.total_steps):
        t, t_next = grid[i], grid[i + 1]
        eps_u, eps_c = _eps_pair(eps_fn, z, t.expand(M), cond_tokens,
                                 null_cond)
        z, _ = _step_update(sched, sage, z, t, t_next, eps_u, eps_c)
    return {"latents": z, "nfe": 2.0 * M * sage.total_steps}
