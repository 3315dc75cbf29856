"""Algorithm 1 — Shared Diffusion Sampling (the paper's inference scheme).

* shared phase: K latents, conditioned on the masked mean text features c̄,
  for t = T .. T* (``n_shared`` sampler steps);
* branch phase: latents broadcast K -> (K, N), each member continues with
  its own cⁿ for t = T* .. 0;
* CFG with a null-condition pass packed into the same denoiser batch; the
  beyond-paper ``shared_uncond_cfg`` option evaluates the unconditional
  branch once per group during branching, on the group-mean latent, so a
  branch step costs N + 1 denoiser rows per group instead of 2N.

The two phases are resumable segments over an explicit
:class:`SampleCarry` ``(z, eps_prev, step_idx)``, so the serving scheduler
advances groups a segment at a time and packs groups at different grid
positions into one call: ``step_idx`` (and ``branch_phase``'s
``fork_idx``) may be per-row (B,) tensors, and every schedule gather then
returns per-row values that broadcast along the batch axis.  The solver
history (``eps_prev``, read by DPM-Solver++(2M) only) restarts at global
step 0 in the shared phase and at each row's fork in the branch phase, so
a resumed segment equals a one-shot run.  The JAX package's ``lax.scan``
over steps is a Python loop here.

Heterogeneous stacks: both phases take an explicit ``grid`` — 1-D (one
grid for every row) or 2-D (B, L), one zero-padded grid per row for rows
of different step budgets — and ``row_samplers``, a per-row tuple of
solver names for stacks mixing DDIM and DPM-Solver++ rows: each solver's
update runs on its own row subset and is scattered back.

Each phase is a host part and a body.  The host part (:func:`shared_phase`,
:func:`branch_phase`) moves a host grid, the row split of a mixed stack and
``fork_idx`` to the latents' device; the body (:func:`shared_segment`,
:func:`branch_segment`) takes device tensors only and makes no host-to-device
copy and no sync, so a CUDA graph can capture it
(``serving/runners.py``).

Kernel routing: ``sage.step_impl == "fused"`` sends the CFG+solver update
through ``kernels.dispatch.cfg_ddim_step`` / ``cfg_dpmpp_step`` and the
shared-uncond group-mean latent through ``dispatch.group_mean`` (the
hand-written kernels on a CUDA tensor); c̄ of the text features always
takes the plain route.  The DDIM kernel takes the schedule's tables and
the step's timesteps and gathers its own schedule values, so a fused DDIM
update is one launch; a DDIM-only segment builds no 2M history indices.
The denoiser's attention backend is ``ModelConfig.attn_impl``.
"""
from __future__ import annotations

from dataclasses import replace as _dc_replace
from typing import (Callable, Dict, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import torch

from repro_torch import resolve_device
from repro_torch.config import SageConfig
from repro_torch.core import samplers
from repro_torch.core.guidance import cfg_combine
from repro_torch.core.schedule import Schedule, ddim_timesteps
from repro_torch.kernels import dispatch
from repro_torch.kernels._tiles import bcast_rows
from repro_torch.kernels.group_mean.ref import masked_group_mean_ref

# eps_fn(z, t, cond) -> eps ; z (B,H,W,C), t (B,), cond (B,Lc,dc)
EpsFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
# solver name -> the (static) row subset it steps, as an index tensor
RowSplit = Dict[str, torch.Tensor]


def group_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the member axis (plain route).  x (K,N,...),
    mask (K,N)."""
    return masked_group_mean_ref(x, mask)


def _fused_step(sage: SageConfig) -> bool:
    """The one gate of the kernel route: both solvers' steps and the
    shared-uncond group mean."""
    return sage.step_impl == "fused"


def _grid(sched: Schedule, sage: SageConfig, grid, device) -> torch.Tensor:
    if grid is None:
        grid = ddim_timesteps(sched.T, sage.total_steps)
    grid = torch.as_tensor(grid, dtype=torch.long, device=device)
    if grid.ndim not in (1, 2):
        raise ValueError(f"grid must be 1-D or 2-D (rows, L), got shape "
                         f"{tuple(grid.shape)}")
    return grid


def _grid_gather(grid: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Timesteps at (possibly per-row) grid positions: ``grid[i]`` for a
    1-D grid; for a 2-D (B, L) grid row j reads ``grid[j, i_j]`` (rows
    shorter than L are zero-padded and never indexed past their own
    budget)."""
    if grid.ndim == 1:
        return grid[i]
    i = i.expand(grid.shape[0])
    return grid.gather(1, i[:, None])[:, 0]


def _norm_row_samplers(sage: SageConfig,
                       row_samplers: Optional[Sequence[str]]
                       ) -> Tuple[SageConfig, Optional[Tuple[str, ...]]]:
    """Collapse a uniform per-row sampler assignment onto the scalar
    ``sage.sampler`` path; keep the tuple only when rows mix solvers."""
    if row_samplers is None:
        return sage, None
    row_samplers = tuple(row_samplers)
    if len(set(row_samplers)) == 1:
        return _dc_replace(sage, sampler=row_samplers[0]), None
    return sage, row_samplers


def segment_solver(sage: SageConfig, row_samplers: Optional[Sequence[str]],
                   rows: int, device
                   ) -> Tuple[SageConfig, Optional[RowSplit]]:
    """A segment's solver, resolved on the host once: the scalar path's
    config, or the deployment config and each solver's row subset (index
    tensors on ``device``) for a stack of ``rows`` rows mixing solvers."""
    sage, row_samplers = _norm_row_samplers(sage, row_samplers)
    return sage, _row_split(row_samplers, rows, device)


def _row_split(row_samplers: Optional[Tuple[str, ...]], rows: int,
               device) -> Optional[RowSplit]:
    """Each solver's row subset of a mixed stack, built once per segment
    (any name but ``dpmpp`` steps as DDIM, as a uniform pack would)."""
    if row_samplers is None:
        return None
    if len(row_samplers) != rows:
        raise ValueError(f"{len(row_samplers)} row samplers for {rows} rows")
    rows_of = {"ddim": [j for j, s in enumerate(row_samplers) if s != "dpmpp"],
               "dpmpp": [j for j, s in enumerate(row_samplers)
                         if s == "dpmpp"]}
    return {name: torch.tensor(idx, dtype=torch.long, device=device)
            for name, idx in rows_of.items() if idx}


def _eps_pair(eps_fn: EpsFn, z, t, cond, null_cond):
    """One batched denoiser call for the CFG pair -> (eps_u, eps_c)."""
    B = z.shape[0]
    zz = torch.cat([z, z], 0)
    tt = torch.cat([t, t], 0)
    cc = torch.cat([null_cond.expand(cond.shape).to(cond.dtype), cond], 0)
    eps = eps_fn(zz, tt, cc)
    return eps[:B], eps[B:]


def _sampler_update(sched: Schedule, sage: SageConfig, z, t, t_next, eps,
                    eps_prev, t_prev, is_first):
    """Reference DDIM / DPM-Solver++(2M) update from the combined eps; the
    2M warm-up takes the first-order step by aliasing eps_prev := eps."""
    if sage.sampler == "dpmpp":
        ep = torch.where(bcast_rows(is_first, z.ndim) != 0, eps, eps_prev)
        return samplers.dpmpp_2m_step(sched, z, t, t_next, eps, ep, t_prev,
                                      clip_x0=sage.clip_x0)
    return samplers.ddim_step(sched, z, t, t_next, eps, clip_x0=sage.clip_x0)


def _rows(B: int, *values):
    """Broadcast 0-dim step values to (B,) for row gathers."""
    return [v.expand(B) for v in values]


def _mixed_step_reference(sched: Schedule, sage: SageConfig, z, t, t_next,
                          eps_u, eps_c, eps_prev, t_prev, is_first,
                          split: RowSplit):
    """Mixed-solver reference update: each solver's solo update on its own
    row subset, scattered back (never both updates and a select).  Both
    solo reference paths carry the combined eps as history."""
    eps = cfg_combine(eps_u, eps_c, sage.guidance_scale)
    tb, tnb, tpb, fb = _rows(z.shape[0], t, t_next, t_prev, is_first)
    z_next = torch.empty_like(z)
    for name, ix in split.items():
        z_next[ix] = _sampler_update(
            sched, _dc_replace(sage, sampler=name), z[ix], tb[ix], tnb[ix],
            eps[ix], eps_prev[ix], tpb[ix], fb[ix])
    return z_next, eps


def _mixed_step_fused(sched: Schedule, sage: SageConfig, z, t, t_next,
                      eps_u, eps_c, eps_prev, t_prev, is_first,
                      split: RowSplit):
    """Mixed-solver fused update: each solver's kernel over its row subset
    (two sub-batch launches), scattered back.  History per row is that of
    the solo fused paths: DDIM rows carry eps_c, 2M rows the kernel's
    combined eps."""
    tb, tnb, tpb, fb = _rows(z.shape[0], t, t_next, t_prev, is_first)
    z_next, eps_hist = torch.empty_like(z), torch.empty_like(z)
    if "ddim" in split:
        ix = split["ddim"]
        z_next[ix] = dispatch.cfg_ddim_step(
            z[ix], eps_u[ix], eps_c[ix], guidance=sage.guidance_scale,
            alphas=sched.alphas, sigmas=sched.sigmas, t=tb[ix],
            t_next=tnb[ix], clip_x0=sage.clip_x0, impl="fused")
        eps_hist[ix] = eps_c[ix]
    if "dpmpp" in split:
        ix = split["dpmpp"]
        a_t, s_t, a_n, s_n, lam, lam_p, lam_n = samplers.dpmpp_scalars(
            sched, tb[ix], tnb[ix], tpb[ix])
        z_next[ix], eps_hist[ix] = dispatch.cfg_dpmpp_step(
            z[ix], eps_u[ix], eps_c[ix], eps_prev[ix],
            guidance=sage.guidance_scale, a_t=a_t, s_t=s_t, a_n=a_n,
            s_n=s_n, lam=lam, lam_p=lam_p, lam_n=lam_n, is_first=fb[ix],
            clip_x0=sage.clip_x0, impl="fused")
    return z_next, eps_hist


def _step_update(sched: Schedule, sage: SageConfig, z, t, t_next,
                 eps_u, eps_c, eps_prev, t_prev, is_first,
                 split: Optional[RowSplit] = None):
    """One CFG + solver update; returns ``(z_next, history carry)``.

    The fused DDIM route carries eps_c (as the JAX package does; DDIM
    never reads it), the fused 2M route the kernel's combined eps, the
    reference route the combined eps.  A ``split`` routes a mixed-solver
    stack through the per-subset updates.  ``t_prev`` and ``is_first`` are
    read by the 2M and mixed updates only (``None`` where
    :func:`_reads_history` is false); the fused DDIM update is one kernel
    launch that gathers its own schedule values."""
    if sage.step_impl not in dispatch.STEP_IMPLS:
        raise ValueError(f"unknown step impl {sage.step_impl!r}; one of "
                         f"{dispatch.STEP_IMPLS}")
    if split is not None:
        mixed = _mixed_step_fused if _fused_step(sage) \
            else _mixed_step_reference
        return mixed(sched, sage, z, t, t_next, eps_u, eps_c, eps_prev,
                     t_prev, is_first, split)
    if _fused_step(sage) and sage.sampler == "dpmpp":
        a_t, s_t, a_n, s_n, lam, lam_p, lam_n = samplers.dpmpp_scalars(
            sched, t, t_next, t_prev)
        return dispatch.cfg_dpmpp_step(
            z, eps_u, eps_c, eps_prev, guidance=sage.guidance_scale,
            a_t=a_t, s_t=s_t, a_n=a_n, s_n=s_n, lam=lam, lam_p=lam_p,
            lam_n=lam_n, is_first=is_first, clip_x0=sage.clip_x0,
            impl="fused")
    if _fused_step(sage):
        z = dispatch.cfg_ddim_step(
            z, eps_u, eps_c, guidance=sage.guidance_scale,
            alphas=sched.alphas, sigmas=sched.sigmas, t=t, t_next=t_next,
            clip_x0=sage.clip_x0, impl="fused")
        return z, eps_c
    eps = cfg_combine(eps_u, eps_c, sage.guidance_scale)
    return _sampler_update(sched, sage, z, t, t_next, eps, eps_prev, t_prev,
                           is_first), eps


def _reads_history(sage: SageConfig, split: Optional[RowSplit]) -> bool:
    """Whether a segment's updates read ``t_prev`` and the warm-up flag:
    DPM-Solver++(2M) and mixed stacks do; a DDIM-only segment builds
    neither."""
    return split is not None or sage.sampler == "dpmpp"


def _history_indices(grid: torch.Tensor, i: torch.Tensor, first,
                     reads: bool):
    """``(t_prev, is_first)`` at grid position ``i``, the history restarting
    where ``i == first``; ``(None, None)`` when the updates do not read
    them."""
    if not reads:
        return None, None
    return _grid_gather(grid, torch.clamp_min(i - 1, 0)), i == first


class SampleCarry(NamedTuple):
    """Resumable sampler state between segment calls.

    ``z`` is (B, H, W, C) with B = K during the shared phase and B = K*N
    after :func:`fork_carry`; ``eps_prev`` (same shape) is the
    DPM-Solver++(2M) history (never read by DDIM); ``step_idx`` is the
    global position on the DDIM grid — a 0-dim long tensor, or a per-row
    (B,) one in a packed stack."""
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
    # a copy: for K = 1 the reshape would be a view repeating one row
    # (stride 0), which the step kernels refuse
    zb = carry.z[:, None].expand(K, n_members, H, W, C).reshape(
        K * n_members, H, W, C).contiguous()
    return SampleCarry(zb, torch.zeros_like(zb), carry.step_idx)


def _step_index(carry: SampleCarry) -> torch.Tensor:
    return torch.as_tensor(carry.step_idx, dtype=torch.long,
                           device=carry.z.device)


def shared_segment(eps_fn: EpsFn, sched: Schedule, sage: SageConfig,
                   carry: SampleCarry, cbar: torch.Tensor,
                   null_cond: torch.Tensor, n_steps: int, grid: torch.Tensor,
                   split: Optional[RowSplit] = None) -> SampleCarry:
    """The body of :func:`shared_phase` over device tensors: ``carry``'s
    ``step_idx`` a long tensor, ``grid`` the 1-D or 2-D long grid, ``sage``
    and ``split`` from :func:`segment_solver`."""
    z, eps_prev, i = carry
    K = z.shape[0]
    hist = _reads_history(sage, split)
    for _ in range(n_steps):
        t, t_next = _grid_gather(grid, i), _grid_gather(grid, i + 1)
        eps_u, eps_c = _eps_pair(eps_fn, z, t.expand(K), cbar, null_cond)
        z, eps_prev = _step_update(
            sched, sage, z, t, t_next, eps_u, eps_c, eps_prev,
            *_history_indices(grid, i, 0, hist), split)
        i = i + 1
    return SampleCarry(z, eps_prev, i)


def shared_phase(eps_fn: EpsFn, sched: Schedule, sage: SageConfig,
                 carry: SampleCarry, cbar: torch.Tensor,
                 null_cond: torch.Tensor, n_steps: int,
                 grid: Optional[torch.Tensor] = None,
                 row_samplers: Optional[Sequence[str]] = None
                 ) -> SampleCarry:
    """Advance the group-trunk phase ``n_steps`` sampler steps.

    carry.z (K, H, W, C); cbar (K, Lc, dc) group-mean text features.  The
    start position rides in ``carry.step_idx`` (0-dim, or per-row (K,));
    the history warm-up fires at global step 0 only.  ``grid`` (1-D, or
    2-D (K, L) per row) overrides the default DDIM grid; ``row_samplers``
    lets rows mix solvers."""
    if n_steps <= 0:
        return carry
    z = carry.z
    grid = _grid(sched, sage, grid, z.device)
    sage, split = segment_solver(sage, row_samplers, z.shape[0], z.device)
    return shared_segment(eps_fn, sched, sage,
                          carry._replace(step_idx=_step_index(carry)), cbar,
                          null_cond, n_steps, grid, split)


def branch_segment(eps_fn: EpsFn, sched: Schedule, sage: SageConfig,
                   carry: SampleCarry, cond_flat: torch.Tensor,
                   mask: torch.Tensor, null_cond: torch.Tensor, n_steps: int,
                   fork_idx: Union[int, torch.Tensor], grid: torch.Tensor,
                   split: Optional[RowSplit] = None) -> SampleCarry:
    """The body of :func:`branch_phase` over device tensors, as
    :func:`shared_segment`'s; ``fork_idx`` an int or a tensor on the
    latents' device."""
    K, N = mask.shape
    z, eps_prev, i = carry
    if z.shape[0] != K * N:
        raise ValueError(f"carry has {z.shape[0]} rows, mask {K}x{N}")
    if sage.shared_uncond_cfg:
        gm_impl = "kernel" if _fused_step(sage) else "reference"
        cc = torch.cat([null_cond.expand((K,) + tuple(null_cond.shape))
                        .to(cond_flat.dtype), cond_flat], 0)
    hist = _reads_history(sage, split)
    for _ in range(n_steps):
        t, t_next = _grid_gather(grid, i), _grid_gather(grid, i + 1)
        if sage.shared_uncond_cfg:
            # the uncond pass once per group, on the group-mean latent (exact
            # at the fork, an approximation after), packed into ONE denoiser
            # call of K + K*N rows; with per-row t a group's row takes its
            # first member's t
            zg = dispatch.group_mean(z.reshape((K, N) + tuple(z.shape[1:])),
                                     mask, impl=gm_impl)
            tg = t.reshape(K, N)[:, 0] if t.ndim else t.expand(K)
            eps = eps_fn(torch.cat([zg, z], 0),
                         torch.cat([tg, t.expand(K * N)], 0), cc)
            # a copy: for one group (K = 1) the reshape would be a view
            # repeating one row (stride 0), which the step kernels refuse
            eps_u = eps[:K, None].expand((K, N) + tuple(z.shape[1:])
                                         ).reshape(z.shape).contiguous()
            eps_c = eps[K:]
        else:
            eps_u, eps_c = _eps_pair(eps_fn, z, t.expand(K * N), cond_flat,
                                     null_cond)
        z, eps_prev = _step_update(
            sched, sage, z, t, t_next, eps_u, eps_c, eps_prev,
            *_history_indices(grid, i, fork_idx, hist), split)
        i = i + 1
    return SampleCarry(z, eps_prev, i)


def branch_phase(eps_fn: EpsFn, sched: Schedule, sage: SageConfig,
                 carry: SampleCarry, cond_flat: torch.Tensor,
                 mask: torch.Tensor, null_cond: torch.Tensor, n_steps: int,
                 fork_idx: Union[int, torch.Tensor],
                 grid: Optional[torch.Tensor] = None,
                 row_samplers: Optional[Sequence[str]] = None
                 ) -> SampleCarry:
    """Advance the per-member phase ``n_steps`` steps after a fork.

    carry.z (K*N, H, W, C) from :func:`fork_carry`; cond_flat
    (K*N, Lc, dc); mask (K, N), on the latents' device when the
    shared-uncond group mean takes the kernel route.  ``fork_idx`` is the
    global step each row forked at (int, or per-row (K*N,)): the solver
    history restarts there.  ``grid`` / ``row_samplers`` as in
    :func:`shared_phase`, per member row."""
    if n_steps <= 0:
        return carry
    z = carry.z
    if isinstance(fork_idx, torch.Tensor):
        fork_idx = fork_idx.to(z.device)
    grid = _grid(sched, sage, grid, z.device)
    sage, split = segment_solver(sage, row_samplers, z.shape[0], z.device)
    return branch_segment(eps_fn, sched, sage,
                          carry._replace(step_idx=_step_index(carry)),
                          cond_flat, mask, null_cond, n_steps, fork_idx,
                          grid, split)


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
    noise, cond_tokens, mask, null_cond = (
        x.to(dev) for x in (noise, cond_tokens, mask, null_cond))
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
    ``device`` — every prompt its own trajectory, which is one shared
    phase over the whole grid with each row's own condition.
    noise (M, H, W, C); cond_tokens (M, Lc, dc)."""
    dev = resolve_device(device)
    noise, cond_tokens, null_cond = (x.to(dev) for x in
                                     (noise, cond_tokens, null_cond))
    carry = shared_phase(eps_fn, sched.to(dev), sage, init_carry(noise),
                         cond_tokens, null_cond, sage.total_steps)
    return {"latents": carry.z,
            "nfe": 2.0 * cond_tokens.shape[0] * sage.total_steps}
