"""Equation 3 — the SAGE training objective.

L_SAGE = E[ lambda1 * w_ts ||eps_th(a_ts z̄ + s_ts e, c̄) - e||^2          (i)
           + lambda2 * ||eps_th(a_ts z̄ + s_ts e, c̄) - soft_target||^2    (ii)
           + (1/N) sum_n w_tb ||eps_th(a_tb z^n + s_tb e, c^n) - e||^2 ]  (iii)

soft_target = (1/N) sum_n eps_th(a_ts z^n + s_ts e, c^n)   (stop-grad by
default — distillation semantics; configurable).

(i)+(ii) supervise the *shared phase* (t_s ~ U{T*..T}); (iii) is the
*branch phase* loss (t_b ~ U{1..T*}).  One shared noise e per group
(Alg. 2 line 7).  All member evals are batched into a single eps_fn call
so the loss costs (2N + 1) model evals per group, fused.

The random draws are an argument (``draws``): :func:`sage_draws` /
:func:`ldm_draws` fill them from a ``torch.Generator``; a parity test hands
over the JAX package's ``jax.random`` draws instead.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

from repro_torch.config import SageConfig
from repro_torch.core.schedule import Schedule
from repro_torch.core.shared_sampling import group_mean

EpsFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
Draws = Dict[str, torch.Tensor]


def sample_group_timesteps(generator: torch.Generator, sage: SageConfig,
                           sched: Schedule, n: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """t_s ~ U{T*..T}, t_b ~ U{1..T*} on the continuous training grid
    (branch point mapped from the sampler grid to [0, sched.T])."""
    ts_lo = int(sched.T * (1.0 - sage.share_ratio))
    t_s = torch.randint(ts_lo, sched.T + 1, (n,), generator=generator)
    t_b = torch.randint(1, max(ts_lo, 2), (n,), generator=generator)
    return t_s, t_b


def sage_draws(generator: torch.Generator, sage: SageConfig,
               sched: Schedule, k: int, latent: Sequence[int],
               device) -> Draws:
    """One group batch's draws: t_s, t_b (K,) and the shared noise eps
    (K, H, W, C), drawn on the CPU from ``generator`` and moved to
    ``device``."""
    t_s, t_b = sample_group_timesteps(generator, sage, sched, k)
    eps = torch.randn((k, *latent), generator=generator)
    return {name: x.to(device) for name, x in
            (("t_s", t_s), ("t_b", t_b), ("eps", eps))}


def _mse(a: torch.Tensor, b: torch.Tensor, dims) -> torch.Tensor:
    return torch.mean((a - b) ** 2, dim=dims)


def sage_loss(eps_fn: EpsFn, sched: Schedule, sage: SageConfig,
              draws: Draws, z: torch.Tensor, cond: torch.Tensor,
              mask: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """z (K,N,H,W,C) clean member latents; cond (K,N,Lc,dc); mask (K,N);
    ``draws`` from :func:`sage_draws`."""
    K, N, H, W, C = z.shape
    t_s, t_b, eps = draws["t_s"], draws["t_b"], draws["eps"]

    zbar = group_mean(z, mask)                             # (K,H,W,C)
    cbar = group_mean(cond, mask)                          # (K,Lc,dc)

    def noise(z_, t_):
        a = sched.alpha(t_).reshape(-1, 1, 1, 1)
        s = sched.sigma(t_).reshape(-1, 1, 1, 1)
        return a * z_ + s * eps.repeat_interleave(z_.shape[0] // K, dim=0)

    # one fused eps_fn call: [shared(K) | members@ts(K*N) | members@tb(K*N)]
    zm = z.reshape(K * N, H, W, C)
    cm = cond.reshape(K * N, *cond.shape[2:])
    t_s_m = t_s.repeat_interleave(N)
    t_b_m = t_b.repeat_interleave(N)
    z_in = torch.cat([noise(zbar, t_s), noise(zm, t_s_m), noise(zm, t_b_m)])
    t_in = torch.cat([t_s, t_s_m, t_b_m])
    c_in = torch.cat([cbar, cm, cm])
    pred = eps_fn(z_in, t_in, c_in)

    pred_shared = pred[:K]
    pred_m_ts = pred[K:K + K * N].reshape(K, N, H, W, C)
    pred_m_tb = pred[K + K * N:].reshape(K, N, H, W, C)

    w_ts = sched.snr_weight(t_s)
    w_tb = sched.snr_weight(t_b)

    # (i) shared-phase denoising faithfulness
    l1 = torch.mean(w_ts * _mse(pred_shared, eps, (1, 2, 3)))

    # (ii) soft-target alignment
    soft = group_mean(pred_m_ts, mask)
    if sage.soft_target_stopgrad:
        soft = soft.detach()
    l2 = torch.mean(_mse(pred_shared, soft, (1, 2, 3)))

    # (iii) branch-phase per-member fidelity
    per_m = _mse(pred_m_tb, eps[:, None], (2, 3, 4))        # (K,N)
    l3 = torch.mean(w_tb * torch.sum(per_m * mask, 1)
                    / torch.clamp_min(torch.sum(mask, 1), 1e-6))

    loss = sage.lambda1 * l1 + sage.lambda2 * l2 + l3
    return loss, {"shared": l1, "soft": l2, "branch": l3}


def ldm_draws(generator: torch.Generator, sched: Schedule,
              shape: Sequence[int], device) -> Draws:
    """t ~ U{1..T} (B,) and eps of the latents' ``shape`` (B, H, W, C)."""
    t = torch.randint(1, sched.T + 1, (shape[0],), generator=generator)
    eps = torch.randn(tuple(shape), generator=generator)
    return {"t": t.to(device), "eps": eps.to(device)}


def ldm_loss(eps_fn: EpsFn, sched: Schedule, draws: Draws, z: torch.Tensor,
             cond: torch.Tensor) -> torch.Tensor:
    """Standard LDM objective (paper Eq. 2) — the Standard-FT baseline."""
    t, eps = draws["t"], draws["eps"]
    a = sched.alpha(t).reshape(-1, 1, 1, 1)
    s = sched.sigma(t).reshape(-1, 1, 1, 1)
    pred = eps_fn(a * z + s * eps, t, cond)
    w = sched.snr_weight(t)
    return torch.mean(w * torch.mean((pred - eps) ** 2, dim=(1, 2, 3)))
