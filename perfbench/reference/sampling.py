"""SAGE's shared sampling (Alg. 1 of the paper) in plain PyTorch and NumPy:
the cosine VP schedule, the DDIM grid, cosine-similarity grouping by a
greedy clique cover, and one group sampled from its noise, its trunk under
the members' mean text features, then each member on its own.

Nothing here imports the program; the rules follow the paper and the
``sage`` dict of a configuration file.
"""
from __future__ import annotations

from typing import Callable, List, Mapping, Sequence, Tuple

import numpy as np
import torch

EpsFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
TRAIN_STEPS = 1000
TAU_MAX = 1.01                     # edges: tau_min < cos <= TAU_MAX


def schedule(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alpha_t, sigma_t) for t = 0..1000 of the cosine schedule, f32."""
    t = np.linspace(0.0, 1.0, TRAIN_STEPS + 1)
    f = np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
    abar = np.clip(f / f[0], 1e-8, 1.0)
    return (torch.from_numpy(np.sqrt(abar).astype(np.float32)).to(device),
            torch.from_numpy(np.sqrt(1.0 - abar).astype(np.float32)
                             ).to(device))


def ddim_grid(steps: int) -> List[int]:
    """Sample times from 1000 down to 0 in ``steps`` even strides."""
    return [int(x) for x in np.linspace(TRAIN_STEPS, 0, steps + 1).round()]


def split_steps(sage: Mapping) -> Tuple[int, int]:
    """(shared steps, branch steps): the branch takes round(T (1 - beta))."""
    T = sage["total_steps"]
    n_branch = int(round(T * (1.0 - sage["share_ratio"])))
    return T - n_branch, n_branch


def nfe_per_member(sage: Mapping, n_members: int) -> float:
    """Denoiser rows a member's image costs: its share of the trunk's CFG
    pairs plus its own branch pairs."""
    n_shared, n_branch = split_steps(sage)
    return (2.0 * n_shared + 2.0 * n_members * n_branch) / n_members


def similarity(pooled: np.ndarray) -> np.ndarray:
    e = np.asarray(pooled, np.float32)
    e = e / np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-8)
    return e @ e.T


def clique_groups(sim: np.ndarray, tau_min: float, group_max: int,
                  tie: float = 0.0, served: Sequence[Sequence[int]] = ()
                  ) -> List[List[int]]:
    """Greedy clique cover of the graph whose edges join pairs of cosine
    similarity in (tau_min, TAU_MAX]: seeds in decreasing degree order,
    each absorbing its most similar candidates that are joined to every
    member so far, up to ``group_max``.

    A decision that similarities within ``tie`` of each other, or of
    ``tau_min``, leave open is rounding's to make: it goes the way the
    ``served`` groups (the cover being judged) went, so that a cover that
    departs from this one only there is the same cover."""
    M = sim.shape[0]
    group_of = np.full(M, -1)
    for k, g in enumerate(served):
        group_of[list(g)] = k
    together = (group_of[:, None] == group_of[None, :]) & (group_of[:, None]
                                                           >= 0)
    adj = (sim > tau_min) & (sim <= TAU_MAX)
    adj |= (np.abs(sim - tau_min) <= tie) & together
    np.fill_diagonal(adj, False)
    free = np.ones(M, bool)
    groups = []
    for seed in np.argsort(-adj.sum(1)):
        if not free[seed]:
            continue
        members = [int(seed)]
        free[seed] = False
        order = np.argsort(-sim[seed])
        if tie > 0:
            # within a run of near-equal similarities, the served group's
            # members first
            vals = sim[seed][order]
            block = np.concatenate([[0], np.cumsum(-np.diff(vals) > tie)])
            order = order[np.lexsort((~together[seed][order], block))]
        for cand in order:
            if len(members) >= group_max:
                break
            if adj[seed, cand] and free[cand] and all(adj[cand, m]
                                                      for m in members):
                members.append(int(cand))
                free[cand] = False
        groups.append(members)
    return groups


def is_clique(sim: np.ndarray, members: Sequence[int], tau_min: float,
              tie: float = 0.0) -> bool:
    return all(tau_min - tie < sim[a, b] <= TAU_MAX
               for i, a in enumerate(members) for b in members[i + 1:])


def ddim_update(z, eps_u, eps_c, guidance, a_t, s_t, a_n, s_n, clip):
    """Classifier-free guidance, then one deterministic DDIM step with
    x0 clipped to [-clip, clip]."""
    eps = eps_u + guidance * (eps_c - eps_u)
    x0 = ((z - s_t * eps) / torch.clamp_min(a_t, 1e-6)).clamp(-clip, clip)
    return a_n * x0 + s_n * eps


def sample_groups(eps_fn: EpsFn, sage: Mapping, noise: torch.Tensor,
                  conds: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Final latents of G groups sampled side by side: ``noise`` (G, H, W,
    C), one trunk latent a group; ``conds[g]`` (N_g, Lc, dc) its members'
    text features.  The trunk runs under the members' mean features, then
    each member continues from it under its own; every step evaluates the
    unconditional (all-zero features) and the conditional rows in one call.
    Returns each group's (N_g, H, W, C) latents."""
    alphas, sigmas = schedule(noise.device)
    grid = ddim_grid(sage["total_steps"])
    n_shared, _ = split_steps(sage)
    g_s, clip = sage["guidance_scale"], sage["clip_x0"]

    def step(z, i, cond):
        t, tn = grid[i], grid[i + 1]
        B = z.shape[0]
        tt = torch.full((2 * B,), t, dtype=torch.long, device=z.device)
        eps = eps_fn(torch.cat([z, z]), tt,
                     torch.cat([torch.zeros_like(cond), cond]))
        return ddim_update(z, eps[:B], eps[B:], g_s, alphas[t], sigmas[t],
                           alphas[tn], sigmas[tn], clip)

    z = noise.float()
    cbar = torch.stack([c.mean(0) for c in conds])
    for i in range(n_shared):
        z = step(z, i, cbar)
    sizes = [c.shape[0] for c in conds]
    z = torch.cat([z[g:g + 1].expand(n, *z.shape[1:])
                   for g, n in enumerate(sizes)])
    cond = torch.cat(list(conds))
    for i in range(n_shared, sage["total_steps"]):
        z = step(z, i, cond)
    return list(z.split(sizes))
