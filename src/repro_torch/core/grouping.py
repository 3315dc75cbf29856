"""Semantic grouping of prompts (paper §2.2 + §3.1 dataset construction).

Prompts are nodes; edges connect pairs whose embedding cosine similarity
falls in (tau_min, tau_max].  Sampling-time grouping uses a greedy clique
cover (every pair inside a group must be an edge — exactly the paper's
constraint; exact max-clique enumeration is NP-hard, greedy is the
deployable choice and is what we benchmark).  Group sizes are clamped to
[group_min, group_max]; leftovers become singleton groups (independent
sampling).

Host-side numpy — grouping is control-flow-heavy graph work that belongs on
the scheduler CPU, not the accelerator.  This is a copy of the JAX
package's numpy module, kept in the port so it never imports that package.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


# Default tau_max: edges live in the OPEN-BELOW interval (tau_min, tau_max]
# (see ``edge_mask``); 1.01 > 1.0 keeps exact-duplicate prompts (cosine
# == 1.0 up to float error) groupable under the default.
DEFAULT_TAU_MAX = 1.01


def similarity_matrix(embeds: np.ndarray) -> np.ndarray:
    """embeds (M, d), L2-normalised -> (M, M) cosine similarity."""
    e = np.asarray(embeds, np.float32)
    e = e / np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-8)
    return e @ e.T


def edge_mask(sim: np.ndarray, tau_min: float,
              tau_max: float = DEFAULT_TAU_MAX) -> np.ndarray:
    """THE tau interval convention, in one place: a pair is an edge iff its
    cosine similarity falls in the half-open interval ``(tau_min, tau_max]``
    — strictly above tau_min (tau_min itself is *not* similar enough),
    up to and including tau_max.  Every grouping consumer
    (``greedy_clique_groups``, ``incremental_assign``, the serving engine
    and ``serving.shared_prefill``) goes through this helper rather than
    re-encoding the comparison.
    """
    if not tau_min < tau_max:
        raise ValueError(
            f"tau interval empty: need tau_min < tau_max, got "
            f"({tau_min}, {tau_max}]")
    return (sim > tau_min) & (sim <= tau_max)


def greedy_clique_groups(sim: np.ndarray, tau_min: float,
                         tau_max: float = DEFAULT_TAU_MAX, group_max: int = 5
                         ) -> List[List[int]]:
    """Greedy clique cover of the threshold graph.

    Nodes are visited in decreasing degree order; each seed greedily absorbs
    the most-similar compatible candidates (compatible = edge to EVERY
    current member, the paper's pairwise constraint).  Edges follow the
    ``edge_mask`` (tau_min, tau_max] convention.
    """
    if group_max < 1:
        raise ValueError(f"group_max must be >= 1, got {group_max}")
    M = sim.shape[0]
    adj = edge_mask(sim, tau_min, tau_max)
    np.fill_diagonal(adj, False)
    degree = adj.sum(1)
    unassigned = np.ones(M, bool)
    groups: List[List[int]] = []
    for seed in np.argsort(-degree):
        if not unassigned[seed]:
            continue
        members = [int(seed)]
        unassigned[seed] = False
        cand_mask = adj[seed] & unassigned
        # highest-similarity-first absorption
        for cand in np.argsort(-sim[seed]):
            if len(members) >= group_max:
                break
            if not cand_mask[cand]:
                continue
            if all(adj[cand, m] for m in members):
                members.append(int(cand))
                unassigned[cand] = False
        groups.append(members)
    return groups


def incremental_assign(new_embed: np.ndarray,
                       group_embeds: Sequence[np.ndarray], tau_min: float,
                       tau_max: float = DEFAULT_TAU_MAX,
                       group_max: int = 5) -> int:
    """Continuous-batching admission: attach ONE arriving request to an
    existing *open* group, or signal that it should seed a new group.

    ``group_embeds[i]`` is the (n_i, d) stack of member embeddings of open
    group i.  The request may join a group iff it has an edge — the
    ``edge_mask`` (tau_min, tau_max] convention — to EVERY current member
    (the same pairwise clique constraint ``greedy_clique_groups`` enforces,
    so incrementally-built groups satisfy the identical invariant) and the
    group is not full.  Among admissible groups the one with the highest
    minimum similarity (tightest resulting clique) wins.

    Returns the chosen group index, or -1 to seed a new group.
    """
    if group_max < 1:
        raise ValueError(f"group_max must be >= 1, got {group_max}")
    e = np.asarray(new_embed, np.float32).reshape(-1)
    e = e / max(float(np.linalg.norm(e)), 1e-8)
    best, best_score = -1, -np.inf
    for gi, members in enumerate(group_embeds):
        m = np.asarray(members, np.float32)
        if m.shape[0] >= group_max:
            continue
        m = m / np.maximum(np.linalg.norm(m, axis=-1, keepdims=True), 1e-8)
        sims = m @ e
        if not np.all(edge_mask(sims, tau_min, tau_max)):
            continue
        score = float(sims.min())
        if score > best_score:
            best, best_score = gi, score
    return best


def flatten_groups(groups: Sequence[Sequence[int]], group_size: int
                   ) -> List[List[int]]:
    """Split oversize groups into packed rows of at most ``group_size`` —
    the row order of :func:`pad_groups`.  Exposed so completion unpacking
    can map packed row k back to the right member indices (a clique larger
    than N occupies *multiple* rows; iterating the unsplit groups
    misaligns every row after the first split)."""
    flat: List[List[int]] = []
    for g in groups:
        for i in range(0, len(g), group_size):
            flat.append(list(g[i:i + group_size]))
    return flat


def pad_groups(groups: Sequence[Sequence[int]], group_size: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Static-shape packing: (K, N) member indices + (K, N) validity mask.

    Groups larger than N are split (see :func:`flatten_groups`, which
    defines the packed row order); padding repeats the first member (its
    compute is masked out of all reductions).
    """
    flat = flatten_groups(groups, group_size)
    K = len(flat)
    idx = np.zeros((K, group_size), np.int32)
    mask = np.zeros((K, group_size), np.float32)
    for k, g in enumerate(flat):
        idx[k, :len(g)] = g
        idx[k, len(g):] = g[0]
        mask[k, :len(g)] = 1.0
    return idx, mask


def cost_saving(groups: Sequence[Sequence[int]], total_steps: int,
                branch_point: int, cfg_evals: int = 2,
                shared_uncond: bool = False) -> dict:
    """Paper's cost-saving ratio: reduction in total sampler NFE relative to
    independent sampling of the same M prompts.

    independent:   M * T * cfg_evals
    shared (ours): K * (T - T*) * cfg_evals    (shared phase)
                 + sum_k N_k * T* * e_b        (branch phase)
    where e_b = cfg_evals, or 1 + 1/N_k with the beyond-paper shared-uncond
    CFG (the unconditional eval is group-level, amortised over members).
    """
    M = sum(len(g) for g in groups)
    K = len(groups)
    T, Ts = total_steps, branch_point
    indep = M * T * cfg_evals
    shared_phase = K * (T - Ts) * cfg_evals
    if shared_uncond:
        branch_phase = sum((len(g) + 1) * Ts for g in groups)
    else:
        branch_phase = sum(len(g) * Ts * cfg_evals for g in groups)
    ours = shared_phase + branch_phase
    return {"M": M, "K": K, "nfe_independent": indep, "nfe_shared": ours,
            "saving": 1.0 - ours / indep}


def adaptive_branch_point(sim_min: float, total_steps: int,
                          beta_max: float = 0.5) -> int:
    """Beyond-fixed-T* option the paper mentions (§2.2): share more steps
    when the group is tighter.  Linear map sim in [0,1] -> beta in
    [0, beta_max]; returns T* (steps remaining for the branch phase)."""
    beta = float(np.clip(sim_min, 0.0, 1.0)) * beta_max
    return int(round(total_steps * (1.0 - beta)))
