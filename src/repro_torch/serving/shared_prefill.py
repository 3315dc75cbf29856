"""SAGE's insight mapped to autoregressive serving.

The paper amortises the early, semantically-coarse part of generation
across similar queries.  For an AR model the exact analogue is a *shared
trunk*: group requests by prompt-embedding similarity, run ONE prefill
over the group's common prefix, fork the KV/state cache at the branch
point, then decode each member with its own continuation.  The exact
common prefix is lossless: the members' logits are those of independent
prefills.

The JAX package's cross-batch variant, ``cached_prefix_prefill`` (the
trunk served from the semantic trunk cache), waits for the port of the
trunk cache.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import grouping
from repro_torch.serving.kvcache import fork_model_cache


def common_prefix_len(token_rows: np.ndarray) -> int:
    """token_rows (N, S) -> length of the longest shared prefix."""
    if len(token_rows) == 1:
        return token_rows.shape[1]
    eq = np.all(token_rows == token_rows[0:1], axis=0)
    nz = np.nonzero(~eq)[0]
    return int(nz[0]) if len(nz) else token_rows.shape[1]


def group_requests(embeds: np.ndarray, tau: float, group_max: int = 8
                   ) -> List[List[int]]:
    """Semantic grouping of pending requests (paper §2.2, greedy cliques),
    with the edge convention of ``core.grouping.edge_mask``."""
    sim = grouping.similarity_matrix(embeds)
    return grouping.greedy_clique_groups(sim, tau, group_max=group_max)


def shared_prefix_prefill(prefill_fn: Callable, decode_fn: Callable,
                          tokens: np.ndarray, max_len: int
                          ) -> Tuple[Any, Any, int, Dict]:
    """One group: prefill the shared trunk once, fork, catch up members.

    prefill_fn(tokens (1, P), max_len) -> (logits, cache)
    decode_fn(cache, token (N, 1), pos) -> (logits, cache)

    Returns (logits, caches, next_pos, stats).  Cost: P + N*(S-P) token
    steps instead of N*S — the AR mirror of the paper's K(T-T*) + N T*
    accounting.
    """
    N, S = tokens.shape
    P = common_prefix_len(tokens)
    P = max(1, min(P, S - 1))            # leave >= 1 token to catch up
    logits, trunk = prefill_fn(tokens[:1, :P], max_len)
    caches = fork_model_cache(trunk, N)
    logits = torch.repeat_interleave(logits, N, dim=0)
    for pos in range(P, S):
        logits, caches = decode_fn(caches, tokens[:, pos:pos + 1], pos)
    naive = N * S
    ours = P + N * (S - P)
    return logits, caches, S, {
        "prefix_len": P, "token_steps": ours, "token_steps_naive": naive,
        "saving": 1.0 - ours / naive}
