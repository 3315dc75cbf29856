"""SAGE's insight mapped to autoregressive serving.

The paper amortises the early, semantically-coarse part of generation
across similar queries.  For an AR model the exact analogue is a *shared
trunk*: group requests by prompt-embedding similarity, run ONE prefill
over the group's common prefix, fork the KV/state cache at the branch
point, then decode each member with its own continuation.  The exact
common prefix is lossless: the members' logits are those of independent
prefills.

Cross-batch reuse rides the same semantic cache as diffusion trunks:
:func:`cached_prefix_prefill` stores the prefill's (logits, state cache)
in a :class:`~repro_torch.serving.trunk_cache.TrunkCache` under
``payload="ar_prefix"``, which namespaces the key, so one byte budget,
admission policy, index and tier ledger serve both kinds without their
entries ever satisfying each other's lookups.  Prefix reuse is lossless:
the trunk's token bytes ride the ``cfg_key``, so only an exact trunk match
hits; the centroid only routes the lookup.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import grouping
from repro_torch.serving.kvcache import fork_model_cache
from repro_torch.serving.trunk_cache import (TrunkCache, TrunkEntry,
                                             _to_device, _unit)


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


# -- cross-batch prefix reuse (the unified trunk cache) ----------------------

def prefix_cache_key(trunk_tokens: np.ndarray, max_len: int) -> Hashable:
    """Compatibility fingerprint of an AR prefix trunk: its token bytes
    are in the key, so an ``ar_prefix`` hit is an exact match on the
    tokens that built the state cache."""
    t = np.ascontiguousarray(np.asarray(trunk_tokens, np.int32))
    return ("ar_prefix", int(max_len), t.shape[-1], t.tobytes())


def cached_prefix_prefill(prefill_fn: Callable, decode_fn: Callable,
                          tokens: np.ndarray, max_len: int, *,
                          cache: Optional[TrunkCache],
                          embeds: Optional[np.ndarray] = None,
                          centroid: Optional[np.ndarray] = None
                          ) -> Tuple[Any, Any, int, Dict]:
    """:func:`shared_prefix_prefill` with the trunk served from, or stored
    into, the semantic cache (``payload="ar_prefix"``).

    ``centroid`` (or the mean of ``embeds``) routes the lookup; the trunk
    token bytes in the ``cfg_key`` keep reuse exact.  On a hit the P
    prefill token steps leave the ledger; on a miss the fresh (logits,
    state cache) pair is inserted for the next wave.  ``cache=None`` is
    the uncached path.  Returns ``(logits, caches, next_pos, stats)``;
    the stats add ``trunk_cache_hit``.
    """
    if centroid is None:
        if embeds is None:
            raise ValueError("need embeds or centroid for cache routing")
        centroid = np.asarray(embeds, np.float32).mean(axis=0)
    centroid = _unit(centroid)
    N, S = tokens.shape
    P = common_prefix_len(tokens)
    P = max(1, min(P, S - 1))            # leave >= 1 token to catch up
    cfg_key = prefix_cache_key(tokens[0, :P], max_len)
    entry = None
    if cache is not None:
        entry = cache.lookup(centroid, 0.0, cfg_key, (P,),
                             payload="ar_prefix")
    if entry is not None:
        # on the device it was stored from (a victim policy may have
        # spilled it right back)
        logits, trunk = _to_device(entry.z, entry.device)
    else:
        logits, trunk = prefill_fn(tokens[:1, :P], max_len)
        if cache is not None:
            cache.insert(TrunkEntry(
                z=(logits, trunk), eps_prev=None, step_idx=P,
                beta_bucket=0.0, rng_fold=0, centroid=centroid,
                cfg_key=cfg_key, payload="ar_prefix"), shape=(P,))
    caches = fork_model_cache(trunk, N)
    logits = torch.repeat_interleave(logits, N, dim=0)
    for pos in range(P, S):
        logits, caches = decode_fn(caches, tokens[:, pos:pos + 1], pos)
    naive = N * S
    ours = (0 if entry is not None else P) + N * (S - P)
    return logits, caches, S, {
        "prefix_len": P, "token_steps": ours, "token_steps_naive": naive,
        "saving": 1.0 - ours / naive,
        "trunk_cache_hit": entry is not None}
