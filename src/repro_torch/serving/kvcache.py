"""KV/state-cache manipulation for the serving engine.

Caches are trees of nested dicts and lists with tensor leaves, in the
JAX package's structure; every function returns a new tree and leaves
its input as it is.  The tree helpers also walk (named) tuples and pass
non-tensor leaves through, for the graph runners' inputs
(``serving/runners.py``).
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def _map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_map(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _rep(n: int, dim: int):
    return lambda x: x if x.ndim == 0 else torch.repeat_interleave(x, n,
                                                                   dim=dim)


def fork_cache(cache: Any, n: int) -> Any:
    """Replicate a batch-1-per-group cache along the member axis:
    (B, ...) -> (B*n, ...).  This is SAGE's branch point for AR serving —
    O(bytes) for attention KV, O(d_state) for SSM states (the SSM fork is
    the cheapest)."""
    return _map(_rep(n, 0), cache)


def fork_model_cache(cache: Any, n: int) -> Any:
    """Fork an LM runtime cache ({'prefix','blocks','suffix'}): the stacked
    'blocks' leaves carry a leading n_blocks axis, so their batch axis is
    1; prefix/suffix leaves fork on axis 0."""
    return {"prefix": _map(_rep(n, 0), cache["prefix"]),
            "blocks": _map(_rep(n, 1), cache["blocks"]),
            "suffix": _map(_rep(n, 0), cache["suffix"])}


def select_rows(cache: Any, idx) -> Any:
    """Gather member rows of a batched cache (request eviction/reorder)."""
    def take(x):
        if x.ndim == 0:
            return x
        return x.index_select(0, torch.as_tensor(idx, dtype=torch.long,
                                                 device=x.device))
    return _map(take, cache)


def cache_bytes(cache: Any) -> int:
    """Bytes of a tree's tensor leaves (``None`` and other leaves hold
    none)."""
    return sum(x.numel() * x.element_size() for x in _leaves(cache)
               if isinstance(x, torch.Tensor))
