"""Deterministic fault injection for the streaming scheduler.

The port's copy of the JAX package's :class:`FaultPlan`.  Each fault kind
draws from its own ``np.random.RandomState`` stream, seeded by
``zlib.crc32(kind) ^ seed`` and advanced once per query, so a plan fires
the same faults, query for query, as the JAX plan of the same seed, and a
kind's draws do not depend on which other kinds are enabled.  The
scheduler queries it at its fault points:

* ``launch_fails()`` — once per segment launch (one per pack bucket, or
  per group on the per-group path).  On injection the launch is skipped
  and the carry is untouched, so the retry (exponential backoff, bounded
  by ``RequestScheduler(max_retries)``) re-runs the same computation;
  exhaustion sheds the group, its spent NFE moved to ``nfe_wasted``.
* ``tick_stalls()`` — once per ``tick()``; injection turns the tick into a
  pure time advance.
* ``cache_miss()`` — once per would-be trunk-cache hit
  (``serving.trunk_cache.TrunkCache.lookup``); injection forces a miss and
  keeps the entry, so the group computes its own shared phase exactly;
* ``cache_corrupt()`` — once per would-be hit, after the forced-miss
  query; injection flips a byte of the stored payload
  (:func:`corrupt_array`), which the cache's always-on CRC gate
  (:func:`array_crc`) catches: the entry is dropped and the lookup misses.

``max_faults`` bounds the total injection count.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

KINDS = ("launch_fail", "cache_miss", "cache_corrupt", "tick_stall")

# CLI spec aliases (see FaultPlan.parse): short token -> dataclass field
_SPEC_KEYS = {"launch": "p_launch_fail", "miss": "p_cache_miss",
              "corrupt": "p_cache_corrupt", "stall": "p_tick_stall"}


def _sorted_leaves(tree: Any) -> Iterator[Any]:
    """A payload tree's leaves in the JAX package's ``jax.tree.leaves``
    order: dict keys sorted, lists, tuples and named tuples in order,
    ``None`` an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _sorted_leaves(v)
    elif tree is not None:
        yield tree


def _host_bytes(leaf: Any) -> np.ndarray:
    """A leaf's bytes in C order as a host ``uint8`` array: a tensor
    through a ``uint8`` view (bfloat16 has no numpy dtype), anything else
    through numpy."""
    if isinstance(leaf, torch.Tensor):
        flat = leaf.detach().contiguous().reshape(-1)
        return flat.view(torch.uint8).cpu().numpy()
    return np.ascontiguousarray(np.asarray(leaf)).reshape(-1).view(np.uint8)


def array_crc(x: Any) -> int:
    """CRC32 of a payload's bytes, the trunk cache's integrity fingerprint.
    ``x`` is one tensor or a tree of them (the AR-prefix payloads are
    (logits, state cache) trees): the leaves, in :func:`_sorted_leaves`
    order, are chained through one running CRC, so a tree hashes as the
    JAX package's ``array_crc`` hashes the same bytes, and any flipped
    byte changes the fingerprint.  A device tensor is copied to the host
    to be hashed."""
    crc = 0
    for leaf in _sorted_leaves(x):
        crc = zlib.crc32(_host_bytes(leaf), crc)
    return crc


def _map_first(fn: Callable[[Any], Any], tree: Any, done: list) -> Any:
    """``tree`` with its first leaf (in :func:`_sorted_leaves` order)
    replaced by ``fn(leaf)``; the other leaves are kept as they are."""
    if isinstance(tree, dict):
        out = dict(tree)
        for k in sorted(tree):
            out[k] = _map_first(fn, tree[k], done)
        return out
    if isinstance(tree, (list, tuple)):
        items = [_map_first(fn, v, done) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    if tree is None or done:
        return tree
    done.append(True)
    return fn(tree)


def _flip_byte0(leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        out = leaf.detach().clone().contiguous()
        raw = out.reshape(-1).view(torch.uint8)
        raw[0] = raw[0] ^ 0xFF
        return out
    a = np.ascontiguousarray(np.asarray(leaf)).copy()
    a.view(np.uint8).reshape(-1)[0] ^= 0xFF
    return a


def corrupt_array(x: Any) -> Any:
    """Deterministically damage one byte of ``x`` (the injected corruption
    model): every bit of byte 0 of the first leaf is flipped.  Returns a
    new tree of the same structure, the damaged leaf a copy on its own
    device, whose CRC cannot match the original's."""
    return _map_first(_flip_byte0, x, [])


@dataclass
class FaultPlan:
    """Seeded, per-kind-streamed fault injectors.  Probabilities are per
    query; ``injected`` / ``queries`` count per kind."""
    seed: int = 0
    p_launch_fail: float = 0.0
    p_cache_miss: float = 0.0
    p_cache_corrupt: float = 0.0
    p_tick_stall: float = 0.0
    max_faults: Optional[int] = None
    injected: Dict[str, int] = field(default_factory=dict)
    queries: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        for k in KINDS:
            p = getattr(self, f"p_{k}")
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"p_{k} must be in [0, 1], got {p}")
        self._rng = {k: np.random.RandomState(
            zlib.crc32(k.encode()) ^ (self.seed & 0x7FFFFFFF))
            for k in KINDS}
        self.injected = {k: 0 for k in KINDS}
        self.queries = {k: 0 for k in KINDS}

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def _fire(self, kind: str) -> bool:
        self.queries[kind] += 1
        p = getattr(self, f"p_{kind}")
        if p <= 0.0:
            return False
        if (self.max_faults is not None
                and self.total_injected >= self.max_faults):
            return False
        hit = bool(self._rng[kind].rand() < p)
        if hit:
            self.injected[kind] += 1
        return hit

    def launch_fails(self) -> bool:
        return self._fire("launch_fail")

    def cache_miss(self) -> bool:
        return self._fire("cache_miss")

    def cache_corrupt(self) -> bool:
        return self._fire("cache_corrupt")

    def tick_stalls(self) -> bool:
        return self._fire("tick_stall")

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Build a plan from a spec string, e.g.
        ``"launch=0.2,miss=0.1,corrupt=0.05,stall=0.1,seed=3,max=20"``
        (all tokens optional; see ``_SPEC_KEYS`` for the aliases)."""
        kw = {}
        for tok in filter(None, (t.strip() for t in spec.split(","))):
            if "=" not in tok:
                raise ValueError(f"bad fault-plan token {tok!r} "
                                 f"(want key=value)")
            k, v = tok.split("=", 1)
            if k in _SPEC_KEYS:
                kw[_SPEC_KEYS[k]] = float(v)
            elif k == "seed":
                kw["seed"] = int(v)
            elif k == "max":
                kw["max_faults"] = int(v)
            else:
                raise ValueError(
                    f"unknown fault-plan key {k!r}; have "
                    f"{sorted(_SPEC_KEYS) + ['seed', 'max']}")
        return cls(**kw)
