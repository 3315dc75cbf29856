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
* ``cache_miss()`` / ``cache_corrupt()`` — the trunk cache's fault points;
  the port has no trunk cache yet, so nothing queries them.

``max_faults`` bounds the total injection count.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

KINDS = ("launch_fail", "cache_miss", "cache_corrupt", "tick_stall")

# CLI spec aliases (see FaultPlan.parse): short token -> dataclass field
_SPEC_KEYS = {"launch": "p_launch_fail", "miss": "p_cache_miss",
              "corrupt": "p_cache_corrupt", "stall": "p_tick_stall"}


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
