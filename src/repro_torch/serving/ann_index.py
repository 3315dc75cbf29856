"""Pluggable centroid indexes for the trunk cache's similarity search.

The port's copy of the JAX package's ``serving/ann_index.py``.  An index
only *proposes* candidates; ``TrunkCache.lookup`` re-verifies each against
the true ``tau_trunk`` cosine, so an index can lower recall but never
cause a false accept (a trunk miss is always safe: the group computes its
own shared phase exactly).

* :class:`ScanIndex` (``index="scan"``) is the oracle: ``candidates``
  returns ``None`` and the cache scans every resident entry in LRU order.
* :class:`LshIndex` (``index="lsh"``) buckets unit centroids by
  sign-random-projection LSH (SimHash): ``n_tables`` tables, each an
  ``n_bits``-bit code from the signs of ``planes @ centroid``; a lookup
  returns the union of its probe buckets.  Two unit vectors of cosine
  ``s`` fall on one side of a random hyperplane with probability
  ``1 - arccos(s) / pi``, so recall is ``1 - (1 - p^n_bits)^n_tables``:
  above 0.95 for ``tau_trunk >= 0.9`` at the defaults (8 x 6).

The hash runs on the host in f32: centroids are numpy there already (the
scheduler's pooled embeddings), and one (48, d) product a lookup is not
worth a device launch and a sync.  The planes are drawn per embedding dim
from a ``torch.Generator`` seeded from ``(seed, dim)``; the JAX package's
(``jax.random.fold_in``) cannot be drawn in torch, so parity runs carry
them over (``weights.lsh_from_jax``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import (Dict, List, Optional, Protocol, Tuple, Union,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch import seeded_generator


@runtime_checkable
class CentroidIndex(Protocol):
    """Candidate generator over (key, unit centroid) pairs.  ``candidates``
    returns ``None`` for "no narrowing, scan everything" or a list of keys
    to re-verify."""

    name: str

    def add(self, key: Tuple, centroid: np.ndarray) -> None: ...

    def discard(self, key: Tuple) -> None: ...

    def candidates(self, centroid: np.ndarray) -> Optional[List[Tuple]]: ...

    def rebuild(self) -> None: ...

    def __len__(self) -> int: ...


class ScanIndex:
    """The exact oracle: no narrowing, the cache scans all entries in
    residency (LRU) order."""

    name = "scan"

    def __init__(self):
        self._keys: "OrderedDict[Tuple, None]" = OrderedDict()

    def add(self, key: Tuple, centroid: np.ndarray) -> None:
        self._keys[key] = None

    def discard(self, key: Tuple) -> None:
        self._keys.pop(key, None)

    def candidates(self, centroid: np.ndarray) -> Optional[List[Tuple]]:
        return None                      # sentinel: scan every entry

    def rebuild(self) -> None:
        pass

    def __len__(self) -> int:
        return len(self._keys)


class LshIndex:
    """Sign-random-projection (SimHash) LSH over unit centroids.

    Buckets are keyed ``(dim, table, code)``, so centroids of different
    dims never collide; ``candidates`` returns the union of the probe
    buckets in first-inserted order.  ``_planes`` maps an embedding dim to
    its (n_tables * n_bits, dim) f32 planes, drawn on first use."""

    name = "lsh"

    def __init__(self, n_tables: int = 8, n_bits: int = 6, seed: int = 0):
        if n_tables < 1 or n_bits < 1:
            raise ValueError(f"n_tables/n_bits must be >= 1, "
                             f"got {n_tables}/{n_bits}")
        self.n_tables = n_tables
        self.n_bits = n_bits
        self.seed = seed
        self._planes: Dict[int, np.ndarray] = {}        # dim -> projection
        # (dim, table, code) -> ordered set of keys in that bucket
        self._buckets: Dict[Tuple[int, int, int],
                            "OrderedDict[Tuple, None]"] = {}
        # key -> (dim, per-table codes, centroid) for removal + rebuild
        self._sigs: Dict[Tuple, Tuple[int, Tuple[int, ...],
                                      np.ndarray]] = {}
        self.stats = {"adds": 0, "removes": 0, "lookups": 0,
                      "candidates": 0, "rehashes": 0}

    # -- hashing -------------------------------------------------------
    def _planes_for(self, dim: int) -> np.ndarray:
        planes = self._planes.get(dim)
        if planes is None:
            planes = torch.randn((self.n_tables * self.n_bits, dim),
                                 generator=seeded_generator(self.seed, dim)
                                 ).numpy()
            self._planes[dim] = planes
        return planes

    def signature(self, centroid: np.ndarray
                  ) -> Tuple[int, Tuple[int, ...]]:
        """(dim, per-table bucket codes) for a unit centroid."""
        c = np.asarray(centroid, np.float32).reshape(-1)
        dim = c.shape[0]
        bits = (self._planes_for(dim) @ c) >= 0.0
        weights = 1 << np.arange(self.n_bits)
        codes = tuple(
            int(bits[t * self.n_bits:(t + 1) * self.n_bits] @ weights)
            for t in range(self.n_tables))
        return dim, codes

    # -- mutation ------------------------------------------------------
    def add(self, key: Tuple, centroid: np.ndarray) -> None:
        if key in self._sigs:            # re-add = overwrite signature
            self.discard(key)
        c = np.asarray(centroid, np.float32).reshape(-1)
        dim, codes = self.signature(c)
        for t, code in enumerate(codes):
            self._buckets.setdefault((dim, t, code),
                                     OrderedDict())[key] = None
        self._sigs[key] = (dim, codes, c)
        self.stats["adds"] += 1

    def discard(self, key: Tuple) -> None:
        sig = self._sigs.pop(key, None)
        if sig is None:
            return
        dim, codes, _ = sig
        for t, code in enumerate(codes):
            bucket = self._buckets.get((dim, t, code))
            if bucket is not None:
                bucket.pop(key, None)
                if not bucket:
                    del self._buckets[(dim, t, code)]
        self.stats["removes"] += 1

    # -- query ---------------------------------------------------------
    def candidates(self, centroid: np.ndarray) -> List[Tuple]:
        self.stats["lookups"] += 1
        if not self._sigs:               # empty index: nothing to probe
            return []
        dim, codes = self.signature(centroid)
        seen, out = set(), []
        for t, code in enumerate(codes):
            for key in self._buckets.get((dim, t, code), ()):
                if key not in seen:
                    seen.add(key)
                    out.append(key)
        self.stats["candidates"] += len(out)
        return out

    def rebuild(self) -> None:
        """Rehash every resident key from its stored centroid; with the
        planes unchanged the buckets come back exactly."""
        items = [(k, c) for k, (_, _, c) in self._sigs.items()]
        self._buckets.clear()
        self._sigs.clear()
        for key, c in items:
            self.add(key, c)
        self.stats["rehashes"] += 1

    def __len__(self) -> int:
        return len(self._sigs)

    @property
    def mean_candidates(self) -> float:
        """Average candidate-set size per lookup."""
        n = self.stats["lookups"]
        return self.stats["candidates"] / n if n else 0.0


_INDEXES = {
    "scan": ScanIndex,
    "lsh": LshIndex,
}


def make_index(spec: Union[str, CentroidIndex, None],
               **kw) -> CentroidIndex:
    """Resolve an index name (``"scan"`` / ``"lsh"``) or pass an instance
    through; ``kw`` goes to the named constructor."""
    if spec is None:
        return ScanIndex()
    if isinstance(spec, str):
        if spec not in _INDEXES:
            raise ValueError(f"unknown cache index {spec!r}; "
                             f"have {sorted(_INDEXES)}")
        return _INDEXES[spec](**kw)
    return spec
