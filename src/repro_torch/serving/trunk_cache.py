"""Cross-batch semantic trunk cache: SAGE's sharing across time.

The port of the JAX package's ``serving/trunk_cache.py``.  When a group
finishes its shared phase, the trunk (the :class:`~repro_torch.core.
shared_sampling.SampleCarry` at the branch point) is stored under the
group's mean prompt embedding.  A later group whose centroid is close
enough (cosine >= ``tau_trunk``) skips its shared phase and forks straight
into branching from the cached latent.  Branches forked from a cached trunk
are exact for the cached centroid's conditioning and approximate for the
new group's, the same approximation as the paper's within-group sharing,
so ``tau_trunk`` should sit well above ``tau_min``.  Everything else that
shapes a trunk must match exactly: the sampler configuration and step
budget (``cfg_key``, per group), the share-ratio bucket, the latent shape
and the payload type.

Keys are two-level: the centroid quantized to ``quant_decimals`` gives an
exact-hit dict key, re-checked against ``tau_trunk``; a key that misses or
fails the re-check falls through to a similarity search over the
candidates of a pluggable index (``serving.ann_index``: the exact
``"scan"`` or ``"lsh"``), each re-verified against the true cosine.

Payloads: diffusion trunks (``payload="trunk"``) and AR prefix trunks
(``payload="ar_prefix"``, a (logits, state cache) tree from
``serving.shared_prefill.cached_prefix_prefill``) share one cache,
namespaced by the payload field of the key.

Tiers: entries live in a device working set bounded by ``max_bytes``; an
overflow spills the victim's payload to CPU tensors (the host tier,
bounded by ``host_bytes``) instead of dropping it, and a hit on a spilled
entry promotes it back to the device it was stored from.  With
``host_bytes=0`` overflow evicts outright.

Admission (``serving.policies.CacheAdmission``) decides whether a trunk
earns bytes and which entry a tier's budget demotes or evicts first; every
lookup ticks the requester's key through ``admission.on_lookup``.

Integrity: a CRC of the payload's bytes (``serving.faults.array_crc``) is
taken at insert and checked on every hit; a mismatch drops the entry and
counts as a miss.  A :class:`~repro_torch.serving.faults.FaultPlan` may
force misses and corrupt payloads on the hit path.  The CRC reads the
payload on the host, so a hit or an insert of a device payload copies it
there once.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Hashable, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.serving.ann_index import CentroidIndex, make_index
from repro_torch.serving.faults import (FaultPlan, _sorted_leaves, array_crc,
                                        corrupt_array)
from repro_torch.serving.kvcache import _map, cache_bytes
from repro_torch.serving.policies import CacheAdmission, make_cache_admission
from repro_torch.serving.telemetry import safe_ratio

HBM, HOST = "hbm", "host"


@dataclass
class TrunkEntry:
    """One completed shared phase: the carry at the branch point."""
    z: Any                       # (1, H, W, C) trunk latent at T*, or for
    #                              payload="ar_prefix" the (logits, cache)
    #                              tree at the prefix boundary
    eps_prev: Any                # solver history at T*, or None
    step_idx: int                # grid position of z (== n_shared); for
    #                              ar_prefix payloads, the prefix length
    beta_bucket: float           # share-ratio bucket the trunk ran under
    rng_fold: int                # the gid whose noise started the trunk
    centroid: np.ndarray         # unit-norm mean prompt embedding
    cfg_key: Hashable            # sampler/schedule compatibility fingerprint
    payload: str = "trunk"       # "trunk" | "ar_prefix"
    tier: str = HBM              # residency tier, maintained by the cache
    nbytes: int = 0
    crc: Optional[int] = None    # CRC of z's bytes, checked on every hit
    device: Optional[torch.device] = None   # where the payload was stored
    #                                         from: a promotion returns it

    def __post_init__(self):
        if not self.nbytes:
            self.nbytes = cache_bytes((self.z, self.eps_prev))
        if self.crc is None:
            self.crc = array_crc(self.z)
        if self.device is None:
            self.device = next(
                (x.device for x in _sorted_leaves(self.z)
                 if isinstance(x, torch.Tensor)), torch.device("cpu"))


def _unit(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, np.float32).reshape(-1)
    return v / max(float(np.linalg.norm(v)), 1e-8)


def _to_host(x: Any) -> Any:
    """A payload tree committed to CPU tensors (bytes unchanged, so the
    CRC survives the tier move)."""
    return _map(lambda t: t.to("cpu"), x)


def _to_device(x: Any, device: torch.device) -> Any:
    """A spilled payload tree back on ``device``."""
    return _map(lambda t: t.to(device), x)


class TrunkCache:
    """Tiered LRU map: quantized group centroid -> :class:`TrunkEntry`.

    ``lookup`` is exact-key first, then a similarity search over index
    candidates; both require ``cfg_key`` / ``beta_bucket`` / shape /
    payload equality and the exact ``tau_trunk`` cosine.

    ``max_bytes`` bounds the device tier, ``host_bytes`` the host spill
    tier (0: no spilling, overflow evicts).  ``index`` is ``"scan"``,
    ``"lsh"`` or a :class:`~repro_torch.serving.ann_index.CentroidIndex`.
    ``store_history=False`` drops ``eps_prev`` from stored entries (a hit
    forks, which restarts the history).  ``admission`` is a
    :class:`~repro_torch.serving.policies.CacheAdmission` or its name
    (``"always"`` / ``"popularity"``); ``faults`` a
    :class:`~repro_torch.serving.faults.FaultPlan` queried on the hit path.
    """

    def __init__(self, tau_trunk: float = 0.95,
                 max_bytes: int = 64 * 1024 * 1024,
                 quant_decimals: int = 2, store_history: bool = True,
                 admission: Union[str, CacheAdmission, None] = None,
                 faults: Optional[FaultPlan] = None,
                 index: Union[str, CentroidIndex, None] = "scan",
                 host_bytes: int = 0):
        if not 0.0 < tau_trunk <= 1.0:
            raise ValueError(f"tau_trunk must be in (0, 1], got {tau_trunk}")
        if host_bytes < 0:
            raise ValueError(f"host_bytes must be >= 0, got {host_bytes}")
        self.tau_trunk = tau_trunk
        self.max_bytes = max_bytes
        self.host_bytes = host_bytes
        self.quant_decimals = quant_decimals
        self.store_history = store_history
        self.admission = make_cache_admission(admission)
        self.faults = faults
        self.index = make_index(index)
        self._entries: "OrderedDict[Tuple, TrunkEntry]" = OrderedDict()
        self.bytes = 0
        self.tier_bytes = {HBM: 0, HOST: 0}
        self.stats = {"hits": 0, "exact_hits": 0, "misses": 0,
                      "hits_hbm": 0, "hits_host": 0,
                      "inserts": 0, "evictions": 0, "overwrites": 0,
                      "admission_rejects": 0, "fault_forced_misses": 0,
                      "integrity_drops": 0, "spills": 0, "promotions": 0}

    # ------------------------------------------------------------------
    def _quant_key(self, centroid: np.ndarray, beta_bucket: float,
                   cfg_key: Hashable, shape: Tuple[int, ...],
                   payload: str = "trunk") -> Tuple:
        q = np.round(_unit(centroid), self.quant_decimals)
        # -0.0 and 0.0 quantize to different bytes; canonicalise
        q = q + 0.0
        return (q.tobytes(), round(beta_bucket, 4), cfg_key, shape, payload)

    # -- tier mechanics ------------------------------------------------
    def _remove(self, key: Tuple) -> TrunkEntry:
        """Drop ``key`` from the store, ledger and index (no stats)."""
        entry = self._entries.pop(key)
        self.bytes -= entry.nbytes
        self.tier_bytes[entry.tier] -= entry.nbytes
        self.index.discard(key)
        return entry

    def _spill(self, key: Tuple) -> None:
        """Demote a device entry to the host tier (bytes move between the
        tier ledgers, the total is unchanged)."""
        entry = self._entries[key]
        entry.z = _to_host(entry.z)
        entry.eps_prev = _to_host(entry.eps_prev)
        entry.tier = HOST
        self.tier_bytes[HBM] -= entry.nbytes
        self.tier_bytes[HOST] += entry.nbytes
        self.stats["spills"] += 1

    def _promote(self, key: Tuple) -> None:
        """Promote on hit: a spilled entry back to its own device."""
        entry = self._entries[key]
        entry.z = _to_device(entry.z, entry.device)
        entry.eps_prev = _to_device(entry.eps_prev, entry.device)
        entry.tier = HBM
        self.tier_bytes[HOST] -= entry.nbytes
        self.tier_bytes[HBM] += entry.nbytes
        self.stats["promotions"] += 1

    def _tier_keys(self, tier: str) -> List[Tuple]:
        """Keys resident in ``tier``, LRU -> MRU order."""
        return [k for k, e in self._entries.items() if e.tier == tier]

    def _enforce_budgets(self) -> None:
        """Settle both budgets: device overflow spills (or evicts without a
        host tier), host overflow evicts.  The last device entry is never
        forced out by its own size: an oversized single trunk stays
        resident."""
        while self.tier_bytes[HBM] > self.max_bytes:
            hbm = self._tier_keys(HBM)
            if len(hbm) <= 1:
                break
            victim = self.admission.victim(hbm, tier=HBM)
            if self.host_bytes > 0:
                self._spill(victim)
            else:
                self._remove(victim)
                self.stats["evictions"] += 1
        while self.tier_bytes[HOST] > self.host_bytes:
            host = self._tier_keys(HOST)
            if not host:
                break
            victim = self.admission.victim(host, tier=HOST)
            self._remove(victim)
            self.stats["evictions"] += 1

    # ------------------------------------------------------------------
    def lookup(self, centroid: np.ndarray, beta_bucket: float,
               cfg_key: Hashable, shape: Tuple[int, ...],
               payload: str = "trunk") -> Optional[TrunkEntry]:
        """Best compatible entry with cosine >= tau_trunk, else None."""
        c = _unit(centroid)
        key = self._quant_key(centroid, beta_bucket, cfg_key, shape,
                              payload)
        # the demand signal, on every lookup path
        self.admission.on_lookup(key)
        hit = self._entries.get(key)
        # quantization is coarser than tau_trunk can be, so an exact-key
        # hit must still clear the cosine threshold
        if hit is not None and float(hit.centroid @ c) >= self.tau_trunk:
            hit_key, exact = key, True
        else:
            # no exact entry, or a colliding one that failed the re-check:
            # it must not mask a compatible near-duplicate under another key
            hit_key, best_sim, exact = None, self.tau_trunk, False
            cand = self.index.candidates(c)
            items = (self._entries.items() if cand is None
                     else ((k, self._entries[k]) for k in cand
                           if k in self._entries))
            compat = (round(beta_bucket, 4), cfg_key, shape, payload)
            for k, e in items:
                if (k[1], k[2], k[3], k[4]) != compat:
                    continue
                sim = float(e.centroid @ c)
                if sim >= best_sim:
                    hit_key, best_sim = k, sim
        if hit_key is None:
            self.stats["misses"] += 1
            return None
        entry = self._entries[hit_key]
        # faults ride the hit path only: a forced miss keeps the entry,
        # corruption damages the payload for the gate below to catch
        if self.faults is not None:
            if self.faults.cache_miss():
                self.stats["fault_forced_misses"] += 1
                self.stats["misses"] += 1
                return None
            if self.faults.cache_corrupt():
                entry.z = corrupt_array(entry.z)
        # the integrity gate, always on
        if entry.crc != array_crc(entry.z):
            self._remove(hit_key)
            self.stats["integrity_drops"] += 1
            self.stats["misses"] += 1
            return None
        # a hit is attributed to the tier the entry was found in
        self.stats["hits_" + entry.tier] += 1
        self._entries.move_to_end(hit_key)
        if entry.tier == HOST:
            # the caller forks from this trunk: it belongs in the working
            # set, and its promotion may spill a colder device entry
            self._promote(hit_key)
            self._enforce_budgets()
        self.stats["hits"] += 1
        if exact:
            self.stats["exact_hits"] += 1
        return entry

    def insert(self, entry: TrunkEntry,
               shape: Optional[Tuple[int, ...]] = None) -> bool:
        """Store a completed trunk if the admission policy admits its key;
        returns whether it was stored."""
        entry.centroid = _unit(entry.centroid)
        shape = shape if shape is not None else tuple(entry.z.shape)
        key = self._quant_key(entry.centroid, entry.beta_bucket,
                              entry.cfg_key, shape, entry.payload)
        if not self.admission.admit(key):
            self.stats["admission_rejects"] += 1
            return False
        if not self.store_history and entry.eps_prev is not None:
            entry.eps_prev = None
            entry.nbytes = cache_bytes((entry.z,))
        # overwriting a key is evict-then-insert: the old entry's bytes
        # leave the ledger before the new entry's arrive
        if key in self._entries:
            self._remove(key)
            self.stats["overwrites"] += 1
        entry.tier = HBM                 # fresh trunks enter the working set
        self._entries[key] = entry
        self.bytes += entry.nbytes
        self.tier_bytes[HBM] += entry.nbytes
        self.index.add(key, entry.centroid)
        self.stats["inserts"] += 1
        self._enforce_budgets()
        return True

    # ------------------------------------------------------------------
    def ledger_bytes(self) -> int:
        """Recount ``bytes`` from the stored entries (must equal it)."""
        return sum(e.nbytes for e in self._entries.values())

    def tier_ledger(self) -> dict:
        """Per-tier recount (must equal ``tier_bytes``)."""
        out = {HBM: 0, HOST: 0}
        for e in self._entries.values():
            out[e.tier] += e.nbytes
        return out

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def hit_rate(self) -> float:
        return safe_ratio(self.stats["hits"],
                          self.stats["hits"] + self.stats["misses"])
