"""Admission and launch policies: WHEN work enters the streaming scheduler.

The port's copy of the JAX package's ``serving/policies.py`` (pure Python;
the port imports nothing of that package).

* :class:`LaunchPolicy` — which *open* groups launch this tick, and in
  what order.  :class:`EagerPolicy` launches a group the moment it is full,
  has waited ``max_wait_ticks`` or is deadline-urgent (the oracle);
  :class:`PadAwarePolicy` holds sub-full groups up to a deadline-safe
  window and releases first the groups whose rows fill an existing
  :class:`~repro_torch.serving.packing.PackKey` bucket;
  :class:`AdaptivePadAwarePolicy` sizes the hold from the arrival rate.
* launch orders — the advance-priority key of the in-flight groups under a
  ``max_groups_per_tick`` cap: ``fifo``, ``edf`` and ``qos_edf``.
* :class:`AdmissionPolicy` — the per-request overload verdict (admit, shed
  or degrade) from a saturation estimate.
* :class:`CacheAdmission` — whether a completed trunk earns bytes in the
  :class:`~repro_torch.serving.trunk_cache.TrunkCache` and which entry a
  tier's byte budget demotes or evicts first: :class:`AdmitAll` (store
  everything, LRU) or :class:`PopularityAdmission` (store keys asked for
  ``threshold`` times, evict the coldest).

Policies see the scheduler only through :class:`LaunchContext` and
:class:`AdmissionContext`.  Invariants every launch policy keeps: it
chooses *when*, never *whether* (every open group launches once its hold
budget or deadline window is spent); a hold never causes a deadline miss;
and with equal group compositions the completions are those of eager.
"""
from __future__ import annotations

import math
from typing import (Any, Callable, Dict, FrozenSet, List, NamedTuple,
                    Optional, Protocol, Sequence, Tuple, Union,
                    runtime_checkable)

from repro_torch.serving.packing import PackKey

# -- QoS classes and quality tiers --------------------------------------------
#
# ``interactive`` (latency-sensitive, usually deadlined) outranks ``batch``
# (throughput traffic that must not starve: the WFQ weights and the
# scheduler's starvation bound see to it).  Rank 0 is the most urgent.
QOS_RANK: Dict[str, int] = {"interactive": 0, "batch": 1}
DEFAULT_QOS = "interactive"

# A tier names a group's step budget (``RequestScheduler(tiers=...)``); it
# is a grouping compartment like QoS but not a pack axis: each row gathers
# its timesteps from its own group's grid.
DEFAULT_TIER = "standard"


def qos_rank(g) -> int:
    """Launch-order rank of a group's or request's QoS class (duck-typed on
    ``.qos``; unknown or missing classes sort last)."""
    return QOS_RANK.get(getattr(g, "qos", DEFAULT_QOS), len(QOS_RANK))


class LaunchContext(NamedTuple):
    """Read-only tick snapshot a :class:`LaunchPolicy` decides from.

    ``signature_of`` maps an *open* group to the :class:`PackKey` it would
    occupy if launched this tick; ``inflight_signatures`` are the buckets
    the in-flight groups occupy, so a launch whose signature is among them
    rides an existing launch.  ``ticks_to_finish`` is the conservative
    number of ticks a freshly launched group needs (``ceil(T /
    slice_steps) + 1``, the max over the step budgets of the open groups).
    """
    now: float
    tick: int
    group_size: int
    max_wait_ticks: int
    deadline_slack: float
    ticks_to_finish: int
    inflight_signatures: FrozenSet[PackKey]
    signature_of: Callable[[Any], PackKey]
    # EWMA of arrivals per tick: what AdaptivePadAwarePolicy sizes holds from
    arrival_rate: float = 0.0


# -- per-group predicates (shared by every policy) ---------------------------

def is_full(g, ctx: LaunchContext) -> bool:
    return len(g.members) >= ctx.group_size


def wait_ticks(g, ctx: LaunchContext) -> int:
    return ctx.tick - g.created_tick


def is_urgent(g, ctx: LaunchContext) -> bool:
    """The eager deadline trigger: already inside the slack window."""
    return g.earliest_deadline() <= ctx.now + ctx.deadline_slack


def deadline_safe_to_hold(g, ctx: LaunchContext) -> bool:
    """A hold is safe iff the group can still launch next tick and finish
    before its earliest deadline (1 tick per ``now`` unit)."""
    return (g.earliest_deadline()
            > ctx.now + ctx.deadline_slack + ctx.ticks_to_finish)


@runtime_checkable
class LaunchPolicy(Protocol):
    """Which open groups launch this tick, in launch order."""

    name: str

    def launches(self, open_groups: Sequence[Any],
                 ctx: LaunchContext) -> List[Any]:
        ...


class EagerPolicy:
    """Launch the moment a group is full, has waited ``max_wait_ticks``, or
    is under deadline pressure, in open-group (creation) order."""

    name = "eager"

    def launches(self, open_groups: Sequence[Any],
                 ctx: LaunchContext) -> List[Any]:
        return [g for g in open_groups
                if is_full(g, ctx)
                or wait_ticks(g, ctx) >= ctx.max_wait_ticks
                or is_urgent(g, ctx)]


class PadAwarePolicy:
    """Hold sub-full groups, fill existing pack buckets first.

    Only the ``max_wait_ticks`` trigger differs from :class:`EagerPolicy`:
    a sub-full group past it is held up to ``hold_ticks`` more ticks so
    late compartment-mates can still join, unless one of three releases
    fires first: holding is no longer deadline-safe; its would-be
    :class:`PackKey` is among the in-flight buckets (launching adds rows to
    an existing launch, so holding buys nothing); or the hold expired.
    Launch order: full / urgent groups, then bucket fills, then expiries.
    """

    def __init__(self, hold_ticks: int = 2):
        if hold_ticks < 0:
            raise ValueError(f"hold_ticks must be >= 0, got {hold_ticks}")
        self.hold_ticks = hold_ticks

    name = "pad_aware"

    def _hold_budget(self, g, ctx: LaunchContext) -> int:
        """Extra ticks this group may be held past ``max_wait_ticks``."""
        return self.hold_ticks

    def launches(self, open_groups: Sequence[Any],
                 ctx: LaunchContext) -> List[Any]:
        now, fills, expired = [], [], []
        for g in open_groups:
            if is_full(g, ctx) or is_urgent(g, ctx):
                now.append(g)
            elif wait_ticks(g, ctx) >= ctx.max_wait_ticks:
                if not deadline_safe_to_hold(g, ctx):
                    now.append(g)
                elif ctx.signature_of(g) in ctx.inflight_signatures:
                    fills.append(g)
                elif (wait_ticks(g, ctx)
                      >= ctx.max_wait_ticks + self._hold_budget(g, ctx)):
                    expired.append(g)
        return now + fills + expired


class AdaptivePadAwarePolicy(PadAwarePolicy):
    """Pad-aware holds sized by the recent arrival process: the expected
    ticks until ``group_size - members`` more requests arrive at the
    arrival-rate EWMA, capped at ``hold_max``; 0 below ``min_rate``."""

    name = "adaptive"

    def __init__(self, hold_max: int = 4, min_rate: float = 0.25):
        super().__init__(hold_ticks=hold_max)
        if min_rate <= 0:
            raise ValueError(f"min_rate must be > 0, got {min_rate}")
        self.min_rate = min_rate

    def _hold_budget(self, g, ctx: LaunchContext) -> int:
        need = max(ctx.group_size - len(g.members), 1)
        if ctx.arrival_rate < self.min_rate:
            return 0
        return min(self.hold_ticks,
                   int(math.ceil(need / ctx.arrival_rate)))


_LAUNCH_POLICIES: Dict[str, Callable[[], LaunchPolicy]] = {
    "eager": EagerPolicy,
    "pad_aware": PadAwarePolicy,
    "adaptive": AdaptivePadAwarePolicy,
}


def make_launch_policy(spec: Union[str, LaunchPolicy, None],
                       **kw) -> LaunchPolicy:
    """Resolve a policy name (``"eager"`` / ``"pad_aware"`` /
    ``"adaptive"``) or pass an instance through; ``kw`` goes to the named
    constructor."""
    if spec is None:
        return EagerPolicy()
    if isinstance(spec, str):
        if spec not in _LAUNCH_POLICIES:
            raise ValueError(f"unknown launch policy {spec!r}; "
                             f"have {sorted(_LAUNCH_POLICIES)}")
        return _LAUNCH_POLICIES[spec](**kw)
    return spec


# -- launch-order comparators ------------------------------------------------
#
# A plain key function over duck-typed groups (``qos`` /
# ``earliest_deadline()`` / ``gid``): the scheduler sorts its advance
# candidates with it, and the preemptive selector consumes them in that
# order within each class.
LaunchOrder = Callable[[Any], Tuple]


def order_fifo(g) -> Tuple:
    """Strict arrival order (group creation), QoS- and deadline-blind."""
    return (g.gid,)


def order_edf(g) -> Tuple:
    """Earliest deadline first, ties by creation."""
    return (g.earliest_deadline(), g.gid)


def order_qos_edf(g) -> Tuple:
    """(qos, deadline), the default: interactive outranks batch, EDF within
    a class (with one class, exactly :func:`order_edf`)."""
    return (qos_rank(g), g.earliest_deadline(), g.gid)


_LAUNCH_ORDERS: Dict[str, LaunchOrder] = {
    "fifo": order_fifo,
    "edf": order_edf,
    "qos_edf": order_qos_edf,
}


def make_launch_order(spec: Union[str, LaunchOrder, None]) -> LaunchOrder:
    """Resolve an order name (``"fifo"`` / ``"edf"`` / ``"qos_edf"``) or
    pass a key callable through."""
    if spec is None:
        return order_qos_edf
    if isinstance(spec, str):
        if spec not in _LAUNCH_ORDERS:
            raise ValueError(f"unknown launch order {spec!r}; "
                             f"have {sorted(_LAUNCH_ORDERS)}")
        return _LAUNCH_ORDERS[spec]
    return spec


# -- request admission (overload control) ------------------------------------

class AdmissionContext(NamedTuple):
    """Read-only saturation snapshot for one arriving request:
    ``backlog_ticks`` is the scheduler's conservative drain-time estimate
    of the work already in the system, ``arrival_rate`` the arrivals-per-
    tick EWMA."""
    now: float
    qos: str
    deadline: Optional[float]
    backlog_ticks: float
    ticks_to_finish: int
    arrival_rate: float


ADMIT, SHED, DEGRADE = "admit", "shed", "degrade"


@runtime_checkable
class AdmissionPolicy(Protocol):
    """Per-request verdict: ``"admit"``, ``"shed"`` (refused now, an
    accounted ``status="shed"`` record) or ``"degrade"`` (admitted at the
    scheduler's ``degrade_tier`` step budget, ``status="degraded"``)."""

    name: str

    def decide(self, ctx: AdmissionContext) -> str: ...


class AdmitAllRequests:
    """No overload control: everything is served."""

    name = "admit_all"

    def decide(self, ctx: AdmissionContext) -> str:
        return ADMIT


class SaturationAdmission:
    """Shed (or degrade) once the backlog exceeds ``horizon_ticks`` of
    drain time; ``interactive`` requests get ``interactive_headroom`` x the
    horizon before they are refused."""

    name = "saturation"

    def __init__(self, horizon_ticks: float = 8.0, mode: str = SHED,
                 interactive_headroom: float = 2.0):
        if horizon_ticks <= 0:
            raise ValueError(
                f"horizon_ticks must be > 0, got {horizon_ticks}")
        if mode not in (SHED, DEGRADE):
            raise ValueError(f"mode must be 'shed' or 'degrade', "
                             f"got {mode!r}")
        if interactive_headroom < 1.0:
            raise ValueError(f"interactive_headroom must be >= 1, "
                             f"got {interactive_headroom}")
        self.horizon_ticks = horizon_ticks
        self.mode = mode
        self.interactive_headroom = interactive_headroom

    def decide(self, ctx: AdmissionContext) -> str:
        limit = self.horizon_ticks
        if QOS_RANK.get(ctx.qos, len(QOS_RANK)) == 0:
            limit *= self.interactive_headroom
        return ADMIT if ctx.backlog_ticks <= limit else self.mode


_ADMISSION_POLICIES: Dict[str, Callable[..., AdmissionPolicy]] = {
    "admit_all": AdmitAllRequests,
    "shed": lambda **kw: SaturationAdmission(mode=SHED, **kw),
    "degrade": lambda **kw: SaturationAdmission(mode=DEGRADE, **kw),
}


def make_admission_policy(spec: Union[str, AdmissionPolicy, None],
                          **kw) -> AdmissionPolicy:
    """Resolve an admission name (``"admit_all"`` / ``"shed"`` /
    ``"degrade"``) or pass an instance through; ``kw`` goes to the named
    constructor."""
    if spec is None:
        return AdmitAllRequests()
    if isinstance(spec, str):
        if spec not in _ADMISSION_POLICIES:
            raise ValueError(f"unknown admission policy {spec!r}; "
                             f"have {sorted(_ADMISSION_POLICIES)}")
        return _ADMISSION_POLICIES[spec](**kw)
    return spec


# -- trunk-cache admission ---------------------------------------------------

@runtime_checkable
class CacheAdmission(Protocol):
    """Store / evict policy of :class:`~repro_torch.serving.trunk_cache.
    TrunkCache`.

    ``on_lookup`` is called once per cache lookup with the requester's
    quantized key, on the exact-key path and the similarity path alike,
    hit or miss, so popularity counts measure demand, not residency.
    ``admit`` gates ``insert``; ``victim`` picks the key the pressured tier
    demotes or evicts first (``keys`` are that tier's residents, LRU to
    MRU; ``tier`` names it: ``"hbm"`` victims spill to the host tier when
    there is one, ``"host"`` victims leave the cache).
    """

    name: str

    def on_lookup(self, key: Tuple) -> None: ...

    def admit(self, key: Tuple) -> bool: ...

    def victim(self, keys: Sequence[Tuple],
               tier: str = "") -> Optional[Tuple]: ...


class AdmitAll:
    """Store every completed trunk; the coldest resident of the tier under
    pressure spills or leaves first (plain LRU, tier-blind)."""

    name = "always"

    def on_lookup(self, key: Tuple) -> None:
        pass

    def admit(self, key: Tuple) -> bool:
        return True

    def victim(self, keys: Sequence[Tuple],
               tier: str = "") -> Optional[Tuple]:
        for k in keys:                      # first = least recently used
            return k
        return None


class PopularityAdmission:
    """Store only trunks whose quantized-centroid key has been asked for at
    least ``threshold`` times; evict the coldest first.

    The count is demand-side (every ``TrunkCache.lookup`` ticks the
    requester's key), so a theme must recur before its trunk earns bytes.
    The victim is the resident key with the lowest count, ties broken LRU
    first.  Counts survive eviction and tier moves (they measure the
    stream, not the cache); ``tier`` is accepted for the protocol but the
    signal is tier-blind.  Past ``max_keys`` counters the coldest half is
    dropped, so a long-lived server's counter state stays bounded.
    """

    def __init__(self, threshold: int = 2, max_keys: int = 65_536):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = threshold
        self.max_keys = max_keys
        self.counts: Dict[Tuple, int] = {}

    name = "popularity"

    def on_lookup(self, key: Tuple) -> None:
        self.counts[key] = self.counts.get(key, 0) + 1
        if len(self.counts) > self.max_keys:
            keep = sorted(self.counts.items(), key=lambda kv: -kv[1])
            self.counts = dict(keep[:self.max_keys // 2])

    def admit(self, key: Tuple) -> bool:
        return self.counts.get(key, 0) >= self.threshold

    def victim(self, keys: Sequence[Tuple],
               tier: str = "") -> Optional[Tuple]:
        best, best_count = None, None
        for k in keys:                      # LRU -> MRU: ties stay LRU
            c = self.counts.get(k, 0)
            if best is None or c < best_count:
                best, best_count = k, c
        return best


_CACHE_ADMISSIONS: Dict[str, Callable[..., CacheAdmission]] = {
    "always": AdmitAll,
    "popularity": PopularityAdmission,
}


def make_cache_admission(spec: Union[str, CacheAdmission, None],
                         **kw) -> CacheAdmission:
    """Resolve a cache admission name (``"always"`` / ``"popularity"``) or
    pass an instance through; ``kw`` goes to the named constructor."""
    if spec is None:
        return AdmitAll()
    if isinstance(spec, str):
        if spec not in _CACHE_ADMISSIONS:
            raise ValueError(f"unknown cache admission {spec!r}; "
                             f"have {sorted(_CACHE_ADMISSIONS)}")
        return _CACHE_ADMISSIONS[spec](**kw)
    return spec
