"""Serving observability: request-lifecycle tracing and a metrics
registry, free when off and deterministic under a virtual clock.

The port of the JAX package's ``serving/telemetry.py``; pure Python and
numpy-free, so the same trace and the same exposition come out of either
package for the same run.

:class:`Tracer`
    Structured lifecycle spans (``request.submit -> request.admit ->
    request.group -> group.hold -> group.launch -> cache.{exact,ann,miss}
    -> phase.shared -> group.fork -> phase.branch -> request.complete`` /
    ``group.preempt`` / ``group.resume``; docs/architecture.md §11 lists
    the taxonomy) and per-tick phase spans, exported as Chrome trace-event
    JSON (Perfetto, chrome://tracing).  Timestamps come ONLY from the
    scheduler's injectable ``now`` clock, so a virtual-clock trace is a
    function of the arrival trace alone.  Events inside one tick lie on a
    sub-tick slot cursor (1/1024 tick an event), so admission -> launch ->
    advance -> complete nest as spans without wall-clock data.  The tracer
    sums its own emit time (``self_seconds``), so its overhead (under 5%
    of a run's wall) is read directly, not from an A/B timing.

:class:`MetricsRegistry`
    The home of the serving stats: counters live in :class:`StatGroup`
    objects, real ``dict`` subclasses, so ``stats["nfe"] += x`` and every
    reader of ``sched.stats`` / ``cache.stats`` work unchanged; beside
    them callable gauges, labeled counter families (per-QoS mirrors, fault
    counts by kind) and fixed-bucket histograms (latency, queue depth,
    pack occupancy).  ``to_prometheus()`` writes the text exposition
    format, names ``sage_<group>_<key>`` with ``_total`` on counters.

Neither reads a tensor, an RNG or anything the sampler sees: tracing on
or off gives bitwise equal results, and with ``tracer=None`` (the
default) each of the scheduler's emit sites is one ``is not None`` test.
No emit argument may be a device tensor: reading one would sync the
stream at every launch.

:func:`safe_ratio` is the divide-by-zero guard of every derived rate
(``launches_per_tick``, ``pad_waste``, hit rates): a rate over nothing is
the default (0.0), never NaN or inf.
"""
from __future__ import annotations

import bisect
import json
import time
from collections import Counter, OrderedDict
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, List, Mapping,
                    Optional, Sequence, Tuple)

__all__ = ["safe_ratio", "Histogram", "StatGroup", "MetricsRegistry",
           "Tracer", "TraceEvent", "LATENCY_BUCKETS",
           "QUEUE_DEPTH_BUCKETS", "OCCUPANCY_BUCKETS",
           "PID_REQUESTS", "PID_GROUPS", "PID_EXEC"]


def safe_ratio(num: float, den: float, default: float = 0.0) -> float:
    """``num / den`` with an explicit empty-denominator answer.

    THE divide-by-zero convention for derived serving stats: a rate over
    nothing is ``default`` (0.0 unless stated), never NaN/inf and never
    a mixed bag of per-call-site sentinels."""
    return num / den if den else default


# -- fixed histogram bucket sets (upper bounds; +Inf is implicit) -------
# latencies are virtual ticks (1 tick = 1 time unit on the virtual
# clock); queue depth is waiting requests at tick start; occupancy is
# members/group_size at launch (1.0 = a full group)
LATENCY_BUCKETS: Tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64, 128)
QUEUE_DEPTH_BUCKETS: Tuple[float, ...] = (0, 1, 2, 4, 8, 16, 32, 64)
OCCUPANCY_BUCKETS: Tuple[float, ...] = (0.25, 0.5, 0.75, 1.0)


class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus semantics).

    ``buckets`` are upper bounds in increasing order; observations above
    the last bound land only in the implicit +Inf bucket.  ``observe``
    is O(log buckets) pure python — cheap enough to stay always-on next
    to the stat deques it summarises."""

    __slots__ = ("buckets", "counts", "total", "sum")

    def __init__(self, buckets: Sequence[float]):
        b = tuple(float(x) for x in buckets)
        if list(b) != sorted(set(b)):
            raise ValueError(f"buckets must be strictly increasing: {b}")
        self.buckets = b
        self.counts = [0] * len(b)        # per-bound cumulative-at-export
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        if i < len(self.counts):
            self.counts[i] += 1
        self.total += 1
        self.sum += v

    def cumulative(self) -> List[Tuple[float, int]]:
        """(upper_bound, cumulative_count) pairs, +Inf last."""
        out, acc = [], 0
        for b, c in zip(self.buckets, self.counts):
            acc += c
            out.append((b, acc))
        out.append((float("inf"), self.total))
        return out


class StatGroup(dict):
    """A registry-owned counter group that IS a plain dict.

    The serving stack mutates its stats with ``stats[k] += v`` from hot
    loops and the test suite reads them as dicts; subclassing ``dict``
    keeps both contracts byte-for-byte while letting the registry
    enumerate and export the group.  No methods are overridden — there
    is deliberately nothing to slow down."""
    __slots__ = ()


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare, floats via repr."""
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _labels(d: Mapping[str, Any]) -> str:
    inner = ",".join(f'{k}="{v}"' for k, v in d.items())
    return "{" + inner + "}" if inner else ""


class MetricsRegistry:
    """Single home for serving metrics: counter groups, gauges, labeled
    families and histograms, with Prometheus text exposition.

    Groups/families are attached *by reference* — the registry never
    copies or wraps the hot-path dicts, it only knows where they live —
    so registration has zero steady-state cost.  Names must be unique
    across all kinds (one exposition namespace).
    """

    def __init__(self, namespace: str = "sage"):
        self.namespace = namespace
        self._groups: "OrderedDict[str, Mapping[str, float]]" = \
            OrderedDict()
        self._gauges: "OrderedDict[str, Callable[[], float]]" = \
            OrderedDict()
        # flat families: name -> (mapping, label key); nested families:
        # prefix -> (mapping-of-dicts, label key)
        self._families: "OrderedDict[str, Tuple[Mapping, str]]" = \
            OrderedDict()
        self._nested: "OrderedDict[str, Tuple[Mapping, str]]" = \
            OrderedDict()
        self._hists: "OrderedDict[str, Histogram]" = OrderedDict()
        self._collectors: List[Callable[[], Iterable]] = []

    # -- registration ---------------------------------------------------
    def _claim(self, name: str) -> None:
        for pool in (self._groups, self._gauges, self._families,
                     self._nested, self._hists):
            if name in pool:
                raise ValueError(
                    f"metric name {name!r} already registered — one "
                    f"registry serves one scheduler/cache/fault set")

    def group(self, prefix: str,
              initial: Mapping[str, float]) -> StatGroup:
        """Create and register a counter group; returns the live
        :class:`StatGroup` the owner mutates directly."""
        sg = StatGroup(initial)
        self.attach_group(prefix, sg)
        return sg

    def attach_group(self, prefix: str,
                     mapping: Mapping[str, float]) -> None:
        """Adopt an existing stats dict (e.g. ``TrunkCache.stats``) as a
        counter group — the registry becomes its export surface without
        the owner changing a line of accounting code."""
        self._claim(prefix)
        self._groups[prefix] = mapping

    def gauge(self, name: str, fn: Callable[[], float]) -> None:
        """Register a point-in-time reading (resolved at export)."""
        self._claim(name)
        self._gauges[name] = fn

    def attach_family(self, name: str, mapping: Mapping[str, float],
                      label: str) -> None:
        """Adopt a flat ``{label_value: count}`` dict as one labeled
        counter family (e.g. ``FaultPlan.injected`` by fault kind)."""
        self._claim(name)
        self._families[name] = (mapping, label)

    def attach_nested(self, prefix: str,
                      mapping: Mapping[str, Mapping[str, float]],
                      label: str) -> None:
        """Adopt a ``{label_value: {key: count}}`` dict-of-dicts (e.g.
        the per-QoS class_stats mirrors) as per-key labeled families."""
        self._claim(prefix)
        self._nested[prefix] = (mapping, label)

    def histogram(self, name: str,
                  buckets: Sequence[float]) -> Histogram:
        self._claim(name)
        h = Histogram(buckets)
        self._hists[name] = h
        return h

    def collector(self, fn: Callable[[], Iterable]) -> None:
        """Register an export-time sample source: ``fn()`` yields
        ``(name, labels_dict, value, type)`` tuples (the hook the
        kernel-dispatch log uses to ride the same .prom file)."""
        self._collectors.append(fn)

    # -- views ----------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        """Flat ``{qualified_name: value}`` view of everything (labels
        rendered into the key) — the test-facing export."""
        out: Dict[str, float] = {}
        for prefix, m in self._groups.items():
            for k, v in m.items():
                out[f"{prefix}_{k}"] = v
        for name, fn in self._gauges.items():
            out[name] = fn()
        for name, (m, label) in self._families.items():
            for k, v in m.items():
                out[f'{name}{{{label}="{k}"}}'] = v
        for prefix, (m, label) in self._nested.items():
            for lv, sub in m.items():
                for k, v in sub.items():
                    out[f'{prefix}_{k}{{{label}="{lv}"}}'] = v
        for name, h in self._hists.items():
            out[f"{name}_count"] = h.total
            out[f"{name}_sum"] = h.sum
        for fn in self._collectors:
            for name, labels, v, _kind in fn():
                out[f"{name}{_labels(labels or {})}"] = v
        return out

    def to_prometheus(self) -> str:
        """Text exposition format (one namespace, counters suffixed
        ``_total``, histograms with cumulative ``_bucket`` series)."""
        ns, lines = self.namespace, []

        def emit(name: str, kind: str, samples) -> None:
            base = f"{ns}_{name}" + ("_total" if kind == "counter"
                                     else "")
            lines.append(f"# TYPE {base} {kind}")
            for labels, v in samples:
                lines.append(f"{base}{_labels(labels)} {_fmt(v)}")

        for prefix, m in self._groups.items():
            for k, v in m.items():
                emit(f"{prefix}_{k}", "counter", [({}, v)])
        for name, fn in self._gauges.items():
            emit(name, "gauge", [({}, fn())])
        for name, (m, label) in self._families.items():
            emit(name, "counter",
                 [({label: k}, v) for k, v in m.items()])
        for prefix, (m, label) in self._nested.items():
            keys = sorted({k for sub in m.values() for k in sub})
            for k in keys:
                emit(f"{prefix}_{k}", "counter",
                     [({label: lv}, sub.get(k, 0))
                      for lv, sub in m.items()])
        for name, h in self._hists.items():
            base = f"{ns}_{name}"
            lines.append(f"# TYPE {base} histogram")
            for bound, acc in h.cumulative():
                le = "+Inf" if bound == float("inf") else _fmt(bound)
                lines.append(f'{base}_bucket{{le="{le}"}} {acc}')
            lines.append(f"{base}_sum {_fmt(h.sum)}")
            lines.append(f"{base}_count {h.total}")
        for fn in self._collectors:
            for name, labels, v, kind in fn():
                emit(name, kind, [(labels or {}, v)])
        return "\n".join(lines) + "\n"

    def export(self, path: str) -> int:
        """Write the Prometheus exposition; returns the line count."""
        text = self.to_prometheus()
        with open(path, "w") as f:
            f.write(text)
        return text.count("\n")


# -- tracing ------------------------------------------------------------

# process lanes in the exported trace: requests get tid=rid, groups
# tid=gid, exec is the single tick/launch timeline
PID_REQUESTS, PID_GROUPS, PID_EXEC = 1, 2, 3
_PROCESS_NAMES = {PID_REQUESTS: "requests", PID_GROUPS: "groups",
                  PID_EXEC: "exec"}

# sub-tick layout: each exec-lane event occupies one slot of 1/1024
# tick, so phase spans nest their launches and the whole tick stays
# inside [now, now+1) no matter how busy it was (the cursor clamps at
# the last slot — ordering beyond 1022 events/tick piles up, it never
# spills into the next tick)
_SLOT = 1.0 / 1024.0
_MAX_SLOT = 1022


@dataclass
class TraceEvent:
    """One trace event in scheduler-clock units (unscaled)."""
    name: str
    cat: str
    ph: str                       # "X" complete span | "i" instant
    ts: float
    dur: float
    pid: int
    tid: int
    args: Optional[Dict[str, Any]] = None


@dataclass
class Tracer:
    """Collects lifecycle spans; exports Chrome trace-event JSON.

    ``time_scale`` maps scheduler-clock units to microseconds at export
    (default 1e6: one virtual tick renders as one second — readable in
    Perfetto; pass 1.0 when driving with wall-clock seconds... which
    already are microseconds after the 1e6 scale, so leave the default).
    ``max_events`` bounds memory on long-lived servers: past it events
    are dropped (counted in ``dropped``) while ``counts()`` stays exact.

    Overhead accounting: every emit is wrapped in a perf_counter pair
    whose total lands in ``self_seconds`` — the tracer's own cost is
    part of its telemetry, so the < 5% overhead contract is asserted
    directly instead of via flaky A/B wall comparisons.
    """
    time_scale: float = 1e6
    max_events: int = 1 << 20
    events: List[TraceEvent] = field(default_factory=list)
    dropped: int = 0
    self_seconds: float = 0.0

    def __post_init__(self):
        self._counts: Counter = Counter()
        self._base = 0.0              # current tick's ts origin
        self._slot = 0                # sub-tick slot cursor
        self._tick_args: Dict[str, Any] = {}
        self._phase: Optional[str] = None
        self._phase_slot = 0

    # -- core emit -------------------------------------------------------
    def _emit(self, name: str, cat: str, ph: str, ts: float, dur: float,
              pid: int, tid: int,
              args: Optional[Dict[str, Any]]) -> None:
        t0 = time.perf_counter()
        self._counts[name] += 1
        if len(self.events) < self.max_events:
            self.events.append(
                TraceEvent(name, cat, ph, ts, dur, pid, tid, args))
        else:
            self.dropped += 1
        self.self_seconds += time.perf_counter() - t0

    def instant(self, name: str, ts: float, *, pid: int, tid: int,
                cat: str = "lifecycle", **args: Any) -> None:
        """A zero-duration lifecycle mark at an explicit scheduler-clock
        timestamp (request/group lanes)."""
        self._emit(name, cat, "i", ts, 0.0, pid, tid, args or None)

    def span(self, name: str, ts: float, dur: float, *, pid: int,
             tid: int, cat: str = "lifecycle", **args: Any) -> None:
        """A duration span at explicit scheduler-clock bounds."""
        self._emit(name, cat, "X", ts, dur, pid, tid, args or None)

    # -- exec-lane tick structure ---------------------------------------
    def _cursor(self) -> int:
        s = self._slot
        if self._slot < _MAX_SLOT:
            self._slot += 1
        return s

    def tick_begin(self, now: float, tick: int) -> None:
        """Open a tick frame: subsequent exec-lane events lay out on the
        sub-tick slot cursor starting at ``now``."""
        self._base = float(now)
        self._slot = 0
        self._phase = None
        self._tick_args = {"tick": tick}

    def phase_begin(self, name: str) -> None:
        """Open a tick phase (closing any still-open one first, so the
        scheduler's admit -> launch -> advance -> complete sections each
        call only ``phase_begin``)."""
        self.phase_end()
        self._phase = name
        self._phase_slot = self._slot

    def phase_end(self) -> None:
        """Close the open tick phase as a span covering every slot its
        events consumed (at least one, so empty phases stay visible)."""
        if self._phase is None:
            return
        start = self._phase_slot
        end = max(self._slot, start + 1)
        self._slot = end
        self._emit(f"tick.{self._phase}", "tick", "X",
                   self._base + start * _SLOT, (end - start) * _SLOT,
                   PID_EXEC, 0, None)
        self._phase = None

    def exec_mark(self, name: str, **args: Any) -> None:
        """Instant on the exec lane at the next sub-tick slot."""
        self._emit(name, "exec", "i", self._base + self._cursor() * _SLOT,
                   0.0, PID_EXEC, 0, args or None)

    def launch_span(self, name: str, **args: Any) -> None:
        """One segment launch: a one-slot span on the exec lane, nested
        inside the current tick phase."""
        self._emit(name, "exec", "X",
                   self._base + self._cursor() * _SLOT, _SLOT,
                   PID_EXEC, 0, args or None)

    def tick_end(self, **args: Any) -> None:
        """Close the tick frame as a span over all consumed slots."""
        self.phase_end()
        a = dict(self._tick_args)
        a.update(args)
        self._emit("tick", "tick", "X", self._base,
                   max(self._slot, 1) * _SLOT, PID_EXEC, 0, a)

    # -- views & export --------------------------------------------------
    def counts(self) -> Dict[str, int]:
        """Exact per-name event counts (unaffected by ``max_events``
        drops) — what the reconciliation tests compare to ``stats``."""
        return dict(self._counts)

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON object (ts/dur in microseconds)."""
        sc = self.time_scale
        evs: List[Dict[str, Any]] = []
        for pid, pname in _PROCESS_NAMES.items():
            evs.append({"name": "process_name", "ph": "M", "pid": pid,
                        "tid": 0, "args": {"name": pname}})
        for e in self.events:
            d: Dict[str, Any] = {"name": e.name, "cat": e.cat,
                                 "ph": e.ph, "ts": e.ts * sc,
                                 "pid": e.pid, "tid": e.tid}
            if e.ph == "X":
                d["dur"] = e.dur * sc
            else:
                d["s"] = "t"       # instant scope: thread
            if e.args:
                d["args"] = e.args
            evs.append(d)
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export(self, path: str) -> int:
        """Write Perfetto-loadable JSON; returns the event count."""
        obj = self.to_chrome()
        with open(path, "w") as f:
            json.dump(obj, f)
        return len(obj["traceEvents"])
