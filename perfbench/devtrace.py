"""The device's side of a traced window, from ``torch.profiler``: its busy
time (the union of every device activity), the time each kernel took, and
the idle gaps between activities, each named by the benchmark's innermost
host span (``bench.*``) open when the gap began."""
from __future__ import annotations

import bisect
import collections
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity

TOP = 10
NAME = 160                        # characters of a kernel's name kept
#: the spans that bound a traced window, the first present taken: an open
#: loop's load (its window less the drain), else the whole window
WINDOWS = ("bench.load", "bench.window")


def profiler(device):
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


@dataclass
class Trace:
    window_s: float                      # the traced window (WINDOWS)
    busy_s: float                        # device busy within it
    kernel_s: Dict[str, float]           # device seconds by activity name
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k[:NAME], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in self.gaps[:TOP]]}

    def seconds_of(self, names) -> float:
        """Device seconds of the activities whose name holds any of
        ``names``."""
        return sum(s for k, s in self.kernel_s.items()
                   if any(n in k for n in names))


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof, window) -> Trace:
    """Reduce a stopped profiler to a :class:`Trace` over its window span
    (the first of :data:`WINDOWS` that it holds)."""
    events = prof.profiler.kineto_results.events()
    host, dev = [], []
    for e in events:
        start, dur, name = e.start_ns(), e.duration_ns(), e.name()
        if name.startswith("bench."):
            # a host span, and its copy on the device's timeline (a user
            # annotation, no device work)
            if e.device_type() != DeviceType.CUDA:
                host.append((start, start + dur, name))
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            dev.append((start, start + dur, name))
    win = next(([h for h in host if h[2] == n] for n in WINDOWS
                if any(h[2] == n for h in host)), [])
    if win:
        lo, hi = win[0][0], win[0][1]
    else:                                # the window span was cut off
        lo = min((h[0] for h in host), default=0)
        hi = max((h[1] for h in host), default=0)
    hi = max(hi, lo + 1)
    kernel_s: Dict[str, float] = collections.defaultdict(float)
    spans = []
    for a, b, name in dev:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        kernel_s[name] += (b - a) / 1e9
        spans.append((a, b))
    busy = _merge(spans)
    busy_s = sum(b - a for a, b in busy) / 1e9
    # idle gaps inside the window, named by the innermost bench span open
    # at the gap's start (the latest-starting one that covers it)
    host = sorted(h for h in host if h[2] not in WINDOWS)
    starts = [h[0] for h in host]
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        k = bisect.bisect_right(starts, a)
        name = "bench.window"
        for h in reversed(host[max(0, k - 64):k]):
            if h[0] <= a < h[1]:
                name = h[2]
                break
        gaps.append((name, (b - a) / 1e9))
    gaps.sort(key=lambda g: -g[1])
    return Trace((hi - lo) / 1e9, busy_s, dict(kernel_s),
                 gaps)
