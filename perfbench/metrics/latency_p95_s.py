"""95th percentile (nearest rank) of the latency of every request due in
the window, from when it was due to when ``tick()`` returned its image; a
request refused, failed or not back within the drain counts as infinitely
late."""
import math

from perfbench.harness import served


def read(run):
    lat = sorted(r.done - r.due if served(r) else math.inf
                 for r in run.window.requests)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1]
