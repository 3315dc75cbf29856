"""Find an open cell's knee (not run by the benchmark).

    python3 perfbench/sweep.py --workload <cell> --rates 10,20,30 \\
        [--seconds 20] [--seed 1]

One process serves the cell's open loop at each rate in turn, the cell's
own settings otherwise, and prints a JSON line a rate: the latency
percentiles of the requests due in the window (from when each was due),
how many were pending when the window closed and when the drain ended,
and how late the generator ran.  The knee is the highest rate whose
backlog does not grow through the window; the cell offers 0.8 of it.
"""
import argparse
import copy
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = str(Path(__file__).resolve().parent)
sys.path[:] = [p for p in sys.path if p != HERE]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch
    from perfbench import harness

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    system = harness.System(cell.config, args.seed, torch.device("cuda:0"))
    for rate in (float(r) for r in args.rates.split(",")):
        wl = copy.deepcopy(cell.workload)
        wl["arrivals"]["rate"] = rate
        rng = np.random.default_rng([args.seed, 7])
        t0 = time.perf_counter()
        w = harness.open_window(system, wl, args.seconds, rng)
        lat = sorted(r.done - r.due if harness.served(r) else math.inf
                     for r in w.requests)
        n = len(lat)
        pct = {f"p{q}": lat[math.ceil(q / 100 * n) - 1] if n else None
               for q in (50, 90, 95, 99)}
        print(json.dumps({
            "rate": rate, "requests": n,
            "served": sum(harness.served(r) for r in w.requests),
            **{k: (v if v is None or math.isfinite(v) else 1e300)
               for k, v in pct.items()},
            "captures_in_window": w.captures, "stats": w.stats,
            "group_sizes": harness.group_sizes(w), **w.notes,
            "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
