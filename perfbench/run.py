"""Run one cell of the port's benchmark on this machine's GPU.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Prints the run's details on standard error
and, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer ones with ``--trace 1``), ``device``, with
``--trace 1`` ``breakdown``, and last ``compared``: each number the output
check compared, beside its limit.  Exits non-zero, printing no result,
without a CUDA device or the port's sources, or when JAX or the JAX
package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = str(Path(__file__).resolve().parent)
# run as a script, the script's folder heads sys.path: keep the benchmark's
# module names from shadowing others
sys.path[:] = [p for p in sys.path if p != HERE]
# every build and kernel cache of the run at a fixed place in the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}


def _finite(x):
    """JSON has no infinity: a value that never came reads 1e300."""
    if isinstance(x, float) and not math.isfinite(x):
        return 1e300
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"perfbench: no src/repro_torch under {ROOT}: the program "
              f"under test is missing", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from perfbench import harness

    cell = harness.find_cell(args.workload)
    chips = next(w["chips"] for w in harness.load_json(
        ROOT / "BENCHMARK.json")["workloads"] if w["name"] == cell.name)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {cell.name} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    harness.log(f"[smi] before: {smi()}")
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T_START)
    harness.log(f"[smi] after: {smi()}")
    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & set(harness.FORBIDDEN))
    if loaded:
        print(f"perfbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    for name, n in result["compared"].items():
        harness.log(f"[check] {name} {n['value']} limit {n['limit']}")
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
