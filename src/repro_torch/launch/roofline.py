"""Roofline report CLI: renders the dry run's JSONs
(``experiments/dryrun_torch/*.json``) as markdown; the twin of the JAX
package's ``launch/roofline.py``.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh 16x16]
    PYTHONPATH=src python -m repro_torch.launch.roofline --variants  # §Perf view

The terms are the dry run's datasheet predictions (``launch/dryrun.py``),
not measurements.
"""
from __future__ import annotations

import argparse
import glob
import json


def markdown_table(rows, mesh="16x16", variant="baseline"):
    """One row a case: the three roofline terms, the bottleneck, the
    useful-FLOP ratio, the model GFLOPs and the GiB a device (arguments
    plus temporaries)."""
    hdr = ("| arch | shape | compute s | memory s | collective s | "
           "bottleneck | useful FLOPs | model GF | mem/dev GB |\n"
           "|---|---|---|---|---|---|---|---|---|")
    out = [hdr]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r["mesh"] != mesh or r.get("variant", "baseline") != variant:
            continue
        mem = r.get("memory_analysis", {})
        dev_gb = (mem.get("argument_size_in_bytes", 0)
                  + mem.get("temp_size_in_bytes", 0)) / 2**30
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_term_s']:.2e} "
            f"| {r['memory_term_s']:.2e} | {r['collective_term_s']:.2e} "
            f"| {r['bottleneck']} | {r['useful_flops_ratio']:.2f} "
            f"| {r['model_flops_global']/1e9:.0f} | {dev_gb:.1f} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--variants", action="store_true",
                    help="show §Perf variants next to their baselines")
    args = ap.parse_args(argv)

    rows = []
    for f in sorted(glob.glob(f"{args.dir}/*.json")):
        with open(f) as fh:
            rows.append(json.load(fh))
    if args.variants:
        keys = {(r["arch"], r["shape"]) for r in rows
                if r.get("variant", "baseline") != "baseline"}
        print("| arch | shape | variant | compute s | memory s | "
              "collective s | bottleneck |")
        print("|---|---|---|---|---|---|---|")
        for r in sorted(rows, key=lambda r: (r["arch"], r["shape"],
                                             r.get("variant", ""))):
            if (r["arch"], r["shape"]) not in keys or r["mesh"] != args.mesh:
                continue
            print(f"| {r['arch']} | {r['shape']} | "
                  f"{r.get('variant','baseline')} "
                  f"| {r['compute_term_s']:.2e} | {r['memory_term_s']:.2e} "
                  f"| {r['collective_term_s']:.2e} | {r['bottleneck']} |")
        return
    print(markdown_table(rows, mesh=args.mesh))


if __name__ == "__main__":
    main()
