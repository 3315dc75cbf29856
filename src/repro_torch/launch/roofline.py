"""Roofline report CLI: renders the dry run's JSONs
(``experiments/dryrun_torch/*.json``) as markdown; the twin of the JAX
package's ``launch/roofline.py``.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh 16x16]
    PYTHONPATH=src python -m repro_torch.launch.roofline --variants  # §Perf view
    PYTHONPATH=src python -m repro_torch.launch.roofline --against DIR  # two runs

``--against`` compares the runs of two dry runs case by case (another
torch, another commit): what each counts a device that the other does
not.

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


#: what a dry run counts a device, compared by ``--against``
COMPARED = ("flops_per_dev", "collective_bytes_per_dev")


def differences(rows, others):
    """The cases of two dry runs' JSONs, matched by arch, shape, mesh and
    variant, whose FLOPs, collective bytes by kind or argument bytes a
    device differ (a line each), and those only one of them ran; the
    number of cases both ran that count the same, and of cases both
    ran."""
    def key(r):
        return r["arch"], r["shape"], r["mesh"], r.get("variant", "baseline")

    def counts(r):
        out = {k: r[k] for k in COMPARED}
        out["argument_size_in_bytes"] = r["memory_analysis"][
            "argument_size_in_bytes"]
        return out

    mine, theirs = {key(r): r for r in rows}, {key(r): r for r in others}
    lines = [f"{':'.join(k)}: only in {side}" for side, a, b in
             (("this run", mine, theirs), ("the other", theirs, mine))
             for k in sorted(a) if k not in b]
    both = sorted(set(mine) & set(theirs))
    same = 0
    for k in both:
        a, b = counts(mine[k]), counts(theirs[k])
        lines += [f"{':'.join(k)}: {name} {a[name]} vs {b[name]}"
                  for name in a if a[name] != b[name]]
        same += a == b
    return lines, same, len(both)


def _load(directory):
    rows = []
    for f in sorted(glob.glob(f"{directory}/*.json")):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--variants", action="store_true",
                    help="show §Perf variants next to their baselines")
    ap.add_argument("--against", default=None,
                    help="another run's JSON directory: print the cases "
                         "whose counts differ")
    args = ap.parse_args(argv)

    rows = _load(args.dir)
    if args.against:
        lines, same, n = differences(rows, _load(args.against))
        print("\n".join(lines))
        print(f"{same} of {n} cases count the same")
        return
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
