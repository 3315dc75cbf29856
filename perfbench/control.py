"""Readings that set a cell's output limits (not run by the benchmark).

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \\
        [--control 3] [--seconds 0]

In one process, for each seed: the cell's system with that seed's weights
serves one short window at the cell's own load and sizes (an offline cell:
one batch; an open cell: ``--seconds`` of arrivals at its rate), and the
output check compares it with the float32 reference, as a run does (the
program's readings).  For an offline cell the largest gap between the
program's cosine similarities of the batch's prompts and the reference's
is printed too (``sim_gap``: what ``check.SIM_TIE`` is set above).  For
the first ``--control`` seeds the control then takes the program's place:
the reference with every matrix product of the DiT and every convolution
of the decoder on operands rounded to float8 e4m3 (each tensor scaled by
its largest magnitude), the precision below the bf16 the configuration
serves the DiT and the decoder in.  Its latents and its decoder's images
of them go into the window's requests where the program's were, and the
run's own output check (``check.judge``) judges that window against the
cell's limits: the control's readings, and its ``correct``, which has to
be false.  One JSON line a seed; ``PERF.md`` gives the readings each
limit was set from.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = str(Path(__file__).resolve().parent)
sys.path[:] = [p for p in sys.path if p != HERE]


def _fp8(x):
    """``x`` rounded to float8 e4m3 under a per-tensor scale, in float32."""
    import torch
    s = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def fp8_mm(a, b):
    import torch
    return torch.matmul(_fp8(a), _fp8(b))


def fp8_conv(x, w, *args, **kw):
    import torch.nn.functional as F
    return F.conv2d(_fp8(x), _fp8(w), *args, **kw)


def control_window(config, wl, window, seed, device):
    """``window`` with the control in the program's place: each member of
    the groups the output check draws for ``seed`` carries the control's
    latent and its decoder's image of it."""
    from perfbench import check
    groups = check.served_groups(window)
    picked = check.pick_groups(window, seed, int(wl["check"]["groups"]))
    ctl = check.Reference(config, seed, device, mm=fp8_mm, conv=fp8_conv,
                          rows=int(wl["check"]["rows"]))
    lat = ctl.latents([[r.prompt for r in groups[g]] for g in picked],
                      picked)
    out = copy.copy(window)
    out.requests = list(window.requests)
    at = {id(r): k for k, r in enumerate(out.requests)}
    for g, zs in zip(picked, lat):
        for r, z in zip(groups[g], zs):
            out.requests[at[id(r)]] = dataclasses.replace(
                r, latent=z, image=ctl.decode(z[None])[0])
    return out


def control_numbers(config, wl, window, seed, device) -> dict:
    """The run's output check of the control in the program's place: each
    number compared, and ``correct``."""
    from perfbench import check
    numbers = check.judge(config, wl, control_window(config, wl, window,
                                                     seed, device),
                          seed, device)
    return {"correct": check.passed(numbers),
            **{k: v["value"] for k, v in numbers.items()}}


def sim_gap(config, window, pooled, seed, device) -> float:
    """The largest gap between the program's and the reference's cosine
    similarities of one offline batch's prompts."""
    from perfbench import check
    from perfbench.reference import sampling as S
    prompts = window.batches[0]
    _, want = check.Reference(config, seed, device).embed(prompts)
    return float(abs(S.similarity(pooled) - S.similarity(want)).max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch
    from perfbench import check, harness

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    cell = harness.find_cell(args.workload)
    wl = cell.workload
    seeds = [int(s) for s in args.seeds.split(",")]
    system = harness.System(cell.config, seeds[0], dev)
    pooled = []
    system.text.register_forward_hook(
        lambda m, a, out: pooled.append(out[1].detach().float().cpu()))
    for k, seed in enumerate(seeds):
        gc.collect()                  # an open loop's graphs, seed to seed
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        system.reseed(seed)
        rng = np.random.default_rng([seed & (2 ** 64 - 1), 7])
        w = harness.LOOPS[wl["loop"]](system, wl, args.seconds, rng)
        numbers = check.judge(cell.config, wl, w, seed, dev)
        line = {"seed": seed, "program": {k2: v["value"]
                                          for k2, v in numbers.items()},
                "requests": len(w.requests)}
        if wl["loop"] == "offline":
            # the window's one batch: the text tower's last rows
            line["sim_gap"] = sim_gap(
                cell.config, w, torch.cat(pooled)[-len(w.batches[0]):]
                .numpy(), seed, dev)
        pooled.clear()
        if k < args.control:
            line["control"] = control_numbers(cell.config, wl, w, seed, dev)
        line["s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
