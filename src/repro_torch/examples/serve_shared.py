"""Serve batched text-to-image requests through the port's SAGE engine:
semantic grouping + shared sampling + adaptive branch point + (optionally)
the shared-uncond CFG.  The twin of the JAX package's
``examples/serve_shared.py``, with its flags and output.

    PYTHONPATH=src python -m repro_torch.examples.serve_shared \\
        --requests 24 --adaptive [--device cpu]

The device defaults to CUDA and raises without a GPU; ``--device cpu``
runs the kernels' plain versions.  The model is ``sage-dit`` at smoke
size, with random weights drawn from seed 0 (DiT) and 1 (text tower), no
VAE.  ``--backend kernel --fused-step`` runs attention and the CFG+solver
update on the hand-written CUDA kernels.

Streaming mode drives the continuous-batching scheduler instead of the
synchronous engine: requests arrive over virtual time as a Poisson
process, join open groups incrementally, advance in S-step segments per
tick, and (with --trunk-cache) reuse completed shared phases across
batches via the semantic trunk cache:

    PYTHONPATH=src python -m repro_torch.examples.serve_shared \\
        --requests 24 --streaming --arrival-rate 2.0 --trunk-cache --themes 4

Overload / chaos drills (streaming mode): ``--qos-mix`` tags a fraction
of arrivals as deadline-carrying interactive traffic (the rest is batch),
``--overload shed|degrade`` arms saturation admission past
``--shed-horizon`` ticks of estimated backlog, ``--max-groups-per-tick``
caps launch slots (the contended resource), and ``--fault-plan``
injects seeded faults (``launch=P,miss=P,corrupt=P,stall=P,seed=N``):

    PYTHONPATH=src python -m repro_torch.examples.serve_shared \\
        --requests 48 --streaming --arrival-rate 4.0 --themes 3 \\
        --qos-mix 0.25 --overload shed --max-groups-per-tick 2 \\
        --fault-plan launch=0.1,stall=0.05,seed=7

Telemetry (streaming mode): ``--trace out.json`` records the full
request/group/exec lifecycle as Chrome trace-event JSON (load in
Perfetto or chrome://tracing — deterministic under the virtual clock),
``--metrics out.prom`` writes the Prometheus exposition of every
counter/gauge/histogram plus the live kernel-dispatch route matrix,
and ``--report`` prints the joined SLO + capacity (the H100 cost model of
``launch/costs.py``) + dispatch report:

    PYTHONPATH=src python -m repro_torch.examples.serve_shared \\
        --requests 48 --streaming --trunk-cache --themes 4 \\
        --trace trace.json --metrics metrics.prom --report
"""
import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import SageConfig, get_config
from repro_torch.data.synthetic import ShapesDataset
from repro_torch.kernels.dispatch import DISPATCH_LOG
from repro_torch.models import text_encoder as te
from repro_torch.models.dit import DiT
from repro_torch.serving import reports
from repro_torch.serving.engine import SageServingEngine
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.policies import (PadAwarePolicy, SaturationAdmission,
                                          make_cache_admission)
from repro_torch.serving.telemetry import MetricsRegistry, Tracer
from repro_torch.serving.trunk_cache import TrunkCache


def build_engine(args, modules: Optional[Sequence] = None):
    """The example's engine: ``sage-dit`` at smoke size on ``args.device``,
    with ``modules`` (DiT, text tower) when given (e.g. weights brought
    over from the JAX package), else random ones from seeds 0 and 1."""
    dev = resolve_device(args.device)
    cfg = get_config("sage-dit", smoke=True)
    sage = SageConfig(total_steps=args.steps, share_ratio=0.3,
                      guidance_scale=4.0, tau_min=0.3,
                      adaptive_branch=args.adaptive,
                      shared_uncond_cfg=args.shared_uncond,
                      sampler=args.sampler)
    if modules is None:
        tc = te.text_cfg(dim=cfg.cond_dim, layers=2)
        modules = (
            DiT(cfg, device=dev,
                generator=torch.Generator(device=dev).manual_seed(0)),
            te.TextTower(tc, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1)))
    dit, text = modules
    return SageServingEngine(
        sage, dit, text, None, group_size=4, attn_impl=args.backend,
        step_impl="fused" if args.fused_step else None, device=dev)


def run_sync(engine, prompts):
    engine.submit(prompts)
    t0 = time.time()
    done = []
    while engine.queue:
        done.extend(engine.step(max_batch=16))
    dt = time.time() - t0

    groups = {}
    for c in done:
        groups.setdefault(c.group_id, []).append(c.prompt)
    print(f"served {len(done)} requests in {dt:.1f}s "
          f"({len(groups)} groups)")
    for gid, ps in sorted(groups.items())[:5]:
        print(f"  group {gid}: {ps}")
    print(f"NFE total          = {engine.stats['nfe']:.0f}")
    print(f"NFE if independent = {engine.stats['nfe_independent']:.0f}")
    print(f"cost saving        = {engine.cost_saving:.1%}")


def run_streaming(engine, prompts, args):
    """Poisson arrival simulation over virtual time (1 tick = 1 time unit;
    the scheduler treats `now` as an opaque monotone clock)."""
    rng = np.random.RandomState(args.seed)
    gaps = rng.exponential(1.0 / max(args.arrival_rate, 1e-6), len(prompts))
    arrival_t = np.cumsum(gaps)

    cache = None
    if args.trunk_cache:
        kw = ({"threshold": args.popularity_threshold}
              if args.cache_admission == "popularity" else {})
        cache = TrunkCache(
            tau_trunk=args.tau_trunk,
            admission=make_cache_admission(args.cache_admission, **kw),
            index=args.cache_index,
            max_bytes=args.hbm_budget, host_bytes=args.host_budget)
    policy = (PadAwarePolicy(hold_ticks=args.hold_ticks)
              if args.policy == "pad_aware" else args.policy)
    admission = None
    if args.overload != "off":
        admission = SaturationAdmission(horizon_ticks=args.shed_horizon,
                                        mode=args.overload)
    faults = (FaultPlan.parse(args.fault_plan)
              if args.fault_plan else None)
    telemetry_on = bool(args.trace or args.metrics or args.report)
    tracer = Tracer() if telemetry_on else None
    metrics = MetricsRegistry() if telemetry_on else None
    if telemetry_on:
        DISPATCH_LOG.enabled = True
        metrics.collector(DISPATCH_LOG.prometheus_samples)
    sched = engine.streaming_scheduler(
        slice_steps=args.slice_steps, max_wait_ticks=args.max_wait_ticks,
        trunk_cache=cache, packed=not args.per_group, policy=policy,
        max_groups_per_tick=args.max_groups_per_tick,
        admission=admission, faults=faults, tracer=tracer,
        metrics=metrics, mix_samplers=args.sampler_mix > 0)

    # qos assignment: a seeded coin per request tags it interactive
    # (deadline-carrying) with probability --qos-mix, else batch
    qrng = np.random.RandomState(args.seed + 2)
    interactive = qrng.rand(len(prompts)) < args.qos_mix

    # hetero geometry: per-request shape / quality tier / solver draws.
    # Shapes derive from the model's square latent: full, half-res and
    # half-width (portrait) variants — all patch-aligned.
    hrng = np.random.RandomState(args.seed + 3)
    cfg = engine.scheduler.cfg
    h, c = cfg.latent_size, cfg.latent_channels
    alt_shapes = [(h // 2, h // 2, c), (h // 2, h, c)]
    other = {"ddim": "dpmpp", "dpmpp": "ddim"}[engine.sage.sampler]

    def draw_axes(batch):
        shp = [alt_shapes[hrng.randint(2)] if hrng.rand() < args.shape_mix
               else (h, h, c) for _ in batch]
        tr = [("draft", "premium")[hrng.randint(2)]
              if hrng.rand() < args.tier_mix else "standard" for _ in batch]
        smp = [other if hrng.rand() < args.sampler_mix
               else engine.sage.sampler for _ in batch]
        return {"shape": shp, "tier": tr, "sampler": smp}

    t0 = time.time()
    done, now, i = [], 0.0, 0
    while i < len(prompts) or sched.pending:
        now += 1.0
        int_batch, bat_batch = [], []
        while i < len(prompts) and arrival_t[i] <= now:
            (int_batch if interactive[i] else bat_batch).append(prompts[i])
            i += 1
        if int_batch:
            sched.submit(int_batch, now=now,
                         deadline=now + args.int_deadline,
                         qos="interactive", **draw_axes(int_batch))
        if bat_batch:
            sched.submit(bat_batch, now=now, qos="batch",
                         **draw_axes(bat_batch))
        done.extend(sched.tick(now=now))
    dt = time.time() - t0

    s = sched.summary()
    hits = sum(1 for c in done if c.cache_hit)
    ok = sum(1 for c in done if c.status == "ok")
    print(f"served {ok}/{len(done)} requests in {dt:.1f}s wall "
          f"({s['ticks']:.0f} ticks, arrival rate {args.arrival_rate}/tick)")
    print(f"NFE total          = {s['nfe']:.0f}")
    print(f"NFE if independent = {s['nfe_independent']:.0f}")
    print(f"cost saving        = {s['cost_saving']:.1%}")
    print(f"latency p50 / p95  = {s['latency_p50']:.1f} / "
          f"{s['latency_p95']:.1f} ticks")
    print(f"occupancy / queue  = {s['occupancy_mean']:.2f} / "
          f"{s['queue_depth_mean']:.1f}")
    print(f"launches per tick  = {s['launches_per_tick']:.2f} "
          f"({'per-group' if args.per_group else 'packed'}, "
          f"policy {args.policy}, pad waste {s['pad_waste']:.1%})")
    if args.shape_mix > 0 or args.tier_mix > 0 or args.sampler_mix > 0:
        for tier, ts in sorted(sched.tier_stats.items()):
            print(f"  tier {tier:<9} = {ts['completed']:.0f} done, "
                  f"NFE {ts['nfe']:.0f} "
                  f"({sched.tiers[tier]} steps/request)")
        for key, b in sorted(sched.shape_stats.items()):
            print(f"  shape {key:<8} = {b['launches']:.0f} launches, "
                  f"{b['rows']:.0f} rows ({b['pad_rows']:.0f} pad)")
    if args.qos_mix > 0 or args.overload != "off" or faults is not None:
        print(f"goodput            = {s['goodput']:.0f} deadline-met "
              f"({s['goodput_per_tick']:.2f}/tick), "
              f"missed {s['deadline_missed']:.0f}")
        print(f"overload ledger    = shed {s['shed']:.0f}, degraded "
              f"{s['degraded']:.0f}, rejected_expired "
              f"{s['rejected_expired']:.0f}, backlog "
              f"{s['backlog_ticks']:.1f} ticks")
        print(f"preemption         = {s['preemptions']:.0f} preempts, "
              f"{s['resumes']:.0f} resumes")
        for q in ("interactive", "batch"):
            if f"{q}_requests" in s:
                print(f"  {q:<11} req  = {s[f'{q}_requests']:.0f} "
                      f"(ok {s.get(f'{q}_completed', 0):.0f}, "
                      f"shed {s.get(f'{q}_shed', 0):.0f}, "
                      f"p95 {s.get(f'{q}_latency_p95', 0):.1f} ticks)")
    if faults is not None:
        inj = {k: v for k, v in faults.injected.items() if v}
        print(f"fault injection    = {sum(faults.injected.values())} "
              f"injected {inj or '{}'} / "
              f"{sum(faults.queries.values())} draws; "
              f"{s['launch_faults']:.0f} launch "
              f"faults, {s['retries']:.0f} retries, {s['shed_faulted']:.0f} "
              f"shed_faulted, {s['stalled_ticks']:.0f} stalled ticks, "
              f"nfe_wasted {s['nfe_wasted']:.0f}")
    if cache is not None:
        print(f"trunk cache        = {hits} hit requests, "
              f"{s['cache_hits']:.0f} group hits "
              f"({s['cache_exact_hits']:.0f} exact, "
              f"rate {s['cache_hit_rate']:.0%}), "
              f"NFE saved {s['nfe_saved_cache']:.0f}, "
              f"{s['cache_entries']:.0f} entries / {s['cache_bytes']:.0f} B")
        print(f"cache admission    = {args.cache_admission}, "
              f"{s['cache_admission_rejects']:.0f} store rejects")
        print(f"cache index/tiers  = {s['cache_index']}, "
              f"hbm {s['cache_hbm_bytes']:.0f} B / "
              f"host {s['cache_host_bytes']:.0f} B, "
              f"{s['cache_spills']:.0f} spills, "
              f"{s['cache_promotions']:.0f} promotions")

    if tracer is not None and args.trace:
        n = tracer.export(args.trace)
        print(f"trace              = {args.trace} ({n} events, "
              f"{tracer.dropped} dropped)")
    if metrics is not None and args.metrics:
        n = metrics.export(args.metrics)
        print(f"metrics            = {args.metrics} ({n} lines)")
    if args.report:
        slo = reports.slo_report(s, counts=tracer.counts(),
                                 pending=sched.pending)
        cap = reports.capacity_report(
            s, total_steps=engine.sage.total_steps,
            share_ratio=engine.sage.share_ratio,
            group_size=engine.group_size,
            slice_steps=args.slice_steps,
            max_groups_per_tick=args.max_groups_per_tick,
            n_params=sum(p.numel() for p in engine.modules[0].parameters()),
            n_tokens=(cfg.latent_size // cfg.patch) ** 2)
        print(reports.format_report(slo, cap,
                                    reports.dispatch_report()))


def main(argv: Optional[Sequence[str]] = None,
         modules: Optional[Sequence] = None) -> None:
    """Parse ``argv`` and serve; ``modules`` go to :func:`build_engine`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--adaptive", action="store_true")
    ap.add_argument("--shared-uncond", action="store_true")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--backend", choices=["naive", "chunked", "kernel"],
                    default="naive",
                    help="attention route (repro_torch.kernels.dispatch)")
    ap.add_argument("--fused-step", action="store_true",
                    help="fused CUDA CFG+solver update (DDIM and dpmpp)")
    ap.add_argument("--sampler", choices=["ddim", "dpmpp"], default="ddim",
                    help="ODE solver (both have fused CUDA kernels)")
    ap.add_argument("--streaming", action="store_true",
                    help="continuous-batching scheduler + Poisson arrivals")
    ap.add_argument("--arrival-rate", type=float, default=2.0,
                    help="mean arrivals per tick (streaming mode)")
    ap.add_argument("--slice-steps", type=int, default=4,
                    help="sampler steps each in-flight group advances "
                         "per tick")
    ap.add_argument("--max-wait-ticks", type=int, default=2,
                    help="ticks an underfull group waits before launching")
    ap.add_argument("--per-group", action="store_true",
                    help="disable packed tick execution (one denoiser "
                         "launch per group per tick instead of one per "
                         "pack bucket; streaming mode)")
    ap.add_argument("--policy", choices=["eager", "pad_aware", "adaptive"],
                    default="eager",
                    help="launch policy (streaming mode): eager launches "
                         "sub-full groups at max-wait; pad_aware holds "
                         "them inside a deadline-safe window to fill "
                         "branch rows before padding them; adaptive "
                         "scales the hold budget with the observed "
                         "arrival rate")
    ap.add_argument("--hold-ticks", type=int, default=2,
                    help="extra ticks pad_aware may hold a sub-full "
                         "group past max-wait")
    ap.add_argument("--qos-mix", type=float, default=0.0,
                    help="fraction of arrivals tagged interactive "
                         "(deadline-carrying, preferred by the qos_edf "
                         "launch order); the rest are batch class "
                         "(streaming mode)")
    ap.add_argument("--int-deadline", type=float, default=8.0,
                    help="deadline (ticks after arrival) attached to "
                         "interactive requests")
    ap.add_argument("--overload", choices=["off", "shed", "degrade"],
                    default="off",
                    help="saturation admission past --shed-horizon ticks "
                         "of estimated backlog: shed rejects (accounted "
                         "status=shed), degrade admits at draft NFE "
                         "(max share bucket)")
    ap.add_argument("--shed-horizon", type=float, default=8.0,
                    help="backlog horizon (ticks) beyond which admission "
                         "sheds/degrades; interactive gets 2x headroom")
    ap.add_argument("--max-groups-per-tick", type=int, default=None,
                    help="cap on groups advanced per tick (the launch-"
                         "slot budget preemption arbitrates; default "
                         "unlimited)")
    ap.add_argument("--shape-mix", type=float, default=0.0,
                    help="fraction of arrivals requesting an alternate "
                         "latent shape (half-res or portrait variant of "
                         "the model's square latent); shape buckets pack "
                         "side by side in one tick (streaming mode)")
    ap.add_argument("--tier-mix", type=float, default=0.0,
                    help="fraction of arrivals at a non-standard quality "
                         "tier (draft or premium, 50/50): per-row step "
                         "budgets inside shared packs (streaming mode)")
    ap.add_argument("--sampler-mix", type=float, default=0.0,
                    help="fraction of arrivals using the non-default "
                         "solver; >0 enables mixed-sampler packs "
                         "(per-row ddim/dpmpp dispatch in one launch; "
                         "streaming mode)")
    ap.add_argument("--fault-plan", default="",
                    help="seeded fault injection spec, e.g. "
                         "'launch=0.1,miss=0.05,corrupt=0.02,stall=0.05,"
                         "seed=7,max=50' (streaming mode)")
    ap.add_argument("--trunk-cache", action="store_true",
                    help="cross-batch semantic trunk cache")
    ap.add_argument("--tau-trunk", type=float, default=0.95,
                    help="cosine threshold for trunk-cache hits")
    ap.add_argument("--cache-admission", choices=["always", "popularity"],
                    default="always",
                    help="trunk-cache store policy: always (LRU) or "
                         "popularity (store on Nth demand hit, evict "
                         "cold entries first)")
    ap.add_argument("--cache-index", choices=["scan", "lsh"],
                    default="scan",
                    help="trunk-cache similarity search: exact linear "
                         "scan (oracle) or sign-random-projection LSH "
                         "buckets (candidates re-verified against "
                         "tau-trunk, so hits are never false accepts)")
    ap.add_argument("--hbm-budget", type=int, default=64 * 1024 * 1024,
                    help="trunk-cache HBM working-set byte budget")
    ap.add_argument("--host-budget", type=int, default=0,
                    help="host-RAM spill-tier byte budget (0 disables "
                         "the tier: HBM overflow evicts instead of "
                         "spilling)")
    ap.add_argument("--popularity-threshold", type=int, default=2,
                    help="demand hits a centroid key needs before its "
                         "trunk earns cache bytes (popularity admission)")
    ap.add_argument("--themes", type=int, default=0,
                    help="draw prompts from this many repeated themes "
                         "(0 = all distinct) — repeated themes are what "
                         "the trunk cache exploits")
    ap.add_argument("--trace", default="",
                    help="write a Chrome trace-event JSON of the run "
                         "(request/group/exec lifecycle lanes; open in "
                         "Perfetto; streaming mode)")
    ap.add_argument("--metrics", default="",
                    help="write the Prometheus text exposition of all "
                         "serving metrics + kernel dispatch routes "
                         "(streaming mode)")
    ap.add_argument("--report", action="store_true",
                    help="print the joined SLO/capacity/dispatch report "
                         "(streaming mode)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    engine = build_engine(args, modules)
    ds = ShapesDataset(res=16)
    if args.themes > 0:
        _, base = ds.batch(0, args.themes)
        rng = np.random.RandomState(args.seed + 1)
        prompts = [base[rng.randint(args.themes)]
                   for _ in range(args.requests)]
    else:
        _, prompts = ds.batch(0, args.requests)

    if args.streaming:
        run_streaming(engine, prompts, args)
    else:
        run_sync(engine, prompts)


if __name__ == "__main__":
    main()
