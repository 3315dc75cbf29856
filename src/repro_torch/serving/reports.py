"""SLO and capacity reports over the serving telemetry.

The port of the JAX package's ``serving/reports.py``.  Joins the three
telemetry surfaces of one run, the scheduler's ``summary()`` (a view of
its :class:`~repro_torch.serving.telemetry.MetricsRegistry`), the
:class:`~repro_torch.serving.telemetry.Tracer`'s event counts and the
kernel :data:`~repro_torch.kernels.dispatch.DISPATCH_LOG`, into the two
documents an operator reads:

``slo_report``
    Goodput, latency and outcomes per QoS class, cache efficiency per
    tier, pad waste, and (given a tracer's counts) the request
    conservation check: every submitted request is completed, shed,
    rejected or still pending; a residual other than 0 is a scheduler
    bug, and the report shows it.

``capacity_report``
    The cost model of ``launch/costs.py`` predicts ticks-to-drain and NFE
    for the observed request count; the report prints predicted against
    observed, the tick gap (queueing, holds, retries, stalls) and the NFE
    gap (cache savings).  Its ``roofline`` section takes the H100's
    constants, so it differs from the JAX package's by their ratio.

``dispatch_report``
    The live route matrix of the dispatch log.  The port's log records a
    route at every Python-level dispatch (eager calls, a CUDA graph's
    warm-up and capture; a replay records nothing), the JAX package's
    once per trace: ``fallback_launches`` counts the port's dispatches.

``attributed_columns``
    Extra ``k=v`` tokens for a benchmark row.

Everything here is arithmetic over numbers already collected: no tensor,
no side effects.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

from repro_torch.core.shared_sampling import phase_split
from repro_torch.launch.costs import (denoiser_flops_per_eval, predict_drain,
                                      roofline_seconds)
from repro_torch.serving.telemetry import safe_ratio

__all__ = ["slo_report", "capacity_report", "attributed_columns",
           "dispatch_report", "format_report"]

#: summary() outcome keys mirrored per class (``{qos}_{key}``)
_CLASS_KEYS = ("completed", "shed", "degraded", "preemptions",
               "deadline_met", "deadline_missed")


def _classes(summary: Mapping[str, Any]) -> List[str]:
    """QoS classes present in a summary (detected from the per-class
    latency keys the scheduler emits for every class it saw)."""
    suffix = "_latency_p50"
    return sorted(k[:-len(suffix)] for k in summary
                  if k.endswith(suffix) and not k.startswith("latency"))


def slo_report(summary: Mapping[str, Any],
               counts: Optional[Mapping[str, int]] = None,
               pending: int = 0) -> Dict[str, Any]:
    """Per-class SLO breakdown + cache efficiency from one run's
    ``summary()``; pass ``tracer.counts()`` (and the scheduler's
    ``pending``) to add the trace-side conservation check."""
    s = summary
    rep: Dict[str, Any] = {
        "overall": {
            "requests": s.get("requests", 0),
            "completed": s.get("completed", 0),
            "goodput": s.get("goodput", s.get("completed", 0)),
            "goodput_per_tick": s.get("goodput_per_tick", 0.0),
            "acceptance": safe_ratio(s.get("completed", 0),
                                     s.get("requests", 0)),
            "latency_p50": s.get("latency_p50", 0.0),
            "latency_p95": s.get("latency_p95", 0.0),
            "cost_saving": s.get("cost_saving", 0.0),
            "nfe_per_request": s.get("nfe_per_request", 0.0),
            "launches_per_tick": s.get("launches_per_tick", 0.0),
            "pad_waste": s.get("pad_waste", 0.0),
            "ticks": s.get("ticks", 0),
        },
        "classes": {},
    }
    for q in _classes(s):
        row = {k: s.get(f"{q}_{k}", 0) for k in _CLASS_KEYS}
        row["latency_p50"] = s.get(f"{q}_latency_p50", 0.0)
        row["latency_p95"] = s.get(f"{q}_latency_p95", 0.0)
        row["goodput"] = row["deadline_met"]
        rep["classes"][q] = row
    if "cache_hits" in s:
        hits, misses = s["cache_hits"], s.get("cache_misses", 0)
        lookups = hits + misses if misses else None
        rep["cache"] = {
            "hits": hits,
            "exact_hits": s.get("cache_exact_hits", 0),
            "ann_hits": hits - s.get("cache_exact_hits", 0),
            "hits_hbm": s.get("cache_hits_hbm", 0),
            "hits_host": s.get("cache_hits_host", 0),
            "hit_rate": s.get("cache_hit_rate", 0.0),
            "nfe_saved": s.get("nfe_saved_cache", 0),
            "spills": s.get("cache_spills", 0),
            "promotions": s.get("cache_promotions", 0),
            "index": s.get("cache_index", "scan"),
        }
        if lookups is not None:
            rep["cache"]["lookups"] = lookups
    if counts is not None:
        submits = counts.get("request.submit", 0)
        accounted = (counts.get("request.complete", 0)
                     + counts.get("request.shed", 0)
                     + counts.get("request.shed_faulted", 0)
                     + counts.get("request.rejected_expired", 0)
                     + pending)
        rep["conservation"] = {
            "submits": submits,
            "completes": counts.get("request.complete", 0),
            "sheds": (counts.get("request.shed", 0)
                      + counts.get("request.shed_faulted", 0)),
            "rejects": counts.get("request.rejected_expired", 0),
            "pending": pending,
            "residual": submits - accounted,   # 0 on a sound trace
        }
    return rep


def capacity_report(summary: Mapping[str, Any], *, total_steps: int,
                    share_ratio: float, group_size: int,
                    slice_steps: int,
                    max_groups_per_tick: Optional[int] = None,
                    n_params: Optional[float] = None,
                    n_tokens: int = 0,
                    chips: int = 1) -> Dict[str, Any]:
    """Predicted vs. observed tick economics (the cost model of
    ``launch/costs.py`` wired to the scheduler).  ``n_params`` /
    ``n_tokens`` (the DiT's parameter count and latent token count) add a
    roofline seconds-per-request floor on the H100; omit them for the
    tick-economics-only report."""
    n_shared, _ = phase_split(total_steps, share_ratio)
    requests = int(summary.get("requests", 0))
    pred = predict_drain(requests, group_size, total_steps, n_shared,
                         slice_steps,
                         max_groups_per_tick=max_groups_per_tick)
    obs_ticks = int(summary.get("ticks", 0))
    obs_nfe = float(summary.get("nfe", 0))
    # predict_drain counts SOLVER steps; the scheduler's NFE ledger
    # counts denoiser evals (2x under CFG, (N+1)/2N-ish with the shared
    # uncond pass).  Scale the prediction by the observed evals-per-step
    # factor so the NFE gap attributes scheduling effects, not units.
    evals_per_step = safe_ratio(
        float(summary.get("nfe_independent", 0)),
        requests * total_steps, default=1.0) or 1.0
    rep: Dict[str, Any] = {
        "model": {
            "requests": requests, "group_size": group_size,
            "total_steps": total_steps, "n_shared": n_shared,
            "slice_steps": slice_steps,
            "max_groups_per_tick": max_groups_per_tick,
            "evals_per_step": evals_per_step,
        },
        "predicted": {
            "groups": pred.groups,
            "ticks_to_drain": pred.ticks,
            "nfe": pred.nfe * evals_per_step,
            "nfe_independent": pred.nfe_independent * evals_per_step,
        },
        "observed": {
            "ticks": obs_ticks,
            "nfe": obs_nfe,
            "nfe_independent": summary.get("nfe_independent", 0),
        },
        # the gaps ARE the report: positive tick gap = queueing + holds
        # + retries + stalls; negative NFE gap = cache savings (and
        # degraded-mode beta boosts); positive = pad/retry waste
        "gaps": {
            "extra_ticks": obs_ticks - pred.ticks,
            "tick_ratio": safe_ratio(obs_ticks, pred.ticks),
            "nfe_delta": obs_nfe - pred.nfe * evals_per_step,
            "nfe_ratio": safe_ratio(obs_nfe, pred.nfe * evals_per_step),
            "nfe_saved_cache": summary.get("nfe_saved_cache", 0),
            "nfe_wasted": summary.get("nfe_wasted", 0),
            "stalled_ticks": summary.get("stalled_ticks", 0),
        },
    }
    if n_params and n_tokens:
        flops_eval = denoiser_flops_per_eval(n_params, n_tokens)
        rep["roofline"] = {
            "flops_per_eval": flops_eval,
            "seconds_per_request_floor": roofline_seconds(
                flops_eval * safe_ratio(obs_nfe or pred.nfe,
                                        max(requests, 1)),
                chips=chips),
        }
    return rep


def dispatch_report(log=None) -> Dict[str, Any]:
    """Kernel route-decision rollup from the (module-global by default)
    dispatch log: every (op, requested→chosen) route with its count,
    fallbacks split out — the live fallback matrix.  ``fallback_launches``
    counts the fallback rows' dispatches, as the port's log records them
    (every Python-level dispatch, none in a graph replay)."""
    if log is None:
        from repro_torch.kernels import dispatch
        log = dispatch.DISPATCH_LOG
    rows = log.snapshot()
    return {"enabled": log.enabled, "routes": rows,
            "fallbacks": [r for r in rows if r["reason"] != "requested"],
            "fallback_launches": sum(
                r["count"] for r in rows if r["reason"] != "requested")}


def attributed_columns(summary: Mapping[str, Any]) -> str:
    """Extra ``k=v`` tokens for a benchmark row (goodput / pad / cache
    attribution); tokens are only appended, so a row's name and ``nfe=``
    stay as they were."""
    s = summary
    toks = [f"goodput={int(s.get('goodput', s.get('completed', 0)))}",
            f"launches_per_tick={s.get('launches_per_tick', 0.0):.2f}",
            f"pad_waste={s.get('pad_waste', 0.0):.3f}"]
    if "cache_hit_rate" in s:
        toks.append(f"cache_hit_rate={s['cache_hit_rate']:.3f}")
        toks.append(f"cache_hbm_hits={int(s.get('cache_hits_hbm', 0))}")
        toks.append(f"cache_host_hits={int(s.get('cache_hits_host', 0))}")
    return " ".join(toks)


def _fmt_num(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.3f}" if abs(v) < 1e6 else f"{v:.3e}"
    return str(v)


def _kv_lines(d: Mapping[str, Any], indent: str = "  ") -> List[str]:
    return [f"{indent}{k:<24} {_fmt_num(v)}" for k, v in d.items()]


def format_report(slo: Mapping[str, Any],
                  capacity: Optional[Mapping[str, Any]] = None,
                  dispatch: Optional[Mapping[str, Any]] = None) -> str:
    """Render the joined report as the text block
    ``repro_torch.examples.serve_shared --report`` prints."""
    lines: List[str] = ["== SLO report =="]
    lines += _kv_lines(slo["overall"])
    for q, row in sorted(slo.get("classes", {}).items()):
        lines.append(f" class {q}:")
        lines += _kv_lines(row, indent="   ")
    if "cache" in slo:
        lines.append(" cache:")
        lines += _kv_lines(slo["cache"], indent="   ")
    if "conservation" in slo:
        lines.append(" conservation (trace):")
        lines += _kv_lines(slo["conservation"], indent="   ")
    if capacity is not None:
        lines.append("== capacity (dryrun cost model) ==")
        for sect in ("model", "predicted", "observed", "gaps",
                     "roofline"):
            if sect in capacity:
                lines.append(f" {sect}:")
                lines += _kv_lines(capacity[sect], indent="   ")
    if dispatch is not None:
        lines.append("== kernel dispatch ==")
        if not dispatch.get("enabled", False):
            lines.append("  (dispatch log disabled)")
        for r in dispatch.get("routes", []):
            mark = "" if r["reason"] == "requested" else "  <- FALLBACK"
            lines.append(
                f"  {r['op']:<16} {r['requested']:>9} -> "
                f"{r['chosen']:<9} x{r['count']:<6} "
                f"[{r['shape']}] {r['reason']}{mark}")
        lines.append(
            f"  fallback_launches={dispatch.get('fallback_launches', 0)}")
    return "\n".join(lines)
