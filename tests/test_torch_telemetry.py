"""The port's serving telemetry (``serving/telemetry.py``, ``reports.py``,
``kernels.dispatch.DISPATCH_LOG``, ``launch/costs.py``) held against the
JAX package, and ``tests/test_telemetry.py``'s cases on the port.

The chaos scenario of ``tests/test_telemetry.py`` (an overloaded,
faulted, cached streaming run with a tracer, a registry and the dispatch
log on) runs ONCE per module through the JAX scheduler (plain routes on
the CPU) and once through the port's (``device="cpu"``), with the JAX
init's weights brought over and the JAX-drawn noise.  The two traces must
be equal as Chrome objects, event for event; the Prometheus expositions
line for line but for the dispatch counts (the JAX log records once per
trace, the port's at every Python-level dispatch: the route SETS must be
equal); ``summary()`` and the SLO and capacity reports equal, the
capacity report's ``roofline`` by the ratio of the cards' peaks.  The
port's own copies of the JAX cases (schema, conservation, reconciliation,
export, overhead, names, bitwise invisibility, ``safe_ratio``, buckets,
the event cap, the dispatch log, the reports) read the port's run.  The
example ``repro_torch.examples.serve_shared`` prints the JAX example's
report text on the same flags and weights.

The machine with the card has no JAX: JAX is imported inside the
fixtures, and the ``cuda`` test runs there with
``python -m pytest --noconftest -m cuda tests/test_torch_telemetry.py``.
"""
import dataclasses
import importlib.util
import itertools
import json
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import weights
from repro_torch.config import SageConfig, get_config, replace
from repro_torch.kernels import dispatch
from repro_torch.launch import costs
from repro_torch.launch.costs import predict_drain
from repro_torch.models import text_encoder as te
from repro_torch.serving import reports
from repro_torch.serving.engine import SageServingEngine
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.telemetry import (Histogram, MetricsRegistry,
                                           Tracer, safe_ratio)
from repro_torch.serving.trunk_cache import TrunkCache

from test_torch_streaming import (CS, ROOT, _smoke_modules,  # noqa: F401
                                  one_torch_thread)

SAGE = dict(total_steps=6, share_ratio=0.33, guidance_scale=3.0,
            tau_min=0.3)
FAULTS = "launch=0.2,miss=0.1,stall=0.1,seed=7"
CHAOS = dict(slice_steps=3, max_wait_ticks=1, max_groups_per_tick=2,
             admission="shed")
DISPATCH = "sage_kernel_dispatch_total"
# the roofline's compute term: the JAX package's TPU v5e bf16 peak over
# the H100's (launch/costs.py of each)
PEAK_RATIO = 197e12 / costs.PEAK_FLOPS


def themed_prompts(n, themes=3, seed=0):
    base = [f"a {c} circle on a white canvas"
            for c in ("red", "green", "blue", "yellow")][:themes]
    rng = np.random.RandomState(seed)
    return [base[rng.randint(themes)] for _ in range(n)]


def drive_chaos(sched):
    """``tests/test_telemetry.py``'s chaos loop: 20 themed prompts on
    exponential arrivals, half of each batch interactive with a deadline.
    Returns (records, host wall)."""
    prompts = themed_prompts(20)
    rng = np.random.RandomState(3)
    arrival = np.cumsum(rng.exponential(0.4, len(prompts)))
    t0 = time.perf_counter()
    done, now, i, ticks = [], 0.0, 0, 0
    while (i < len(prompts) or sched.pending) and ticks < 200:
        now += 1.0
        ticks += 1
        batch = []
        while i < len(prompts) and arrival[i] <= now:
            batch.append(prompts[i])
            i += 1
        if batch:
            half = len(batch) // 2
            if batch[:half]:
                sched.submit(batch[:half], now=now, deadline=now + 6.0,
                             qos="interactive")
            if batch[half:]:
                sched.submit(batch[half:], now=now, qos="batch")
        done.extend(sched.tick(now=now))
    return done, time.perf_counter() - t0


def _with_log(log, fn):
    """``fn()`` with ``log`` enabled and empty; returns (result, routes),
    the log disabled and emptied after."""
    was, log.enabled = log.enabled, True
    log.reset()
    try:
        return fn(), dict(log.routes)
    finally:
        log.enabled = was
        log.reset()


# ---------------------------------------------------------------------------
# the chaos scenario on both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_chaos():
    """The chaos run through the JAX scheduler: (scheduler, tracer,
    registry, records, routes, its DiT config, weights as numpy, noise)."""
    import jax
    import jax.numpy as jnp
    from repro.config import SageConfig as JaxSageConfig
    from repro.config import get_config as jax_get_config
    from repro.config import replace as jax_replace
    from repro.kernels import dispatch as jax_dispatch
    from repro.models import dit as jax_dit
    from repro.models import text_encoder as jax_te
    from repro.serving.engine import SageServingEngine as JaxEngine
    from repro.serving.faults import FaultPlan as JaxFaultPlan
    from repro.serving.telemetry import MetricsRegistry as JaxRegistry
    from repro.serving.telemetry import Tracer as JaxTracer
    from repro.serving.trunk_cache import TrunkCache as JaxCache

    jcfg = jax_replace(jax_get_config("sage-dit", smoke=True),
                       dtype="float32")
    jtc = jax_te.text_cfg(dim=jcfg.cond_dim, layers=2)
    w = dict(dit=jax.tree.map(np.asarray, jax_dit.init_params(
                 jcfg, jax.random.PRNGKey(0))),
             text=jax.tree.map(np.asarray, jax_te.init_text(
                 jax.random.PRNGKey(1), jtc)))
    tracer, metrics = JaxTracer(), JaxRegistry()
    metrics.collector(jax_dispatch.DISPATCH_LOG.prometheus_samples)
    sched = JaxEngine(jcfg, JaxSageConfig(**SAGE),
                      dit_params=jax.tree.map(jnp.asarray, w["dit"]),
                      text_params=jax.tree.map(jnp.asarray, w["text"]),
                      text_cfg=jtc, group_size=4).streaming_scheduler(
        trunk_cache=JaxCache(tau_trunk=0.9),
        faults=JaxFaultPlan.parse(FAULTS), tracer=tracer, metrics=metrics,
        **CHAOS)
    (done, _), routes = _with_log(jax_dispatch.DISPATCH_LOG,
                                  lambda: drive_chaos(sched))
    # the exposition with the routes as they stood after the run
    log = jax_dispatch.DISPATCH_LOG
    log.routes.update(routes)
    prom = metrics.to_prometheus()
    log.reset()

    def noise(gid, shape):
        return torch.tensor(np.asarray(jax.random.normal(
            jax.random.fold_in(sched._launch_key, gid), shape,
            jnp.float32)))
    return dict(sched=sched, tracer=tracer, done=done, routes=routes,
                prom=prom, cfg=jcfg, weights=w, noise=noise)


def _port_modules(jx):
    cfg = replace(get_config("sage-dit", smoke=True), dtype="float32")
    tc = te.text_cfg(dim=cfg.cond_dim, layers=2)
    return (weights.dit_from_jax(jx["weights"]["dit"], cfg, device="cpu"),
            weights.text_from_jax(jx["weights"]["text"], tc, device="cpu"))


@pytest.fixture(scope="module")
def chaos_run(jax_chaos):
    """The same run through the port: (scheduler, tracer, registry,
    records, wall, routes, exposition)."""
    tracer, metrics = Tracer(), MetricsRegistry()
    metrics.collector(dispatch.DISPATCH_LOG.prometheus_samples)
    sched = SageServingEngine(
        SageConfig(**SAGE), *_port_modules(jax_chaos), group_size=4,
        noise_fn=jax_chaos["noise"], device="cpu").streaming_scheduler(
        trunk_cache=TrunkCache(tau_trunk=0.9),
        faults=FaultPlan.parse(FAULTS), tracer=tracer, metrics=metrics,
        **CHAOS)
    (done, wall), routes = _with_log(dispatch.DISPATCH_LOG,
                                     lambda: drive_chaos(sched))
    dispatch.DISPATCH_LOG.routes.update(routes)
    prom = metrics.to_prometheus()
    dispatch.DISPATCH_LOG.reset()
    return dict(sched=sched, tracer=tracer, metrics=metrics, done=done,
                wall=wall, routes=routes, prom=prom)


def _route_set(routes, pallas="pallas"):
    """The distinct (op, requested, chosen, reason, shape) rows, the JAX
    package's ``pallas`` read as the port's ``kernel``."""
    def name(x):
        return "kernel" if x == pallas else x
    return {(op, name(req), name(ch), reason, shape)
            for op, req, ch, reason, shape in routes}


def test_chrome_trace_equals_jax(jax_chaos, chaos_run):
    """The port's trace of the chaos run is the JAX tracer's, event for
    event: names, lanes, sub-tick timestamps and arguments."""
    got = chaos_run["tracer"].to_chrome()
    want = jax_chaos["tracer"].to_chrome()
    assert len(got["traceEvents"]) == len(want["traceEvents"]) > 100
    for i, (g, w) in enumerate(zip(got["traceEvents"],
                                   want["traceEvents"])):
        assert g == w, i
    assert got == want
    assert chaos_run["tracer"].counts() == jax_chaos["tracer"].counts()


def test_prometheus_equals_jax_but_for_dispatch_counts(jax_chaos,
                                                       chaos_run):
    """Line for line, but for the dispatch routes' counts; their label
    sets are equal."""
    got, want = (x.splitlines() for x in (chaos_run["prom"],
                                          jax_chaos["prom"]))
    assert [ln for ln in got if not ln.startswith(DISPATCH)] == \
        [ln for ln in want if not ln.startswith(DISPATCH)]

    def labels(lines):
        return {ln.rsplit(" ", 1)[0] for ln in lines
                if ln.startswith(DISPATCH + "{")}
    assert labels(got) == labels(want) != set()


def test_summary_and_reports_equal_jax(jax_chaos, chaos_run):
    js, ps = jax_chaos["sched"], chaos_run["sched"]
    from repro.serving import reports as jax_reports
    assert ps.summary() == js.summary()
    assert ps.stats == dict(js.stats)
    assert ps.class_stats == js.class_stats
    assert reports.slo_report(ps.summary(), chaos_run["tracer"].counts(),
                              ps.pending) == jax_reports.slo_report(
        js.summary(), jax_chaos["tracer"].counts(), js.pending)
    n_params = jax_chaos["cfg"].n_params()
    kw = dict(total_steps=6, share_ratio=0.33, group_size=4, slice_steps=3,
              max_groups_per_tick=2, n_params=n_params,
              n_tokens=(8 // 2) ** 2)
    got = reports.capacity_report(ps.summary(), **kw)
    want = jax_reports.capacity_report(js.summary(), **kw)
    groof, wroof = got.pop("roofline"), want.pop("roofline")
    assert got == want
    assert groof["flops_per_eval"] == wroof["flops_per_eval"]
    assert groof["seconds_per_request_floor"] == pytest.approx(
        wroof["seconds_per_request_floor"] * PEAK_RATIO, rel=1e-12)
    assert reports.attributed_columns(ps.summary()) == \
        jax_reports.attributed_columns(js.summary())


def test_dispatch_route_sets_equal_jax(jax_chaos, chaos_run):
    """The chaos run's routes (plain attention, both packages), and each
    kernel op with its JAX shape bucket and fallback reasons."""
    assert _route_set(chaos_run["routes"]) == \
        _route_set(jax_chaos["routes"]) != set()
    import jax
    import jax.numpy as jnp
    from repro.kernels import dispatch as jd

    rng = np.random.default_rng(0)

    def both(*shapes):
        arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        return [jnp.asarray(a) for a in arrs], [torch.tensor(a)
                                                 for a in arrs]

    def jax_calls():
        (q,), _ = both((1, 8, 2, 32))
        jd.attention(q, q, q, impl="pallas", causal=True, interpret="on")
        jd.attention(q, q, q, impl="pallas", window=4, interpret="on")
        (q2,), _ = both((1, 8, 2, 288))
        jd.attention(q2, q2, q2, impl="pallas", causal=True)
        jd.attention(q, q, q, impl="naive")
        (z, eu, ec, ep), _ = both(*[(4, 8, 8, 4)] * 4)
        jd.cfg_ddim_step(z, eu, ec, guidance=3.0, a_t=0.5, s_t=0.8,
                         a_n=0.6, s_n=0.7, impl="fused", interpret="on")
        jd.cfg_dpmpp_step(z, eu, ec, ep, guidance=3.0, a_t=0.5, s_t=0.8,
                          a_n=0.6, s_n=0.7, lam=0.1, lam_p=0.0, lam_n=0.2,
                          is_first=jnp.zeros((4,), bool), impl="fused",
                          interpret="on")
        jd.group_mean(z.reshape(1, 4, 8, 8, 4), jnp.ones((1, 4)),
                      impl="pallas", interpret="on")
        jd.group_mean(z.reshape(1, 4, 8, 8, 4), jnp.ones((1, 4)))

    def port_calls():
        q = torch.randn(1, 8, 2, 32)
        dispatch.attention(q, q, q, impl="kernel", causal=True)
        dispatch.attention(q, q, q, impl="kernel", window=4)
        q2 = torch.randn(1, 8, 2, 288)
        dispatch.attention(q2, q2, q2, impl="kernel", causal=True)
        dispatch.attention(q, q, q, impl="naive")
        from repro_torch.core.schedule import make_schedule
        sched = make_schedule(1000)
        z, eu, ec, ep = (torch.randn(4, 8, 8, 4) for _ in range(4))
        t = torch.full((4,), 500)
        dispatch.cfg_ddim_step(z, eu, ec, guidance=3.0, alphas=sched.alphas,
                               sigmas=sched.sigmas, t=t, t_next=t - 100,
                               impl="fused")
        one = torch.tensor(0.5)
        dispatch.cfg_dpmpp_step(z, eu, ec, ep, guidance=3.0, a_t=one,
                                s_t=one, a_n=one, s_n=one, lam=one,
                                lam_p=one, lam_n=one,
                                is_first=torch.zeros(4, dtype=torch.bool),
                                impl="fused")
        dispatch.group_mean(z.reshape(1, 4, 8, 8, 4), torch.ones(1, 4),
                            impl="kernel")
        dispatch.group_mean(z.reshape(1, 4, 8, 8, 4), torch.ones(1, 4))

    _, jroutes = _with_log(jd.DISPATCH_LOG, jax_calls)
    _, proutes = _with_log(dispatch.DISPATCH_LOG, port_calls)
    assert jax.default_backend() == "cpu"
    assert _route_set(proutes) == _route_set(jroutes)
    assert {r[3] for r in proutes} == {"requested", "head_dim>256",
                                       "noncausal_window"}
    assert ("group_mean", "kernel", "kernel", "requested",
            "1x4x8x8x4") in proutes


# ---------------------------------------------------------------------------
# tests/test_telemetry.py's cases on the port's run
# ---------------------------------------------------------------------------

def test_trace_schema_well_formed(chaos_run):
    obj = chaos_run["tracer"].to_chrome()
    assert obj["traceEvents"], "chaos run must produce events"
    for e in obj["traceEvents"]:
        assert e["ph"] in ("X", "i", "M")
        if e["ph"] == "M":
            continue
        assert e["pid"] in (1, 2, 3)
        assert isinstance(e["name"], str) and e["name"]
        assert e["ts"] >= 0.0
        if e["ph"] == "X":
            assert e["dur"] >= 0.0
        else:
            assert e["s"] == "t"


def test_request_conservation(chaos_run):
    sched, c = chaos_run["sched"], chaos_run["tracer"].counts()
    assert c["request.submit"] == 20
    accounted = (c.get("request.complete", 0) + c.get("request.shed", 0)
                 + c.get("request.shed_faulted", 0)
                 + c.get("request.rejected_expired", 0) + sched.pending)
    assert accounted == c["request.submit"]


def test_spans_reconcile_with_summary(chaos_run):
    sched, tracer, done = (chaos_run[k] for k in ("sched", "tracer",
                                                  "done"))
    s = sched.summary()
    assert CS.reconcile(tracer.counts(), s, tracer.events) == []
    assert s["completed"] == len([d for d in done
                                  if d.status in ("ok", "degraded")])
    # the chaos run exercises faults, retries, stalls and the cache
    assert s["launch_faults"] and s["retries"] and s["stalled_ticks"]
    assert s["cache_hits"]


def test_chrome_export_round_trips(chaos_run, tmp_path):
    path = tmp_path / "trace.json"
    n = chaos_run["tracer"].export(str(path))
    obj = json.loads(path.read_text())
    assert len(obj["traceEvents"]) == n > 0
    assert obj["otherData"]["dropped_events"] == 0


def test_tracer_overhead_under_5pct(chaos_run):
    tracer, wall = chaos_run["tracer"], chaos_run["wall"]
    assert tracer.self_seconds < 0.05 * wall, (
        f"tracer spent {tracer.self_seconds:.4f}s of {wall:.2f}s wall")


def test_prometheus_export(chaos_run, tmp_path):
    sched, metrics, text = (chaos_run[k] for k in ("sched", "metrics",
                                                   "prom"))
    s = sched.summary()
    assert f"sage_scheduler_launches_total {int(s['launches'])}" in text
    assert f"sage_scheduler_completed_total {int(s['completed'])}" in text
    assert f"sage_cache_hits_total {int(s['cache_hits'])}" in text
    assert 'sage_faults_injected_total{kind="launch_fail"}' in text
    assert 'sage_scheduler_class_completed_total{qos="interactive"}' in text
    assert 'sage_scheduler_latency_ticks_bucket{le="+Inf"} ' in text
    assert f"sage_scheduler_ticks {sched.ticks}" in text
    assert 'sage_kernel_dispatch_total{op="attention",requested="naive"' \
        in text
    path = tmp_path / "m.prom"
    assert metrics.export(str(path)) == \
        metrics.to_prometheus().count("\n")
    snap = metrics.snapshot()
    assert snap["scheduler_launches"] == s["launches"]
    assert snap["cache_hits"] == s["cache_hits"]


def test_metrics_registry_claims_names_once():
    reg = MetricsRegistry()
    reg.group("scheduler", {"a": 0})
    with pytest.raises(ValueError, match="already registered"):
        reg.attach_group("scheduler", {})
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("scheduler", lambda: 0)


def _short_run(mods, telemetry):
    tracer = Tracer() if telemetry else None
    metrics = MetricsRegistry() if telemetry else None
    sched = SageServingEngine(SageConfig(**SAGE), *mods, group_size=4,
                              device="cpu").streaming_scheduler(
        slice_steps=3, max_wait_ticks=1,
        trunk_cache=TrunkCache(tau_trunk=0.9), tracer=tracer,
        metrics=metrics)
    prompts = themed_prompts(8, seed=5)
    done, now = [], 0.0
    sched.submit(prompts[:4], now=now)
    for _ in range(20):
        now += 1.0
        if now == 3.0:
            sched.submit(prompts[4:], now=now)
        done.extend(sched.tick(now=now))
        if not sched.pending and now > 3.0:
            break
    return sched.summary(), sorted(done, key=lambda c: c.prompt)


def test_telemetry_is_bitwise_invisible():
    """Equal images and summary with the tracer and registry on and off
    (the port's default noise, its own weights)."""
    mods = _smoke_modules("cpu", torch.Generator().manual_seed(11))[:2]
    s_off, done_off = _short_run(mods, telemetry=False)
    s_on, done_on = _short_run(mods, telemetry=True)
    assert len(done_off) == len(done_on) == 8
    for a, b in zip(done_off, done_on):
        assert a.prompt == b.prompt
        np.testing.assert_array_equal(a.image, b.image)
    assert s_off == s_on


def test_telemetry_is_bitwise_invisible_under_chaos(jax_chaos, chaos_run):
    """The chaos run (failed launches and their retries, a stalled tick,
    trunk-cache hits) without a tracer, a registry or the dispatch log:
    the traced run's records, bitwise images and ``summary()``."""
    sched = SageServingEngine(
        SageConfig(**SAGE), *_port_modules(jax_chaos), group_size=4,
        noise_fn=jax_chaos["noise"], device="cpu").streaming_scheduler(
        trunk_cache=TrunkCache(tau_trunk=0.9),
        faults=FaultPlan.parse(FAULTS), **CHAOS)
    assert sched.tracer is None and not dispatch.DISPATCH_LOG.enabled
    done, _ = drive_chaos(sched)
    traced = chaos_run["done"]
    assert [(c.prompt, c.status, c.group_id) for c in done] == [
        (c.prompt, c.status, c.group_id) for c in traced]
    for a, b in zip(done, traced):
        assert (a.image is None) == (b.image is None)
        if a.image is not None:
            np.testing.assert_array_equal(a.image, b.image)
    got = sched.summary()
    assert got == chaos_run["sched"].summary()
    assert got["retries"] >= 1 and got["stalled_ticks"] >= 1
    assert got["cache_hits"] >= 1


def test_safe_ratio():
    assert safe_ratio(6, 3) == 2.0
    assert safe_ratio(1, 0) == 0.0
    assert safe_ratio(0, 0) == 0.0
    assert safe_ratio(1, 0, default=1.0) == 1.0
    assert safe_ratio(3, 2) == 1.5


def test_zero_run_summary_reports_zero_ratios():
    mods = _smoke_modules("cpu", torch.Generator().manual_seed(12))[:2]
    sched = SageServingEngine(SageConfig(**SAGE), *mods, group_size=4,
                              device="cpu").streaming_scheduler(
        slice_steps=3, trunk_cache=TrunkCache(tau_trunk=0.9))
    s = sched.summary()
    for k in ("launches_per_tick", "pad_waste", "nfe_per_request",
              "cost_saving", "goodput_per_tick", "cache_hit_rate"):
        assert s[k] == 0.0, (k, s[k])
    assert sched.trunk_cache.hit_rate == 0.0


def test_histogram_buckets():
    h = Histogram([1, 2, 4])
    for v in (0.5, 1.0, 3.0, 100.0):
        h.observe(v)
    assert h.total == 4 and h.sum == 104.5
    assert h.cumulative() == [(1.0, 2), (2.0, 2), (4.0, 3),
                              (float("inf"), 4)]
    with pytest.raises(ValueError):
        Histogram([2, 1])


def test_tracer_max_events_cap_keeps_counts_exact():
    tr = Tracer(max_events=3)
    for i in range(10):
        tr.instant("x", float(i), pid=1, tid=0)
    assert len(tr.events) == 3 and tr.dropped == 7
    assert tr.counts()["x"] == 10
    assert tr.to_chrome()["otherData"]["dropped_events"] == 7


@pytest.fixture()
def dispatch_log():
    log = dispatch.DISPATCH_LOG
    was, log.enabled = log.enabled, True
    log.reset()
    yield log
    log.enabled = was
    log.reset()


def test_dispatch_records_fallbacks(dispatch_log):
    """head_dim > 256 and a non-causal window fall back to the chunked
    loop, and the log says why; a covered shape takes the kernel route."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 8, 2, 512), generator=g)
    dispatch.attention(q, q, q, impl="kernel", causal=True)
    q2 = torch.randn((1, 8, 2, 32), generator=g)
    dispatch.attention(q2, q2, q2, impl="kernel", window=4, causal=False)
    dispatch.attention(q2, q2, q2, impl="kernel", causal=True)
    fb = dispatch_log.fallbacks()
    assert {r["reason"] for r in fb} == {"head_dim>256", "noncausal_window"}
    assert sum(r["count"] for r in fb) == 2
    routed = [r for r in dispatch_log.snapshot() if r["chosen"] == "kernel"]
    assert routed and all(r["reason"] == "requested" for r in routed)
    rep = reports.dispatch_report(dispatch_log)
    assert rep["fallback_launches"] == 2 and rep["enabled"]
    samples = list(dispatch_log.prometheus_samples())
    assert any(s[1]["reason"] == "head_dim>256" for s in samples)


def test_dispatch_log_disabled_records_nothing():
    log = dispatch.DISPATCH_LOG
    assert not log.enabled
    log.reset()
    q = torch.randn((1, 4, 1, 16))
    dispatch.attention(q, q, q, impl="naive")
    dispatch.group_mean(q.reshape(1, 4, 16), torch.ones(1, 4))
    assert log.routes == {} and log.snapshot() == []
    assert not dispatch.DispatchLog().enabled


def test_reports_join_and_render(chaos_run):
    sched, tracer = chaos_run["sched"], chaos_run["tracer"]
    s = sched.summary()
    slo = reports.slo_report(s, counts=tracer.counts(),
                             pending=sched.pending)
    assert slo["conservation"]["residual"] == 0
    assert slo["overall"]["requests"] == 20
    assert set(slo["classes"]) == {"interactive", "batch"}
    assert slo["cache"]["hits"] == s["cache_hits"]
    cap = reports.capacity_report(
        s, total_steps=6, share_ratio=0.33, group_size=4, slice_steps=3,
        max_groups_per_tick=2,
        n_params=sum(p.numel() for p in sched.dit.parameters()),
        n_tokens=(8 // 2) ** 2)
    assert cap["predicted"]["ticks_to_drain"] > 0
    assert cap["observed"]["ticks"] == s["ticks"]
    assert (cap["gaps"]["extra_ticks"]
            == s["ticks"] - cap["predicted"]["ticks_to_drain"])
    assert cap["roofline"]["seconds_per_request_floor"] > 0.0
    text = reports.format_report(slo, cap, reports.dispatch_report())
    assert "== SLO report ==" in text and "ticks_to_drain" in text
    assert "(dispatch log disabled)" in text
    cols = reports.attributed_columns(s)
    assert "goodput=" in cols and "pad_waste=" in cols
    assert "cache_hit_rate=" in cols


def test_predict_drain_tick_economics():
    p = predict_drain(24, 4, 8, 2, 4)
    assert p.groups == 6
    assert p.shared_segments == 1 and p.branch_segments == 2
    assert p.ticks == 3
    assert p.nfe == 6 * 2 + 24 * 6
    assert p.nfe_independent == 24 * 8
    capped = predict_drain(24, 4, 8, 2, 4, max_groups_per_tick=2)
    assert capped.ticks == 9
    empty = predict_drain(0, 4, 8, 2, 4)
    assert empty.ticks == 0 and empty.nfe == 0


def test_predict_drain_equals_jax_on_a_grid():
    """Every count of ``predict_drain`` equals the JAX cost model's, over
    a grid that reaches the edge cases (no requests, n_shared outside
    [0, T], slices longer than a phase, a cap above and below the
    groups); the roofline differs only by the cards' constants."""
    from repro.launch import costs as jax_costs
    n = 0
    for req, gs, T, ns, sl, cap in itertools.product(
            (0, 1, 5, 24), (0, 1, 4), (0, 1, 6, 30), (-1, 0, 2, 9, 40),
            (0, 1, 3, 8), (None, 1, 2, 16)):
        got = predict_drain(req, gs, T, ns, sl, cap)
        want = jax_costs.predict_drain(req, gs, T, ns, sl, cap)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), \
            (req, gs, T, ns, sl, cap)
        n += 1
    assert n == 4 * 3 * 4 * 5 * 4 * 4
    for p, t in ((1e6, 16), (6.7e8, 1024)):
        assert costs.denoiser_flops_per_eval(p, t) == \
            jax_costs.denoiser_flops_per_eval(p, t)
    f = costs.denoiser_flops_per_eval(6.7e8, 1024)
    assert costs.roofline_seconds(f) == pytest.approx(
        jax_costs.roofline_seconds(f) * PEAK_RATIO, rel=1e-12)
    assert costs.roofline_seconds(0, 3.35e12) == 1.0
    assert costs.roofline_seconds(0, 0, 450e9) == 1.0


# ---------------------------------------------------------------------------
# the example: its report text equals the JAX example's
# ---------------------------------------------------------------------------

EXAMPLE_FLAGS = ["--requests", "16", "--steps", "6", "--streaming",
                 "--trunk-cache", "--themes", "4", "--report"]


def _report_block(out):
    """The joined report ``--report`` prints, without its roofline and
    dispatch sections (the cards' constants, the logs' counting)."""
    lines = out[out.index("== SLO report =="):].splitlines()
    keep, skip = [], False
    for ln in lines:
        if ln.startswith("== kernel dispatch =="):
            break
        if ln.startswith(" roofline:"):
            skip = True
        elif ln.startswith(" ") and not ln.startswith("   "):
            skip = False
        if not skip:
            keep.append(ln)
    return keep


def test_example_report_equals_jax(jax_chaos, capsys, monkeypatch,
                                   tmp_path):
    """``repro_torch.examples.serve_shared`` and the JAX example on the
    same flags and the JAX init's weights (the DiT's from ``PRNGKey(0)``,
    the text tower's from ``PRNGKey(1)``, as the JAX example draws
    them): equal report text but for the roofline and the dispatch
    counts; the trace and the exposition are written."""
    from repro.kernels import dispatch as jax_dispatch
    from repro_torch.examples import serve_shared
    spec = importlib.util.spec_from_file_location(
        "jax_serve_shared", ROOT / "examples" / "serve_shared.py")
    jax_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_example)
    monkeypatch.setattr(sys, "argv", ["serve_shared.py"] + EXAMPLE_FLAGS)
    try:
        jax_example.main()
    finally:
        jax_dispatch.DISPATCH_LOG.enabled = False
        jax_dispatch.DISPATCH_LOG.reset()
    want = capsys.readouterr().out
    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    try:
        serve_shared.main(EXAMPLE_FLAGS + [
            "--device", "cpu", "--trace", str(trace), "--metrics",
            str(prom)], modules=_port_modules(jax_chaos))
    finally:
        dispatch.DISPATCH_LOG.enabled = False
        dispatch.DISPATCH_LOG.reset()
    got = capsys.readouterr().out
    assert _report_block(got) == _report_block(want)
    assert len(_report_block(got)) > 40
    assert " roofline:" in got and "== kernel dispatch ==" in got
    assert json.loads(trace.read_text())["traceEvents"]
    assert "sage_kernel_dispatch_total" in prom.read_text()


def test_example_raises_without_a_gpu_unless_asked_for_the_cpu():
    from repro_torch.examples import serve_shared
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        serve_shared.main(["--requests", "2", "--steps", "2"])


def test_chip_smoke_telemetry_checks_run_on_the_cpu(capsys):
    """``chip_smoke._telemetry``'s bookkeeping on a traced pass of trace H
    at smoke size on the CPU (where a wrapper launches nothing, so the
    log's kernel-route dispatches stand in for the launches): no failure,
    its three lines printed; a launch count off by one, or the counts of
    another trace, is a failure."""
    mods = _smoke_modules("cpu", torch.Generator().manual_seed(13))
    sched = SageServingEngine(
        SageConfig(**CS.STREAM_TRACES["H"]["sage"]), *mods, group_size=4,
        attn_impl="kernel", step_impl="fused", device="cpu"
    ).streaming_scheduler(tracer=Tracer(),
                          **CS.STREAM_TRACES["H"]["scheduler"])
    (_, _), routes = _with_log(dispatch.DISPATCH_LOG,
                               lambda: CS.drive_stream(sched, "H", 8, 4))
    tel = dict(tracer=sched.tracer, wall=1e3, routes=routes)
    logged = CS.dispatch_counts(routes)
    assert logged["attention"] and logged["cfg_ddim_step"] \
        and logged["cfg_dpmpp_step"]
    wrappers = {w: logged.get(op, 0) for op, w in CS.DISPATCH_OPS.items()}
    ledger = dict(sched.stats, ticks=sched.ticks)
    failures = []
    CS._telemetry(sched, "H", "cpu", tel, dict(ledger), wrappers, failures)
    assert failures == []
    out = capsys.readouterr().out
    assert out.count("[telemetry:H]") == 3 and "equal to STREAM_TRACE" in out
    wrappers["ddim_step"] += 1
    CS._telemetry(sched, "H", "cpu", tel, dict(ledger), wrappers, failures)
    CS._telemetry(sched, "O", "cpu", tel, dict(ledger),
                  {w: logged.get(op, 0)
                   for op, w in CS.DISPATCH_OPS.items()}, failures)
    assert len(failures) == 2


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_traced_trace_h_is_bitwise_untraced_and_logs_every_dispatch():
    """Trace H at smoke size on the card, untraced and then on a second
    scheduler with a tracer, a registry and the dispatch log on: bitwise
    equal images and equal ``summary()``; the tracer reconciles with it;
    the log's count of each kernel op equals its wrapper's launches
    outside the graph replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the hand-written "
                    "kernels run only there")
    from repro_torch.serving import runners
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = CS.STREAM_TRACES["H"]
    mods = _smoke_modules("cuda", torch.Generator().manual_seed(31))
    out = []
    for traced in (False, True):
        tracer = Tracer() if traced else None
        eng = SageServingEngine(SageConfig(**spec["sage"]), *mods,
                                group_size=4, attn_impl="kernel",
                                step_impl="fused", device="cuda")
        sched = eng.streaming_scheduler(
            tracer=tracer, metrics=MetricsRegistry() if traced else None,
            **spec["scheduler"])
        before = runners.launch_counts()
        (done, _), routes = _with_log(
            dispatch.DISPATCH_LOG,
            lambda: CS.drive_stream(sched, "H", 8, 4))
        launched = runners.counts_delta(before, runners.launch_counts())
        out.append((done, sched.summary(), tracer, routes, launched))
    (d0, s0, _, _, _), (d1, s1, tracer, routes, launched) = out
    assert s1 == s0
    assert [c.prompt for c in d1] == [c.prompt for c in d0]
    for a, b in zip(d1, d0):
        assert np.array_equal(a.image, b.image), a.prompt
    assert CS.reconcile(tracer.counts(), s1, tracer.events) == []
    assert tracer.counts() == CS.STREAM_TRACE_COUNTS["H"]
    logged = CS.dispatch_counts(routes)
    for op, wrapper in CS.DISPATCH_OPS.items():
        assert logged.get(op, 0) == launched[wrapper], op
    assert logged["attention"] > 0 and logged["cfg_ddim_step"] > 0
