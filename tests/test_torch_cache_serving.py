"""The port's streaming scheduler with the cross-batch trunk cache, held
against the JAX scheduler on trace "C" of ``chip_smoke.STREAM_TRACES``.

Trace C (two waves of one 64x64-class shape: wave A co-packs two step
budgets, wave B repeats both classes for exact-key hits, one found on the
device and one on the host, and adds a premium class that must miss) is
served pass after pass by one JAX scheduler and one port scheduler on the
CPU, with the same bridged weights and the JAX-drawn noise: a cache with
the scan index, one with the LSH index (the JAX planes carried over), one
whose every would-be hit is corrupted, and no cache.  Per pass: the
discrete outcome (``chip_smoke.STREAM_EXPECTED``), records with
``cache_hit``, images within 1e-3, stats, ``summary()`` with its
``cache_*`` keys, the cache ledgers and the packs whose grid was 2-D must
equal the JAX scheduler's.  Inside the port (default noise): LSH equals
scan bitwise, the corrupt pass equals the pass without a cache bitwise,
NFE is conserved, ``run_batch`` leaves the cache alone, and a group's
default noise depends on its gid only, so forcing one hit to miss leaves
every other group's image as it was.

The machine with the card has no JAX: JAX is imported inside the fixtures.
"""
import copy
import inspect

import numpy as np
import pytest
import torch

from repro_torch import weights
from repro_torch.config import SageConfig, get_config, replace
from repro_torch.models import text_encoder as te
from repro_torch.serving import packing
from repro_torch.serving.engine import SageServingEngine
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.scheduler import RequestScheduler, default_noise
from repro_torch.serving.telemetry import Tracer
from repro_torch.serving.trunk_cache import TrunkCache

from test_torch_streaming import (CS, RECORD, _smoke_modules,  # noqa: F401
                                  assert_images_close, one_torch_thread,
                                  randomized)

PASSES = ("scan", "lsh", "corrupt", "nocache")
EXPECTED = {"scan": "C", "lsh": "C", "corrupt": "C:corrupt",
            "nocache": "C:nocache"}
LATENT, CHANNELS = 8, 4                  # sage-dit smoke


def trace_c(sampler="ddim"):
    """Trace C's spec with every class on ``sampler``."""
    spec = copy.deepcopy(CS.STREAM_TRACES["C"])
    spec["waves"] = tuple(
        (k, tuple(c[:-1] + (sampler,) for c in classes))
        for k, classes in spec["waves"])
    return spec


def records(done):
    return [tuple(getattr(c, k) for k in RECORD + ("cache_hit",))
            for c in done]


def _ledger(cache):
    """A cache's state, comparable across the packages: the entries'
    payload bytes differ in the last bits, so their CRCs are left out, and
    the cfg_key without its kernel routes (attn_impl, step_impl), which
    name each package's own."""
    if cache is None:
        return None

    def key(k):
        ck = k[2][:1] + k[2][2:3] + k[2][4:]
        return k[:2] + (ck,) + k[3:]
    return (dict(cache.stats), cache.bytes, dict(cache.tier_bytes),
            [(key(k), e.tier, e.nbytes, e.step_idx, e.rng_fold)
             for k, e in cache._entries.items()], cache.index.name)


def serve_passes(sampler, passes=PASSES):
    """Trace C on ``sampler`` through one JAX and one port scheduler, the
    ``passes`` in turn (each its own cache, the clock moved on 100 between
    passes; the LSH pass with a tracer on each side).  Returns {pass:
    {"jax"/"port": (outcome, records, summary, cache ledger, 2-D packs,
    cumulative stats), "jax_tracer"/"port_tracer": the pass's tracer or
    None}}."""
    import jax
    import jax.numpy as jnp
    from repro import serving as jax_serving
    from repro.config import SageConfig as JaxSageConfig
    from repro.config import get_config as jax_get_config
    from repro.config import replace as jax_replace
    from repro.models import dit as jax_dit
    from repro.models import text_encoder as jax_te
    from repro.models import vae as jax_vae
    from repro.serving.ann_index import LshIndex as JaxLsh
    from repro.serving.faults import FaultPlan as JaxFaultPlan
    from repro.serving.scheduler import RequestScheduler as JaxScheduler
    from repro.serving.telemetry import Tracer as JaxTracer
    from repro.serving.trunk_cache import TrunkCache as JaxCache
    import repro.serving.packing  # noqa: F401  (the module spied on)

    spec = trace_c(sampler)
    jcfg = jax_replace(jax_get_config("sage-dit", smoke=True),
                       dtype="float32")
    tcfg = replace(get_config("sage-dit", smoke=True), dtype="float32")
    jtc = jax_te.text_cfg(dim=jcfg.cond_dim, layers=2)
    tc = replace(te.text_cfg(dim=tcfg.cond_dim, layers=2),
                 attn_impl="kernel")
    key = jax.random.PRNGKey(0)
    w = dict(dit=randomized(jax_dit.init_params, jcfg, key, seed=1),
             text=randomized(jax_te.init_text, key, jtc, seed=2),
             vae=randomized(jax_vae.init_params, key, seed=3))
    js = JaxScheduler(jcfg, JaxSageConfig(**spec["sage"]),
                      jax.tree.map(jnp.asarray, w["dit"]),
                      jax.tree.map(jnp.asarray, w["text"]), jtc,
                      vae_params=jax.tree.map(jnp.asarray, w["vae"]),
                      group_size=4, **spec["scheduler"])

    def noise(gid, shape):
        return torch.tensor(np.asarray(jax.random.normal(
            jax.random.fold_in(js._launch_key, gid), shape, jnp.float32)))

    eng = SageServingEngine(
        SageConfig(**spec["sage"]),
        weights.dit_from_jax(w["dit"], tcfg, device="cpu"),
        weights.text_from_jax(w["text"], tc, device="cpu"),
        weights.vae_from_jax(w["vae"], device="cpu"), group_size=4,
        attn_impl="kernel", step_impl="fused", noise_fn=noise, device="cpu")
    ps = eng.streaming_scheduler(**spec["scheduler"])
    kw = CS.cache_kwargs(spec, LATENT, CHANNELS)
    dim = tcfg.cond_dim
    jlsh = JaxLsh()
    planes = {dim: np.asarray(jlsh._planes_for(dim))}
    caches = {
        "scan": lambda: (JaxCache(**kw), TrunkCache(**kw)),
        "lsh": lambda: (JaxCache(index=jlsh, **kw),
                        TrunkCache(index=weights.lsh_from_jax(planes), **kw)),
        "corrupt": lambda: (
            JaxCache(faults=JaxFaultPlan(seed=0, p_cache_corrupt=1.0), **kw),
            TrunkCache(faults=FaultPlan(seed=0, p_cache_corrupt=1.0), **kw)),
        "nocache": lambda: (None, None)}
    out = {}
    now = 0.0
    for name in passes:
        out[name] = {}
        pair = caches[name]()
        for side, sched, cache, mod, tracer in (
                ("jax", js, pair[0], jax_serving.packing, JaxTracer),
                ("port", ps, pair[1], packing, Tracer)):
            sched.trunk_cache = cache
            # the LSH pass traced (chip_smoke.STREAM_TRACE_COUNTS["C"])
            sched.tracer = tracer() if name == "lsh" else None
            out[name][f"{side}_tracer"] = sched.tracer
            ticks0, stats0 = sched.ticks, dict(sched.stats)
            with CS.count_2d_grids(mod) as grids:
                done, end = CS.drive_stream(sched, spec, LATENT, CHANNELS,
                                            now)
            out[name][side] = (
                CS.stream_outcome(sched, done, LATENT, ticks0,
                                  stats0 if ticks0 else None),
                done, sched.summary(), _ledger(cache), grids[0],
                dict(sched.stats))
        now = end + 100.0
    return out


@pytest.fixture(scope="module")
def passes():
    return serve_passes("ddim")


@pytest.mark.parametrize("name", PASSES)
def test_trace_c_outcome_is_stream_expected(passes, name):
    """``chip_smoke.STREAM_EXPECTED`` is the JAX scheduler's outcome of
    each pass, and the port's."""
    want = dict(CS.STREAM_EXPECTED[EXPECTED[name]])
    if name == "lsh":                     # a later pass: no tier / shape
        del want["tiers"], want["shapes"]    # ledgers (they accumulate)
    assert passes[name]["jax"][0] == want
    assert passes[name]["port"][0] == want


@pytest.mark.parametrize("name", PASSES)
def test_trace_c_records_and_images_equal_jax(passes, name):
    jax_done, port_done = passes[name]["jax"][1], passes[name]["port"][1]
    assert len(port_done) == 18
    assert records(port_done) == records(jax_done)
    assert_images_close(port_done, jax_done)


@pytest.mark.parametrize("name", PASSES)
def test_trace_c_stats_summary_and_cache_ledgers_equal_jax(passes, name):
    (_, _, jsum, jledger, jgrids, jstats) = passes[name]["jax"]
    (_, _, psum, pledger, pgrids, pstats) = passes[name]["port"]
    assert pstats == jstats
    assert psum == jsum
    assert pledger == jledger
    assert pgrids == jgrids
    assert ("cache_hits" in psum) == (name != "nocache")


def test_trace_c_lsh_trace_equals_jax_and_stream_trace_counts(passes):
    """The LSH pass's trace on the port is the JAX tracer's, event for
    event (cache.exact / cache.miss / cache.store among them), reconciled
    with the pass's ledger and its cache; ``chip_smoke.
    STREAM_TRACE_COUNTS["C"]`` is its counts."""
    jt, pt = passes["lsh"]["jax_tracer"], passes["lsh"]["port_tracer"]
    assert passes["scan"]["port_tracer"] is None
    assert pt.to_chrome() == jt.to_chrome()
    assert jt.counts() == CS.STREAM_TRACE_COUNTS["C"]
    stats0 = passes["scan"]["port"][5]
    stats = passes["lsh"]["port"][5]
    ledger = {k: stats[k] - stats0[k] for k in stats}
    cache = passes["lsh"]["port"][3][0]
    ledger.update(ticks=passes["lsh"]["port"][0]["ticks"],
                  cache_hits=cache["hits"],
                  cache_exact_hits=cache["exact_hits"],
                  cache_hits_hbm=cache["hits_hbm"],
                  cache_hits_host=cache["hits_host"])
    assert CS.reconcile(pt.counts(), ledger, pt.events) == []


def test_trace_c_puts_2d_grids_on_both_phases(passes):
    """Wave A's shared packs and the mixed-budget branch packs carry 2-D
    grids; without hits, more packs mix the two budgets."""
    assert passes["scan"]["port"][4] == 4
    assert passes["nocache"]["port"][4] == 10


def test_trace_c_nfe_is_conserved_and_hits_are_the_exact_repeats(passes):
    cached, plain = passes["scan"]["port"][0], passes["nocache"]["port"][0]
    assert cached["nfe"] + cached["cache"]["nfe_saved"] == plain["nfe"]
    assert cached["cache"]["hit_groups"] == [2, 3]
    hits = {c.tier for c in passes["scan"]["port"][1] if c.cache_hit}
    assert hits == {"standard", "draft"}


# ---------------------------------------------------------------------------
# inside the port, with the default noise
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_modules():
    return _smoke_modules("cpu", torch.Generator().manual_seed(31))


def _port(mods, trunk_cache=None, seed=5, spec=None):
    spec = spec or CS.STREAM_TRACES["C"]
    return RequestScheduler(SageConfig(**spec["sage"], step_impl="fused"),
                            *mods, group_size=4, attn_impl="kernel",
                            seed=seed, device="cpu", trunk_cache=trunk_cache,
                            **spec["scheduler"])


def _serve(mods, trunk_cache=None, **kw):
    s = _port(mods, trunk_cache, **kw)
    done, _ = CS.drive_stream(s, "C", LATENT, CHANNELS)
    return s, done


def _assert_bitwise(a, b, skip=()):
    got = [(c.group_id, c.prompt, c.image) for c in a
           if c.group_id not in skip]
    want = [(c.group_id, c.prompt, c.image) for c in b
            if c.group_id not in skip]
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for g, w in zip(got, want):
        assert np.array_equal(g[2], w[2]), g[:2]


def test_lsh_equals_scan_bitwise_and_corrupt_equals_no_cache(port_modules):
    kw = CS.cache_kwargs("C", LATENT, CHANNELS)
    scan, scan_done = _serve(port_modules, TrunkCache(**kw))
    lsh, lsh_done = _serve(port_modules, TrunkCache(index="lsh", **kw))
    plan = FaultPlan(seed=0, p_cache_corrupt=1.0)
    bad, bad_done = _serve(port_modules, TrunkCache(faults=plan, **kw))
    plain, plain_done = _serve(port_modules)
    assert CS.stream_outcome(scan, scan_done, LATENT) == \
        CS.STREAM_EXPECTED["C"]
    _assert_bitwise(lsh_done, scan_done)
    assert lsh.summary()["cache_index"] == "lsh"
    _assert_bitwise(bad_done, plain_done)
    assert bad.trunk_cache.stats["integrity_drops"] == \
        plan.injected["cache_corrupt"] == 2
    assert plain.stats["nfe"] == (scan.stats["nfe"]
                                  + scan.stats["nfe_saved_cache"])
    # groups that computed their own shared phase are the same either way
    _assert_bitwise(scan_done, plain_done, skip=(2, 3))


def test_default_noise_of_a_gid_ignores_earlier_draws(port_modules):
    s = _port(port_modules, seed=9)
    shape = (1, 8, 8, 4)
    first = s.noise_fn(3, shape)
    for gid in (0, 7, 1):
        s.noise_fn(gid, shape)
    assert torch.equal(s.noise_fn(3, shape), first)
    assert torch.equal(default_noise(9, 3, shape), first)
    assert not torch.equal(default_noise(9, 4, shape), first)
    assert not torch.equal(default_noise(10, 3, shape), first)
    assert first.device.type == "cpu" and first.dtype == torch.float32


def test_a_forced_miss_leaves_the_other_groups_images(port_modules):
    """One would-be hit forced to miss (the first: wave B's standard
    group) draws that group's noise and runs its shared phase; every other
    group, the later premium one included, is bitwise as it was."""
    kw = CS.cache_kwargs("C", LATENT, CHANNELS)
    hit, hit_done = _serve(port_modules, TrunkCache(**kw))
    plan = FaultPlan(seed=0, p_cache_miss=1.0, max_faults=1)
    miss, miss_done = _serve(port_modules, TrunkCache(faults=plan, **kw))
    assert miss.trunk_cache.stats["fault_forced_misses"] == 1
    assert [g for g in sorted({c.group_id for c in hit_done if c.cache_hit})
            ] == [2, 3]
    assert sorted({c.group_id for c in miss_done if c.cache_hit}) == [3]
    _assert_bitwise(miss_done, hit_done, skip=(2,))
    forced = [c.image for c in miss_done if c.group_id == 2]
    assert not np.array_equal(forced[0],
                              [c.image for c in hit_done
                               if c.group_id == 2][0])


def test_run_batch_leaves_the_cache_alone(port_modules):
    kw = CS.cache_kwargs("C", LATENT, CHANNELS)
    cache = TrunkCache(**kw)
    prompts = [CS.STREAM_PROMPTS[0]] * 4 + [CS.STREAM_PROMPTS[1]] * 2
    with_cache = _port(port_modules, cache)
    done = with_cache.run_batch(prompts)
    plain = _port(port_modules).run_batch(prompts)
    assert with_cache.trunk_cache is cache
    assert len(cache) == 0 and not any(cache.stats.values())
    assert not any(c.cache_hit for c in done)
    _assert_bitwise(done, plain)


def test_streaming_scheduler_takes_the_cache():
    from repro.serving.engine import SageServingEngine as JaxEngine
    from repro.serving.scheduler import RequestScheduler as JaxScheduler
    mods = _smoke_modules("cpu", torch.Generator().manual_seed(1))
    cache = TrunkCache()
    eng = SageServingEngine(SageConfig(total_steps=4), *mods, device="cpu")
    assert eng.streaming_scheduler(trunk_cache=cache).trunk_cache is cache
    assert eng.streaming_scheduler().trunk_cache is None
    for fn, ref in ((SageServingEngine.streaming_scheduler,
                     JaxEngine.streaming_scheduler),
                    (RequestScheduler, JaxScheduler)):
        assert inspect.signature(fn).parameters["trunk_cache"].default is \
            inspect.signature(ref).parameters["trunk_cache"].default is None


# ---------------------------------------------------------------------------
# chip_smoke's trace-C checks, driven on the CPU at smoke size
# ---------------------------------------------------------------------------

def test_chip_smoke_trace_c_stack_and_f32_checks_run_on_the_cpu():
    """``record_stacks`` sees every stack trace C's four passes hand
    ``ddim_step`` and flash (and restores the dispatch); the card's
    checks take the per-row steps of each row count from
    ``trace_c_stacks``, the same passes at smoke size; the f32 passes of
    ``_stream_cache_f32`` keep the groups computed in both within 1e-3.
    On the CPU the wrappers run their plain versions, so what is checked
    here is the bookkeeping around the kernels."""
    from repro_torch.kernels import dispatch
    failures = []
    steps = CS.trace_c_stacks(failures)
    assert failures == []
    rows = {r for r, _, _ in steps}
    assert rows == {1, 2, 3, 4, 8, 12, 16}
    assert all(len(t) == len(tn) == r for r, t, tn in steps)
    # a shared pack of three budgets: wave B's two groups and the premium
    assert any(r == 3 and len(set(t)) == 3 for r, t, _ in steps)

    cfg = get_config("sage-dit", smoke=True)          # bf16, as served
    tc = replace(te.text_cfg(dim=cfg.cond_dim, layers=2), attn_impl="kernel")
    dev = torch.device("cpu")
    mods = CS._build_modules(cfg, tc, dev, torch.bfloat16)
    wrappers = (dispatch.flash_attention, dispatch.fused_cfg_ddim_step)
    with CS.record_stacks() as card:
        CS._drive_cache_passes(mods, dev, failures, "cpu")
    assert (dispatch.flash_attention, dispatch.fused_cfg_ddim_step) == \
        wrappers
    assert {(s[0], t, tn) for s, _, _, t, tn in card["ddim"]} == steps
    assert {s[0][0] for s in card["flash"]} == {2, 4, 6, 8, 16, 24, 32}
    # the CPU wrapper is ref.py itself: bitwise at the kernel's rounding
    # points in f32 only (ref.py rounds a bf16 eps before dividing by a_t)
    CS._trace_c_stack_checks(failures, card, steps, dev,
                             ddim_dtypes=("float32",))
    CS._stream_cache_f32(failures, cfg, mods, dev)
    assert failures == []
