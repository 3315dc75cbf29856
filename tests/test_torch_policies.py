"""The port's launch / admission policies, launch orders and fault plan held
case for case to the JAX package's, and the overload trace "O" of
``chip_smoke.STREAM_TRACES`` (QoS classes with deadlines, a 2-group cap with
preemption, shed admission, the pad-aware policy and seeded faults) served
by both schedulers on the CPU: records, stats and ``summary()`` equal,
images within 1e-3, and the discrete outcome
``chip_smoke.STREAM_EXPECTED["O"]``.  Inside the port: a retried launch
equals a run without faults bitwise, the scheduler's knobs keep the JAX
names, defaults and validation errors, and ``run_batch`` does not age
streaming groups.

The machine with the card has no JAX, so the tests import it themselves.
"""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.config import SageConfig, get_config
from repro_torch.models import text_encoder as te
from repro_torch.models.dit import DiT
from repro_torch.serving import packing, policies
from repro_torch.serving.engine import SageServingEngine
from repro_torch.serving.faults import KINDS, FaultPlan
from repro_torch.serving.scheduler import RequestScheduler

from test_torch_streaming import (CS, _smoke_modules, assert_images_close,
                                  one_torch_thread, records,  # noqa: F401
                                  serve_both)


class _G:
    """A duck-typed group: members, creation tick, deadline, qos, gid."""

    def __init__(self, gid, n, created_tick, deadline, qos, sig):
        self.gid, self.members = gid, list(range(n))
        self.created_tick, self._deadline = created_tick, deadline
        self.qos, self.sig = qos, sig

    def earliest_deadline(self):
        return float("inf") if self._deadline is None else self._deadline


def _cases(rng, n_cases):
    """Random open-group lists and launch contexts (both packages' tuples
    built from the same draws)."""
    from repro.serving import packing as jax_packing
    from repro.serving import policies as jax_policies
    for _ in range(n_cases):
        groups = [_G(gid, int(rng.randint(1, 5)), int(rng.randint(0, 12)),
                     None if rng.rand() < 0.3 else float(rng.randint(8, 30)),
                     ("interactive", "batch", "other")[rng.randint(3)],
                     int(rng.randint(1, 4)))
                  for gid in range(int(rng.randint(0, 7)))]
        rng.shuffle(groups)
        kw = dict(now=float(rng.randint(8, 16)), tick=int(rng.randint(8, 16)),
                  group_size=4, max_wait_ticks=int(rng.randint(0, 4)),
                  deadline_slack=float(rng.choice([0.0, 1.5])),
                  ticks_to_finish=int(rng.randint(1, 9)),
                  arrival_rate=float(rng.choice([0.0, 0.2, 0.7, 3.0])))
        inflight = set(rng.randint(1, 4, size=rng.randint(0, 3)).tolist())
        ctxs = []
        for pol, pk in ((policies, packing), (jax_policies, jax_packing)):
            ctxs.append(pol.LaunchContext(
                inflight_signatures=frozenset(
                    pk.PackKey("shared", "ddim", (8, 8, 4), s)
                    for s in inflight),
                signature_of=lambda g, pk=pk: pk.PackKey(
                    "shared", "ddim", (8, 8, 4), g.sig), **kw))
        yield groups, ctxs


@pytest.mark.parametrize("spec, kw", [
    ("eager", {}), ("pad_aware", {}), ("pad_aware", dict(hold_ticks=0)),
    ("pad_aware", dict(hold_ticks=5)), ("adaptive", {}),
    ("adaptive", dict(hold_max=2, min_rate=0.5))])
def test_launch_policies_equal_jax_case_for_case(spec, kw):
    from repro.serving import policies as jax_policies
    mine = policies.make_launch_policy(spec, **kw)
    ref = jax_policies.make_launch_policy(spec, **kw)
    assert mine.name == ref.name == spec
    rng = np.random.RandomState(len(spec) + int(sum(kw.values()) * 7))
    n_launched = 0
    for groups, (ctx, jctx) in _cases(rng, 300):
        got = [g.gid for g in mine.launches(list(groups), ctx)]
        assert got == [g.gid for g in ref.launches(list(groups), jctx)]
        n_launched += len(got)
    assert n_launched > 100


@pytest.mark.parametrize("name", ["fifo", "edf", "qos_edf"])
def test_launch_orders_equal_jax_case_for_case(name):
    from repro.serving import policies as jax_policies
    rng = np.random.RandomState(3)
    mine = policies.make_launch_order(name)
    ref = jax_policies.make_launch_order(name)
    for groups, _ in _cases(rng, 200):
        assert ([g.gid for g in sorted(groups, key=mine)]
                == [g.gid for g in sorted(groups, key=ref)])
    assert policies.make_launch_order(None) is policies.order_qos_edf
    key = lambda g: (g.gid,)                                  # noqa: E731
    assert policies.make_launch_order(key) is key


@pytest.mark.parametrize("spec, kw", [
    ("admit_all", {}), ("shed", {}), ("degrade", {}),
    ("shed", dict(horizon_ticks=3.0, interactive_headroom=1.0)),
    ("degrade", dict(horizon_ticks=12.0))])
def test_admission_policies_equal_jax_case_for_case(spec, kw):
    from repro.serving import policies as jax_policies
    mine = policies.make_admission_policy(spec, **kw)
    ref = jax_policies.make_admission_policy(spec, **kw)
    rng = np.random.RandomState(5)
    verdicts = []
    for _ in range(400):
        a = dict(now=float(rng.randint(0, 20)),
                 qos=("interactive", "batch", "other")[rng.randint(3)],
                 deadline=None if rng.rand() < 0.5 else float(
                     rng.randint(0, 40)),
                 backlog_ticks=float(rng.uniform(0, 30)),
                 ticks_to_finish=int(rng.randint(1, 10)),
                 arrival_rate=float(rng.uniform(0, 4)))
        v = mine.decide(policies.AdmissionContext(**a))
        assert v == ref.decide(jax_policies.AdmissionContext(**a))
        verdicts.append(v)
    assert len(set(verdicts)) == (1 if spec == "admit_all" else 2)


@pytest.mark.parametrize("make, args", [
    ("make_launch_policy", ("lifo",)),
    ("make_launch_policy", ("pad_aware",), ),
    ("make_launch_order", ("lifo",)),
    ("make_admission_policy", ("drop",)),
    ("SaturationAdmission", ()), ("PadAwarePolicy", ()),
    ("AdaptivePadAwarePolicy", ())])
def test_policy_validation_errors_equal_jax(make, args):
    from repro.serving import policies as jax_policies
    bad = {"make_launch_policy": {}, "make_launch_order": {},
           "make_admission_policy": {},
           "SaturationAdmission": dict(horizon_ticks=0.0),
           "PadAwarePolicy": dict(hold_ticks=-1),
           "AdaptivePadAwarePolicy": dict(min_rate=0.0)}[make]
    if args == ("pad_aware",):
        bad = dict(hold_ticks=-2)
    errors = []
    for mod in (policies, jax_policies):
        with pytest.raises(ValueError) as e:
            getattr(mod, make)(*args, **bad)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    for mod in (policies, jax_policies):
        for kw in (dict(mode="drop"), dict(interactive_headroom=0.5)):
            with pytest.raises(ValueError):
                mod.SaturationAdmission(**kw)
    assert policies.make_launch_policy(None).name == "eager"
    assert policies.make_admission_policy(None).name == "admit_all"


# ---------------------------------------------------------------------------
# the fault plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed, p, max_faults", [
    (0, 0.3, None), (7, 0.1, 6), (123456789, 0.9, 20), (5, 1.0, 3),
    (2 ** 33 + 5, 0.5, None)])
def test_fault_plan_fires_as_jax_query_for_query(seed, p, max_faults):
    from repro.serving.faults import FaultPlan as JaxFaultPlan
    kw = dict(seed=seed, p_launch_fail=p, p_cache_miss=p / 2,
              p_cache_corrupt=0.0, p_tick_stall=p / 3,
              max_faults=max_faults)
    mine, ref = FaultPlan(**kw), JaxFaultPlan(**kw)
    order = np.random.RandomState(seed % 1000).randint(4, size=400)
    for k in order:
        q = ("launch_fails", "cache_miss", "cache_corrupt",
             "tick_stalls")[k]
        assert getattr(mine, q)() == getattr(ref, q)()
    assert mine.injected == ref.injected and mine.queries == ref.queries
    assert mine.total_injected == ref.total_injected > 0
    assert KINDS == tuple(ref.injected)


@pytest.mark.parametrize("spec", [
    "launch=0.2,miss=0.1,corrupt=0.05,stall=0.1,seed=3,max=20", "",
    "stall=1", "launch=0.5, seed=9"])
def test_fault_plan_parse_equals_jax(spec):
    from repro.serving.faults import FaultPlan as JaxFaultPlan
    mine, ref = FaultPlan.parse(spec), JaxFaultPlan.parse(spec)
    for k in ("seed", "p_launch_fail", "p_cache_miss", "p_cache_corrupt",
              "p_tick_stall", "max_faults"):
        assert getattr(mine, k) == getattr(ref, k)


@pytest.mark.parametrize("spec", ["launch", "boom=1", "launch=2"])
def test_fault_plan_rejects_as_jax(spec):
    from repro.serving.faults import FaultPlan as JaxFaultPlan
    errors = []
    for cls in (FaultPlan, JaxFaultPlan):
        with pytest.raises(ValueError) as e:
            cls.parse(spec)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# the scheduler's knobs
# ---------------------------------------------------------------------------

STREAM_KNOBS = ("slice_steps", "max_wait_ticks", "deadline_slack",
                "max_groups_per_tick", "packed", "policy", "launch_order",
                "qos_weights", "preempt", "starvation_ticks", "admission",
                "faults", "max_retries", "tiers", "degrade_tier",
                "mix_samplers", "group_size", "group_max", "branch_buckets",
                "seed")


def _tiny(device="cpu"):
    cfg = get_config("sage-dit", smoke=True)
    return (DiT(cfg, device=device),
            te.TextTower(te.text_cfg(dim=16, layers=1), device=device))


def test_scheduler_knobs_keep_the_jax_names_and_defaults():
    from repro.serving.engine import SageServingEngine as JaxEngine
    from repro.serving.scheduler import RequestScheduler as JaxScheduler
    mine = inspect.signature(RequestScheduler).parameters
    ref = inspect.signature(JaxScheduler).parameters
    for k in STREAM_KNOBS:
        assert mine[k].default == ref[k].default, k
    for name in ("slice_steps", "max_wait_ticks"):
        assert (inspect.signature(SageServingEngine.streaming_scheduler)
                .parameters[name].default
                == inspect.signature(JaxEngine.streaming_scheduler)
                .parameters[name].default)
    assert (inspect.signature(SageServingEngine).parameters["policy"].default
            == inspect.signature(JaxEngine).parameters["policy"].default)


@pytest.mark.parametrize("bad", [
    dict(slice_steps=0), dict(starvation_ticks=0), dict(max_retries=-1),
    dict(qos_weights={"batch": 0}), dict(tiers={"draft": 0}),
    dict(degrade_tier="economy"), dict(policy="lifo"),
    dict(admission="drop"), dict(launch_order="lifo")])
def test_scheduler_validation_errors_equal_jax(bad):
    from repro.serving.scheduler import RequestScheduler as JaxScheduler
    cfg = get_config("sage-dit", smoke=True)
    errors = []
    with pytest.raises(ValueError) as e:
        RequestScheduler(SageConfig(total_steps=4), *_tiny(), device="cpu",
                         **bad)
    errors.append(str(e.value))
    with pytest.raises(ValueError) as e:
        JaxScheduler(cfg, SageConfig(total_steps=4), None, None, None,
                     **bad)
    errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_submit_validation_errors_equal_jax():
    """Unknown qos, tier or sampler, a shape off the grid, a per-prompt
    sequence of the wrong length: the JAX scheduler's messages."""
    import jax
    from repro.config import SageConfig as JaxSageConfig
    from repro.models import text_encoder as jax_te
    from repro.serving.scheduler import RequestScheduler as JaxScheduler
    cfg = get_config("sage-dit", smoke=True)
    jtc = jax_te.text_cfg(dim=16, layers=1)
    js = JaxScheduler(cfg, JaxSageConfig(total_steps=4), None,
                      jax_te.init_text(jax.random.PRNGKey(0), jtc), jtc)
    ps = RequestScheduler(SageConfig(total_steps=4), *_tiny(), device="cpu")
    for bad in (dict(qos="gold"), dict(tier="economy"),
                dict(sampler="euler"), dict(shape=(8, 8, 3)),
                dict(shape=(7, 8, 4)), dict(shape=(16, 8, 4)),
                dict(shape=(8, 8)), dict(qos=["batch"] * 3)):
        errors = []
        for s in (ps, js):
            with pytest.raises(ValueError) as e:
                s.submit(["a", "b"], now=0.0, **bad)
            errors.append(str(e.value))
        assert errors[0] == errors[1], bad
    assert ps.stats["requests"] == 0 and not ps.arrivals


def test_streaming_scheduler_follows_the_engine():
    """A fresh scheduler on the engine's modules, routes, device, policy
    and noise; the engine's own scheduler is untouched."""
    noise = []
    eng = SageServingEngine(SageConfig(total_steps=4), *_tiny(),
                            attn_impl="kernel", step_impl="fused",
                            policy="pad_aware",
                            noise_fn=lambda gid, shape: noise.append(gid)
                            or torch.zeros(shape), device="cpu")
    s = eng.streaming_scheduler()
    assert s is not eng.scheduler and s.device.type == "cpu"
    assert (s.slice_steps, s.max_wait_ticks) == (4, 2)
    assert s.policy.name == "pad_aware" and s.cfg.attn_impl == "kernel"
    assert s.sage.step_impl == "fused" and s.dit is eng.scheduler.dit
    assert eng.streaming_scheduler(policy="eager").policy.name == "eager"
    s.submit(["a red circle", "a red circle"], now=0.0)
    s.drain(now=1.0)
    assert noise == [0] and s.stats["completed"] == 2
    assert eng.stats["requests"] == 0


def test_run_batch_does_not_age_streaming_groups():
    """A synchronous drain leaves the tick counter alone, so an open
    streaming group's wait (counted in ticks) does not age toward a padded
    launch, and the launch faults of the streaming loop stay off it."""
    s = RequestScheduler(SageConfig(total_steps=4), *_tiny(), device="cpu",
                         max_wait_ticks=3, faults=FaultPlan(
                             p_launch_fail=1.0))
    base = "a small red circle on a blue background"
    s.submit([base], now=1.0)
    s.tick(now=1.0)
    assert len(s.open_groups) == 1                # waiting, wait=0
    ticks = s.ticks
    assert len(s.run_batch([base, base])) == 2
    assert s.ticks == ticks and s.stats["launch_faults"] == 0
    assert len(s.open_groups) == 1                # not aged out
    s.tick(now=2.0)
    assert len(s.open_groups) == 1                # wait=1 < max_wait=3
    s.faults = None
    done = s.drain(now=3.0)
    assert [c.prompt for c in done] == [base]


# ---------------------------------------------------------------------------
# trace O against the JAX scheduler
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trace_o():
    return serve_both("O")


def test_trace_o_records_equal_jax(trace_o):
    js, jdone, ps, pdone, _ = trace_o
    assert records(pdone) == records(jdone)
    assert_images_close(pdone, jdone)
    served = [c for c in pdone if c.image is not None]
    assert served and all(c.image.shape == (64, 64, 3) for c in served)


def test_trace_o_stats_and_summary_equal_jax(trace_o):
    js, _, ps, _, _ = trace_o
    assert ps.stats == dict(js.stats)
    assert ps.summary() == js.summary()
    assert ps.class_stats == {q: dict(d) for q, d in js.class_stats.items()}
    assert ps.faults.injected == js.faults.injected
    assert ps.faults.queries == js.faults.queries


def test_trace_o_outcome_is_stream_expected(trace_o):
    """``chip_smoke.STREAM_EXPECTED["O"]``, the JAX scheduler's outcome and
    the port's, reaches every overload path the trace is for."""
    js, jdone, ps, pdone, _ = trace_o
    want = CS.STREAM_EXPECTED["O"]
    assert CS.stream_outcome(js, jdone, 8) == want
    assert CS.stream_outcome(ps, pdone, 8) == want
    for k in ("shed", "preemptions", "resumes", "retries", "stalled_ticks",
              "deadline_missed", "pack_pad_rows"):
        assert want[k] >= 1, k
    assert want["by_qos"]["interactive/ok"] >= 1


def test_retried_launches_equal_a_run_without_faults_bitwise():
    """Trace H with failing launches (retried with backoff; a failed
    bucket takes its pack-mates down, carries untouched) against trace H
    without faults, on the port: every image bitwise, only later."""
    spec = CS.STREAM_TRACES["H"]
    mods = _smoke_modules("cpu", torch.Generator().manual_seed(31))
    out = []
    for faults in (None, FaultPlan(seed=3, p_launch_fail=0.35)):
        s = RequestScheduler(SageConfig(**spec["sage"], step_impl="fused"),
                             *mods, group_size=4, attn_impl="kernel",
                             faults=faults, device="cpu", **spec["scheduler"])
        out.append((s, CS.drive_stream(s, "H", 8, 4)[0]))
    (clean, want), (faulty, got) = out
    assert faulty.stats["retries"] >= 3 and faulty.stats["shed_faulted"] == 0
    assert faulty.ticks > clean.ticks
    by_group = {}
    for c in want:
        by_group.setdefault(c.group_id, []).append(c)
    assert len(got) == len(want) == 12
    for c in got:
        w = by_group[c.group_id].pop(0)
        assert (c.prompt, c.nfe_share, c.tier, c.status) == (
            w.prompt, w.nfe_share, w.tier, "ok")
        assert c.latency >= w.latency
        assert np.array_equal(c.image, w.image)
