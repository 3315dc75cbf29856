"""The port's streaming scheduler held against the JAX scheduler.

Trace "H" of ``chip_smoke.STREAM_TRACES`` (four classes of shape, tier and
sampler, all arriving at t = 0, mixed-sampler packs) is served once per
module on a virtual clock by the JAX scheduler (plain routes on the CPU)
and by the port's (``device="cpu"``: the kernels' plain twins), with the
same bridged weights and the JAX-drawn initial noise handed over through
``noise_fn``.  Records, stats and ``summary()`` must be equal, images
within 1e-3, and the discrete outcome ``chip_smoke.STREAM_EXPECTED["H"]``,
which the stream phase holds the card's full-width run to.  Inside the
port: packed equals ``packed=False`` bitwise, and the per-group path hands
its runners the fork index as a tensor.  BENCH_7's counts on its own
traces (``benchmarks/serving_bench.py``).

The machine with the card has no JAX: JAX is imported inside the fixtures
and tests that need it, and the ``cuda`` test (trace H at smoke size on
the card against the CPU) runs there with
``python -m pytest --noconftest -m cuda tests/test_torch_streaming.py``.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import weights
from repro_torch.config import SageConfig, get_config, replace
from repro_torch.models import text_encoder as te
from repro_torch.models.dit import DiT
from repro_torch.models.vae import VAEDecoder
from repro_torch.serving.engine import SageServingEngine
from repro_torch.serving.scheduler import RequestScheduler

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-3, 1e-3          # as tests/test_torch_serving.py


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports only the standard library
    at the top)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
RECORD = ("prompt", "group_id", "nfe_share", "latency", "qos", "tier",
          "status")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch ops, restored after it.
    The port's CPU runs are thousands of small ops; under several test
    workers on few cores, a thread pool per op oversubscribes them and an
    op waits on descheduled threads (a trace-C pass measured 3.7 s with
    one thread against 181 s with eight, 8 cores busy)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomized(init, *args, seed):
    """Seeded random values (numpy) for every leaf of ``init(*args)``'s
    pytree: 0.1 for vectors, 1/sqrt(fan_in) for matrices and HWIO convs."""
    import jax
    rng = np.random.default_rng(seed)

    def draw(x):
        fan_in = int(np.prod(x.shape[:-1])) if len(x.shape) == 4 else \
            (x.shape[-2] if len(x.shape) >= 2 else 0)
        std = fan_in ** -0.5 if fan_in else 0.1
        return (rng.standard_normal(x.shape) * std).astype(np.float32)
    return jax.tree.map(draw, jax.eval_shape(lambda: init(*args)))


def serve_both(trace, **over):
    """``trace`` served by the JAX scheduler and by the port's on the CPU,
    f32 smoke config, bridged weights, JAX-drawn noise.  Returns (JAX
    scheduler, its records, port scheduler, its records, a function that
    builds another port scheduler on the same modules and noise)."""
    import jax
    import jax.numpy as jnp
    from repro.config import SageConfig as JaxSageConfig
    from repro.config import get_config as jax_get_config
    from repro.config import replace as jax_replace
    from repro.models import dit as jax_dit
    from repro.models import text_encoder as jax_te
    from repro.models import vae as jax_vae
    from repro.serving.faults import FaultPlan as JaxFaultPlan
    from repro.serving.scheduler import RequestScheduler as JaxScheduler
    from repro_torch.serving.faults import FaultPlan

    spec = CS.STREAM_TRACES[trace]
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
    kw = dict(spec["scheduler"], **over)
    jkw = dict(kw)
    if "faults" in spec:
        jkw["faults"] = JaxFaultPlan(**spec["faults"])
    js = JaxScheduler(jcfg, JaxSageConfig(**spec["sage"]),
                      jax.tree.map(jnp.asarray, w["dit"]),
                      jax.tree.map(jnp.asarray, w["text"]), jtc,
                      vae_params=jax.tree.map(jnp.asarray, w["vae"]),
                      group_size=4, **jkw)
    jdone, _ = CS.drive_stream(js, trace, jcfg.latent_size,
                               jcfg.latent_channels)

    def noise(gid, shape):
        return torch.tensor(np.asarray(jax.random.normal(
            jax.random.fold_in(js._launch_key, gid), shape, jnp.float32)))

    eng = SageServingEngine(
        SageConfig(**spec["sage"]),
        weights.dit_from_jax(w["dit"], tcfg, device="cpu"),
        weights.text_from_jax(w["text"], tc, device="cpu"),
        weights.vae_from_jax(w["vae"], device="cpu"), group_size=4,
        attn_impl="kernel", step_impl="fused", noise_fn=noise,
        device="cpu")

    def port(**more):
        pkw = dict(kw, **more)
        if "faults" in spec and "faults" not in more:
            pkw["faults"] = FaultPlan(**spec["faults"])
        return eng.streaming_scheduler(**pkw)
    ps = port()
    pdone, _ = CS.drive_stream(ps, trace, tcfg.latent_size,
                               tcfg.latent_channels)
    return js, jdone, ps, pdone, port


def records(done):
    return [tuple(getattr(c, k) for k in RECORD) for c in done]


def assert_images_close(got, want):
    for g, w in zip(got, want):
        assert (g.image is None) == (w.image is None)
        if g.image is not None:
            np.testing.assert_allclose(g.image, np.asarray(w.image),
                                       rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def trace_h():
    return serve_both("H")


def test_trace_h_records_equal_jax(trace_h):
    js, jdone, ps, pdone, _ = trace_h
    assert len(pdone) == len(jdone) == 12
    assert records(pdone) == records(jdone)
    assert_images_close(pdone, jdone)
    # the classes' own image shapes: 32x32, 64x64 and 32x64 latents x 8
    assert sorted({c.image.shape for c in pdone}) == [
        (32, 32, 3), (32, 64, 3), (64, 64, 3)]


def test_trace_h_stats_and_summary_equal_jax(trace_h):
    js, _, ps, _, _ = trace_h
    assert ps.stats == dict(js.stats)
    assert ps.ticks == js.ticks
    assert ps.summary() == js.summary()
    assert ps.tier_stats == dict(js.tier_stats)
    assert ps.shape_stats == dict(js.shape_stats)


def test_trace_h_outcome_is_stream_expected(trace_h):
    """``chip_smoke.STREAM_EXPECTED["H"]`` is the JAX scheduler's outcome,
    and the port's."""
    js, jdone, ps, pdone, _ = trace_h
    want = CS.STREAM_EXPECTED["H"]
    assert CS.stream_outcome(js, jdone, 8) == want
    assert CS.stream_outcome(ps, pdone, 8) == want


def test_trace_h_runner_keys_equal_jax(trace_h):
    """The trace captured the JAX scheduler's runner keys, in its order,
    mixed-sampler tuples among them."""
    js, _, ps, _, _ = trace_h
    route = (ps.cfg.attn_impl, ps.cfg.dtype)
    assert list(ps._runners) == [k + route for k in js._runners]
    assert any(isinstance(k[2], tuple) for k in ps._runners)


def test_trace_h_packed_equals_per_group_bitwise(trace_h):
    """``packed=False`` (one launch a group) gives the packed run's
    records and images bitwise, with more launches."""
    _, _, ps, pdone, port = trace_h
    per = port(packed=False)
    done, _ = CS.drive_stream(per, "H", 8, 4)
    assert records(done) == records(pdone)
    for a, b in zip(done, pdone):
        assert np.array_equal(a.image, b.image), a.prompt
    differ = {k for k in ps.stats if ps.stats[k] != per.stats[k]}
    assert differ == {"launches", "pack_rows", "pack_pad_rows"}
    assert per.stats["launches"] > ps.stats["launches"]
    assert per.stats["pack_pad_rows"] == 0


def test_per_group_path_passes_the_fork_index_as_a_tensor(trace_h):
    """A Python int would be baked into a CUDA graph's key (one graph per
    fork value), and a 0-dim index into a 1-D grid is read on the host,
    which a capture cannot do: the per-group path hands its runners the
    fork index as a 0-dim tensor and the grid position per row."""
    _, _, _, _, port = trace_h
    per = port(packed=False)
    forks, steps = [], []
    runner = per._runner

    def spy(phase, n_steps, samplers):
        run = runner(phase, n_steps, samplers)

        def call(carry, *args):
            steps.append((phase, tuple(carry.step_idx.shape)))
            if phase == "branch":
                forks.append(args[3])
            return run(carry, *args)
        return call
    per._runner = spy
    CS.drive_stream(per, "H", 8, 4)
    assert {s for s in steps} == {("shared", (1,)), ("branch", (4,)),
                                  ("branch", (2,))}
    assert forks and all(isinstance(f, torch.Tensor) and f.ndim == 0
                         for f in forks)
    assert {int(f) for f in forks} == {5, 9, 14}      # 15, 30, 45 steps


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp"])
@pytest.mark.parametrize("K", [1, 2])
def test_shared_uncond_branch_hands_the_step_kernel_contiguous_inputs(
        monkeypatch, sampler, K):
    """A bucket of one group under the shared-uncond CFG (trace O's
    single-group branch launches): the group's uncond eps repeated over
    its members must reach the fused step as a contiguous tensor, which
    the kernels require, not as a stride-0 view."""
    from repro_torch.core import shared_sampling as ss
    from repro_torch.core.schedule import make_schedule
    from repro_torch.kernels import dispatch
    seen = []
    step = getattr(dispatch, f"cfg_{sampler}_step")

    def spy(z, eps_u, eps_c, *args, **kw):
        seen.append(all(x.is_contiguous() for x in (z, eps_u, eps_c)))
        return step(z, eps_u, eps_c, *args, **kw)
    monkeypatch.setattr(dispatch, f"cfg_{sampler}_step", spy)
    cfg = replace(get_config("sage-dit", smoke=True), dtype="float32")
    dit = DiT(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    N, g = 4, torch.Generator().manual_seed(6)
    z = torch.randn((K, 8, 8, 4), generator=g)
    carry = ss.fork_carry(ss.SampleCarry(z, torch.zeros_like(z),
                                         torch.tensor(2)), N)
    ss.branch_phase(dit, make_schedule(1000),
                    SageConfig(total_steps=6, sampler=sampler,
                               shared_uncond_cfg=True, step_impl="fused"),
                    carry, torch.randn((K * N, cfg.cond_len, cfg.cond_dim),
                                       generator=g),
                    torch.ones((K, N)), torch.zeros((cfg.cond_len,
                                                     cfg.cond_dim)), 2, 2)
    assert seen == [True, True]


# ---------------------------------------------------------------------------
# BENCH_7's counts on its own traces (benchmarks/serving_bench.py, with the
# bench's weights: the JAX init from PRNGKey(0) / (1), through the bridge)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench_engine():
    import jax
    from repro.config import get_config as jax_get_config
    from repro.data.synthetic import ShapesDataset
    from repro.models import dit as jax_dit
    from repro.models import text_encoder as jax_te
    jcfg = jax_get_config("sage-dit", smoke=True)
    jtc = jax_te.text_cfg(dim=jcfg.cond_dim, layers=2)
    cfg = replace(get_config("sage-dit", smoke=True), dtype="float32")
    tc = replace(te.text_cfg(dim=cfg.cond_dim, layers=2), attn_impl="kernel")
    eng = SageServingEngine(
        SageConfig(total_steps=6, share_ratio=0.33, guidance_scale=3.0,
                   tau_min=0.3),
        weights.dit_from_jax(jax_dit.init_params(jcfg, jax.random.PRNGKey(0)),
                             cfg, device="cpu"),
        weights.text_from_jax(jax_te.init_text(jax.random.PRNGKey(1), jtc),
                              tc, device="cpu"),
        group_size=4, attn_impl="kernel", step_impl="fused", device="cpu")
    _, base = ShapesDataset(res=16).batch(0, 3)
    return eng, base


@pytest.mark.parametrize("merged", [True, False])
def test_bench7_hetero_mix_counts(bench_engine, merged):
    """mix4t4s2hT6: 4 quarter-res draft ddim, 4 full-res standard ddim, 2
    full-res standard dpmpp; merged (one scheduler, mixed-sampler packs)
    launches=5 over 3 ticks, split (one scheduler a class) 8; nfe=74 in
    both (BENCH_7.json)."""
    eng, base = bench_engine
    h, c = eng.scheduler.cfg.latent_size, eng.scheduler.cfg.latent_channels
    classes = [([base[0]] * 4, dict(shape=(h // 2, h // 2, c), tier="draft",
                                    sampler="ddim")),
               ([base[1]] * 4, dict(shape=(h, h, c), tier="standard",
                                    sampler="ddim")),
               ([base[2]] * 2, dict(shape=(h, h, c), tier="standard",
                                    sampler="dpmpp"))]
    kw = dict(slice_steps=3, max_wait_ticks=0, packed=True)
    if merged:
        scheds = [eng.streaming_scheduler(mix_samplers=True, **kw)]
        feeds = [(scheds[0], cls) for cls in classes]
    else:
        scheds = [eng.streaming_scheduler(**kw) for _ in classes]
        feeds = list(zip(scheds, classes))
    for s, (prompts, axes) in feeds:
        s.submit(prompts, now=0.0, **axes)
    done, ticks, now = [], 0, 0.0
    while any(s.pending for s in scheds):
        now += 1.0
        ticks += 1
        for s in scheds:
            done.extend(s.tick(now=now))
    assert len(done) == 10 and ticks == 3
    assert sum(s.stats["nfe"] for s in scheds) == 74
    assert sum(s.stats["launches"] for s in scheds) == (5 if merged else 8)
    pad = (sum(s.stats["pack_pad_rows"] for s in scheds)
           / sum(s.stats["pack_rows"] for s in scheds))
    assert pad == pytest.approx(0.174, abs=5e-4)


@pytest.mark.parametrize("policy, want", [
    ("eager", dict(launches_per_tick=1.33, pad_waste=0.444, nfe=160,
                   p95=3.0)),
    ("pad_aware", dict(launches_per_tick=0.71, pad_waste=0.0, nfe=144,
                       p95=4.0))])
def test_bench7_stagger_counts(bench_engine, policy, want):
    """stag8w2g2T6: 8 waves of 2 prompts, one every 2 ticks, then drain;
    eager ships half-full groups, pad_aware holds them for the next wave
    (BENCH_7.json)."""
    eng, base = bench_engine
    s = eng.streaming_scheduler(slice_steps=3, max_wait_ticks=1,
                                packed=True, policy=policy)
    done, now = [], 0.0
    for w in range(16):
        now += 1.0
        if w % 2 == 0:
            s.submit([base[(w // 2) % 3]] * 2, now=now)
        done.extend(s.tick(now=now))
    while s.pending:
        now += 1.0
        done.extend(s.tick(now=now))
    out = s.summary()
    assert len(done) == 16
    assert out["nfe"] == want["nfe"]
    assert round(out["launches_per_tick"], 2) == want["launches_per_tick"]
    assert round(out["pad_waste"], 3) == want["pad_waste"]
    assert out["latency_p95"] == want["p95"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _smoke_modules(device, gen):
    cfg = replace(get_config("sage-dit", smoke=True), dtype="float32")
    tc = replace(te.text_cfg(dim=cfg.cond_dim, layers=2), attn_impl="kernel")
    mods = (DiT(cfg, device="cpu", generator=gen),
            te.TextTower(tc, device="cpu", generator=gen),
            VAEDecoder(device="cpu", generator=gen, dtype=torch.float32))
    with torch.no_grad():
        for m in mods[:2]:
            for p in m.parameters():
                if not p.any():
                    p.normal_(0.0, 0.02, generator=gen)
    return [m.to(device) for m in mods]


@pytest.mark.cuda
def test_cuda_trace_h_equals_cpu(monkeypatch):
    """Trace H at smoke size on the card (CUDA graphs, the hand-written
    kernels) against the CPU (the plain twins), same weights and noise:
    equal discrete outcome and records, images within 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the hand-written "
                    "kernels run only there")
    spec = CS.STREAM_TRACES["H"]
    out = []
    # f32 on both sides, as chip_smoke.py runs it: no TF32 in cuBLAS or in
    # the VAE's cuDNN convs
    for flag in (torch.backends.cuda.matmul, torch.backends.cudnn):
        monkeypatch.setattr(flag, "allow_tf32", False)
    for dev in ("cuda", "cpu"):
        mods = _smoke_modules(dev, torch.Generator().manual_seed(21))
        s = RequestScheduler(SageConfig(**spec["sage"], step_impl="fused"),
                             *mods, group_size=4, attn_impl="kernel",
                             seed=22, device=dev, **spec["scheduler"])
        done, _ = CS.drive_stream(s, "H", 8, 4)
        out.append((CS.stream_outcome(s, done, 8), done))
    (gpu, gdone), (cpu, cdone) = out
    assert gpu == cpu == CS.STREAM_EXPECTED["H"]
    assert records(gdone) == records(cdone)
    assert_images_close(gdone, cdone)
