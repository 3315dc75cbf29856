"""The port's compiled runners (``serving/runners.py``), the weights cast
once (``models/layers.py``) and the capturable segment bodies
(``core/shared_sampling.py``), on the CPU at smoke size.

A CUDA graph exists only on the card, so here ``runners._warm_up`` and
``runners._record`` are swapped for CPU stand-ins (the "graph" reruns the
function and writes into the outputs it returned first, as a replay
overwrites its memory pool); the keys, static buffers, launch-count
deltas, output copies and the decode's cache set and position are the
runners' own code.
The replay on the card is held to the eager path by the ``cuda`` test
below and by ``chip_smoke.py``.  The machine with the card has no JAX, so
the two tests that hold the port to the JAX package import it themselves;
there, ``python -m pytest --noconftest -m cuda tests/test_torch_runners.py``
runs the ``cuda`` test.
"""
import numpy as np
import pytest
import torch

from repro_torch import weights
from repro_torch.config import SageConfig, get_config, replace
from repro_torch.core import shared_sampling as ss
from repro_torch.core.schedule import ddim_timesteps, make_schedule
from repro_torch.kernels.ddim_step.ops import fused_cfg_ddim_step
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import dit as tdit
from repro_torch.models import layers
from repro_torch.models import text_encoder as te
from repro_torch.models import transformer as tfm
from repro_torch.models.dit import DiT
from repro_torch.serving import kvcache, runners
from repro_torch.serving.engine import SageServingEngine
from repro_torch.serving.kvcache import fork_model_cache

SCHED = make_schedule(1000)


def randomized(init, *args, seed):
    """Seeded random values (numpy) for every leaf of ``init(*args)``'s
    pytree: 0.1 for vectors, 1/sqrt(fan_in) for matrices."""
    import jax
    rng = np.random.default_rng(seed)

    def draw(x):
        fan_in = x.shape[-2] if len(x.shape) >= 2 else 0
        std = fan_in ** -0.5 if fan_in else 0.1
        return (rng.standard_normal(x.shape) * std).astype(np.float32)
    return jax.tree.map(draw, jax.eval_shape(lambda: init(*args)))


def _live(model, seed):
    """Seeded values for every parameter (the zero-initialised adaLN gates
    and norms would switch whole branches off)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return model


def _set_counts(counts):
    """Every wrapper's launch count to ``counts`` (keyed as
    ``runners.launch_counts``)."""
    for key, n in counts.items():
        name, _, route = key.partition("/")
        if route:
            runners.WRAPPERS[name].launches_by_route[route] = n
        else:
            runners.WRAPPERS[name].launches = n


def _symbols(counts):
    """Kernel symbols, as libcuda names them, one a launch in
    ``counts``, among others no wrapper launches."""
    mangled = {"flash_attention/sm90":
               "_ZN12_GLOBAL__N_117flash_sm90_kernelILi80EEEv14CUtensorMap_st",
               "flash_attention/tf32x3":
               "_ZN12_GLOBAL__N_119flash_tf32x3_kernelILi2ELi4EEEvPKfS2_",
               "ddim_step": "_ZN12_GLOBAL__N_116ddim_step_kernelIfLi4EEEvPKf",
               "dpmpp_step": "_ZN12_GLOBAL__N_117dpmpp_step_kernelIfLi4EEEvPK",
               "group_mean": "_ZN12_GLOBAL__N_117group_mean_kernelIfLi4EEEvPK",
               "ssd_scan": "_ZN12_GLOBAL__N_113ssd_tc_kernelIfLi8EEEvPKf"}
    out = ["nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN",
           "_ZN2at6native29vectorized_elementwise_kernelILi4E"]
    for key, sym in mangled.items():
        out += [sym] * counts.get(key, 0)
    return out


class _CpuGraph:
    """A stand-in for a captured graph: a replay reruns the function on the
    static inputs and writes into the outputs of the "capture"; as on the
    card, no Python wrapper counts a launch during a replay.  Its kernel
    symbols are those the wrappers launched while it was recorded."""

    def __init__(self, fn, args, out, launched):
        self.fn, self.args, self.out = fn, args, out
        self.symbols = _symbols(launched)

    def replay(self):
        counts = runners.launch_counts()
        new = self.fn(*self.args)
        _set_counts(counts)
        for o, n in zip(kvcache._leaves(self.out), kvcache._leaves(new)):
            if isinstance(o, torch.Tensor):
                o.copy_(n)


@pytest.fixture
def cpu_graphs(monkeypatch):
    def record(fn, args):
        before = runners.launch_counts()
        out = fn(*args)
        launched = runners.counts_delta(before, runners.launch_counts())
        return _CpuGraph(fn, args, out, launched), out
    monkeypatch.setattr(runners, "_warm_up", lambda fn, args: fn(*args))
    monkeypatch.setattr(runners, "_record", record)
    monkeypatch.setattr(runners, "kernel_symbols", lambda g: g.symbols)


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def test_runner_keys_mirror_the_jax_runners():
    """The scheduler's runner keys are the JAX scheduler's (phase, n_steps,
    samplers) plus the attention route; a graph's key adds each input's
    shape and dtype, the grid's rank, fork_idx's kind and an int's value."""
    import jax
    import jax.numpy as jnp
    from repro.config import SageConfig as JaxSageConfig
    from repro.config import get_config as jax_get_config
    from repro.models import dit as jax_dit
    from repro.models import text_encoder as jax_te
    from repro.serving.engine import SageServingEngine as JaxEngine
    jcfg = jax_get_config("sage-dit", smoke=True)
    jtc = jax_te.text_cfg(dim=jcfg.cond_dim, layers=1)
    key = jax.random.PRNGKey(0)
    jeng = JaxEngine(jcfg, JaxSageConfig(total_steps=4),
                     jax.tree.map(jnp.asarray, randomized(
                         jax_dit.init_params, jcfg, key, seed=1)),
                     jax.tree.map(jnp.asarray, randomized(
                         jax_te.init_text, key, jtc, seed=2)), jtc)
    cfg = get_config("sage-dit", smoke=True)
    teng = SageServingEngine(
        SageConfig(total_steps=4), DiT(cfg, device="cpu"),
        te.TextTower(te.text_cfg(dim=cfg.cond_dim, layers=1), device="cpu"),
        attn_impl="kernel", device="cpu")
    calls = [("shared", 3, "ddim"), ("shared", 3, "dpmpp"),
             ("shared", 2, "ddim"), ("branch", 3, "ddim"),
             ("branch", 3, ("ddim", "dpmpp")), ("shared", 3, "ddim")]
    for phase, n, samplers in calls:
        for sched in (jeng.scheduler, teng.scheduler):
            getattr(sched, f"_{phase}_runner")(n, samplers)
    route = ("kernel", cfg.dtype)
    assert list(teng.scheduler._runners) == [k + route
                                             for k in jeng.scheduler._runners]
    assert len(teng.scheduler._runners) == 5

    def graph_key(key, *args):          # as SegmentRunner keys its graphs
        return key + runners.signature(args)

    z = torch.zeros((8, 8, 8, 4))
    grid = torch.as_tensor(ddim_timesteps(1000, 4))
    fork = torch.full((8,), 2)

    def args(**kw):
        a = dict(z=z, mask=torch.ones((2, 4)), fork=fork, grid=grid)
        a.update(kw)
        return (ss.SampleCarry(a["z"], a["z"], a["fork"]), a["z"][:, 0],
                a["mask"], a["z"][0, 0], a["fork"], a["grid"])
    key = ("branch", 3, "ddim") + route
    base = graph_key(key, *args())
    assert graph_key(key, *args()) == base
    assert graph_key(key, *args(z=torch.ones((8, 8, 8, 4)))) == base
    differ = [args(z=torch.zeros((4, 8, 8, 4))),            # a shape
              args(z=torch.zeros((8, 8, 8, 4), dtype=torch.bfloat16)),
              args(mask=torch.ones((1, 8))),
              args(grid=torch.zeros((8, 5), dtype=torch.long)),  # 2-D grid
              args(fork=2), args(fork=3)]                  # kind, value
    keys = [graph_key(key, *a) for a in differ]
    assert base not in keys and len(set(keys)) == len(keys)
    for other in (("branch", 2, "ddim"), ("branch", 3, "dpmpp"),
                  ("shared", 3, "ddim"), ("branch", 3, ("ddim", "dpmpp"))):
        assert graph_key(other + route, *args()) != base
    assert graph_key(("branch", 3, "ddim", "naive", cfg.dtype),
                     *args()) != base


# ---------------------------------------------------------------------------
# launch counts
# ---------------------------------------------------------------------------

ONE_PATH = {"flash_attention": 4, "flash_attention/sm90": 3,
            "flash_attention/tf32x3": 1, "ddim_step": 2}


def _launch_like_a_path():
    """What one segment's kernels do to the counters: ``ONE_PATH``."""
    flash_attention.launches += 4
    flash_attention.launches_by_route["sm90"] += 3
    flash_attention.launches_by_route["tf32x3"] += 1
    fused_cfg_ddim_step.launches += 2


@pytest.mark.parametrize("k", [1, 2, 5])
def test_counts_delta_turns_a_capture_into_the_eager_counts(k):
    """A graph's launches, read from its kernel symbols, over k replays are
    what the wrappers count over k eager runs."""
    start = runners.launch_counts()
    for _ in range(k):
        _launch_like_a_path()
    eager = runners.counts_delta(start, runners.launch_counts())
    _set_counts(start)
    _launch_like_a_path()                       # the capture's one run
    delta = runners.counts_delta(start, runners.launch_counts())
    _set_counts(start)
    graph = runners.launches_of(_symbols(delta))
    assert graph == delta
    assert {key: k * n for key, n in graph.items()} == eager
    assert graph["flash_attention/sm90"] == 3


def test_kernel_symbols_name_every_count_and_kernel():
    """Each count but flash's total has a kernel symbol, and each symbol is
    a ``__global__`` function of the kernel sources."""
    import re
    from pathlib import Path
    counts = set(runners.launch_counts()) - {"flash_attention"}
    assert set(runners.KERNEL_SYMBOLS) == counts
    csrc = Path(runners.__file__).parents[1] / "csrc"
    globals_ = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
        " ".join(f.read_text() for f in csrc.glob("*.cu"))))
    assert set(runners.KERNEL_SYMBOLS.values()) <= globals_
    names = list(runners.KERNEL_SYMBOLS.values())
    assert not any(a in b for a in names for b in names if a != b)


def test_runner_counts_replays_not_warm_up_or_capture(cpu_graphs):
    """The wrappers count what they launch (the warm-up and the capture);
    the replays, which run no wrapper, go to ``REPLAYED`` from the graph's
    kernel symbols."""
    def fn(x):
        _launch_like_a_path()
        return x * 2
    run = runners.SegmentRunner(("shared", 1, "ddim"), fn)
    start = runners.launch_counts()
    replayed = dict(runners.REPLAYED)
    for i in range(3):
        run(torch.full((2,), float(i)))
    assert run.replays == 3 and len(run.graphs) == 1
    wrappers = runners.counts_delta(start, runners.launch_counts())
    assert wrappers == {k: 2 * ONE_PATH.get(k, 0) for k in start}
    assert runners.counts_delta(replayed, runners.REPLAYED) == {
        k: 3 * ONE_PATH.get(k, 0) for k in start}
    _set_counts(start)


def test_capture_raises_when_the_graph_disagrees_with_the_wrappers(
        cpu_graphs, monkeypatch):
    """A graph that does not hold exactly what the wrappers launched into
    it (a launch off the capture stream, a kernel from elsewhere) fails."""
    def fn(x):
        _launch_like_a_path()
        return x * 2
    start = runners.launch_counts()
    monkeypatch.setattr(runners, "kernel_symbols",
                        lambda g: g.symbols[:-1])
    with pytest.raises(RuntimeError, match="captured graph"):
        runners.SegmentRunner(("shared", 1, "ddim"), fn)(torch.ones(2))
    _set_counts(start)


# ---------------------------------------------------------------------------
# weights cast once
# ---------------------------------------------------------------------------

def test_cast_once_copy_is_bitwise_the_cast():
    g = torch.Generator().manual_seed(0)
    w = torch.nn.Parameter(torch.randn((33, 17), generator=g) * 3)
    assert layers.cast_weights_([w], torch.float32) == 0
    assert layers.cast_weights_([w], torch.bfloat16) == 33 * 17 * 2
    with torch.no_grad():                        # as the serving path reads
        held = layers.cast(w, torch.bfloat16)
        assert held.data_ptr() == w._casts[torch.bfloat16][1].data_ptr()
        assert torch.equal(held, w.to(torch.bfloat16))
        assert torch.equal(layers.cast(w.t(), torch.bfloat16).t(), held)
        x = torch.randn((5, 33), generator=g).to(torch.bfloat16)
        assert torch.equal(layers.dot(x, w), x @ w.to(torch.bfloat16))
        w.mul_(0.5)                              # an in-place write
        assert layers.cast(w, torch.bfloat16).data_ptr() != held.data_ptr()
        assert torch.equal(layers.cast(w, torch.bfloat16),
                           w.to(torch.bfloat16))
        layers.cast_weights_([w], torch.bfloat16)  # refreshed in place
        assert layers.cast(w, torch.bfloat16).data_ptr() == held.data_ptr()
        assert torch.equal(held, w.to(torch.bfloat16))
    # under autograd the detached copy is never read: a fresh cast that
    # carries w's gradient, bitwise the copy
    live = layers.cast(w, torch.bfloat16)
    assert live.grad_fn is not None and live.data_ptr() != held.data_ptr()
    assert torch.equal(live, held)


def test_dit_forward_equal_with_and_without_cast_weights():
    cfg = get_config("sage-dit", smoke=True)            # bf16 activations
    a = _live(DiT(cfg, device="cpu"), 1)
    b = DiT(cfg, device="cpu")
    b.load_state_dict(a.state_dict())
    n = a.cast_weights_()
    want = sum(p.numel() for name, p in a.named_parameters()
               if name.rsplit(".", 1)[-1] in tdit.CAST) * 2
    assert n == want > 0
    assert DiT(replace(cfg, dtype="float32"),
               device="cpu").cast_weights_() == 0
    g = torch.Generator().manual_seed(2)
    z = torch.randn((3, 8, 8, 4), generator=g)
    t = torch.tensor([999, 500, 3])
    c = torch.randn((3, cfg.cond_len, cfg.cond_dim), generator=g)
    for impl in ("naive", "kernel"):
        k = replace(cfg, attn_impl=impl)
        assert torch.equal(a(z, t, c, cfg=k), b(z, t, c, cfg=k))


def test_text_tower_holds_no_copy_and_is_unchanged():
    tc = te.text_cfg(dim=64, layers=2)
    tower = _live(te.TextTower(tc, device="cpu"), 3)
    toks = te.tokenize(["a red circle", "a green tree at dawn"], 48)
    f0, p0 = tower(toks)
    # the tower runs in its embedding's dtype, f32: nothing to cast
    assert layers.cast_weights_(tower.parameters(), tower.embed.dtype) == 0
    f1, p1 = tower(toks)
    assert torch.equal(f0, f1) and torch.equal(p0, p1)


def test_lm_equal_with_and_without_cast_weights():
    cfg = get_config("mamba2-780m", smoke=True)          # bf16 activations
    a = _live(tfm.LM(cfg, device="cpu"), 4)
    b = tfm.LM(cfg, device="cpu")
    b.load_state_dict(a.state_dict())
    assert a.cast_weights_() > 0
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (2, 37))
    (la, ca), (lb, cb) = tfm.prefill(a, toks), tfm.prefill(b, toks)
    assert torch.equal(la, lb)
    tok = la.argmax(-1)
    for _ in range(3):
        (la, ca), (lb, cb) = (tfm.decode_step(a, ca, tok),
                              tfm.decode_step(b, cb, tok))
        assert torch.equal(la, lb)
        tok = la.argmax(-1)


def test_weight_bridge_makes_the_copies_stale():
    import jax
    from repro.config import get_config as jax_get_config
    from repro.models import dit as jax_dit
    jcfg = jax_get_config("sage-dit", smoke=True)
    cfg = get_config("sage-dit", smoke=True)             # bf16 activations
    key = jax.random.PRNGKey(0)
    pa = randomized(jax_dit.init_params, jcfg, key, seed=5)
    pb = randomized(jax_dit.init_params, jcfg, key, seed=6)
    model = weights.dit_from_jax(pa, cfg, device="cpu")
    model.cast_weights_()
    held = {id(p): p._casts[torch.bfloat16][1] for p in model._cast}
    weights.load_numpy(model, weights._unstack_blocks(
        dict(weights._flatten(pb))))
    fresh = weights.dit_from_jax(pb, cfg, device="cpu")
    g = torch.Generator().manual_seed(7)
    z = torch.randn((2, 8, 8, 4), generator=g)
    t = torch.tensor([900, 10])
    c = torch.randn((2, cfg.cond_len, cfg.cond_dim), generator=g)
    with torch.no_grad():                  # as the forward reads them
        assert all(layers.cast(p, torch.bfloat16) is not held[id(p)]
                   for p in model._cast)
    assert torch.equal(model(z, t, c), fresh(z, t, c))
    model.cast_weights_()
    with torch.no_grad():
        assert all(layers.cast(p, torch.bfloat16) is held[id(p)]
                   for p in model._cast)
    assert torch.equal(model(z, t, c), fresh(z, t, c))


# ---------------------------------------------------------------------------
# capturable segment bodies
# ---------------------------------------------------------------------------

def _toy_eps(z, t, c):
    return (0.5 * torch.sin(z)
            + (torch.cos(t / 1000.0) * c[:, 0, 0])[:, None, None, None])


def _segment_inputs(rows, grid2d, seed=8):
    g = torch.Generator().manual_seed(seed)
    z = torch.randn((rows, 4, 4, 4), generator=g)
    cond = torch.randn((rows, 3, 2), generator=g)
    if grid2d:
        grid = np.zeros((rows, 9), np.int64)
        for j in range(rows):
            n = 6 if j % 2 else 8
            grid[j, :n + 1] = ddim_timesteps(1000, n)
    else:
        grid = ddim_timesteps(1000, 8)
    return z, cond, grid


@pytest.mark.parametrize("step_impl", ["reference", "fused"])
@pytest.mark.parametrize("grid2d", [False, True])
@pytest.mark.parametrize("mixed", [False, True])
def test_segment_bodies_equal_the_phases_bitwise(step_impl, grid2d, mixed):
    """The phases with a host (numpy) grid, 1-D or 2-D, a tensor fork_idx
    and per-row solvers against their bodies on the converted inputs, as a
    runner hands them over: bitwise equal."""
    K, N = 2, 3
    sage = SageConfig(total_steps=8, guidance_scale=3.0,
                      step_impl=step_impl, sampler="dpmpp",
                      shared_uncond_cfg=mixed)
    z, cbar, grid = _segment_inputs(K, grid2d)
    null = torch.zeros((3, 2))
    rs = ("ddim", "dpmpp") if mixed else None
    carry = ss.SampleCarry(z, torch.zeros_like(z), torch.tensor([0, 1]))
    got = ss.shared_phase(_toy_eps, SCHED, sage, carry, cbar, null, 3,
                          grid=grid, row_samplers=rs)
    s_sage, split = ss.segment_solver(sage, rs, K, "cpu")
    want = ss.shared_segment(_toy_eps, SCHED, s_sage, carry, cbar, null, 3,
                             torch.as_tensor(grid), split)
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    fork = ss.fork_carry(got, N)
    fork_idx = got.step_idx.repeat_interleave(N)
    fork = fork._replace(step_idx=fork_idx)
    zb, cond, gridb = _segment_inputs(K * N, grid2d, seed=9)
    mask = torch.tensor([[1.0, 1.0, 0.0], [1.0, 1.0, 1.0]])
    rsb = tuple(s for s in ("ddim", "dpmpp") for _ in range(N)) \
        if mixed else None
    if not grid2d:
        gridb = grid
    for fk in (fork_idx, 3):
        got_b = ss.branch_phase(_toy_eps, SCHED, sage, fork, cond, mask,
                                null, 4, fk, grid=gridb, row_samplers=rsb)
        b_sage, split = ss.segment_solver(sage, rsb, K * N, "cpu")
        want_b = ss.branch_segment(_toy_eps, SCHED, b_sage, fork, cond,
                                   mask, null, 4, fk, torch.as_tensor(gridb),
                                   split)
        for a, b in zip(got_b, want_b):
            assert torch.equal(a, b)
        assert torch.isfinite(got_b.z).all()


# ---------------------------------------------------------------------------
# the runners' own logic, with the CPU stand-ins for a graph
# ---------------------------------------------------------------------------

def test_segment_runner_replays_equal_eager_and_outputs_are_copies(
        cpu_graphs):
    sage = SageConfig(total_steps=8, guidance_scale=3.0, sampler="dpmpp",
                      step_impl="fused", shared_uncond_cfg=True)
    K, N = 2, 3
    z, cond, _ = _segment_inputs(K * N, False)
    grid = torch.as_tensor(ddim_timesteps(1000, 8))
    mask = torch.tensor([[1.0, 1.0, 1.0], [1.0, 1.0, 0.0]])
    null = torch.zeros((3, 2))
    fork = torch.full((K * N,), 2)

    def body(carry, cond_flat, m, nul, fk, gr):
        return ss.branch_segment(_toy_eps, SCHED, sage, carry, cond_flat, m,
                                 nul, 3, fk, gr)
    run = runners.SegmentRunner(("branch", 3, "dpmpp"), body)

    def inputs(scale):
        return (ss.SampleCarry(z * scale, torch.zeros_like(z), fork), cond,
                mask, null, fork, grid)
    first = run(*inputs(1.0))
    keep = [x.clone() for x in first]
    second = run(*inputs(-0.5))
    for a, b in zip(first, keep):             # the first result is intact
        assert torch.equal(a, b)
    for got, scale in ((first, 1.0), (second, -0.5)):
        want = body(*inputs(scale))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert not torch.equal(first.z, second.z)
    assert len(run.graphs) == 1 and run.replays == 2


def test_decode_runner_matches_the_eager_loop(cpu_graphs):
    """The one cache set updated in place, the copy of a foreign cache
    (left as it was) and a fresh logits tensor per step: greedy tokens
    equal an eager ``decode_step`` loop token for token, logits bitwise."""
    cfg = replace(get_config("mamba2-780m", smoke=True), dtype="float32")
    model = _live(tfm.LM(cfg, device="cpu"), 10)
    prompt = np.random.RandomState(1).randint(0, cfg.vocab, (1, 21))
    logits, trunk = tfm.prefill(model, prompt)
    cache = fork_model_cache(trunk, 3)
    tok0 = logits.argmax(-1).repeat_interleave(3, 0)
    run = runners.DecodeRunner(model)
    outs = {}
    for name, step in (("eager", lambda c, t: tfm.decode_step(model, c, t)),
                       ("graph", run)):
        c, tok, toks = cache, tok0, []
        for i in range(6):
            lg, c = step(c, tok)
            tok = lg.argmax(-1)
            toks.append(tok)
        outs[name] = (torch.cat(toks, 1), lg)
    assert torch.equal(outs["graph"][0], outs["eager"][0])
    assert torch.equal(outs["graph"][1], outs["eager"][1])
    (cset, _, _, _), = run.graphs.values()
    assert c is cset and run.replays == 6
    # a cache of the same shapes from elsewhere is copied into the set
    before = [x.clone() for x in kvcache._leaves(cache)]
    lg, c2 = run(cache, tok0)
    want, _ = tfm.decode_step(model, cache, tok0)
    assert torch.equal(lg, want) and c2 is cset
    assert all(torch.equal(a, b)
               for a, b in zip(kvcache._leaves(cache), before))


def test_decode_runner_places_rows_at_the_device_position(cpu_graphs):
    """A dense LM's decode through one graph for every position: the
    position is a static 0-dim tensor filled before each replay, so each
    step's logits are bitwise the eager ``decode_step``'s and the set's KV
    rows those of the eager cache, step by step; the input cache is left
    as it was, and a step without its position raises."""
    cfg = replace(get_config("phi3-mini-3.8b", smoke=True), dtype="float32")
    model = _live(tfm.LM(cfg, device="cpu"), 17)
    prompt = np.random.RandomState(2).randint(0, cfg.vocab, (1, 14))
    logits, trunk = tfm.prefill(model, prompt, max_len=24)
    cache = fork_model_cache(trunk, 2)
    before = [x.clone() for x in kvcache._leaves(cache)]
    run = runners.DecodeRunner(model)
    tok = logits.argmax(-1).repeat_interleave(2, 0)
    eager, graph = cache, cache
    for i in range(6):
        want, eager = tfm.decode_step(model, eager, tok, 14 + i)
        got, graph = run(graph, tok, 14 + i)
        assert torch.equal(got, want)
        for a, b in zip(kvcache._leaves(graph), kvcache._leaves(eager)):
            assert torch.equal(a, b)
        tok = want.argmax(-1)
    assert len(run.graphs) == 1 and run.replays == 6
    assert all(torch.equal(a, b)
               for a, b in zip(kvcache._leaves(cache), before))
    with pytest.raises(ValueError, match="position"):
        run(graph, tok)


@pytest.mark.parametrize("arch,prompt", [("recurrentgemma-2b", 61),
                                         ("deepseek-v2-lite-16b", 14)])
def test_decode_runner_serves_the_hybrid_and_moe(cpu_graphs, arch, prompt):
    """The hybrid (RG-LRU states updated in place, the local attention's
    64-row ring wrapped by the steps at 61..66) and MoE with MLA (the
    latent rows written at the device position; routing with no host
    read): each step's logits and the set's cache bitwise the eager
    ``decode_step``'s, one graph for every position; a step without its
    position raises, as a local or MLA layer reads it."""
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    model = _live(tfm.LM(cfg, device="cpu"), 19)
    tokens = np.random.RandomState(3).randint(0, cfg.vocab, (1, prompt))
    logits, trunk = tfm.prefill(model, tokens, max_len=prompt + 8)
    assert tfm.uses_pos(cfg)
    cache = fork_model_cache(trunk, 2)
    run = runners.DecodeRunner(model)
    tok = logits.argmax(-1).repeat_interleave(2, 0)
    eager, graph = cache, cache
    for i in range(6):
        want, eager = tfm.decode_step(model, eager, tok, prompt + i)
        got, graph = run(graph, tok, prompt + i)
        assert torch.equal(got, want)
        for a, b in zip(kvcache._leaves(graph), kvcache._leaves(eager)):
            assert torch.equal(a, b)
        tok = want.argmax(-1)
    assert len(run.graphs) == 1 and run.replays == 6
    with pytest.raises(ValueError, match="position"):
        run(graph, tok)


def test_decode_runner_refreshes_weights_when_a_decode_starts(
        cpu_graphs, monkeypatch):
    """A step fed back the runner's own cache only fills the token and
    replays: the cast-once weights are refreshed (a walk over the
    parameters) once a decode, when it starts from another cache."""
    cfg = get_config("mamba2-780m", smoke=True)
    model = _live(tfm.LM(cfg, device="cpu"), 16)
    refreshes = []
    cast_weights_ = model.cast_weights_
    monkeypatch.setattr(model, "cast_weights_",
                        lambda *a: refreshes.append(1) or cast_weights_(*a))
    logits, trunk = tfm.prefill(model, np.arange(12)[None] % cfg.vocab)
    cache = fork_model_cache(trunk, 2)
    tok = logits.argmax(-1).repeat_interleave(2, 0)
    run = runners.DecodeRunner(model)
    for n_decodes in (1, 2):
        c = cache
        for _ in range(4):
            lg, c = run(c, tok)
            tok = lg.argmax(-1)
        assert len(refreshes) == n_decodes
    assert run.replays == 8 and len(run.graphs) == 1


@pytest.mark.cuda
def test_cuda_replay_equals_eager():
    """On the card: a captured branch segment of the smoke DiT on the
    kernel routes replays bitwise equal to the eager body, twice, a decode
    graph gives the eager loop's tokens, and a dense LM's, the hybrid's
    (across its local ring's wrap) and an MoE LM's decode graphs (one for
    every position) the eager steps' logits and caches bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the hand-written "
                    "kernels run only there")
    dev = torch.device("cuda")
    cfg = replace(get_config("sage-dit", smoke=True), attn_impl="kernel")
    dit = _live(DiT(cfg, device="cpu"), 11).to(dev)
    dit.cast_weights_()
    sage = SageConfig(total_steps=8, sampler="dpmpp", step_impl="fused",
                      shared_uncond_cfg=True)
    sched = SCHED.to(dev)
    g = torch.Generator().manual_seed(12)
    K, N = 2, 4
    cond = torch.randn((K * N, cfg.cond_len, cfg.cond_dim), generator=g
                       ).to(dev)
    mask = torch.ones((K, N), device=dev)
    null = torch.zeros((cfg.cond_len, cfg.cond_dim), device=dev)
    fork = torch.full((K * N,), 2, device=dev)
    grid = torch.as_tensor(ddim_timesteps(1000, 8), device=dev)

    def body(carry, c, m, nul, fk, gr):
        return ss.branch_segment(dit, sched, sage, carry, c, m, nul, 3, fk,
                                 gr)
    run = runners.SegmentRunner(("branch", 3, "dpmpp"), body)
    results = []
    for seed in (13, 14):
        z = torch.randn((K * N, 8, 8, 4), generator=torch.Generator(
            ).manual_seed(seed)).to(dev)
        args = (ss.SampleCarry(z, torch.zeros_like(z), fork), cond, mask,
                null, fork, grid)
        results.append((run(*args), body(*args)))
    for got, want in results:
        for a, b in zip(got, want):
            assert torch.equal(a, b)

    lcfg = get_config("mamba2-780m", smoke=True)
    lm = _live(tfm.LM(lcfg, device="cpu"), 15).to(dev)
    logits, trunk = tfm.prefill(lm, np.arange(30)[None] % lcfg.vocab)
    cache = fork_model_cache(trunk, 2)
    drun = runners.DecodeRunner(lm)
    toks = {}
    for name, step in (("eager", lambda c, t: tfm.decode_step(lm, c, t)),
                       ("graph", drun)):
        c, tok, out = cache, logits.argmax(-1).repeat_interleave(2, 0), []
        for _ in range(5):
            lg, c = step(c, tok)
            tok = lg.argmax(-1)
            out.append(tok)
        toks[name] = torch.cat(out, 1)
    assert torch.equal(toks["graph"], toks["eager"])

    dcfg = replace(get_config("phi3-mini-3.8b", smoke=True),
                   attn_impl="kernel")
    dense = _live(tfm.LM(dcfg, device="cpu"), 18).to(dev)
    dense.cast_weights_()
    logits, trunk = tfm.prefill(dense, np.arange(40)[None] % dcfg.vocab,
                                max_len=48)
    cache = fork_model_cache(trunk, 2)
    drun = runners.DecodeRunner(dense)
    eager, graph = cache, cache
    tok = logits.argmax(-1).repeat_interleave(2, 0)
    for i in range(5):
        want, eager = tfm.decode_step(dense, eager, tok, 40 + i)
        got, graph = drun(graph, tok, 40 + i)
        assert torch.equal(got, want)
        tok = want.argmax(-1)

    # the hybrid across its local ring's wrap (window 64), and MoE with MLA
    for arch, prompt in (("recurrentgemma-2b", 61),
                         ("deepseek-v2-lite-16b", 40)):
        hcfg = replace(get_config(arch, smoke=True), attn_impl="kernel")
        lm = _live(tfm.LM(hcfg, device="cpu"), 20).to(dev)
        lm.cast_weights_()
        logits, trunk = tfm.prefill(lm, np.arange(prompt)[None] % hcfg.vocab,
                                    max_len=prompt + 8)
        cache = fork_model_cache(trunk, 2)
        drun = runners.DecodeRunner(lm)
        eager, graph = cache, cache
        tok = logits.argmax(-1).repeat_interleave(2, 0)
        for i in range(6):
            want, eager = tfm.decode_step(lm, eager, tok, prompt + i)
            got, graph = drun(graph, tok, prompt + i)
            assert torch.equal(got, want), (arch, i)
            for a, b in zip(kvcache._leaves(graph), kvcache._leaves(eager)):
                assert torch.equal(a, b), (arch, i)
            tok = want.argmax(-1)
