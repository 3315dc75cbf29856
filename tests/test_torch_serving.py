"""The PyTorch port's serving slice held against the JAX package.

``SageServingEngine(..., device="cpu").step()`` at smoke size against the
JAX engine on its kernel routes (``attn_impl="pallas"``,
``step_impl="fused"``, Pallas in interpret mode on the CPU), with the
same bridged weights and the JAX-drawn initial noise handed over through
``noise_fn``.  Discrete outputs must match exactly; images within a
stated tolerance.  Also: resumed segments equal a one-shot run inside the
port, ``shared_sample`` (the broadcast launch shape) against JAX, the
port's import isolation, and the device rule.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SageConfig as JaxSageConfig
from repro.config import get_config as jax_get_config
from repro.config import replace as jax_replace
from repro.core.schedule import make_schedule as jax_make_schedule
from repro.core.shared_sampling import shared_sample as jax_shared_sample
from repro.models import dit as jax_dit
from repro.models import text_encoder as jax_te
from repro.models import vae as jax_vae
from repro.serving.engine import SageServingEngine as JaxEngine
from repro_torch import weights
from repro_torch.config import SageConfig, get_config, replace
from repro_torch.core import shared_sampling as ss
from repro_torch.core.schedule import make_schedule
from repro_torch.examples import quickstart
from repro_torch.kernels import dispatch
from repro_torch.launch import train as lm_train
from repro_torch.models import text_encoder as te
from repro_torch.models.dit import DiT
from repro_torch.serving import packing
from repro_torch.serving.engine import SageServingEngine
from repro_torch.serving.scheduler import RequestScheduler

ROOT = Path(__file__).resolve().parents[1]

# f32 on both sides, but the first DDIM step divides by alpha_T ~ 1e-4:
# the last-bit eps differences between the frameworks' summation orders
# grow ~1e4x on the elements inside the x0 clip (observed max abs error
# ~1e-4 on images in [-1, 1], on a few elements of 12288)
RTOL, ATOL = 1e-3, 1e-3

PROMPTS = [
    "a red circle on a white background",
    "a tall green tree in a field at dawn",
    "a small red circle on a white background",
    "a tall green tree in a field at dusk",
    "a red circle on a light white background",
    "a green tree in a wide field at dawn",
]


def randomized(init, *args, seed):
    """Seeded random values for every leaf of ``init(*args)``'s pytree
    (shapes only are traced, nothing runs): 0.1 for vectors, 1/sqrt(fan_in)
    for matrices and HWIO convs, so no adaLN gate or norm stays at its zero
    init."""
    rng = np.random.default_rng(seed)

    def draw(x):
        fan_in = int(np.prod(x.shape[:-1])) if len(x.shape) == 4 else \
            (x.shape[-2] if len(x.shape) >= 2 else 0)
        std = fan_in ** -0.5 if fan_in else 0.1
        return (rng.standard_normal(x.shape) * std).astype(np.float32)
    return jax.tree.map(draw, jax.eval_shape(lambda: init(*args)))


@pytest.fixture(scope="module")
def bridged():
    """Seeded random weights for the DiT, text tower and VAE (numpy), and
    the f32 smoke configs of both packages."""
    jcfg = jax_replace(jax_get_config("sage-dit", smoke=True),
                       dtype="float32")
    tcfg = replace(get_config("sage-dit", smoke=True), dtype="float32")
    jtc = jax_te.text_cfg(dim=jcfg.cond_dim, layers=2)
    tc = replace(te.text_cfg(dim=tcfg.cond_dim, layers=2),
                 attn_impl="kernel")
    key = jax.random.PRNGKey(0)
    return dict(
        jcfg=jcfg, tcfg=tcfg, jtc=jtc, tc=tc,
        dit=randomized(jax_dit.init_params, jcfg, key, seed=1),
        text=randomized(jax_te.init_text, key, jtc, seed=2),
        vae=randomized(jax_vae.init_params, key, seed=3))


def _sage(**kw):
    base = dict(total_steps=4, share_ratio=0.5, guidance_scale=2.0,
                tau_min=0.6)
    base.update(kw)
    return base


def test_engine_step_matches_jax(bridged):
    b = bridged
    jeng = JaxEngine(b["jcfg"], JaxSageConfig(**_sage()),
                     jax.tree.map(jnp.asarray, b["dit"]),
                     jax.tree.map(jnp.asarray, b["text"]), b["jtc"],
                     vae_params=jax.tree.map(jnp.asarray, b["vae"]),
                     group_size=4, attn_impl="pallas", step_impl="fused")
    launch_key = jeng.scheduler._launch_key

    def jax_noise(gid, shape):
        return torch.tensor(np.asarray(jax.random.normal(
            jax.random.fold_in(launch_key, gid), shape, jnp.float32)))

    teng = SageServingEngine(
        SageConfig(**_sage()),
        weights.dit_from_jax(b["dit"], b["tcfg"], device="cpu"),
        weights.text_from_jax(b["text"], b["tc"], device="cpu"),
        weights.vae_from_jax(b["vae"], device="cpu"), group_size=4,
        attn_impl="kernel", step_impl="fused", noise_fn=jax_noise,
        device="cpu")
    for eng in (jeng, teng):
        eng.submit(PROMPTS)
    want = jeng.step(adaptive=True)
    got = teng.step(adaptive=True)

    assert len(got) == len(want) == len(PROMPTS)
    assert ([(c.prompt, c.group_id, c.nfe_share) for c in got]
            == [(c.prompt, c.group_id, c.nfe_share) for c in want])
    assert len({c.group_id for c in got}) > 1          # really grouped
    for k in ("nfe", "nfe_independent", "launches", "pack_rows",
              "pack_pad_rows", "requests", "completed"):
        assert teng.stats[k] == jeng.stats[k], k
    assert teng.cost_saving == pytest.approx(jeng.cost_saving)
    for g, w in zip(got, want):
        assert g.image.shape == w.image.shape == (64, 64, 3)
        np.testing.assert_allclose(g.image, np.asarray(w.image), rtol=RTOL,
                                   atol=ATOL)


def test_shared_sample_matches_jax(bridged):
    """``shared_sample`` with a padded (K=2, N=2) packing: the broadcast
    scalar launch of the fused step."""
    b = bridged
    jcfg = jax_replace(b["jcfg"], attn_impl="pallas")
    sage_kw = _sage(total_steps=3, share_ratio=0.34)
    rng = np.random.default_rng(11)
    K, N, H = 2, 2, jcfg.latent_size
    cond = rng.standard_normal((K, N, jcfg.cond_len, jcfg.cond_dim)
                               ).astype(np.float32)
    mask = np.array([[1, 1], [1, 0]], np.float32)
    null = np.zeros((jcfg.cond_len, jcfg.cond_dim), np.float32)
    key = jax.random.PRNGKey(5)
    jp = jax.tree.map(jnp.asarray, b["dit"])
    want = jax_shared_sample(
        lambda z, t, c: jax_dit.forward(jp, jcfg, z, t, c),
        jax_make_schedule(1000), JaxSageConfig(**sage_kw, step_impl="fused"),
        key, jnp.asarray(cond), jnp.asarray(mask), jnp.asarray(null),
        (H, H, jcfg.latent_channels))
    noise = np.array(jax.random.normal(key, (K, H, H, jcfg.latent_channels),
                                       jnp.float32))
    model = weights.dit_from_jax(b["dit"], replace(b["tcfg"],
                                                   attn_impl="kernel"),
                                 device="cpu")
    got = ss.shared_sample(model, make_schedule(1000),
                           SageConfig(**sage_kw, step_impl="fused"),
                           torch.from_numpy(noise), torch.from_numpy(cond),
                           torch.from_numpy(mask), torch.from_numpy(null),
                           device="cpu")
    assert got["nfe"] == float(want["nfe"])
    indep = ss.independent_sample(
        model, make_schedule(1000), SageConfig(**sage_kw, step_impl="fused"),
        torch.from_numpy(noise), torch.from_numpy(cond[0]),
        torch.from_numpy(null), device="cpu")
    assert indep["latents"].shape == (N, H, H, jcfg.latent_channels)
    assert indep["nfe"] == 2 * N * sage_kw["total_steps"]
    np.testing.assert_allclose(got["latents"].numpy(),
                               np.asarray(want["latents"]), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("step_impl", ["reference", "fused"])
def test_resumed_segments_equal_one_shot(step_impl):
    """Inside the port: a phase advanced in pieces from a packed carry
    with per-row step indices equals one segment over the same steps."""
    cfg = replace(get_config("sage-dit", smoke=True), dtype="float32")
    model = DiT(cfg, device="cpu",
                generator=torch.Generator().manual_seed(3))
    sched = make_schedule(1000)
    sage = SageConfig(**_sage(total_steps=6), step_impl=step_impl)
    g = torch.Generator().manual_seed(4)
    H, C, Lc, dc = cfg.latent_size, cfg.latent_channels, cfg.cond_len, \
        cfg.cond_dim
    cbar = torch.randn((2, Lc, dc), generator=g)
    null = torch.zeros((Lc, dc))
    carry = ss.SampleCarry(torch.randn((2, H, H, C), generator=g),
                           torch.zeros((2, H, H, C)),
                           torch.tensor([0, 1]))
    one = ss.shared_phase(model, sched, sage, carry, cbar, null, 3)
    two = ss.shared_phase(model, sched, sage,
                          ss.shared_phase(model, sched, sage, carry, cbar,
                                          null, 1), cbar, null, 2)
    assert torch.equal(one.z, two.z)
    assert torch.equal(one.step_idx, torch.tensor([3, 4]))

    N = 3
    fork = ss.fork_carry(one, N)
    fork = fork._replace(step_idx=one.step_idx.repeat_interleave(N))
    cond = torch.randn((2 * N, Lc, dc), generator=g)
    mask = torch.ones((2, N))
    one = ss.branch_phase(model, sched, sage, fork, cond, mask, null, 2,
                          fork.step_idx)
    two = ss.branch_phase(model, sched, sage,
                          ss.branch_phase(model, sched, sage, fork, cond,
                                          mask, null, 1, fork.step_idx),
                          cond, mask, null, 1, fork.step_idx)
    assert torch.equal(one.z, two.z)
    assert ss.branch_phase_nfe(mask, 2, False) == 2 * 2 * 2 * N


def test_engines_sharing_a_dit_keep_their_own_attn_impl(monkeypatch):
    """Two engines on one DiT, built on the kernel route and then the naive
    one: each step runs its own route (the scheduler's copy of the config,
    handed to every forward), and the DiT module is never written."""
    cfg = replace(get_config("sage-dit", smoke=True), dtype="float32")
    dit = DiT(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    text = te.TextTower(replace(te.text_cfg(dim=cfg.cond_dim, layers=1),
                                attn_impl="chunked"), device="cpu")
    engines = {impl: SageServingEngine(
        SageConfig(**_sage(total_steps=2)), dit, text, attn_impl=impl,
        device="cpu") for impl in ("kernel", "naive")}
    assert dit.cfg is cfg
    seen = []
    attention = dispatch.attention

    def spy(*args, impl, **kw):
        seen.append(impl)
        return attention(*args, impl=impl, **kw)
    monkeypatch.setattr(dispatch, "attention", spy)
    for impl in ("kernel", "naive", "kernel"):
        eng = engines[impl]
        seen.clear()
        eng.submit(PROMPTS[:3])
        assert len(eng.step()) == 3
        assert eng.scheduler.cfg.attn_impl == impl
        # the text tower keeps its own route; every DiT forward takes impl
        assert set(seen) == {"chunked", impl}, seen
    assert dit.cfg is cfg


# a static width of 0; modules on another device than the engine's
@pytest.mark.parametrize("bad", [dict(group_size=0), dict(device="meta")])
def test_failed_engine_construction_leaves_the_dit_config(bad):
    cfg = get_config("sage-dit", smoke=True)
    dit = DiT(cfg, device="cpu")
    text = te.TextTower(te.text_cfg(dim=16, layers=1), device="cpu")
    kw = dict(attn_impl="kernel", step_impl="fused", device="cpu")
    kw.update(bad)
    with pytest.raises(ValueError):
        SageServingEngine(SageConfig(), dit, text, **kw)
    assert dit.cfg is cfg and dit.cfg.attn_impl == "naive"


def test_packing_pads_and_aligns():
    """Branch packs pad each group to the static width with member-0
    replicas; phase alignment gives one bucket per phase."""
    class G:
        def __init__(self, n, state, steps_done, n_shared):
            self.members = list(range(n))
            self.state, self.steps_done, self.n_shared = (state, steps_done,
                                                          n_shared)
            self.total_steps, self.shape, self.sampler = 6, (2, 2, 1), "ddim"
            z = torch.arange(n, dtype=torch.float32)[:, None, None, None
                                                     ].expand(n, 2, 2, 1)
            self.carry = ss.SampleCarry(z.clone(), z.clone(),
                                        torch.tensor(steps_done))
            self.cond_flat = torch.zeros((n, 3, 2))
    gs = [G(2, "branch", 3, 3), G(3, "branch", 4, 2), G(1, "shared", 1, 3)]
    packs = packing.build_packs(gs, 6, align_phases=True)
    assert [(k.phase, k.n_steps, len(v)) for k, v in packs] == [
        ("branch", 2, 2), ("shared", 2, 1)]
    carry, cond, mask, fork = packing.pack_branch(gs[:2], 4)
    assert carry.z[:, 0, 0, 0].tolist() == [0, 1, 0, 0, 0, 1, 2, 0]
    assert mask.tolist() == [[1, 1, 0, 0], [1, 1, 1, 0]]
    assert carry.step_idx.tolist() == [3] * 4 + [4] * 4
    assert fork.tolist() == [3] * 4 + [2] * 4
    assert packing.pad_stats(gs[:2], 4) == (8, 3)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    # the streaming surface: the scheduler and its own policies and faults
    serving = ROOT / "src" / "repro_torch" / "serving"
    for name in ("scheduler.py", "policies.py", "faults.py", "engine.py"):
        assert serving / name in files, name
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    cfg = get_config("sage-dit", smoke=True)
    with pytest.raises(RuntimeError, match="cuda"):
        DiT(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        te.TextTower(te.text_cfg(dim=16, layers=1))
    model = DiT(cfg, device="cpu")
    text = te.TextTower(te.text_cfg(dim=16, layers=1), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        SageServingEngine(SageConfig(), model, text)
    with pytest.raises(RuntimeError, match="cuda"):
        RequestScheduler(SageConfig(), model, text)
    # a streaming scheduler runs where its engine runs, and asked for the
    # card it raises too
    eng = SageServingEngine(SageConfig(), model, text, device="cpu")
    assert eng.streaming_scheduler().device.type == "cpu"
    with pytest.raises(RuntimeError, match="cuda"):
        eng.streaming_scheduler(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ss.shared_sample(model, make_schedule(10), SageConfig(total_steps=2),
                         torch.zeros(1, 8, 8, 4), torch.zeros(1, 1, 48, 64),
                         torch.ones(1, 1), torch.zeros(48, 64))
    # the LM training launcher and the quickstart, called as a user would
    with pytest.raises(RuntimeError, match="cuda"):
        lm_train.main(["--arch", "mamba2-780m", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        quickstart.main([])
