"""The PyTorch port's DPM-Solver++(2M), shared-uncond CFG, mixed-solver
stacks and per-row step grids held against the JAX package.

Kernel twins (``dpmpp_step``, ``group_mean``) against the JAX kernels run
in interpret mode on the CPU, as ``tests/test_kernel_fused_dpmpp.py`` runs
them; the sampler math, the segment API (``shared_phase`` /
``branch_phase`` with ``row_samplers`` and 2-D grids), ``shared_sample`` /
``independent_sample`` and the engine's ``step()`` against the JAX
package's on the same numpy-seeded inputs.  Inside the port: resumed
segments equal a one-shot run, and packed rows equal per-group runs,
bitwise.
"""
from dataclasses import replace as dc_replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SageConfig as JaxSageConfig
from repro.core import samplers as jax_samplers
from repro.core import shared_sampling as jss
from repro.core.schedule import make_schedule as jax_make_schedule
from repro.kernels.dpmpp_step.ops import fused_cfg_dpmpp_step as jax_dpmpp
from repro.kernels.group_mean.ops import masked_group_mean as jax_gmean
from repro.models import dit as jax_dit
from repro.serving import packing as jax_packing
from repro.serving.engine import SageServingEngine as JaxEngine
from repro_torch import weights
from repro_torch.config import SageConfig, replace
from repro_torch.core import samplers
from repro_torch.core import shared_sampling as ss
from repro_torch.core.schedule import Schedule, ddim_timesteps, make_schedule
from repro_torch.kernels import dispatch
from repro_torch.kernels._tiles import bcast_rows
from repro_torch.kernels.dpmpp_step import ops as dpmpp_ops
from repro_torch.kernels.dpmpp_step.ref import fused_cfg_dpmpp_step_ref
from repro_torch.kernels.group_mean import ops as gmean_ops
from repro_torch.kernels.group_mean.ref import masked_group_mean_ref
from repro_torch.serving import packing
from repro_torch.serving import scheduler as tsched
from repro_torch.serving.engine import SageServingEngine
from test_torch_serving import PROMPTS, _sage, bridged  # noqa: F401

# step kernels, the JAX suite's tolerances (tests/test_kernels.py): f32
# differs at the last bit (expm1 / log implementations), bf16 by one
# rounding of the output
STEP_TOL = {np.float32: 1e-5, "bfloat16": 3e-2}
# group mean: f32 sums of a few products, in another order
GMEAN_TOL = 1e-6
# trajectories: f32, but the first step divides by alpha_T ~ 1e-4, so
# last-bit differences grow ~1e4x on elements inside the x0 clip (as
# tests/test_torch_serving.py)
TRAJ_TOL = 1e-3

SCHED_J = jax_make_schedule(1000)
SCHED_T = make_schedule(1000)


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# dpmpp_step: the plain twin against the JAX kernel
# ---------------------------------------------------------------------------

# per-row stacks whose first half sits at its fork (step 9 of 30, the 0.3
# share ratio's; history warm-up) and whose second half is mid-branch: the
# shared phase's 2 trunks and the branch phase's 2 groups x 4 members
FORK_STACKS = {"fork2": 2, "fork8": 8}


def _dpmpp_inputs(rng, per_row, B):
    grid = ddim_timesteps(1000, 30)
    if per_row in FORK_STACKS:
        i = np.repeat([9, 12], B // 2)
        first = i == 9
    elif per_row:
        i = np.array([9, 9, 12, 12, 0, 29][:B])
        first = np.array([True, True, False, False, True, False][:B])
    else:
        i, first = np.int64(12), np.bool_(False)
    return grid[i], grid[i + 1], grid[np.maximum(i - 1, 0)], first


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_x0", [0.0, 3.0])
@pytest.mark.parametrize("per_row", [False, True, *FORK_STACKS])
def test_dpmpp_ref_matches_jax_kernel(per_row, clip_x0, dtype):
    """Broadcast and per-row launches, warm-up mixed across rows (rows at
    their fork next to rows mid-phase), both outputs."""
    rng = np.random.default_rng(hash((per_row, clip_x0, dtype)) % 2**32)
    shape = (FORK_STACKS.get(per_row, 6), 9, 7, 3)
    z, eu, ec, ep = (_rand(rng, shape) for _ in range(4))
    t, tn, tp, first = _dpmpp_inputs(rng, per_row, shape[0])
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jsc = jax_samplers.dpmpp_scalars(SCHED_J, jnp.asarray(t), jnp.asarray(tn),
                                     jnp.asarray(tp))
    want = jax_dpmpp(*(jnp.asarray(x, jdt) for x in (z, eu, ec, ep)), 7.5,
                     *jsc, jnp.asarray(first), clip_x0=clip_x0)
    tsc = samplers.dpmpp_scalars(SCHED_T, torch.as_tensor(t),
                                 torch.as_tensor(tn), torch.as_tensor(tp))
    args = [torch.from_numpy(x).to(tdt) for x in (z, eu, ec, ep)]
    got = fused_cfg_dpmpp_step_ref(*args, 7.5, *tsc, torch.as_tensor(first),
                                   clip_x0=clip_x0)
    tol = STEP_TOL[np.float32 if dtype == "float32" else "bfloat16"]
    for g, w in zip(got, want):
        assert g.dtype == tdt
        np.testing.assert_allclose(_np(g), _np(w), rtol=tol, atol=tol)
    # the kernel route on a CPU tensor is exactly the plain version
    before = dpmpp_ops.fused_cfg_dpmpp_step.launches
    names = ("a_t", "s_t", "a_n", "s_n", "lam", "lam_p", "lam_n")
    routed = dispatch.cfg_dpmpp_step(
        *args, guidance=7.5, is_first=torch.as_tensor(first),
        clip_x0=clip_x0, impl="fused", **dict(zip(names, tsc)))
    assert all(torch.equal(r, g) for r, g in zip(routed, got))
    assert dpmpp_ops.fused_cfg_dpmpp_step.launches == before


def test_dpmpp_warmup_ignores_a_garbage_history():
    """At a warm-up row the history term is exactly zero whatever eps_prev
    holds (here inf), and lam_p == lam (t_prev aliases t at step 0)."""
    rng = np.random.default_rng(0)
    z, eu, ec = (torch.from_numpy(_rand(rng, (2, 4, 4, 4))) for _ in range(3))
    ep = torch.full_like(z, float("inf"))
    t = torch.tensor([1000, 500])
    sc = samplers.dpmpp_scalars(SCHED_T, t, torch.tensor([967, 467]), t)
    zn, eps = fused_cfg_dpmpp_step_ref(z, eu, ec, ep, 3.0, *sc,
                                       torch.tensor([True, True]), 3.0)
    first_order = samplers.dpmpp_2m_step(SCHED_T, z, t,
                                         torch.tensor([967, 467]), eps,
                                         clip_x0=3.0)
    assert torch.isfinite(zn).all()
    torch.testing.assert_close(zn, first_order, rtol=0, atol=1e-6)


def test_dpmpp_wrapper_rejects_mismatched_shapes():
    z = torch.zeros(2, 4, 4, 4)
    with pytest.raises(ValueError, match="shape mismatch"):
        dpmpp_ops.fused_cfg_dpmpp_step(z, z, z, torch.zeros(2, 4, 4, 3), 1.0,
                                       *(0.5,) * 7, False)
    with pytest.raises(ValueError, match="unknown step impl"):
        dispatch.cfg_dpmpp_step(z, z, z, z, guidance=1.0, a_t=0.5, s_t=0.5,
                                a_n=0.5, s_n=0.5, lam=0.0, lam_p=0.0,
                                lam_n=0.1, is_first=False, impl="magic")


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("with_history", [False, True])
@pytest.mark.parametrize("clip_x0", [0.0, 3.0])
def test_dpmpp_sampler_math_matches_jax(per_row, with_history, clip_x0):
    """``dpmpp_scalars`` and ``dpmpp_2m_step`` against the JAX package's."""
    rng = np.random.default_rng(17 + per_row + 2 * with_history)
    z, eps, eps_prev = (_rand(rng, (4, 6, 6, 4)) for _ in range(3))
    t, tn, tp, _ = _dpmpp_inputs(rng, per_row, 4)
    jt = [jnp.asarray(v) for v in (t, tn, tp)]
    tt = [torch.as_tensor(v) for v in (t, tn, tp)]
    for a, b in zip(samplers.dpmpp_scalars(SCHED_T, *tt),
                    jax_samplers.dpmpp_scalars(SCHED_J, *jt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    hist = dict(eps_prev=eps_prev, t_prev=tp) if with_history else {}
    want = jax_samplers.dpmpp_2m_step(
        SCHED_J, jnp.asarray(z), jt[0], jt[1], jnp.asarray(eps),
        **{k: jnp.asarray(v) for k, v in hist.items()}, clip_x0=clip_x0)
    got = samplers.dpmpp_2m_step(
        SCHED_T, torch.from_numpy(z), tt[0], tt[1], torch.from_numpy(eps),
        **{k: torch.as_tensor(v) for k, v in hist.items()}, clip_x0=clip_x0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=STEP_TOL[np.float32],
                               atol=STEP_TOL[np.float32])


# ---------------------------------------------------------------------------
# group_mean: the plain twin against the JAX kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 4, 8, 8, 4), (2, 3, 77, 5),
                                   (3, 1, 6, 5), (2, 8, 4, 4, 4),
                                   (2, 64, 3, 7)])
def test_group_mean_ref_matches_jax_kernel(shape, dtype):
    """A padded member (mask 0) and an all-zero mask row (count clamped
    at 1e-6: the mean is 0); N from 1 (the padded member is its whole
    group) to 64, the kernel's most."""
    rng = np.random.default_rng(sum(shape))
    x = _rand(rng, shape)
    mask = np.ones(shape[:2], np.float32)
    mask[0, -1] = 0.0
    mask[1] = 0.0
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jax_gmean(jnp.asarray(x, jdt), jnp.asarray(mask))
    tx = torch.from_numpy(x).to(tdt)
    got = masked_group_mean_ref(tx, torch.from_numpy(mask))
    assert got.dtype == tdt and tuple(got.shape) == (shape[0],) + shape[2:]
    tol = GMEAN_TOL if dtype == "float32" else STEP_TOL["bfloat16"]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    assert not got[1].any()
    before = gmean_ops.masked_group_mean.launches
    routed = dispatch.group_mean(tx, torch.from_numpy(mask), impl="kernel")
    assert torch.equal(routed, got)
    assert gmean_ops.masked_group_mean.launches == before
    with pytest.raises(ValueError, match="unknown group_mean impl"):
        dispatch.group_mean(tx, torch.from_numpy(mask), impl="pallas")
    with pytest.raises(ValueError, match="does not match"):
        gmean_ops.masked_group_mean(tx, torch.ones(shape[0], shape[1] + 1))


# ---------------------------------------------------------------------------
# shared_sample / independent_sample with DPM-Solver++ against JAX
# ---------------------------------------------------------------------------

def _sample_setup(b):
    from repro.config import replace as jax_replace
    jcfg = jax_replace(b["jcfg"], attn_impl="pallas")
    rng = np.random.default_rng(23)
    K, N, H = 2, 2, jcfg.latent_size
    cond = _rand(rng, (K, N, jcfg.cond_len, jcfg.cond_dim))
    mask = np.array([[1, 1], [1, 0]], np.float32)
    null = np.zeros((jcfg.cond_len, jcfg.cond_dim), np.float32)
    jp = jax.tree.map(jnp.asarray, b["dit"])
    model = weights.dit_from_jax(b["dit"], replace(b["tcfg"],
                                                   attn_impl="kernel"),
                                 device="cpu")
    return (jcfg, (K, N, H), cond, mask, null,
            lambda z, t, c: jax_dit.forward(jp, jcfg, z, t, c), model)


@pytest.mark.parametrize("step_impl", ["reference", "fused"])
@pytest.mark.parametrize("shared_uncond", [False, True])
def test_shared_sample_dpmpp_matches_jax(bridged, shared_uncond,  # noqa: F811
                                         step_impl):
    """Alg. 1 with DPM-Solver++(2M) (warm-up at step 0 and at the fork),
    a padded (K=2, N=2) packing, shared-uncond CFG on and off."""
    jcfg, (K, N, H), cond, mask, null, jeps, model = _sample_setup(bridged)
    kw = _sage(total_steps=4, share_ratio=0.5, sampler="dpmpp",
               shared_uncond_cfg=shared_uncond, step_impl=step_impl)
    key = jax.random.PRNGKey(6)
    shape = (H, H, jcfg.latent_channels)
    want = jss.shared_sample(jeps, SCHED_J, JaxSageConfig(**kw), key,
                             jnp.asarray(cond), jnp.asarray(mask),
                             jnp.asarray(null), shape)
    noise = np.array(jax.random.normal(key, (K,) + shape, jnp.float32))
    got = ss.shared_sample(model, SCHED_T, SageConfig(**kw),
                           torch.from_numpy(noise), torch.from_numpy(cond),
                           torch.from_numpy(mask), torch.from_numpy(null),
                           device="cpu")
    assert got["nfe"] == float(want["nfe"])
    np.testing.assert_allclose(got["latents"].numpy(),
                               np.asarray(want["latents"]), rtol=TRAJ_TOL,
                               atol=TRAJ_TOL)


@pytest.mark.parametrize("step_impl", ["reference", "fused"])
def test_independent_sample_dpmpp_matches_jax(bridged,  # noqa: F811
                                              step_impl):
    jcfg, (K, N, H), cond, _, null, jeps, model = _sample_setup(bridged)
    kw = _sage(total_steps=3, sampler="dpmpp", step_impl=step_impl)
    key = jax.random.PRNGKey(8)
    shape = (H, H, jcfg.latent_channels)
    want = jss.independent_sample(jeps, SCHED_J, JaxSageConfig(**kw), key,
                                  jnp.asarray(cond[0]), jnp.asarray(null),
                                  shape)
    noise = np.array(jax.random.normal(key, (N,) + shape, jnp.float32))
    got = ss.independent_sample(model, SCHED_T, SageConfig(**kw),
                                torch.from_numpy(noise),
                                torch.from_numpy(cond[0]),
                                torch.from_numpy(null), device="cpu")
    assert got["nfe"] == float(want["nfe"])
    np.testing.assert_allclose(got["latents"].numpy(),
                               np.asarray(want["latents"]), rtol=TRAJ_TOL,
                               atol=TRAJ_TOL)


# ---------------------------------------------------------------------------
# the engine: dpmpp + shared-uncond + fused against the JAX engine
# ---------------------------------------------------------------------------

def test_engine_step_dpmpp_shared_uncond_matches_jax(bridged,  # noqa: F811
                                                     monkeypatch):
    b = bridged
    kw = _sage(total_steps=6, sampler="dpmpp", shared_uncond_cfg=True)
    jeng = JaxEngine(b["jcfg"], JaxSageConfig(**kw),
                     jax.tree.map(jnp.asarray, b["dit"]),
                     jax.tree.map(jnp.asarray, b["text"]), b["jtc"],
                     vae_params=jax.tree.map(jnp.asarray, b["vae"]),
                     group_size=4, branch_buckets=(0.4, 0.45),
                     attn_impl="pallas", step_impl="fused")
    launch_key = jeng.scheduler._launch_key

    def jax_noise(gid, shape):
        return torch.tensor(np.asarray(jax.random.normal(
            jax.random.fold_in(launch_key, gid), shape, jnp.float32)))

    teng = SageServingEngine(
        SageConfig(**kw),
        weights.dit_from_jax(b["dit"], b["tcfg"], device="cpu"),
        weights.text_from_jax(b["text"], b["tc"], device="cpu"),
        weights.vae_from_jax(b["vae"], device="cpu"), group_size=4,
        branch_buckets=(0.4, 0.45), attn_impl="kernel", step_impl="fused",
        noise_fn=jax_noise, device="cpu")
    # record, per branch segment, the rows' fork steps and whether each row
    # starts at its fork
    segs = []
    branch = tsched.branch_segment

    def spy(eps_fn, sched, sage, carry, cond, mask, null, n, fork, *rest):
        segs.append((tuple(fork.tolist()),
                     tuple((carry.step_idx == fork).tolist())))
        return branch(eps_fn, sched, sage, carry, cond, mask, null, n, fork,
                      *rest)
    monkeypatch.setattr(tsched, "branch_segment", spy)
    for eng in (jeng, teng):
        eng.submit(PROMPTS)
    want = jeng.step(adaptive=True)
    got = teng.step(adaptive=True)

    # the adaptive buckets (min similarity 0.84 and 0.90 -> beta 0.4 and
    # 0.45) gave the two groups forks at steps 2 and 3, so their branch
    # histories restart in different segments.  The phase-aligned drain
    # advances every shared group alike, so each branch pack starts with
    # all its rows at their fork (per-row warm-up mixes in the segment
    # tests below).
    assert sorted({f for forks, _ in segs for f in forks}) == [2, 3], segs
    assert all(all(w) for _, w in segs), segs
    assert ([(c.prompt, c.group_id, c.nfe_share) for c in got]
            == [(c.prompt, c.group_id, c.nfe_share) for c in want])
    for k in teng.stats:
        assert teng.stats[k] == jeng.stats[k], k
    assert teng.cost_saving == pytest.approx(jeng.cost_saving)
    for g, w in zip(got, want):
        assert g.image.shape == w.image.shape == (64, 64, 3)
        np.testing.assert_allclose(g.image, np.asarray(w.image),
                                   rtol=TRAJ_TOL, atol=TRAJ_TOL)


# ---------------------------------------------------------------------------
# segments: resumption, mixed solvers, 2-D grids (a row-independent toy
# denoiser, so packed and per-group rows can be compared bitwise)
# ---------------------------------------------------------------------------

def _toy_eps_torch(z, t, c):
    return (0.5 * torch.sin(z)
            + (torch.cos(t / 1000.0) * c[:, 0, 0])[:, None, None, None])


def _toy_eps_jax(z, t, c):
    return (0.5 * jnp.sin(z)
            + (jnp.cos(t / 1000.0) * c[:, 0, 0])[:, None, None, None])


class _G:
    """A duck-typed in-flight group for the packing helpers."""

    def __init__(self, total_steps, sampler, n=1, state="shared",
                 steps_done=0):
        self.total_steps, self.sampler = total_steps, sampler
        self.members = list(range(n))
        self.state, self.steps_done, self.n_shared = state, steps_done, 2
        self.shape = (4, 4, 4)


@pytest.mark.parametrize("shared_uncond", [False, True])
@pytest.mark.parametrize("step_impl", ["reference", "fused"])
def test_dpmpp_segments_resume_across_boundaries_and_fork(step_impl,
                                                          shared_uncond):
    """Inside the port: a DPM-Solver++ trajectory cut into segments (cuts
    inside both phases, and the fork between them, where the history
    restarts) equals the one-shot segments bitwise."""
    sage = SageConfig(total_steps=8, guidance_scale=3.0, sampler="dpmpp",
                      shared_uncond_cfg=shared_uncond, step_impl=step_impl)
    g = torch.Generator().manual_seed(5)
    K, N, H, Lc, dc = 2, 3, 4, 3, 2
    cbar = torch.randn((K, Lc, dc), generator=g)
    cond = torch.randn((K * N, Lc, dc), generator=g)
    null = torch.zeros((Lc, dc))
    mask = torch.tensor([[1.0, 1.0, 0.0], [1.0, 1.0, 1.0]])
    start = ss.init_carry(torch.randn((K, H, H, 4), generator=g))

    def run(cuts_shared, cuts_branch):
        c = start
        for n in cuts_shared:
            c = ss.shared_phase(_toy_eps_torch, SCHED_T, sage, c, cbar,
                                null, n)
        c = ss.fork_carry(c, N)
        fork = c.step_idx.expand(K * N)
        c = c._replace(step_idx=fork)
        for n in cuts_branch:
            c = ss.branch_phase(_toy_eps_torch, SCHED_T, sage, c, cond, mask,
                                null, n, fork)
        return c

    one = run([3], [5])
    two = run([1, 2], [2, 1, 2])
    assert torch.equal(one.z, two.z) and torch.equal(one.eps_prev,
                                                     two.eps_prev)
    assert one.step_idx.tolist() == [8] * (K * N)
    assert torch.isfinite(one.z).all()


def test_pack_grid_and_samplers_match_jax():
    gs = [_G(6, "ddim"), _G(4, "dpmpp"), _G(6, "dpmpp")]
    for groups, width in ((gs, None), (gs, 3), (gs[:1], 2),
                          ([gs[0], gs[2]], 4)):
        np.testing.assert_array_equal(
            packing.pack_grid(groups, 1000, width).numpy(),
            np.asarray(jax_packing.pack_grid(groups, 1000, width)))
        assert (packing.pack_samplers(groups, width)
                == jax_packing.pack_samplers(groups, width))
    assert packing.pack_grid(gs, 1000, 3).shape == (9, 7)
    assert packing.pack_samplers([gs[1], gs[2]]) is None
    # mix_samplers collapses the solver axis of the pack key to "*"
    gs += [_G(6, "ddim", state="branch", steps_done=3)]
    for mix in (False, True):
        for align in (False, True):
            got = packing.build_packs(gs, 2, mix, align)
            want = jax_packing.build_packs(gs, 2, mix, align)
            assert ([(tuple(k), [id(g) for g in v]) for k, v in got]
                    == [(tuple(k), [id(g) for g in v]) for k, v in want])
    assert [k.sampler for k, _ in packing.build_packs(gs, 2, True)] == [
        packing.MIXED, packing.MIXED]


def _mixed_groups():
    # two groups of different step budgets and solvers
    return [_G(4, "dpmpp", n=2), _G(6, "ddim", n=2)]


@pytest.mark.parametrize("step_impl", ["reference", "fused"])
def test_shared_phase_mixed_solvers_2d_grid(step_impl):
    """A packed trunk stack of a 4-step dpmpp group and a 6-step ddim group
    (row_samplers + a 2-D grid): against JAX's shared_phase, and equal
    bitwise to each group run alone on its own 1-D grid."""
    gs = _mixed_groups()
    rng = np.random.default_rng(31)
    K, H, Lc, dc = 2, 4, 3, 2
    z = _rand(rng, (K, H, H, 4))
    ep = _rand(rng, (K, H, H, 4))
    cbar = _rand(rng, (K, Lc, dc))
    null = np.zeros((Lc, dc), np.float32)
    step = np.array([0, 1])
    kw = dict(total_steps=6, guidance_scale=3.0, step_impl=step_impl)
    rs, grid = packing.pack_samplers(gs), packing.pack_grid(gs, 1000)
    assert grid.ndim == 2 and rs == ("dpmpp", "ddim")
    want = jss.shared_phase(
        _toy_eps_jax, SCHED_J, JaxSageConfig(**kw),
        jss.SampleCarry(jnp.asarray(z), jnp.asarray(ep), jnp.asarray(step)),
        jnp.asarray(cbar), jnp.asarray(null), 3, grid=jnp.asarray(grid),
        row_samplers=rs)
    t = torch.from_numpy
    got = ss.shared_phase(_toy_eps_torch, SCHED_T, SageConfig(**kw),
                          ss.SampleCarry(t(z), t(ep), t(step)), t(cbar),
                          t(null), 3, grid=grid, row_samplers=rs)
    for a, b in ((got.z, want.z), (got.eps_prev, want.eps_prev)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TRAJ_TOL,
                                   atol=TRAJ_TOL)
    assert got.step_idx.tolist() == [3, 4]
    for j, grp in enumerate(gs):
        solo = ss.shared_phase(
            _toy_eps_torch, SCHED_T,
            SageConfig(**dict(kw, total_steps=grp.total_steps,
                              sampler=grp.sampler)),
            ss.SampleCarry(t(z[j:j + 1]), t(ep[j:j + 1]),
                           torch.tensor(step[j])), t(cbar[j:j + 1]),
            t(null), 3)
        assert torch.equal(solo.z, got.z[j:j + 1])
        assert torch.equal(solo.eps_prev, got.eps_prev[j:j + 1])


@pytest.mark.parametrize("shared_uncond", [False, True])
@pytest.mark.parametrize("step_impl", ["reference", "fused"])
def test_branch_phase_mixed_solvers_2d_grid(step_impl, shared_uncond):
    """A packed branch stack (width 2) of the same two groups, one at its
    fork and one mid-branch, per-row step and fork indices: against JAX's
    branch_phase, and equal bitwise to each group run alone."""
    gs = _mixed_groups()
    rng = np.random.default_rng(37)
    K, N, H, Lc, dc = 2, 2, 4, 3, 2
    z = _rand(rng, (K * N, H, H, 4))
    ep = _rand(rng, (K * N, H, H, 4))
    cond = _rand(rng, (K * N, Lc, dc))
    null = np.zeros((Lc, dc), np.float32)
    mask = np.ones((K, N), np.float32)
    step = np.array([2, 2, 3, 3])
    fork = np.array([2, 2, 2, 2])
    kw = dict(total_steps=6, guidance_scale=3.0, step_impl=step_impl,
              shared_uncond_cfg=shared_uncond)
    rs, grid = packing.pack_samplers(gs, N), packing.pack_grid(gs, 1000, N)
    want = jss.branch_phase(
        _toy_eps_jax, SCHED_J, JaxSageConfig(**kw),
        jss.SampleCarry(jnp.asarray(z), jnp.asarray(ep), jnp.asarray(step)),
        jnp.asarray(cond), jnp.asarray(mask), jnp.asarray(null), 2,
        jnp.asarray(fork), grid=jnp.asarray(grid), row_samplers=rs)
    t = torch.from_numpy
    got = ss.branch_phase(_toy_eps_torch, SCHED_T, SageConfig(**kw),
                          ss.SampleCarry(t(z), t(ep), t(step)), t(cond),
                          t(mask), t(null), 2, t(fork), grid=grid,
                          row_samplers=rs)
    for a, b in ((got.z, want.z), (got.eps_prev, want.eps_prev)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TRAJ_TOL,
                                   atol=TRAJ_TOL)
    for j, grp in enumerate(gs):
        r = slice(j * N, (j + 1) * N)
        solo = ss.branch_phase(
            _toy_eps_torch, SCHED_T,
            SageConfig(**dict(kw, total_steps=grp.total_steps,
                              sampler=grp.sampler)),
            ss.SampleCarry(t(z[r]), t(ep[r]), torch.tensor(step[r][0])),
            t(cond[r]), t(mask[j:j + 1]), t(null), 2, int(fork[r][0]))
        assert torch.equal(solo.z, got.z[r])
        assert torch.equal(solo.eps_prev, got.eps_prev[r])


def test_uniform_row_samplers_take_the_scalar_path():
    sage = SageConfig(sampler="ddim")
    s2, rs = ss._norm_row_samplers(sage, ("dpmpp", "dpmpp"))
    assert rs is None and s2 == dc_replace(sage, sampler="dpmpp")
    with pytest.raises(ValueError, match="row samplers"):
        ss._row_split(("ddim", "dpmpp"), 3, "cpu")


# ---------------------------------------------------------------------------
# the fused DDIM update gathers its own schedule values: a DDIM-only
# segment through it equals the same segment fed pre-gathered scalars
# ---------------------------------------------------------------------------

def _pregathered_ddim(z, eps_u, eps_c, *, guidance, alphas, sigmas, t,
                      t_next, clip_x0, impl):
    """The fused DDIM update as the port made it before its kernel gathered
    its own values: ``samplers.ddim_scalars`` on the schedule, then the
    plain update from those four scalars, op for op."""
    assert impl == "fused"
    sched = Schedule(alphas, sigmas, alphas.numel() - 1)
    a_t, s_t, a_n, s_n = (bcast_rows(v, z.ndim) for v in
                          samplers.ddim_scalars(sched, t, t_next))
    eps = (eps_u + guidance * (eps_c - eps_u)).float()
    z0 = (z.float() - s_t * eps) / torch.clamp_min(a_t, 1e-6)
    if clip_x0:
        z0 = torch.clamp(z0, -clip_x0, clip_x0)
    return (a_n * z0 + s_n * eps).to(z.dtype)


def _ddim_segment_inputs(kind):
    """(step_idx, grid, fork_idx) of a K = 2, N = 3 stack: one grid position
    for every row (0-dim), per-row positions on the 1-D grid, or per-row
    positions on a 2-D grid of two step budgets."""
    K, N = 2, 3
    if kind == "scalar":
        return (torch.tensor(1), torch.as_tensor(ddim_timesteps(1000, 8)),
                torch.tensor(3), K, N)
    if kind == "per_row":
        return (torch.tensor([1, 2]), torch.as_tensor(ddim_timesteps(1000, 8)),
                torch.tensor([3] * N + [4] * N), K, N)
    grid = packing.pack_grid([_G(8, "ddim"), _G(6, "ddim")], 1000)
    return torch.tensor([1, 0]), grid, torch.tensor([3] * N + [2] * N), K, N


@pytest.mark.parametrize("kind", ["scalar", "per_row", "grid2d"])
def test_ddim_segments_gathering_kernel_equals_pregathered(kind,
                                                           monkeypatch):
    """shared_segment and branch_segment on the fused DDIM route, through
    the wrapper that gathers alphas[t] etc. itself, equal bitwise the same
    segments fed pre-gathered scalars (the gathers are exact)."""
    step, grid, fork, K, N = _ddim_segment_inputs(kind)
    sage = SageConfig(total_steps=8, guidance_scale=3.0, step_impl="fused",
                      clip_x0=3.0)
    g = torch.Generator().manual_seed(43)
    H, Lc, dc = 4, 3, 2
    cbar = torch.randn((K, Lc, dc), generator=g)
    cond = torch.randn((K * N, Lc, dc), generator=g)
    null = torch.zeros((Lc, dc))
    mask = torch.ones((K, N))
    start = ss.init_carry(torch.randn((K, H, H, 4), generator=g))
    start = start._replace(step_idx=step)
    bgrid = grid.repeat_interleave(N, 0) if grid.ndim == 2 else grid

    def run():
        trunk = ss.shared_segment(_toy_eps_torch, SCHED_T, sage, start, cbar,
                                  null, 2, grid)
        c = ss.fork_carry(trunk, N)._replace(step_idx=fork)
        return trunk, ss.branch_segment(_toy_eps_torch, SCHED_T, sage, c,
                                        cond, mask, null, 2, fork, bgrid)

    got = run()
    monkeypatch.setattr(dispatch, "cfg_ddim_step", _pregathered_ddim)
    want = run()
    for a, b in zip(got, want):
        assert torch.equal(a.z, b.z) and torch.equal(a.eps_prev, b.eps_prev)
        assert torch.equal(a.step_idx, b.step_idx)
    assert torch.isfinite(got[1].z).all()


@pytest.mark.parametrize("sampler, rows, per_step", [
    ("ddim", None, 2), ("dpmpp", None, 3), ("ddim", ("ddim", "dpmpp"), 3)])
def test_ddim_segment_builds_no_history_indices(sampler, rows, per_step,
                                                monkeypatch):
    """A DDIM-only segment gathers t and t_next a step and hands the update
    no t_prev or warm-up flag; DPM-Solver++ and mixed stacks still gather
    t_prev and build the flag."""
    sage = SageConfig(total_steps=8, sampler=sampler, step_impl="fused")
    sage, split = ss.segment_solver(sage, rows, 2, "cpu")
    gathers, history = [], []
    grid_gather, step_update = ss._grid_gather, ss._step_update

    def count_gather(*args):
        gathers.append(1)
        return grid_gather(*args)

    def spy_update(*args):
        history.append(args[8:10])
        return step_update(*args)
    monkeypatch.setattr(ss, "_grid_gather", count_gather)
    monkeypatch.setattr(ss, "_step_update", spy_update)
    g = torch.Generator().manual_seed(47)
    carry = ss.init_carry(torch.randn((2, 4, 4, 4), generator=g))
    ss.shared_segment(_toy_eps_torch, SCHED_T, sage, carry,
                      torch.randn((2, 3, 2), generator=g), torch.zeros((3, 2)),
                      3, torch.as_tensor(ddim_timesteps(1000, 8)), split)
    assert len(gathers) == 3 * per_step
    reads = sampler == "dpmpp" or rows is not None
    assert all((h[0] is not None and h[1] is not None) == reads
               for h in history) and len(history) == 3
