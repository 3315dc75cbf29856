"""Kernel twins of the PyTorch port held against the JAX package.

The port's plain versions (``kernels/*/ref.py``, which its wrappers run on
a CPU tensor) against the JAX kernels run as ``tests/test_kernels.py``
runs them: Pallas in interpret mode on the CPU.  Inputs come from numpy
with a seed and the same arrays go to both sides.  The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import samplers as jax_samplers
from repro.core.guidance import cfg_combine as jax_cfg_combine
from repro.core.schedule import make_schedule as jax_make_schedule
from repro.kernels.ddim_step.ops import fused_cfg_ddim_step as jax_ddim
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.models import layers as jax_layers
from repro_torch.core.schedule import ddim_timesteps, make_schedule
from repro_torch.kernels import dispatch
from repro_torch.kernels._tiles import step_arrays
from repro_torch.kernels.ddim_step import ops as ddim_ops
from repro_torch.kernels.ddim_step.ref import fused_cfg_ddim_step_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref

# f32 tolerance of the step kernels in the JAX suite (tests/test_kernels.py)
DDIM_TOL = 1e-5
# f32 attention: both sides accumulate in f32; the JAX kernel runs an
# online softmax over 128-key blocks, the port's plain version one
# materialised softmax, so sums differ in order only (observed ~1e-6)
FLASH_TOL = 2e-5


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# ddim_step: both launch shapes (one timestep / per-row timesteps); the
# plain version gathers from the schedule's tables as the kernel does
# ---------------------------------------------------------------------------

def _ddim_inputs(rng, shape, per_row):
    """Latents, a VP schedule's tables (alpha^2 + sigma^2 = 1) of 1001
    entries, and timesteps (B,) or 0-dim, all numpy."""
    z, eu, ec = (_rand(rng, shape) for _ in range(3))
    alphas = rng.uniform(0.01, 1.0, 1001).astype(np.float32)
    sigmas = np.sqrt(1 - alphas ** 2).astype(np.float32)
    B = shape[0]
    t = rng.integers(1, 1001, B if per_row else ())
    tn = np.maximum(t - rng.integers(1, 40, B if per_row else ()), 0)
    return (z, eu, ec), (alphas, sigmas), (t, tn)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("clip_x0", [0.0, 3.0])
@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (3, 17, 5, 3)])
def test_ddim_ref_matches_jax_kernel(per_row, clip_x0, shape):
    """The plain version, gathering from the tables itself, against the JAX
    kernel (interpret mode) handed the same gathers as its scalar block."""
    rng = np.random.default_rng(hash((per_row, clip_x0, shape)) % 2**32)
    (z, eu, ec), (alphas, sigmas), (t, tn) = _ddim_inputs(rng, shape,
                                                          per_row)
    want = jax_ddim(jnp.asarray(z), jnp.asarray(eu), jnp.asarray(ec), 7.5,
                    jnp.asarray(alphas[t]), jnp.asarray(sigmas[t]),
                    jnp.asarray(alphas[tn]), jnp.asarray(sigmas[tn]),
                    clip_x0=clip_x0)
    f = torch.from_numpy
    args = (f(z), f(eu), f(ec), 7.5, f(alphas), f(sigmas),
            torch.as_tensor(t), torch.as_tensor(tn))
    got = fused_cfg_ddim_step_ref(*args, clip_x0=clip_x0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=DDIM_TOL, atol=DDIM_TOL)
    # the wrapper on a CPU tensor is exactly the plain version, no launch
    before = ddim_ops.fused_cfg_ddim_step.launches
    routed = dispatch.cfg_ddim_step(
        *args[:3], guidance=7.5, alphas=args[4], sigmas=args[5], t=args[6],
        t_next=args[7], clip_x0=clip_x0, impl="fused")
    assert torch.equal(routed, got)
    assert ddim_ops.fused_cfg_ddim_step.launches == before


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("clip_x0", [0.0, 3.0])
def test_ddim_ref_matches_jax_sampler(per_row, clip_x0):
    """The plain version's new argument form against the JAX package's own
    DDIM reference on its cosine schedule: ``schedule.alpha`` /
    ``sigma`` gathers at the same timesteps, then ``cfg_combine`` and
    ``samplers.ddim_step`` (the JAX package's route without the kernel)."""
    rng = np.random.default_rng(41 + 2 * per_row + int(clip_x0))
    shape = (4, 8, 8, 4)
    z, eu, ec = (_rand(rng, shape) for _ in range(3))
    grid = ddim_timesteps(1000, 30)
    idx = rng.integers(0, 30, shape[0] if per_row else ())
    t, tn = grid[idx], grid[idx + 1]
    jsched = jax_make_schedule(1000)
    eps = jax_cfg_combine(jnp.asarray(eu), jnp.asarray(ec), 7.5)
    want = jax_samplers.ddim_step(jsched, jnp.asarray(z), jnp.asarray(t),
                                  jnp.asarray(tn), eps, clip_x0=clip_x0)
    sched = make_schedule(1000)
    f = torch.from_numpy
    got = fused_cfg_ddim_step_ref(f(z), f(eu), f(ec), 7.5, sched.alphas,
                                  sched.sigmas, torch.as_tensor(t),
                                  torch.as_tensor(tn), clip_x0=clip_x0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=DDIM_TOL, atol=DDIM_TOL)


def test_ddim_wrapper_rejects_mismatched_shapes():
    z = torch.zeros(2, 4, 4, 4)
    tab = torch.ones(11)
    with pytest.raises(ValueError, match="shape mismatch"):
        ddim_ops.fused_cfg_ddim_step(z, z, torch.zeros(2, 4, 4, 3), 1.0,
                                     tab, tab, 5, 4)
    with pytest.raises(ValueError, match=r"t_next must be 0-dim or \(2,\)"):
        ddim_ops.fused_cfg_ddim_step(z, z, z, 1.0, tab, tab, 5,
                                     torch.tensor([4, 3, 2]))
    with pytest.raises(TypeError, match="integer timesteps"):
        ddim_ops.fused_cfg_ddim_step(z, z, z, 1.0, tab, tab,
                                     torch.tensor(5.0), 4)
    with pytest.raises(ValueError, match="schedule tables"):
        ddim_ops.fused_cfg_ddim_step(z, z, z, 1.0, tab, torch.ones(12), 5, 4)


def test_ddim_timestep_forms_agree():
    """A python int, a 0-dim tensor and a per-row tensor of equal
    timesteps give the same update; per-row timesteps give each row its
    own."""
    g = torch.Generator().manual_seed(3)
    z, eu, ec = (torch.randn((3, 4, 4, 4), generator=g) for _ in range(3))
    sched = make_schedule(1000)
    step = functools.partial(ddim_ops.fused_cfg_ddim_step, z, eu, ec, 2.0,
                             sched.alphas, sched.sigmas, clip_x0=3.0)
    one = step(700, 650)
    assert torch.equal(step(torch.tensor(700), torch.tensor(650)), one)
    assert torch.equal(step(torch.full((3,), 700), torch.tensor(650)), one)
    rows = step(torch.tensor([700, 500, 300]), torch.tensor([650, 450, 250]))
    assert torch.equal(rows[0], one[0])
    assert torch.equal(rows[2:], step(300, 250)[2:])
    assert not torch.equal(rows[1], one[1])


def test_ddim_schedule_arrays():
    """Per-row scalars become (rows,) arrays read at stride 1; 0-dim ones
    stay single values read at stride 0."""
    arrays, stride = step_arrays(
        (torch.tensor([0.1, 0.2]), 0.3, torch.tensor(0.4),
         torch.tensor([0.5, 0.6])), 2, "cpu")
    assert stride == 1
    np.testing.assert_allclose(torch.stack(arrays).numpy(), [
        [0.1, 0.2], [0.3, 0.3], [0.4, 0.4], [0.5, 0.6]], rtol=1e-7)
    arrays, stride = step_arrays((0.1, 0.2, 0.3, 0.4), 5, "cpu")
    assert stride == 0 and all(a.shape == () for a in arrays)
    with pytest.raises(ValueError, match="per-row"):
        step_arrays((torch.tensor([0.1, 0.2, 0.3]), 0.2, 0.3, 0.4), 2,
                    "cpu")
    # a per-row bool flag becomes 0/1
    arrays, stride = step_arrays((0.5, torch.tensor([True, False])), 2,
                                 "cpu")
    assert stride == 1 and arrays[1].tolist() == [1.0, 0.0]


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

FLASH_CASES = {
    # name: (B, Sq, Sk, H, Hkv, D, causal, window)
    "self_hd72": (1, 64, 64, 2, 2, 72, False, 0),
    "cross_sk77_hd72": (1, 40, 77, 2, 2, 72, False, 0),
    "causal_77_hd192": (1, 77, 77, 2, 2, 192, True, 0),
    "gqa_causal": (2, 48, 48, 4, 2, 32, True, 0),
    "gqa_window": (1, 150, 150, 4, 1, 64, True, 24),
    # edges of the bf16 sm90 kernel's padding and masking: a padded width
    # met exactly with a single key, and the widest head ragged against
    # its 64-row query tiles under the causal mask
    "hd80_sk1": (2, 40, 1, 2, 2, 80, False, 0),
    "causal_sq130_hd256": (1, 130, 130, 2, 2, 256, True, 0),
    # head_dims off 8, which the bf16 route zero-pads to a multiple of 8
    # as the JAX wrapper pads to its lanes
    "gqa_causal_hd36": (2, 96, 96, 4, 2, 36, True, 0),
    "gqa_window_hd100": (2, 128, 128, 4, 2, 100, True, 40),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_ref_matches_jax_kernel(case):
    B, Sq, Sk, H, Hkv, D, causal, window = FLASH_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q = _rand(rng, (B, Sq, H, D))
    k = _rand(rng, (B, Sk, Hkv, D))
    v = _rand(rng, (B, Sk, Hkv, D))
    scale = 1.0 / np.sqrt(D)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, window=window, scale=scale)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = attention_ref(tq, tk, tv, causal=causal, window=window,
                        scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FLASH_TOL, atol=FLASH_TOL)
    # the kernel route on a CPU tensor is the plain version, no launch
    before = flash_ops.flash_attention.launches
    routed = dispatch.attention(tq, tk, tv, impl="kernel", causal=causal,
                                window=window, scale=scale)
    assert torch.equal(routed, got)
    assert flash_ops.flash_attention.launches == before


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0),
                                           (True, 8), (False, 8)])
def test_plain_attention_routes_match_jax(impl, causal, window):
    """The port's naive / chunked routes (and the non-causal-window
    fallback of the kernel route) against the JAX package's."""
    from repro.kernels import dispatch as jax_dispatch
    rng = np.random.default_rng(7 + window + causal)
    q = _rand(rng, (2, 33, 4, 16))
    k = _rand(rng, (2, 33, 2, 16))
    v = _rand(rng, (2, 33, 2, 16))
    want = jax_dispatch.attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), impl=impl, causal=causal,
                                  window=window, block=8)
    got = dispatch.attention(*map(torch.from_numpy, (q, k, v)), impl=impl,
                             causal=causal, window=window, block=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FLASH_TOL, atol=FLASH_TOL)
    if window and not causal:
        fb = dispatch.attention(*map(torch.from_numpy, (q, k, v)),
                                impl="kernel", causal=causal, window=window,
                                block=8)
        np.testing.assert_allclose(fb.numpy(), np.asarray(want),
                                   rtol=FLASH_TOL, atol=FLASH_TOL)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 4, 2, 300)
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.flash_attention(q, q, q)
    q = torch.zeros(1, 4, 3, 8)
    k = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="divisible"):
        flash_ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="causal"):
        flash_ops.flash_attention(k, k, k, causal=False, window=2)


def test_rope_and_rms_norm_match_jax():
    rng = np.random.default_rng(3)
    x = _rand(rng, (2, 9, 3, 72))
    scale = _rand(rng, (72,))
    from repro_torch.models import layers
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.arange(9), 10_000.0)
    got = layers.apply_rope(torch.from_numpy(x), torch.arange(9), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    want = jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale))
    got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _cpu_jax():
    assert jax.default_backend() == "cpu"
    yield
