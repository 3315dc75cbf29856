"""Kernel twins of the PyTorch port held against the JAX package.

The port's plain versions (``kernels/*/ref.py``, which its wrappers run on
a CPU tensor) against the JAX kernels run as ``tests/test_kernels.py``
runs them: Pallas in interpret mode on the CPU.  Inputs come from numpy
with a seed and the same arrays go to both sides.  The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ddim_step.ops import fused_cfg_ddim_step as jax_ddim
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.models import layers as jax_layers
from repro_torch.kernels import dispatch
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
# ddim_step: both launch shapes (broadcast scalars / per-row scalars)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("clip_x0", [0.0, 3.0])
@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (3, 17, 5, 3)])
def test_ddim_ref_matches_jax_kernel(per_row, clip_x0, shape):
    rng = np.random.default_rng(hash((per_row, clip_x0, shape)) % 2**32)
    z, eu, ec = (_rand(rng, shape) for _ in range(3))
    B = shape[0]
    if per_row:
        a_t = rng.uniform(0.05, 0.9, B).astype(np.float32)
        a_n = rng.uniform(0.05, 0.9, B).astype(np.float32)
    else:
        a_t = np.float32(0.3)
        a_n = np.float32(0.6)
    s_t = np.sqrt(1 - a_t ** 2).astype(np.float32)
    s_n = np.sqrt(1 - a_n ** 2).astype(np.float32)
    want = jax_ddim(jnp.asarray(z), jnp.asarray(eu), jnp.asarray(ec), 7.5,
                    jnp.asarray(a_t), jnp.asarray(s_t), jnp.asarray(a_n),
                    jnp.asarray(s_n), clip_x0=clip_x0)
    t = torch.from_numpy
    args = (t(z), t(eu), t(ec), 7.5, torch.as_tensor(a_t),
            torch.as_tensor(s_t), torch.as_tensor(a_n), torch.as_tensor(s_n))
    got = fused_cfg_ddim_step_ref(*args, clip_x0=clip_x0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=DDIM_TOL, atol=DDIM_TOL)
    # the wrapper on a CPU tensor is exactly the plain version, no launch
    before = ddim_ops.fused_cfg_ddim_step.launches
    routed = dispatch.cfg_ddim_step(
        *args[:3], guidance=7.5, a_t=args[4], s_t=args[5], a_n=args[6],
        s_n=args[7], clip_x0=clip_x0, impl="fused")
    assert torch.equal(routed, got)
    assert ddim_ops.fused_cfg_ddim_step.launches == before


def test_ddim_wrapper_rejects_mismatched_shapes():
    z = torch.zeros(2, 4, 4, 4)
    with pytest.raises(ValueError, match="shape mismatch"):
        ddim_ops.fused_cfg_ddim_step(z, z, torch.zeros(2, 4, 4, 3), 1.0,
                                     0.5, 0.5, 0.5, 0.5)


def test_ddim_schedule_arrays():
    """Per-row scalars become (rows,) arrays read at stride 1; 0-dim ones
    stay single values read at stride 0."""
    arrays, stride = ddim_ops._schedule_arrays(
        (torch.tensor([0.1, 0.2]), 0.3, torch.tensor(0.4),
         torch.tensor([0.5, 0.6])), 2, "cpu")
    assert stride == 1
    np.testing.assert_allclose(torch.stack(arrays).numpy(), [
        [0.1, 0.2], [0.3, 0.3], [0.4, 0.4], [0.5, 0.6]], rtol=1e-7)
    arrays, stride = ddim_ops._schedule_arrays((0.1, 0.2, 0.3, 0.4), 5,
                                               "cpu")
    assert stride == 0 and all(a.shape == () for a in arrays)
    with pytest.raises(ValueError, match="per-row"):
        ddim_ops._schedule_arrays((torch.tensor([0.1, 0.2, 0.3]), 0.2, 0.3,
                                   0.4), 2, "cpu")


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
