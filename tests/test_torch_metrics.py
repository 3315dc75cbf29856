"""The port's evaluation metrics (``repro_torch.core.metrics``) held to the
JAX package's ``core/metrics.py`` on the CPU: the committed random-conv
weights are JAX's ``_rf_params()`` bitwise; the features at an even and an
odd side (XLA's "SAME" padding of a stride-2 conv is asymmetric on an even
side); ``fd_r``, ``clip_proxy`` and ``group_diversity`` with and without a
mask, within 1e-5 relative (f32 convolutions summed in other orders)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jax_metrics
from repro_torch.core import metrics

RTOL = 1e-5


def _images(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def test_committed_weights_are_jax_draws_bitwise():
    want = [np.asarray(w) for w in jax_metrics._rf_params()]
    got = metrics.rf_params()
    assert len(got) == len(want) == 3
    assert sum(w.size for w in got) == 23_472
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        assert np.array_equal(g, w)


@pytest.mark.parametrize("side", [16, 15, 8, 3])
def test_random_features_match_jax(side):
    x = _images(side, (5, side, side, 3))
    want = np.asarray(jax_metrics.random_features(jnp.asarray(x)))
    got = metrics.random_features(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (5, 112)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("side,pads", [(16, (0, 1)), (15, (1, 1)),
                                       (8, (0, 1)), (1, (1, 1))])
def test_same_padding_is_xlas(side, pads):
    assert metrics._same_pad(side) == pads


def test_fd_r_matches_jax():
    real, gen = _images(1, (8, 16, 16, 3)), _images(2, (8, 16, 16, 3))
    want = jax_metrics.fd_r(jnp.asarray(real), jnp.asarray(gen))
    got = metrics.fd_r(torch.from_numpy(real), torch.from_numpy(gen))
    assert got == pytest.approx(want, rel=RTOL)
    assert metrics.fd_r(torch.from_numpy(real),
                        torch.from_numpy(real)) == pytest.approx(0, abs=1e-4)


def test_clip_proxy_matches_jax():
    rng = np.random.default_rng(3)
    t, i = (rng.standard_normal((6, 16)).astype(np.float32)
            for _ in range(2))
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    i /= np.linalg.norm(i, axis=-1, keepdims=True)
    want = jax_metrics.clip_proxy(jnp.asarray(t), jnp.asarray(i))
    got = metrics.clip_proxy(torch.from_numpy(t), torch.from_numpy(i))
    assert got == pytest.approx(want, rel=RTOL)


@pytest.mark.parametrize("masked", [False, True])
def test_group_diversity_matches_jax(masked):
    images = _images(4, (2, 3, 16, 16, 3))
    mask = np.array([[1, 1, 0], [1, 1, 1]], np.float32) if masked else None
    want = jax_metrics.group_diversity(
        jnp.asarray(images), None if mask is None else jnp.asarray(mask))
    got = metrics.group_diversity(
        torch.from_numpy(images),
        None if mask is None else torch.from_numpy(mask))
    assert got == pytest.approx(want, rel=RTOL)
