"""Modules of the PyTorch port held against the JAX package in f32 at
smoke size, with weights handed over through the bridge
(``repro_torch.weights``).

adaLN, ``lnx`` and the q/k norms are zero at init (adaLN-zero), which
would gate the self-attention and MLP branches of every DiT block to
zero; every bridged parameter is therefore overwritten with seeded random
values before the comparison, so no branch goes untested.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import replace as jax_replace
from repro.models import dit as jax_dit
from repro.models import text_encoder as jax_te
from repro.models import vae as jax_vae
from repro_torch import weights
from repro_torch.config import get_config, replace
from repro_torch.models import text_encoder as te

# f32 on both sides; the frameworks sum matmuls and reductions in other
# orders, which moves the last bits (observed max abs error ~1e-7 on the
# DiT's eps, ~1e-6 on the VAE's image)
RTOL, ATOL = 1e-4, 1e-5


def randomized(init, *args, seed):
    """Seeded random values for every leaf of ``init(*args)``'s pytree
    (shapes only are traced, nothing runs) — numpy arrays, the bridge's
    input: 0.1 for vectors, 1/sqrt(fan_in) for matrices and HWIO convs."""
    rng = np.random.default_rng(seed)

    def draw(x):
        fan_in = int(np.prod(x.shape[:-1])) if len(x.shape) == 4 else \
            (x.shape[-2] if len(x.shape) >= 2 else 0)
        std = fan_in ** -0.5 if fan_in else 0.1
        return (rng.standard_normal(x.shape) * std).astype(np.float32)
    return jax.tree.map(draw, jax.eval_shape(lambda: init(*args)))


def _dit_cfgs(attn_impl):
    jcfg = jax_replace(jax_get_config("sage-dit", smoke=True),
                       dtype="float32")
    tcfg = replace(get_config("sage-dit", smoke=True), dtype="float32",
                   attn_impl=attn_impl)
    return jcfg, tcfg


@pytest.mark.parametrize("attn_impl", ["naive", "chunked", "kernel"])
def test_dit_eps_matches_jax(attn_impl):
    jcfg, tcfg = _dit_cfgs(attn_impl)
    params = randomized(jax_dit.init_params, jcfg, jax.random.PRNGKey(0),
                        seed=1)
    rng = np.random.default_rng(2)
    B, H = 3, jcfg.latent_size
    z = rng.standard_normal((B, H, H, jcfg.latent_channels)
                            ).astype(np.float32)
    t = np.array([999, 500, 3], np.int32)
    cond = rng.standard_normal((B, jcfg.cond_len, jcfg.cond_dim)
                               ).astype(np.float32)
    want = jax_dit.forward(jax.tree.map(jnp.asarray, params), jcfg,
                           jnp.asarray(z), jnp.asarray(t), jnp.asarray(cond))
    model = weights.dit_from_jax(params, tcfg, device="cpu")
    got = model(torch.from_numpy(z), torch.from_numpy(t).long(),
                torch.from_numpy(cond))
    assert got.dtype == torch.float32
    assert float(np.abs(np.asarray(want)).mean()) > 1e-2   # not gated off
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("attn_impl", ["naive", "kernel"])
def test_encode_text_matches_jax(attn_impl):
    jtc = jax_te.text_cfg(dim=64, layers=2)
    tc = replace(te.text_cfg(dim=64, layers=2), attn_impl=attn_impl)
    params = randomized(jax_te.init_text, jax.random.PRNGKey(3), jtc,
                        seed=4)
    prompts = ["a red circle on a white field", "a blue square",
               "x" * 80]                        # longer than max_len
    jt = jax_te.tokenize(prompts, max_len=48)
    tt = te.tokenize(prompts, max_len=48)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    want_f, want_p = jax_te.encode_text(jax.tree.map(jnp.asarray, params),
                                        jtc, jt)
    tower = weights.text_from_jax(params, tc, device="cpu")
    got_f, got_p = te.encode_text(tower, tt)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=RTOL,
                               atol=ATOL)


def test_vae_decode_matches_jax():
    params = randomized(jax_vae.init_params, jax.random.PRNGKey(5), seed=6)
    z = np.random.default_rng(7).standard_normal((2, 8, 6, 4)
                                                 ).astype(np.float32)
    want = jax_vae.decode(jax.tree.map(jnp.asarray, params), jnp.asarray(z))
    vae = weights.vae_from_jax(params, device="cpu")
    got = vae(torch.from_numpy(z))
    assert got.shape == (2, 64, 48, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_bridge_is_strict():
    jcfg, tcfg = _dit_cfgs("naive")
    params = randomized(jax_dit.init_params, jcfg, jax.random.PRNGKey(0),
                        seed=0)
    del params["out"]
    with pytest.raises(KeyError, match="out"):
        weights.dit_from_jax(params, tcfg, device="cpu")
    params = randomized(jax_dit.init_params, jcfg, jax.random.PRNGKey(0),
                        seed=0)
    params["pos"] = params["pos"][:-1]
    with pytest.raises(ValueError, match="pos"):
        weights.dit_from_jax(params, tcfg, device="cpu")
