"""The training slice's data and model losses held to the JAX package at
smoke size in f32: the grouped dataset (groups and batches), ``vae_loss``
and ``contrastive_loss`` with their gradients, through the weight bridge
(the VAE encoder, the image tower with its zero-size marker leaf).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.grouped import build_grouped_dataset as jax_grouped
from repro.models import text_encoder as jte
from repro.models import vae as jvae
from repro_torch import weights
from repro_torch.data.grouped import build_grouped_dataset
from repro_torch.models import text_encoder as te
from repro_torch.models import vae as tvae
from torch_train_helpers import randomized, to_jax


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_grouped_dataset_equals_jax():
    """Prompts embedded by the same text tower in each package: the same
    clique cover, conditions and packed batches."""
    tc = te.text_cfg(dim=32, layers=2)
    jtc = jte.text_cfg(dim=32, layers=2)
    tp = jte.init_text(jax.random.PRNGKey(0), jtc)
    tower = weights.text_from_jax(jax.tree.map(np.asarray, tp), tc,
                                  device="cpu")
    kw = dict(n_items=64, res=16, tau_min=0.4, tau_max=0.95, group_max=3)
    want = jax_grouped(lambda p: jte.encode_text(
        tp, jtc, jte.tokenize(p, max_len=48)), **kw)
    got = build_grouped_dataset(lambda p: te.encode_text(
        tower, te.tokenize(p, max_len=48)), **kw)
    assert got.prompts == want.prompts
    np.testing.assert_array_equal(got.images, want.images)
    assert got.groups == want.groups and len(got.groups) > 8
    assert any(len(g) > 1 for g in got.groups)
    np.testing.assert_allclose(got.cond, want.cond, rtol=1e-4, atol=1e-5)
    for x, y in zip(got.packed(3), want.packed(3)):
        np.testing.assert_array_equal(x, y)
    n = 0
    for a, b in zip(got.iter_batches(2, 3, seed=5),
                    want.iter_batches(2, 3, seed=5)):
        np.testing.assert_array_equal(a["images"], b["images"])
        np.testing.assert_array_equal(a["mask"], b["mask"])
        np.testing.assert_allclose(a["cond"], b["cond"], rtol=1e-4,
                                   atol=1e-5)
        n += 1
    assert n == len(want.packed(3)[0]) // 2


def _named_grads(loss, *modules):
    """Each module's gradients by parameter name, from one backward (an
    unused parameter, the image tower's zero-size marker, gets zeros, as
    in JAX)."""
    named = [dict(m.named_parameters()) for m in modules]
    flat = [p for d in named for p in d.values()]
    grads = iter(torch.autograd.grad(loss, flat, allow_unused=True,
                                     materialize_grads=True))
    return [{n: next(grads) for n in d} for d in named]


def _jax_dotted(tree, hwio=()):
    """A JAX tree (or its gradient) under the port's parameter names:
    stacked blocks split per layer, HWIO convs under ``hwio`` prefixes
    transposed to OIHW."""
    flat = weights._unstack_blocks(dict(weights._flatten(
        jax.tree.map(np.asarray, tree))))
    return {k: (v.transpose(3, 2, 0, 1) if k.startswith(hwio) else v)
            for k, v in flat.items()}


def test_vae_loss_and_gradients_match_jax():
    params = jvae.init_params(jax.random.PRNGKey(3))
    rng = np.random.default_rng(43)
    x = np.tanh(rng.standard_normal((2, 16, 16, 3))).astype(np.float32)
    key = jax.random.PRNGKey(44)
    (want, wparts), wgrads = jax.jit(jax.value_and_grad(
        lambda p: jvae.vae_loss(p, key, jnp.asarray(x)), has_aux=True))(
        params)
    noise = np.asarray(jax.random.normal(key, (2, 2, 2, 4)))
    np_params = jax.tree.map(np.asarray, params)
    enc = weights.vae_encoder_from_jax(np_params, device="cpu")
    dec = weights.vae_from_jax(np_params, device="cpu")
    loss, parts = tvae.vae_loss(enc, dec, torch.from_numpy(x),
                                torch.from_numpy(noise.copy()))
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    for k in ("rec", "kl"):
        assert float(parts[k]) == pytest.approx(float(wparts[k]), rel=1e-5)
    mean, _ = tvae.encode(enc, torch.from_numpy(x))
    np.testing.assert_allclose(
        mean.detach().numpy(),
        np.asarray(jvae.encode(params, jnp.asarray(x))[0]), rtol=1e-4,
        atol=1e-5)
    genc, gdec = _named_grads(loss, enc, dec)
    got = {**genc, **gdec}
    want_g = _jax_dotted(wgrads, hwio=("enc.", "dec."))
    assert set(got) == set(want_g)
    for k, w in want_g.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-3,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=k)


def test_contrastive_loss_and_gradients_match_jax():
    jtc = jte.text_cfg(dim=32, layers=2)
    tp = randomized(jte.init_text, jax.random.PRNGKey(4), jtc, seed=45)
    ip = randomized(lambda k: jte.init_image(k, dim=32, patch=8, image=16,
                                             layers=2),
                    jax.random.PRNGKey(5), seed=46)
    prompts = ["a red circle", "a blue square on white", "a green ring",
               "a small yellow cross"]
    tokens = np.array(jte.tokenize(prompts, max_len=16))
    images = np.tanh(np.random.default_rng(47).standard_normal(
        (4, 16, 16, 3))).astype(np.float32)
    want, (wt, wi) = jax.jit(jax.value_and_grad(
        lambda a, b: jte.contrastive_loss(a, b, jtc, jnp.asarray(tokens),
                                          jnp.asarray(images)),
        argnums=(0, 1)))(to_jax(tp), to_jax(ip))
    text = weights.text_from_jax(tp, te.text_cfg(dim=32, layers=2),
                                 device="cpu")
    image = weights.image_from_jax(ip, device="cpu")
    assert image.patch == 8 and len(image.blocks) == 2
    loss = te.contrastive_loss(text, image, torch.from_numpy(tokens).long(),
                               torch.from_numpy(images))
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    for got, wg in zip(_named_grads(loss, text, image), (wt, wi)):
        want_g = _jax_dotted(wg)
        assert set(got) == set(want_g)
        for k, w in want_g.items():
            np.testing.assert_allclose(
                got[k].numpy(), w, rtol=1e-3,
                atol=1e-6 * float(np.abs(w).max(initial=0)), err_msg=k)
