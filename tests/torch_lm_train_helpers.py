"""Shared set-up of the LM training parity tests
(``tests/test_torch_lm_train*.py``): the JAX launcher's loop
(``src/repro/launch/train.py``'s jitted ``train_step``) and the port's
``launch.train.train`` from the same ``init_params(PRNGKey(0))`` weights,
on the same ``token_stream`` batches, at smoke size."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import OptimConfig as JaxOptimConfig
from repro.config import get_config as jax_get_config
from repro.config import replace as jax_replace
from repro.data.synthetic import token_stream as jax_token_stream
from repro.models import transformer as jax_tfm
from repro.optim.optimizers import apply_updates as jax_apply_updates
from repro.optim.optimizers import clip_by_global_norm as jax_clip
from repro.optim.optimizers import make_optimizer as jax_make_optimizer
from repro_torch import tree as tu
from repro_torch.config import get_config, replace
from repro_torch.core.trainer import value_and_grad
from repro_torch.data.synthetic import token_stream
from repro_torch.launch import train as ltrain
from repro_torch.launch.serve import launcher_extras
from repro_torch.models import transformer as tfm

BATCH, SEQ, STEPS = 2, 16, 3
#: loss and gnorm of every step, relative, in f32 (observed <= 5e-7)
RTOL = 1e-5
#: a gradient leaf in f32, relative to the leaf's largest magnitude: the
#: frameworks sum in other orders (observed <= 6.1e-6, mamba2's A_log)
GRAD_TOL = 1e-5
#: bf16 activations (``tests/test_arch_smoke.py``'s bar)
BF16_TOL = 3e-2


def flat(tree):
    """keystr -> numpy leaf, for a JAX tree or a port tree."""
    if isinstance(tu.leaves(tree)[0], torch.Tensor):
        return {tu.keystr(k): v.detach().cpu().numpy()
                for k, v in tu.flatten_with_path(tree)}
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_extras(jcfg):
    """``train.py``'s zero extras."""
    if jcfg.family == "vlm":
        return {"image_embeds": jnp.zeros(
            (BATCH, jcfg.n_image_tokens, jcfg.vision_dim), jnp.float32)}
    if jcfg.family == "encdec":
        return {"frames": jnp.zeros(
            (BATCH, max(SEQ // 4, 16), jcfg.enc_input_dim), jnp.float32)}
    return {}


def jax_run(arch, optim, dtype="float32"):
    """The JAX launcher's loop for STEPS steps: initial params (numpy),
    each step's loss and gnorm and the first step's gradients."""
    jcfg = jax_replace(jax_get_config(arch, smoke=True), dtype=dtype)
    oc = JaxOptimConfig(kind=optim, lr=3e-4)
    opt = jax_make_optimizer(oc)
    params = jax_tfm.init_params(jcfg, jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.asarray, params)
    opt_state = opt.init(params)

    @jax.jit
    def train_step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: jax_tfm.lm_loss(p, jcfg, batch))(params)
        clipped, gnorm = jax_clip(grads, oc.grad_clip)
        updates, opt_state = opt.update(clipped, opt_state, params, oc.lr)
        return (jax_apply_updates(params, updates), opt_state, loss, gnorm,
                grads)

    stream = jax_token_stream(jcfg.vocab, BATCH, SEQ)
    losses, gnorms, grads0 = [], [], None
    for i in range(STEPS):
        batch = {k: jnp.asarray(v)
                 for k, v in {**next(stream), **jax_extras(jcfg)}.items()}
        params, opt_state, loss, gnorm, grads = train_step(params, opt_state,
                                                           batch)
        losses.append(float(loss))
        gnorms.append(float(gnorm))
        if i == 0:
            grads0 = jax.tree.map(np.asarray, grads)
    return {"params0": params0, "losses": losses, "gnorms": gnorms,
            "grads0": grads0}


def torch_run(arch, optim, params0, dtype="float32", ckpt=""):
    """``launch.train.train`` on the CPU from ``params0`` for STEPS steps,
    and the port's gradient of the first batch's loss at ``params0``."""
    cfg = replace(get_config(arch, smoke=True), dtype=dtype)
    out = ltrain.train(cfg, steps=STEPS, batch=BATCH, seq=SEQ, optim=optim,
                       device="cpu", params=params0, ckpt=ckpt,
                       log=lambda _: None)
    batch = {k: torch.as_tensor(v) for k, v in
             next(token_stream(cfg.vocab, BATCH, SEQ)).items()}
    batch.update({k: torch.as_tensor(v) for k, v in launcher_extras(
        cfg, BATCH, max(SEQ // 4, 16)).items()})
    tree = tu.tree_map(lambda x: torch.tensor(np.asarray(x)), params0)
    model = tfm.meta_lm(cfg)
    _, out["grads0"] = value_and_grad(
        lambda p: tfm.tree_loss(model, p, batch), tree)
    return out


def assert_steps_match(got, want, rtol=RTOL):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol)
    np.testing.assert_allclose(got["gnorms"], want["gnorms"], rtol=rtol)


def assert_grads_match(got, want):
    g, w = flat(got), flat(want)
    assert list(g) == list(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        assert np.abs(g[k] - w[k]).max() <= GRAD_TOL * np.abs(w[k]).max(), k


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
