"""Shared set-up of the training-slice parity tests
(``tests/test_torch_train*.py``, ``tests/test_torch_checkpoint.py``): the
smoke ``sage-dit`` in f32 on both sides, seeded numpy weights and batches,
and the JAX trainer's own ``jax.random`` draws carried to the port's
``draws`` dicts."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config import SageConfig as JSageConfig
from repro.config import get_config as jax_get_config
from repro.config import replace as jax_replace
from repro.core import sage_loss as jlosses
from repro.core import trainer as jtrainer
from repro.core.schedule import make_schedule as jax_make_schedule
from repro.models import dit as jax_dit
from repro_torch import weights
from repro_torch.config import SageConfig, get_config, replace
from repro_torch.core.schedule import make_schedule
from repro_torch.models import dit as tdit

JCFG = jax_replace(jax_get_config("sage-dit", smoke=True), dtype="float32")
CFG = replace(get_config("sage-dit", smoke=True), dtype="float32")
JSAGE = JSageConfig(total_steps=8, share_ratio=0.25)
SAGE = SageConfig(total_steps=8, share_ratio=0.25)
JSCHED = jax_make_schedule(1000)
SCHED = make_schedule(1000)
K, N = 2, 3
LATENT = (CFG.latent_size, CFG.latent_size, CFG.latent_channels)


def randomized(init, *args, seed):
    """Seeded random values for every leaf of ``init(*args)``'s pytree
    (shapes only are traced): 0.1 for vectors, 1/sqrt(fan_in) for
    matrices, so the adaLN-zero gates are open and every branch trains."""
    rng = np.random.default_rng(seed)

    def draw(x):
        if x.size == 0:
            return np.zeros(x.shape, np.float32)
        fan_in = int(np.prod(x.shape[:-1])) if len(x.shape) == 4 else \
            (x.shape[-2] if len(x.shape) >= 2 else 0)
        std = fan_in ** -0.5 if fan_in else 0.1
        return (rng.standard_normal(x.shape) * std).astype(np.float32)
    return jax.tree.map(draw, jax.eval_shape(lambda: init(*args)))


def dit_params(seed):
    """(JAX DiT params as numpy, the port's JAX-layout tree of them)."""
    params = randomized(jax_dit.init_params, JCFG, jax.random.PRNGKey(0),
                        seed=seed)
    return params, tdit.stacked_params(
        weights.dit_from_jax(params, CFG, device="cpu"))


def group_batch(seed):
    """A (K, N) group batch as numpy, the second group one member short."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((K, N) + LATENT).astype(np.float32)
    cond = rng.standard_normal((K, N, CFG.cond_len, CFG.cond_dim)
                               ).astype(np.float32)
    mask = np.array([[1, 1, 1], [1, 1, 0]], np.float32)
    return {"z": z, "cond": cond, "mask": mask}


def flat_batch(seed, b=4):
    rng = np.random.default_rng(seed)
    return {"z": rng.standard_normal((b,) + LATENT).astype(np.float32),
            "cond": rng.standard_normal((b, CFG.cond_len, CFG.cond_dim)
                                        ).astype(np.float32)}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x).copy())
    return t if dtype is None else t.to(dtype)


def sage_draws_of(key, k=K, n=N):
    """The draws the JAX SAGE step makes from ``key``
    (``trainer.py``'s split into the cond-dropout and loss keys,
    ``sage_loss``'s into timesteps and noise)."""
    kd, kl = jax.random.split(key)
    keep = jax.random.uniform(kd, (k, n)) > jtrainer.COND_DROP
    kt, ke = jax.random.split(kl)
    t_s, t_b = jlosses.sample_group_timesteps(kt, JSAGE, JSCHED, k)
    eps = jax.random.normal(ke, (k,) + LATENT)
    return {"keep": _t(keep), "t_s": _t(t_s, torch.long),
            "t_b": _t(t_b, torch.long), "eps": _t(eps)}


def standard_draws_of(key, b):
    kd, kl = jax.random.split(key)
    keep = jax.random.uniform(kd, (b,)) > jtrainer.COND_DROP
    kt, ke = jax.random.split(kl)
    t = jax.random.randint(kt, (b,), 1, JSCHED.T + 1)
    eps = jax.random.normal(ke, (b,) + LATENT)
    return {"keep": _t(keep), "t": _t(t, torch.long), "eps": _t(eps)}


def numpy_tree(tree):
    """A port tree of tensors as the JAX-shaped tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree.detach().numpy()


def assert_trees_close(got, want, rtol, atol, what=""):
    """Leaf by leaf over the JAX tree ``want`` (numpy or jax arrays)."""
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(numpy_tree(got))[0])
    assert len(flat_got) == len(flat_want), what
    for path, w in flat_want:
        np.testing.assert_allclose(
            flat_got[path], np.asarray(w), rtol=rtol, atol=atol,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")
