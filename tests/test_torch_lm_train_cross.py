"""The port's LM training launcher held to the JAX package's on the CPU at
smoke size, as ``tests/test_torch_lm_train.py`` does, for
``deepseek-v2-lite-16b`` with adafactor (MoE, MLA, the routers' aux loss)
and ``seamless-m4t-large-v2`` with AdamW (the encoder over the launcher's
zero frames); and the JAX-layout parameter tree of every assigned config
(``weights.lm_to_jax``, ``transformer.stacked_params``)."""
import jax
import numpy as np
import pytest

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.config import get_config as jax_get_config
from repro.configs import ASSIGNED
from repro.models import transformer as jax_tfm
from repro_torch import weights
from repro_torch.config import get_config
from torch_lm_train_helpers import one_torch_thread  # noqa: F401
from torch_lm_train_helpers import (STEPS, assert_grads_match,
                                    assert_steps_match, flat, jax_run,
                                    torch_run)

RUNS = (("deepseek-v2-lite-16b", "adafactor"),
        ("seamless-m4t-large-v2", "adamw"))


@pytest.fixture(scope="module", params=RUNS, ids=[a for a, _ in RUNS])
def run(request, tmp_path_factory):
    arch, optim = request.param
    want = jax_run(arch, optim)
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    got = torch_run(arch, optim, want["params0"], ckpt=ckpt)
    return dict(arch=arch, want=want, got=got, ckpt=ckpt)


def test_train_steps_match_jax(run):
    assert_steps_match(run["got"], run["want"])


def test_first_gradient_matches_jax_leaf_for_leaf(run):
    assert_grads_match(run["got"]["grads0"], run["want"]["grads0"])


def test_checkpoint_restores_in_jax_bitwise(run):
    like = jax.tree.map(np.zeros_like, run["want"]["params0"])
    restored = flat(jax_restore(run["ckpt"], STEPS, like))
    got = flat(run["got"]["params"])
    assert list(restored) == list(got)
    for k, v in got.items():
        assert restored[k].dtype == v.dtype and np.array_equal(
            restored[k], v), k


@pytest.mark.parametrize("arch", ASSIGNED)
def test_stacked_tree_round_trips_every_leaf(arch):
    """``lm_to_jax(lm_from_jax(p))`` is ``p``: every leaf, path, shape
    and value, in JAX's flatten order."""
    jcfg = jax_get_config(arch, smoke=True)
    params = jax.tree.map(np.asarray,
                          jax_tfm.init_params(jcfg, jax.random.PRNGKey(0)))
    back = flat(weights.lm_to_jax(weights.lm_from_jax(
        params, get_config(arch, smoke=True), device="cpu")))
    want = flat(params)
    assert list(back) == list(want)
    for k, v in want.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
