"""The port's checkpoints (``repro_torch.checkpoint``) in the JAX
package's on-disk layout: each package restores the other's files
bitwise (a bf16 leaf and the image tower's zero-size marker included), the
weight bridge carries a DiT both ways, a train state round-trips, and the
``train_sage`` example writes a checkpoint both packages read."""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.config import get_config as jax_get_config
from repro.core import lora as jlora
from repro.models import dit as jax_dit
from repro.models import text_encoder as jte
from repro_torch import tree as tu
from repro_torch import weights
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.config import OptimConfig, get_config
from repro_torch.core import trainer
from repro_torch.examples import train_sage
from torch_train_helpers import (CFG, K, LATENT, N, SAGE, SCHED, dit_params,
                                 randomized, to_jax)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the example's small ops would otherwise wait on
    a thread pool oversubscribed by the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tree():
    """DiT weights, a LoRA tree, the image tower (its ``cfg_dim`` marker is
    a (0,) leaf), a bf16 array and an int32 step."""
    params, _ = dit_params(seed=61)
    img = randomized(lambda k: jte.init_image(k, dim=32, patch=8, image=16,
                                              layers=2),
                     jax.random.PRNGKey(2), seed=62)
    lo = jlora.init_lora(to_jax(params), 4, jax.random.PRNGKey(3))
    half = np.random.default_rng(63).standard_normal((5, 7)).astype(
        ml_dtypes.bfloat16)
    return {"dit": params, "img": img, "lora": jax.tree.map(np.asarray, lo),
            "half": half, "step": np.array(7, np.int32)}


def _torch_like(tree):
    def leaf(x):
        dt = (torch.bfloat16 if x.dtype == ml_dtypes.bfloat16
              else getattr(torch, str(x.dtype)))
        return torch.zeros(x.shape, dtype=dt)
    return jax.tree.map(leaf, tree)


def _bits(x):
    """A leaf's raw bytes and its dtype name."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes(), tuple(x.shape), name
    x = np.asarray(x)
    return x.tobytes(), x.shape, str(x.dtype)


def _assert_bitwise(got, want):
    g, w = tu.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert _bits(a) == _bits(b)


def test_jax_checkpoint_restores_in_the_port_bitwise(tmp_path):
    tree = _jax_tree()
    jax_save(str(tmp_path), 3, to_jax(tree))
    assert latest_step(str(tmp_path)) == 3
    got = restore_checkpoint(str(tmp_path), 3, _torch_like(tree))
    _assert_bitwise(got, tree)
    assert got["half"].dtype == torch.bfloat16
    assert tuple(got["img"]["cfg_dim"].shape) == (0,)
    assert got["lora"].keys() == tree["lora"].keys()


def _torch_tree(tree):
    def leaf(x):
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(x))
    return jax.tree.map(leaf, tree)


def test_port_checkpoint_restores_in_jax_bitwise(tmp_path):
    tree = _jax_tree()
    save_checkpoint(str(tmp_path), 11, _torch_tree(tree))
    meta = json.loads((tmp_path / "step_00000011" / "tree.json")
                      .read_text())
    assert meta["n"] == len(jax.tree.leaves(tree)) and meta["step"] == 11
    assert "bfloat16" in meta["dtypes"]
    got = jax_restore(str(tmp_path), 11, to_jax(tree))
    _assert_bitwise(jax.tree.leaves(got), tree)
    assert got["half"].dtype == ml_dtypes.bfloat16


def test_restore_refuses_a_tree_of_another_size(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"a": torch.ones(2), "b": torch.ones(3)})
    with pytest.raises(ValueError, match="holds 2 leaves"):
        restore_checkpoint(str(tmp_path), 0, {"a": torch.ones(2)})
    assert latest_step(str(tmp_path / "none")) is None


def test_dit_bridge_round_trips_the_jax_tree():
    params, _ = dit_params(seed=64)
    back = weights.dit_to_jax(weights.dit_from_jax(params, CFG,
                                                   device="cpu"))
    assert (jax.tree.structure(back) == jax.tree.structure(params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_train_state_round_trips(tmp_path):
    """A state after one SAGE step (params, optimizer moments and counts,
    no LoRA) saved and restored: every leaf bitwise, step counters too."""
    _, base = dit_params(seed=65)
    opt = OptimConfig(lr=1e-3)
    state = trainer.init_state(CFG, opt, base_params=base, device="cpu")
    step = trainer.make_sage_train_step(CFG, SAGE, SCHED, opt)
    g = torch.Generator().manual_seed(66)
    batch = {"z": torch.randn((K, N) + LATENT, generator=g),
             "cond": torch.randn((K, N, CFG.cond_len, CFG.cond_dim),
                                 generator=g),
             "mask": torch.ones((K, N))}
    state, _ = step(state, batch, trainer.sage_step_draws(
        g, SAGE, SCHED, K, N, LATENT, "cpu"))
    save_checkpoint(str(tmp_path), 1, state)
    like = trainer.init_state(CFG, opt, seed=5, device="cpu")
    got = restore_checkpoint(str(tmp_path), 1, like)
    assert got["lora"] is None
    for a, b in zip(tu.leaves(got), tu.leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got["step"]) == int(got["opt"]["count"]) == 1


def test_train_sage_example_runs_and_checkpoints(tmp_path, capsys):
    """``python -m repro_torch.examples.train_sage --smoke --steps 2
    --device cpu``: finite losses, and a checkpoint that the port and the
    JAX package both restore into their DiT layouts."""
    out = train_sage.main(["--smoke", "--steps", "2", "--device", "cpu",
                           "--ckpt", str(tmp_path)])
    printed = capsys.readouterr().out
    assert "dataset:" in printed and "final loss" in printed
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
    assert latest_step(str(tmp_path)) == 2
    cfg = get_config("sage-dit-100m", smoke=True)
    like = trainer.init_state(cfg, OptimConfig(), device="cpu")["params"]
    params = restore_checkpoint(str(tmp_path), 2, like)
    assert all(a.shape == b.shape for a, b in
               zip(tu.leaves(params), tu.leaves(like)))
    jcfg = jax_get_config("sage-dit-100m", smoke=True)
    jparams = jax_restore(str(tmp_path), 2, jax_dit.init_params(
        jcfg, jax.random.PRNGKey(0)))
    _assert_bitwise(params, jparams)
    eps = jax_dit.forward(jax.tree.map(jnp.asarray, jparams), jcfg,
                          jnp.zeros((1,) + LATENT), jnp.array([500]),
                          jnp.zeros((1, jcfg.cond_len, jcfg.cond_dim)))
    assert np.all(np.isfinite(np.asarray(eps)))
