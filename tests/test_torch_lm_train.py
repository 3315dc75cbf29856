"""The port's LM training launcher (``repro_torch.launch.train``) held to
the JAX package's (``src/repro/launch/train.py``) on the CPU at smoke size:
``phi3-mini-3.8b`` and ``mamba2-780m`` with AdamW in f32 (each of three
steps' loss and gnorm within 1e-5 relative of the JAX loop's, the first
step's gradient leaf for leaf, the checkpoint restored by JAX bitwise),
``phi3`` in bf16 (within bf16's tolerance), the CLI's printed lines; and
the SSD scan under autograd (the meta device, where a non-CPU tensor
reaches the kernel's route).

``tests/test_torch_lm_train_cross.py`` holds the MoE / MLA and encdec
configs the same way.  Weights are ``init_params(PRNGKey(0))``'s, as the
JAX launcher's."""
import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.launch import train as jax_train
from repro_torch.config import get_config
from repro_torch.data.synthetic import token_stream
from repro_torch.launch import train as ltrain
from repro_torch.models import transformer as tfm
from torch_lm_train_helpers import one_torch_thread  # noqa: F401
from torch_lm_train_helpers import (BF16_TOL, STEPS, assert_grads_match,
                                    assert_steps_match, flat, jax_run,
                                    torch_run)

RUNS = (("phi3-mini-3.8b", "adamw"), ("mamba2-780m", "adamw"))


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


def test_ssd_scan_is_differentiable_off_the_cpu():
    """On the meta device (no kernel, as a CUDA tensor would reach one)
    the mamba2 loss backward runs through the plain scan, while without
    autograd the same forward takes the kernel's route."""
    cfg = get_config("mamba2-780m", smoke=True)
    model = tfm.meta_lm(cfg)
    batch = next(token_stream(cfg.vocab, 2, 16))
    loss = tfm.lm_loss(model, batch)
    loss.backward()
    grads = [p.grad for p in model.parameters()]
    assert all(g is not None and g.shape == p.shape
               for g, p in zip(grads, model.parameters()))
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="no ssd_scan kernel"):
        tfm.forward_train(model, batch["tokens"])


def test_bf16_steps_match_jax_within_bf16():
    want = jax_run("phi3-mini-3.8b", "adamw", dtype="bfloat16")
    got = torch_run("phi3-mini-3.8b", "adamw", want["params0"],
                    dtype="bfloat16")
    assert_steps_match(got, want, rtol=BF16_TOL)


_NUM = re.compile(r"-?\d+\.\d+")


def test_cli_prints_the_jax_launchers_lines(capsys, monkeypatch, tmp_path):
    argv = ["--arch", "phi3-mini-3.8b", "--smoke", "--steps", "2",
            "--batch", "2", "--seq", "16"]
    monkeypatch.setattr(sys, "argv",
                        ["train.py", *argv, "--ckpt", str(tmp_path / "j")])
    jax_train.main()
    want = capsys.readouterr().out.splitlines()
    ltrain.main([*argv, "--ckpt", str(tmp_path / "t"), "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        # the seconds a step, the device count (JAX's host platform may
        # split the CPU) and the two checkpoint paths differ; the rest
        # agree, numbers within bf16's tolerance (bf16 activations)
        g, w = (re.sub(r"\(\S+s/step\)|devices=\d+|-> \S+$", "", x)
                for x in (g, w))
        assert _NUM.sub("#", g) == _NUM.sub("#", w)
        np.testing.assert_allclose([float(x) for x in _NUM.findall(g)],
                                   [float(x) for x in _NUM.findall(w)],
                                   rtol=BF16_TOL)
