"""The port's SAGE trainer (Alg. 2 / Eq. 3, ``repro_torch.core.trainer``)
held to the JAX trainer at smoke ``sage-dit`` size in f32: the same
weights, batch and ``jax.random`` draws on both sides, full fine-tune and
LoRA (JAX's own ``fold_in`` draws of ``a`` carried across).

Each JAX reference is computed once per module (two jitted programs per
mode: ``jax.value_and_grad`` of the step's objective for the first step's
loss, parts and gradients, and ``make_sage_train_step`` for three AdamW
steps).
"""
import jax
import numpy as np
import pytest
import torch

from repro.config import OptimConfig as JOptimConfig
from repro.core import sage_loss as jlosses
from repro.core import trainer as jtrainer
from repro_torch import tree as tu
from repro_torch import weights
from repro_torch.config import OptimConfig
from repro_torch.core import trainer
from torch_train_helpers import (CFG, JCFG, JSAGE, JSCHED, SAGE, SCHED,
                                 assert_trees_close, dit_params, group_batch,
                                 sage_draws_of, to_jax, to_torch)

LR = 1e-3
STEPS = 3
RANK = 4
# f32 on both sides, summed in other orders: the first step's loss and
# parts agree to 5e-7 relative, its gradients to 8.7e-7 of their largest
# element, the moments after three steps to 5.5e-6 of theirs (observed)
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
MOMENT_ATOL = 1e-4
# AdamW's first steps move an element by ~lr·sign(g): where g is ~0 the
# frameworks' last-bit differences flip the sign, so parameters after
# STEPS steps are held within this multiple of LR * STEPS (observed: 0.7%
# of it in full fine-tune, 0.04% with LoRA)
PARAM_ATOL = 0.05 * LR * STEPS


@pytest.fixture(scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_reference(rank):
    params, _ = dit_params(seed=21)
    batch = group_batch(seed=22)
    opt = JOptimConfig(lr=LR)
    jstate = jtrainer.init_state(JCFG, opt, jax.random.PRNGKey(0),
                                 lora_rank=rank, base_params=to_jax(params))
    lora0 = jax.tree.map(np.asarray, jstate["lora"])

    def loss_fn(trainable, frozen, b, key):
        p, lo = (frozen, trainable) if rank else (trainable, None)
        kd, kl = jax.random.split(key)
        cond = jtrainer._drop_cond(kd, b["cond"], 2)
        eps_fn = jtrainer._eps_fn(JCFG, p, lo)
        return jlosses.sage_loss(eps_fn, JSCHED, JSAGE, kl, b["z"], cond,
                                 b["mask"])

    trainable = jstate["lora"] if rank else jstate["params"]
    frozen = jstate["params"] if rank else None
    (loss, parts), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        trainable, frozen, to_jax(batch), jax.random.PRNGKey(10))
    step = jtrainer.make_sage_train_step(JCFG, JSAGE, JSCHED, opt,
                                         lora_rank=rank)
    metrics = []
    for i in range(STEPS):
        jstate, m = step(jstate, to_jax(batch), jax.random.PRNGKey(10 + i))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(params=params, batch=batch, lora0=lora0,
                first=(float(loss), {k: float(v) for k, v in parts.items()}),
                grads=jax.tree.map(np.asarray, grads), metrics=metrics,
                final=jax.tree.map(np.asarray, jstate))


@pytest.fixture(scope="module", params=[0, RANK], ids=["full", "lora"])
def run(request, one_torch_thread):
    """The JAX reference and the port's run of the same steps."""
    rank = request.param
    ref = _jax_reference(rank)
    _, base = dit_params(seed=21)
    opt = OptimConfig(lr=LR)
    state = trainer.init_state(CFG, opt, lora_rank=rank, base_params=base,
                               device="cpu")
    if rank:
        state["lora"] = weights.lora_from_jax(ref["lora0"], device="cpu")
    batch = to_torch(ref["batch"])
    loss_fn = trainer.make_sage_loss(CFG, SAGE, SCHED, lora_rank=rank)
    trainable, frozen = trainer._split(state, rank)
    first, grads = trainer.value_and_grad(
        loss_fn, trainable, frozen, batch, sage_draws_of(
            jax.random.PRNGKey(10)))
    step = trainer.make_sage_train_step(CFG, SAGE, SCHED, opt,
                                        lora_rank=rank)
    given, start = state, tu.tree_map(torch.clone, state)
    metrics = []
    for i in range(STEPS):
        state, m = step(state, batch, sage_draws_of(
            jax.random.PRNGKey(10 + i)))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(ref=ref, rank=rank, first=first, grads=grads,
                metrics=metrics, start=start, given=given, final=state)


def test_first_step_loss_and_parts_match_jax(run):
    loss, parts = run["first"]
    want_loss, want_parts = run["ref"]["first"]
    assert set(parts) == {"shared", "soft", "branch"}
    assert float(loss) == pytest.approx(want_loss, rel=LOSS_RTOL)
    for k, v in want_parts.items():
        assert float(parts[k]) == pytest.approx(v, rel=LOSS_RTOL), k
    assert want_parts["soft"] > 0          # every term of Eq. 3 is live


def test_first_step_gradients_match_jax_leaf_by_leaf(run):
    grads, want = run["grads"], run["ref"]["grads"]
    scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(want))
    assert scale > 0
    assert_trees_close(grads, want, GRAD_RTOL, GRAD_ATOL * scale, "grad")
    if run["rank"]:
        # b = 0 at init: only b gets a gradient, as in JAX
        assert all(float(ab["a"].abs().max()) == 0
                   for ab in grads.values())
        assert all(float(ab["b"].abs().max()) > 0 for ab in grads.values())


def test_three_adamw_steps_match_jax(run):
    """Loss, gnorm and Eq. 3's parts at every step, and the trained
    parameters (or LoRA tree), the optimizer's moments and its count."""
    for got, want in zip(run["metrics"], run["ref"]["metrics"]):
        assert set(got) == set(want) == {"loss", "gnorm", "shared", "soft",
                                         "branch"}
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-7), k
    key = "lora" if run["rank"] else "params"
    final, want = run["final"], run["ref"]["final"]
    assert_trees_close(final[key], want[key], 0, PARAM_ATOL, key)
    for mom in ("mu", "nu"):
        scale = max(float(np.abs(m).max())
                    for m in jax.tree.leaves(want["opt"][mom]))
        assert_trees_close(final["opt"][mom], want["opt"][mom], 0,
                           MOMENT_ATOL * scale, mom)
    assert int(final["step"]) == int(want["step"]) == STEPS
    assert int(final["opt"]["count"]) == int(want["opt"]["count"]) == STEPS
    moved = [float((a - b).abs().max()) for a, b in
             zip(tu.leaves(final[key]), tu.leaves(run["start"][key]))]
    assert min(moved) > 0                     # every trainable leaf moved


def test_steps_write_nothing_in_place_and_lora_keeps_the_base(run):
    """A step returns a new state: the tensors it was given keep their
    values.  With LoRA the base weights come out bitwise unchanged, with
    no gradient, and every ``b`` has moved off zero."""
    for a, b in zip(tu.leaves(run["start"]), tu.leaves(run["given"])):
        assert torch.equal(a, b)
    after = run["final"]["params"]
    if run["rank"]:
        for a, b in zip(tu.leaves(run["start"]["params"]), tu.leaves(after)):
            assert torch.equal(a, b) and not b.requires_grad
        assert all(float(ab["b"].abs().max()) > 0
                   for ab in run["final"]["lora"].values())
    else:
        assert all(not p.requires_grad for p in tu.leaves(after))
