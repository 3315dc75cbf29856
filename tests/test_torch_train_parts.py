"""The training slice's parts held to the JAX package at smoke size in
f32: the schedule's SNR weight, the learning-rate schedule, adafactor and
the Standard-FT step (``ldm_loss``) over three / two steps, the LoRA
filter and ``merge``, remat; plus the JAX package's own trainer cases run
on the port, the ``cast()`` gradient trap and the kernel wrappers'
refusal to run under autograd.  The data and the other models' losses are
in ``test_torch_train_data.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import OptimConfig as JOptimConfig
from repro.core import lora as jlora
from repro.core import trainer as jtrainer
from repro.optim.schedules import make_lr_schedule as jax_lr_schedule
from repro_torch import tree as tu
from repro_torch import weights
from repro_torch.config import OptimConfig, get_config, replace
from repro_torch.core import lora, trainer
from repro_torch.core import sage_loss as losses
from repro_torch.core.schedule import make_schedule
from repro_torch.kernels.ddim_step.ops import fused_cfg_ddim_step
from repro_torch.kernels.dpmpp_step.ops import fused_cfg_dpmpp_step
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.group_mean.ops import masked_group_mean
from repro_torch.kernels.ssd_scan.ops import (ssd_chunked_kernel,
                                              ssd_intra_chunk)
from repro_torch.models import dit as tdit
from repro_torch.models import layers
from repro_torch.optim import make_lr_schedule
from torch_train_helpers import (CFG, JCFG, JSAGE, JSCHED, K, LATENT, N,
                                 SAGE, SCHED, assert_trees_close, dit_params,
                                 flat_batch, group_batch, sage_draws_of,
                                 standard_draws_of, to_jax, to_torch)

# parameters after the steps within these multiples of lr x steps.
# adafactor's update is lr x a clipped per-leaf ratio, not AdamW's sign
# (observed 1.1e-4 of it); AdamW flips sign where a gradient is ~0
# (observed 0.030 of it on the Standard-FT steps)
ADAFACTOR_ATOL = 1e-3
ADAMW_ATOL = 0.1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_snr_weight_matches_jax():
    t = np.arange(JSCHED.T + 1)
    want = np.asarray(JSCHED.snr_weight(jnp.asarray(t)))
    got = SCHED.snr_weight(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[1] == 1.0 and got[-1] < 1e-6         # clamped, then ~0


def test_lr_schedule_matches_jax():
    """JAX evaluates the schedule in f32, the port in double: equal within
    f32's resolution of lr (1 + cos near -1 loses JAX's relative digits)."""
    lr = 3e-4
    for kind in ("constant", "cosine"):
        jc = JOptimConfig(lr=lr, warmup=10, schedule=kind)
        tc = OptimConfig(lr=lr, warmup=10, schedule=kind)
        jl, tl = jax_lr_schedule(jc, 50), make_lr_schedule(tc, 50)
        for s in (0, 5, 9, 10, 30, 49, 60):
            assert tl(s) == pytest.approx(float(jl(s)), rel=1e-6,
                                          abs=1e-7 * lr), (kind, s)


# ---------------------------------------------------------------------------
# optimizers and the Standard-FT step against the JAX trainer
# ---------------------------------------------------------------------------

def _jax_steps(make_step, opt, batch, keys):
    jstate = jtrainer.init_state(JCFG, opt, jax.random.PRNGKey(0),
                                 base_params=to_jax(dit_params(seed=31)[0]))
    step = make_step(opt)
    ms = []
    for key in keys:
        jstate, m = step(jstate, to_jax(batch), key)
        ms.append({k: float(v) for k, v in m.items()})
    return ms, jax.tree.map(np.asarray, jstate)


def _port_steps(make_step, opt, batch, draws):
    state = trainer.init_state(CFG, opt, base_params=dit_params(seed=31)[1],
                               device="cpu")
    step = make_step(opt)
    ms = []
    for d in draws:
        state, m = step(state, to_torch(batch), d)
        ms.append({k: float(v) for k, v in m.items()})
    return ms, state


def _check_steps(got, want, atol, opt_keys):
    (gm, gs), (wm, ws) = got, want
    for a, b in zip(gm, wm):
        assert set(a) == set(b)
        for k in b:
            assert a[k] == pytest.approx(b[k], rel=1e-4, abs=1e-7), k
    assert_trees_close(gs["params"], ws["params"], 0, atol, "params")
    assert int(gs["opt"]["count"]) == int(ws["opt"]["count"]) == len(gm)
    assert set(gs["opt"]) == set(opt_keys)


def test_adafactor_three_steps_match_jax():
    """Adafactor clips each update by one RMS over the whole JAX leaf; the
    port's stacked (layers, d_in, d_out) leaves are the JAX leaves, so the
    clip binds where it binds in JAX."""
    lr, steps = 1e-3, 3
    keys = [jax.random.PRNGKey(40 + i) for i in range(steps)]
    batch = group_batch(seed=32)
    want = _jax_steps(lambda o: jtrainer.make_sage_train_step(
        JCFG, JSAGE, JSCHED, o), JOptimConfig(kind="adafactor", lr=lr),
        batch, keys)
    got = _port_steps(lambda o: trainer.make_sage_train_step(
        CFG, SAGE, SCHED, o), OptimConfig(kind="adafactor", lr=lr), batch,
        [sage_draws_of(k) for k in keys])
    _check_steps(got, want, ADAFACTOR_ATOL * lr * steps, ("s", "count"))
    s = got[1]["opt"]["s"]
    assert set(s["blocks"]["attn"]["wq"]) == {"vr", "vc"}       # factored
    assert set(s["final_adaln_b"]) == {"v"}
    np.testing.assert_allclose(
        s["blocks"]["attn"]["wq"]["vr"].numpy(),
        want[1]["opt"]["s"]["blocks"]["attn"]["wq"]["vr"], rtol=1e-4)


def test_standard_step_and_ldm_loss_match_jax():
    lr, b = 1e-3, 4
    keys = [jax.random.PRNGKey(50 + i) for i in range(2)]
    batch = flat_batch(seed=33, b=b)
    want = _jax_steps(lambda o: jtrainer.make_standard_train_step(
        JCFG, JSCHED, o), JOptimConfig(lr=lr), batch, keys)
    draws = [standard_draws_of(k, b) for k in keys]
    got = _port_steps(lambda o: trainer.make_standard_train_step(
        CFG, SCHED, o), OptimConfig(lr=lr), batch, draws)
    _check_steps(got, want, ADAMW_ATOL * lr * 2, ("mu", "nu", "count"))
    # ldm_loss alone, on the first step's weights and draws, no dropout
    params = dit_params(seed=31)[1]
    d = draws[0]
    loss = losses.ldm_loss(
        lambda z, t, c: tdit.forward(params, CFG, z, t, c), SCHED, d,
        torch.from_numpy(batch["z"]), torch.from_numpy(batch["cond"])
        * d["keep"][:, None, None])
    assert float(loss) == pytest.approx(want[0][0]["loss"], rel=1e-5)


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------

def test_lora_filter_selects_jax_keys_and_shapes():
    jparams, tparams = dit_params(seed=34)
    want = jlora.init_lora(to_jax(jparams), 4, jax.random.PRNGKey(1))
    got = lora.init_lora(tparams, 4, torch.Generator().manual_seed(1))
    assert list(got) == list(want)              # flatten order too
    assert "['blocks']['attn']['wq']" in got and "['pos']" not in got
    for key, ab in want.items():
        for x in ("a", "b"):
            assert tuple(got[key][x].shape) == ab[x].shape, (key, x)
    assert lora.n_params(got) == jlora.n_params(want)
    # JAX's fold_in draws carried across merge as JAX merges them
    ab = jax.tree.map(np.asarray, want)
    ab = {k: {"a": v["a"], "b": np.full_like(v["b"], 0.01)}
          for k, v in ab.items()}
    merged = lora.merge(tparams, weights.lora_from_jax(ab, device="cpu"))
    assert_trees_close(merged, jlora.merge(to_jax(jparams), to_jax(ab)),
                       1e-6, 1e-6, "merged")


def test_lora_merge_zero_b_is_identity():
    """The JAX package's ``test_lora_merge_zero_b_is_identity`` on the
    port: ``b = 0`` gives the base weights back."""
    params = tdit.init_params(CFG, device="cpu")
    merged = lora.merge(params, lora.init_lora(params, 4))
    for a, b in zip(tu.leaves(params), tu.leaves(merged)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7)


def _toy_batch(seed):
    g = torch.Generator().manual_seed(seed)
    return {"z": torch.randn((K, N) + LATENT, generator=g),
            "cond": torch.randn((K, N, CFG.cond_len, CFG.cond_dim),
                                generator=g),
            "mask": torch.ones((K, N))}


def test_sage_loss_finite_and_parts():
    """The JAX package's case on the port: an untrained DiT (out ~ 0)
    predicts eps ~ 0, so the branch term is ~E||e||^2 ~ 1."""
    params = tdit.init_params(CFG, device="cpu")
    batch = _toy_batch(1)
    draws = losses.sage_draws(torch.Generator().manual_seed(2), SAGE, SCHED,
                              K, LATENT, "cpu")
    loss, parts = losses.sage_loss(
        lambda z, t, c: tdit.forward(params, CFG, z, t, c), SCHED, SAGE,
        draws, batch["z"], batch["cond"], batch["mask"])
    assert np.isfinite(float(loss))
    assert set(parts) == {"shared", "soft", "branch"}
    assert 0.0 < float(parts["branch"]) < 5.0


def test_sage_train_step_descends():
    """The JAX case on the port, with the JAX case's draws (its keys
    ``PRNGKey(i + 10)``)."""
    opt = OptimConfig(lr=2e-3)
    state = trainer.init_state(CFG, opt, device="cpu")
    step = trainer.make_sage_train_step(CFG, SAGE, SCHED, opt)
    batch = _toy_batch(1)
    seen = []
    for i in range(8):
        state, m = step(state, batch, sage_draws_of(
            jax.random.PRNGKey(i + 10)))
        seen.append(float(m["loss"]))
    assert seen[-1] < seen[0]                    # same batch -> must descend


def test_lora_only_updates_lora():
    opt = OptimConfig(lr=1e-3)
    state = trainer.init_state(CFG, opt, lora_rank=4, device="cpu")
    step = trainer.make_sage_train_step(CFG, SAGE, SCHED, opt, lora_rank=4)
    before = tu.tree_map(torch.clone, state["params"])
    state, _ = step(state, _toy_batch(1), trainer.sage_step_draws(
        torch.Generator().manual_seed(3), SAGE, SCHED, K, N, LATENT, "cpu"))
    for a, b in zip(tu.leaves(before), tu.leaves(state["params"])):
        assert torch.equal(a, b)
    assert any(float(ab["b"].abs().sum()) > 0
               for ab in state["lora"].values())


# ---------------------------------------------------------------------------
# remat, the cast() trap, the kernels under autograd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank", [0, 4], ids=["full", "lora"])
def test_remat_equals_no_remat(rank):
    """``torch.utils.checkpoint`` around each block recomputes the same
    ops: loss and every gradient bitwise equal."""
    _, params = dit_params(seed=35)
    state = trainer.init_state(CFG, OptimConfig(), lora_rank=rank,
                               base_params=params, device="cpu")
    if rank:     # b != 0, so that a gets a gradient too
        state["lora"] = tu.tree_map(lambda x: x + 0.01, state["lora"])
    trainable, frozen = trainer._split(state, rank)
    batch = to_torch(group_batch(seed=36))
    draws = sage_draws_of(jax.random.PRNGKey(37))
    outs = [trainer.value_and_grad(
        trainer.make_sage_loss(CFG, SAGE, SCHED, rank, remat=remat),
        trainable, frozen, batch, draws) for remat in (False, True)]
    (l0, _), g0 = outs[0]
    (l1, _), g1 = outs[1]
    assert torch.equal(l0, l1)
    for a, b in zip(tu.leaves(g0), tu.leaves(g1)):
        assert torch.equal(a, b) and float(a.abs().max()) > 0


def test_cast_weights_do_not_hide_gradients():
    """A DiT whose weights were cast once (as every serving engine casts
    them) differentiated through ``forward_grad``: every parameter's
    gradient equals an uncast twin's, bitwise; the cast copies would have
    given the cast weights none."""
    cfg = get_config("sage-dit", smoke=True)           # bf16 activations
    jparams, _ = dit_params(seed=38)
    a = weights.dit_from_jax(jparams, cfg, device="cpu")
    b = weights.dit_from_jax(jparams, cfg, device="cpu")
    assert a.cast_weights_() > 0
    batch = flat_batch(seed=39, b=2)
    z, c = torch.from_numpy(batch["z"]), torch.from_numpy(batch["cond"])
    t = torch.tensor([900, 20])
    grads = []
    for model in (a, b):
        loss = (model.forward_grad(z, t, c) ** 2).mean()
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    names = [n for n, _ in a.named_parameters()]
    for name, ga, gb in zip(names, *grads):
        assert torch.equal(ga, gb), name
    cast = {n for n, p in a.named_parameters()
            if n.rsplit(".", 1)[-1] in tdit.CAST}
    assert all(float(g.abs().max()) > 0 for n, g in zip(names, grads[0])
               if n in cast)
    with torch.no_grad():                      # serving still reads copies
        held = a.blocks[0].attn["wq"]._casts[torch.bfloat16][1]
        assert layers.cast(a.blocks[0].attn["wq"], torch.bfloat16) is held


def _wrapper_calls(req):
    """Every kernel wrapper on small CPU inputs, the first tensor of each
    with ``requires_grad=req``."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)

    q = r(1, 4, 2, 8).requires_grad_(req)
    z = r(2, 4, 4, 4).requires_grad_(req)
    x = r(2, 3, 5).requires_grad_(req)
    xs = r(1, 8, 2, 4).requires_grad_(req)
    sched = make_schedule(1000)
    return {
        "flash_attention": lambda: flash_attention(q, r(1, 4, 2, 8),
                                                   r(1, 4, 2, 8)),
        "fused_cfg_ddim_step": lambda: fused_cfg_ddim_step(
            z, r(2, 4, 4, 4), r(2, 4, 4, 4), 3.0, sched.alphas,
            sched.sigmas, torch.tensor(500), torch.tensor(400)),
        "fused_cfg_dpmpp_step": lambda: fused_cfg_dpmpp_step(
            z, r(2, 4, 4, 4), r(2, 4, 4, 4), r(2, 4, 4, 4), 3.0, 0.5, 0.8,
            0.6, 0.7, 0.1, 0.0, 0.2, False),
        "masked_group_mean": lambda: masked_group_mean(x, torch.ones(2, 3)),
        "ssd_intra_chunk": lambda: ssd_intra_chunk(
            xs, -r(1, 8, 2).abs(), r(1, 8, 4), r(1, 8, 4), 4),
        "ssd_chunked_kernel": lambda: ssd_chunked_kernel(
            xs, -r(1, 8, 2).abs(), r(1, 8, 4), r(1, 8, 4), 4),
    }


@pytest.mark.parametrize("name", list(_wrapper_calls(False)))
def test_kernel_wrappers_raise_under_autograd(name):
    """No kernel has a backward: a wrapper asked to run while autograd
    records through an input raises instead of cutting the gradient (and
    does not fall back to its plain version); without grad it runs."""
    with pytest.raises(RuntimeError, match="has no backward"):
        _wrapper_calls(True)[name]()
    with torch.no_grad():
        _wrapper_calls(True)[name]()
    _wrapper_calls(False)[name]()


def test_training_on_the_kernel_attention_route_raises():
    cfg = replace(CFG, attn_impl="kernel")
    _, params = dit_params(seed=40)
    loss_fn = trainer.make_sage_loss(cfg, SAGE, SCHED)
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        trainer.value_and_grad(loss_fn, params, None,
                               to_torch(group_batch(seed=41)),
                               sage_draws_of(jax.random.PRNGKey(42)))
