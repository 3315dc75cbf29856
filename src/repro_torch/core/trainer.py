"""Algorithm 2 — Shared Diffusion Training, plus the Standard-FT baseline.

Functional train-step factories, as in the JAX package; state =
{"params", "lora", "opt", "step"} with ``params`` in the JAX layout
(``models.dit.stacked_params``).  When ``lora_rank > 0`` only the LoRA
tree is optimised (paper §3.1) and the base weights are left as they are;
otherwise full fine-tune.  10% condition dropout trains the null branch
for CFG (standard LDM practice; the null condition is the zero tensor).

A step is ``step(state, batch, draws) -> (new_state, metrics)``: the
JAX step's order (gradients, clip by global norm, optimizer update, apply),
autograd in place of ``jax.value_and_grad``, and the step's random draws
(cond-dropout mask, timesteps, noise) an argument: :func:`sage_step_draws`
and :func:`standard_step_draws` fill them from a ``torch.Generator``.

The denoiser runs its plain routes, as the JAX package differentiates
only through its jnp routes: a model config on the kernel attention route
raises in the kernel's wrapper (the kernels have no backward).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device, seeded_generator
from repro_torch import tree as tu
from repro_torch.config import ModelConfig, OptimConfig, SageConfig
from repro_torch.core import lora as lora_lib
from repro_torch.core import sage_loss as losses
from repro_torch.core.schedule import Schedule
from repro_torch.models import dit
from repro_torch.optim.optimizers import (apply_updates, clip_by_global_norm,
                                          make_optimizer)

Params = Dict[str, Any]
Draws = Dict[str, torch.Tensor]

COND_DROP = 0.1


def init_state(model_cfg: ModelConfig, opt_cfg: OptimConfig, seed: int = 0,
               lora_rank: int = 0, base_params: Optional[Params] = None, *,
               device="cuda") -> Dict[str, Any]:
    """A fresh train state.  The DiT weights are ``base_params`` (JAX
    layout, on ``device``) or a new :class:`~repro_torch.models.dit.DiT`'s
    drawn from ``seed``; LoRA's ``a`` comes from ``seeded_generator(seed,
    1)``."""
    device = resolve_device(device)
    if base_params is None:
        base_params = dit.init_params(
            model_cfg, device=device,
            generator=torch.Generator(device=device).manual_seed(seed))
    opt = make_optimizer(opt_cfg)
    if lora_rank:
        lo = lora_lib.init_lora(base_params, lora_rank,
                                seeded_generator(seed, 1))
        opt_state = opt.init(lo)
    else:
        lo = None
        opt_state = opt.init(base_params)
    return {"params": base_params, "lora": lo, "opt": opt_state,
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _eps_fn(model_cfg: ModelConfig, params: Params, lo: Optional[Params],
            remat: bool = False):
    eff = lora_lib.merge(params, lo) if lo is not None else params

    def eps_fn(z, t, c):
        return dit.forward(eff, model_cfg, z, t, c, remat=remat)

    return eps_fn


def _drop_cond(keep: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """Zero the conditions whose ``keep`` entry is False (keep has the
    batch axes of cond)."""
    shape = tuple(keep.shape) + (1,) * (cond.ndim - keep.ndim)
    return cond * keep.reshape(shape).to(cond.dtype)


def sage_step_draws(generator: torch.Generator, sage: SageConfig,
                    sched: Schedule, k: int, n: int, latent: Sequence[int],
                    device) -> Draws:
    """A SAGE step's draws: ``keep`` (K, N), True where a member keeps its
    condition (probability 1 - ``COND_DROP``), and :func:`sage_draws`'."""
    keep = torch.rand((k, n), generator=generator) > COND_DROP
    return {"keep": keep.to(device),
            **losses.sage_draws(generator, sage, sched, k, latent, device)}


def standard_step_draws(generator: torch.Generator, sched: Schedule,
                        shape: Sequence[int], device) -> Draws:
    """A standard step's draws for latents of ``shape`` (B, H, W, C)."""
    keep = torch.rand((shape[0],), generator=generator) > COND_DROP
    return {"keep": keep.to(device),
            **losses.ldm_draws(generator, sched, shape, device)}


def value_and_grad(fn: Callable, trainable: Params, *args
                   ) -> Tuple[Any, Params]:
    """``jax.value_and_grad(fn, has_aux=...)(trainable, *args)``: fn's
    output (detached) and the gradient of its loss (the output, or its
    first item) with respect to every leaf of ``trainable``."""
    leaves = [x.detach().requires_grad_(True) for x in tu.leaves(trainable)]
    with torch.enable_grad():
        out = fn(tu.unflatten(trainable, leaves), *args)
        loss = out[0] if isinstance(out, tuple) else out
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    detached = tu.tree_map(lambda x: x.detach(), out)
    return detached, tu.unflatten(trainable, grads)


def _split(state: Dict[str, Any], lora_rank: int):
    if lora_rank:
        return state["lora"], state["params"]
    return state["params"], None


def _apply_step(state, trainable, grads, opt, opt_cfg: OptimConfig,
                lora_rank: int):
    grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
    updates, opt_state = opt.update(grads, state["opt"], trainable,
                                    opt_cfg.lr)
    new_state = dict(state)
    new_state["opt"] = opt_state
    new_state["step"] = state["step"] + 1
    new_state["lora" if lora_rank else "params"] = apply_updates(trainable,
                                                                 updates)
    return new_state, gnorm


def make_sage_loss(model_cfg: ModelConfig, sage: SageConfig, sched: Schedule,
                   lora_rank: int = 0, remat: bool = False):
    """The SAGE step's objective: ``loss_fn(trainable, frozen, batch,
    draws) -> (loss, parts)``, trainable the params (full fine-tune) or
    the LoRA tree over the frozen params."""
    def loss_fn(trainable, frozen, batch, draws):
        params, lo = ((frozen, trainable) if lora_rank
                      else (trainable, None))
        cond = _drop_cond(draws["keep"], batch["cond"])
        eps_fn = _eps_fn(model_cfg, params, lo, remat)
        return losses.sage_loss(eps_fn, sched, sage, draws, batch["z"], cond,
                                batch["mask"])

    return loss_fn


def make_sage_train_step(model_cfg: ModelConfig, sage: SageConfig,
                         sched: Schedule, opt_cfg: OptimConfig,
                         lora_rank: int = 0, remat: bool = False):
    """batch = {"z": (K,N,H,W,C), "cond": (K,N,Lc,dc), "mask": (K,N)};
    draws from :func:`sage_step_draws`.  ``sched`` lies on the batch's
    device.  Metrics: loss, gnorm and the three parts of Eq. 3."""
    opt = make_optimizer(opt_cfg)
    loss_fn = make_sage_loss(model_cfg, sage, sched, lora_rank, remat)

    def step(state, batch, draws):
        trainable, frozen = _split(state, lora_rank)
        (loss, parts), grads = value_and_grad(loss_fn, trainable, frozen,
                                              batch, draws)
        new_state, gnorm = _apply_step(state, trainable, grads, opt, opt_cfg,
                                       lora_rank)
        return new_state, {"loss": loss, "gnorm": gnorm, **parts}

    return step


def make_standard_loss(model_cfg: ModelConfig, sched: Schedule,
                       lora_rank: int = 0, remat: bool = False):
    """The Standard-FT objective, ``loss_fn(trainable, frozen, batch,
    draws) -> loss``."""
    def loss_fn(trainable, frozen, batch, draws):
        params, lo = ((frozen, trainable) if lora_rank
                      else (trainable, None))
        cond = _drop_cond(draws["keep"], batch["cond"])
        eps_fn = _eps_fn(model_cfg, params, lo, remat)
        return losses.ldm_loss(eps_fn, sched, draws, batch["z"], cond)

    return loss_fn


def make_standard_train_step(model_cfg: ModelConfig, sched: Schedule,
                             opt_cfg: OptimConfig, lora_rank: int = 0,
                             remat: bool = False):
    """Standard-FT baseline: plain LDM loss on individual (z, c) pairs.
    batch = {"z": (B,H,W,C), "cond": (B,Lc,dc)}; draws from
    :func:`standard_step_draws`."""
    opt = make_optimizer(opt_cfg)
    loss_fn = make_standard_loss(model_cfg, sched, lora_rank, remat)

    def step(state, batch, draws):
        trainable, frozen = _split(state, lora_rank)
        loss, grads = value_and_grad(loss_fn, trainable, frozen, batch,
                                     draws)
        new_state, gnorm = _apply_step(state, trainable, grads, opt, opt_cfg,
                                       lora_rank)
        return new_state, {"loss": loss, "gnorm": gnorm}

    return step
