"""Functional optimizers on parameter trees (optax-style, as in the JAX
package).

An optimizer is a pair (init, update):
    state = init(params)
    updates, state = update(grads, state, params, lr)
``apply_updates`` adds updates (already scaled by -lr) to params.  Trees
are the JAX package's nesting (``repro_torch.tree``), so a per-leaf rule
sees the same leaves as JAX: adafactor's update clip takes one RMS over a
whole leaf, and a DiT block weight is one (layers, d_in, d_out) leaf.
Nothing is updated in place.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import tree as tu
from repro_torch.config import OptimConfig


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the norm
    before clipping)."""
    g2 = sum(torch.sum(torch.square(g.float())) for g in tu.leaves(grads))
    norm = torch.sqrt(g2)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tu.tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _count(params) -> torch.Tensor:
    device = next(iter(tu.leaves(params))).device
    return torch.zeros((), dtype=torch.int32, device=device)


def adamw(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> Optimizer:
    def init(params):
        return {
            "mu": tu.tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params),
            "nu": tu.tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params),
            "count": _count(params),
        }

    def update(grads, state, params, lr):
        c = state["count"] + 1
        mu = tu.tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                         state["mu"], grads)
        nu = tu.tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(
            g.float()), state["nu"], grads)
        bc1 = 1 - b1 ** c.float()
        bc2 = 1 - b2 ** c.float()

        def upd(m, v, p):
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return (-lr * step).to(p.dtype)

        updates = tu.tree_map(upd, mu, nu, params)
        return updates, {"mu": mu, "nu": nu, "count": c}

    return Optimizer(init, update)


def adafactor(eps=1e-30, decay=0.8, clip_threshold=1.0) -> Optimizer:
    """Factored second-moment optimizer — the memory-lean option for the
    biggest training configs (state is O(rows+cols) for matrices vs Adam's
    2x full)."""

    def _factored(p):
        return p.ndim >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1

    def init(params):
        def per_leaf(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"s": tu.tree_map(per_leaf, params),
                "count": _count(params)}

    def update(grads, state, params, lr):
        c = state["count"] + 1
        beta = 1.0 - c.float() ** (-decay)

        def per_leaf(g, s, p):
            gf = g.float()
            g2 = torch.square(gf) + eps
            if _factored(p):
                vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = torch.sqrt(
                    vr[..., None] * vc[..., None, :]
                    / torch.clamp_min(vr.mean(dim=-1, keepdim=True)[..., None],
                                      eps))
                upd = gf / torch.clamp_min(denom, eps)
                ns = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                upd = gf / torch.sqrt(v + eps)
                ns = {"v": v}
            # one RMS over the whole leaf (all layers of a stacked weight)
            rms = torch.sqrt(torch.mean(torch.square(upd)) + 1e-12)
            upd = upd / torch.clamp_min(rms / clip_threshold, 1.0)
            return (-lr * upd).to(p.dtype), ns

        out = tu.tree_map(per_leaf, grads, state["s"], params)
        updates = tu.tree_map(lambda p, o: o[0], params, out)
        new_s = tu.tree_map(lambda p, o: o[1], params, out)
        return updates, {"s": new_s, "count": c}

    return Optimizer(init, update)


def make_optimizer(cfg: OptimConfig) -> Optimizer:
    if cfg.kind == "adamw":
        return adamw(cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay)
    if cfg.kind == "adafactor":
        return adafactor()
    raise ValueError(cfg.kind)


def apply_updates(params, updates):
    return tu.tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
