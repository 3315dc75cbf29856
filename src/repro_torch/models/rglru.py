"""RG-LRU recurrent block (Griffin / RecurrentGemma).  [arXiv:2402.19427]

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
r_t / i_t: sigmoid gates (dense, as in the JAX package).

Train/prefill run the recurrence as a log-depth scan over the sequence
(:func:`linear_scan`: Hillis-Steele doubling, ceil(log2 S) elementwise
steps in f32); decode is a single-step update.  Parameters live in an
``nn.ParameterDict`` named as in the JAX package (``wx``, ``wg``,
``conv_w``, ``conv_b``, ``wa``, ``ba``, ``wi``, ``bi``, ``lam``, ``out``),
so the weight bridge maps them by name.

Cache: {"conv": (B, K-1, W) in the input's dtype, "state": (B, W) f32}.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models.layers import cast, dense_init, dot
from repro_torch.models.ssm import causal_conv1d, conv_step

Cache = Dict[str, torch.Tensor]

_C = 8.0


def init_rglru(cfg: ModelConfig, *, device, generator) -> nn.ParameterDict:
    d = cfg.d_model
    w = cfg.rglru.lru_width or d
    K = cfg.rglru.conv_kernel
    kw = dict(device=device, generator=generator)
    lam = 0.38 + 0.42 * torch.rand((w,), **kw)
    p = {
        "wx": dense_init(d, w, **kw),
        "wg": dense_init(d, w, **kw),
        "conv_w": torch.randn((K, w), **kw) / K,
        "conv_b": torch.zeros(w, device=device),
        "wa": dense_init(w, w, **kw),
        "ba": torch.zeros(w, device=device),
        "wi": dense_init(w, w, **kw),
        "bi": torch.zeros(w, device=device),
        "lam": lam,
        "out": dense_init(w, d, **kw),
    }
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in p.items()})


def _gates(p: Mapping[str, torch.Tensor], x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """log_a (f32) and the gated input sqrt(1 - a^2) * i * x (f32)."""
    xf = x.float()
    r = torch.sigmoid(dot(x, p["wa"]).float() + p["ba"])
    i = torch.sigmoid(dot(x, p["wi"]).float() + p["bi"])
    log_a = -_C * F.softplus(p["lam"]) * r
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return log_a, beta * i * xf


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0, as
    ``jax.lax.associative_scan`` of ``(al ar, ar bl + br)`` computes it:
    Hillis-Steele doubling, each step combining every element with the one
    ``shift`` before it (ceil(log2 S) steps, no loop over S)."""
    S = a.shape[1]
    shift = 1
    while shift < S:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift]
                       + b[:, shift:]], dim=1)
        if 2 * shift < S:
            a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]],
                          dim=1)
        shift *= 2
    return b


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def rglru_full(p: Mapping[str, torch.Tensor], cfg: ModelConfig,
               u: torch.Tensor, init_state: Optional[torch.Tensor] = None,
               return_cache: bool = False):
    """u (B,S,D) -> (B,S,D) [, cache]."""
    B, S, _ = u.shape
    K = cfg.rglru.conv_kernel
    gate = _gelu(dot(u, p["wg"]).float())
    xw = dot(u, p["wx"])
    x = causal_conv1d(xw, p["conv_w"]) + cast(p["conv_b"], xw.dtype)
    log_a, b = _gates(p, x)
    a = torch.exp(log_a)
    if init_state is not None:
        # fold the carried state into the first step
        b = torch.cat([b[:, :1] + a[:, :1] * init_state.float()[:, None],
                       b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    y = (h * gate).to(u.dtype)
    out = dot(y, p["out"])
    if return_cache:
        tail = (xw[:, S - (K - 1):] if S >= K - 1
                else F.pad(xw, (0, 0, K - 1 - S, 0)))
        return out, {"conv": tail, "state": h[:, -1]}
    return out


def rglru_cache_init(cfg: ModelConfig, batch: int, dtype, device) -> Cache:
    w = cfg.rglru.lru_width or cfg.d_model
    return {"conv": torch.zeros((batch, cfg.rglru.conv_kernel - 1, w),
                                dtype=dtype, device=device),
            "state": torch.zeros((batch, w), device=device)}


def rglru_decode(p: Mapping[str, torch.Tensor], cfg: ModelConfig,
                 u: torch.Tensor, cache: Cache, out: Optional[Cache] = None
                 ) -> Tuple[torch.Tensor, Cache]:
    """u (B,1,D) -> ((B,1,D), cache).  The new cache is written into
    ``out``'s tensors when given (``out`` may be ``cache`` itself: the old
    conv window and state are read before anything is written), else into
    new ones; ``cache`` is only read otherwise."""
    gate = _gelu(dot(u, p["wg"]).float())[:, 0]
    xw = dot(u, p["wx"])                                     # (B,1,W)
    window = torch.cat([cache["conv"], xw], dim=1)           # (B,K,W)
    x = conv_step(window, p["conv_w"]) + cast(p["conv_b"], xw.dtype)
    log_a, b = _gates(p, x[:, None, :])
    h = torch.exp(log_a[:, 0]) * cache["state"] + b[:, 0]
    y = (h * gate).to(u.dtype)[:, None, :]
    conv = window[:, 1:]
    if out is not None:
        conv = out["conv"].copy_(conv)
        h = out["state"].copy_(h)
    return dot(y, p["out"]), {"conv": conv, "state": h}
