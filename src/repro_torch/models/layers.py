"""Shared neural-net building blocks.

Conventions (the JAX package's, kept at every public function so the
parity tests compare like with like):

* weights are (d_in, d_out) f32 and applied as ``x @ w.to(x.dtype)``
  (:func:`dot`), so activations run in the config's ``dtype``;
* shapes: x (B, S, D); attention heads last-but-one: q (B, S, H, hd).

Weights cast once: :func:`cast_weights_` gives a parameter a copy in a
lower activation dtype, bitwise ``w.to(dtype)``, which :func:`cast` (and so
:func:`dot`) reads instead of casting again on every call.  The copy is
keyed on the parameter's ``_version`` and device: an in-place write to the
weights (the weight bridge's ``copy_``, ``load_state_dict``) or a move to
another device makes it stale, and a stale copy is never read; nor is a
copy read while autograd records through the parameter.  A copy,
once made, keeps its storage: refreshing it writes in place, so a CUDA
graph captured on it stays valid.
"""
from __future__ import annotations

import math
from typing import Iterable, Mapping, Optional

import torch
import torch.nn.functional as F


def cast(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w.to(dtype)``: its cast-once copy when it holds a current one and
    autograd is not recording through ``w`` (the copy is detached, so
    reading it there would cut ``w``'s gradient)."""
    if torch.is_grad_enabled() and w.requires_grad:
        return w.to(dtype)
    held = getattr(w, "_casts", {}).get(dtype)
    if (held is not None and held[0] == w._version
            and held[1].device == w.device):
        return held[1]
    return w.to(dtype)


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with the weight cast to the activation dtype."""
    return x @ cast(w, x.dtype)


def cast_weights_(params: Iterable[torch.Tensor], dtype: torch.dtype) -> int:
    """Make or refresh each parameter's copy in ``dtype`` (none when it
    already has that dtype) and return the copies' bytes.  A current copy
    is left alone, a stale one rewritten in place."""
    total = 0
    with torch.no_grad():
        for p in params:
            if p.dtype == dtype:
                continue
            casts = p.__dict__.setdefault("_casts", {})
            held = casts.get(dtype)
            if held is None or held[1].device != p.device:
                held = (p._version, p.detach().to(dtype))
            elif held[0] != p._version:
                held = (p._version, held[1].copy_(p))
            casts[dtype] = held
            total += held[1].numel() * held[1].element_size()
    return total


def named_casts(module: torch.nn.Module, names: Iterable[str]
                ) -> Iterable[torch.Tensor]:
    """``module``'s parameters whose last name component is in ``names``:
    the weights a model reads in its activation dtype."""
    names = set(names)
    return (p for n, p in module.named_parameters()
            if n.rsplit(".", 1)[-1] in names)


def dense_init(d_in: int, d_out: int, *, device, generator) -> torch.Tensor:
    return torch.randn((d_in, d_out), device=device,
                       generator=generator) / math.sqrt(d_in)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); pos: integer positions broadcastable to
    (..., S); a 0-dim ``pos`` (a decode step's, on the device) is one
    position."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (hd/2,)
    pos = pos.reshape(1) if pos.ndim == 0 else pos
    ang = pos[..., :, None, None].float() * freqs             # (..,S,1,hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_mlp(d: int, ff: int, kind: str, *, device,
             generator) -> dict:
    p = {"wi": dense_init(d, ff, device=device, generator=generator)}
    if kind == "swiglu":
        p["wg"] = dense_init(d, ff, device=device, generator=generator)
    p["wo"] = dense_init(ff, d, device=device, generator=generator)
    return p


def apply_mlp(p: Mapping[str, torch.Tensor], x: torch.Tensor,
              kind: str) -> torch.Tensor:
    if kind == "swiglu":
        return dot(F.silu(dot(x, p["wg"])) * dot(x, p["wi"]), p["wo"])
    # jax.nn.gelu defaults to the tanh approximation
    return dot(F.gelu(dot(x, p["wi"]), approximate="tanh"), p["wo"])


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Sk,Hkv,hd) with H % Hkv == 0 -> (B,Sq,H,hd).

    Materialises the (Sq, Sk) scores in f32; GQA via reshape."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    q5 = q.reshape(B, Sq, Hkv, g, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q5.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask, scores,
                             torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def causal_mask(sq: int, sk: int, q_offset: int = 0, window: int = 0,
                device=None) -> torch.Tensor:
    """(1,1,1,sq,sk) boolean mask, query i at position i + q_offset;
    window=0 means full causal."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    ki = torch.arange(sk, device=device)[None, :]
    m = ki <= qi
    if window:
        m &= ki > qi - window
    return m[None, None, None]


def attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window: int, scale: float,
                   block: int = 1024) -> torch.Tensor:
    """Online-softmax attention with the key axis looped in blocks: never
    materialises the (Sq, Sk) scores.  Same semantics as :func:`attend`."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qr = q.reshape(B, Sq, Hkv, g, hd)
    qi = torch.arange(Sq, device=q.device)
    m = torch.full((B, Hkv, g, Sq, 1), -1e30, device=q.device)
    l = torch.zeros((B, Hkv, g, Sq, 1), device=q.device)
    acc = torch.zeros((B, Hkv, g, Sq, hd), device=q.device)
    for k0 in range(0, Sk, block):
        kc, vc = k[:, k0:k0 + block], v[:, k0:k0 + block]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qr.float(), kc.float()) * scale
        ki = k0 + torch.arange(kc.shape[1], device=q.device)
        valid = torch.ones((Sq, kc.shape[1]), dtype=torch.bool,
                           device=q.device)
        if causal:
            valid &= ki[None, :] <= qi[:, None]
        if window:
            valid &= ki[None, :] > qi[:, None] - window
        s = torch.where(valid, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(vc.dtype), vc).float()
        m = m_new
    out = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
