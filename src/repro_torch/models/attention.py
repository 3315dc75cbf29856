"""GQA attention (covers MHA/MQA, bias, qk_norm, cross-attention) for the
full-sequence paths.  Parameters live in an ``nn.ParameterDict`` named as
in the JAX package (``wq``, ``wk``, ``wv``, ``wo``, optional ``bq``/``bk``/
``bv`` and ``q_norm``/``k_norm``), so the weight bridge maps them by name.
The decode, prefill and MLA paths come with the LLM substrate.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.models.layers import apply_rope, dense_init, dot, rms_norm


def init_gqa(cfg: ModelConfig, *, device, generator) -> nn.ParameterDict:
    d, hd = cfg.d_model, cfg.hd
    p = {
        "wq": dense_init(d, cfg.n_heads * hd, device=device,
                         generator=generator),
        "wk": dense_init(d, cfg.n_kv_heads * hd, device=device,
                         generator=generator),
        "wv": dense_init(d, cfg.n_kv_heads * hd, device=device,
                         generator=generator),
        "wo": dense_init(cfg.n_heads * hd, d, device=device,
                         generator=generator),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(cfg.n_heads * hd, device=device)
        p["bk"] = torch.zeros(cfg.n_kv_heads * hd, device=device)
        p["bv"] = torch.zeros(cfg.n_kv_heads * hd, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(hd, device=device)
        p["k_norm"] = torch.zeros(hd, device=device)
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in p.items()})


def _qkv(p: Mapping[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
         kv_src: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    hd = cfg.hd
    q = dot(x, p["wq"])
    k = dot(kv_src, p["wk"])
    v = dot(kv_src, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, kv_src.shape[1], cfg.n_kv_heads, hd)
    v = v.reshape(B, kv_src.shape[1], cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    return q, k, v


def gqa_full(p: Mapping[str, torch.Tensor], cfg: ModelConfig,
             x: torch.Tensor, *, causal: bool = True, window: int = 0,
             memory: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (encoder / DiT self-attention / cross).

    Self-attention gets RoPE (the DiT's too, on top of its learned
    position table); cross-attention to ``memory`` does not.  The backend
    is ``cfg.attn_impl`` through the kernel dispatch layer."""
    kv_src = memory if memory is not None else x
    q, k, v = _qkv(p, cfg, x, kv_src)
    if memory is None:
        pos = torch.arange(x.shape[1], device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out = dispatch.attention(q, k, v, impl=cfg.attn_impl, causal=causal,
                             window=window, block=cfg.attn_block,
                             scale=1.0 / math.sqrt(cfg.hd))
    return dot(out.reshape(*x.shape[:2], -1), p["wo"])
