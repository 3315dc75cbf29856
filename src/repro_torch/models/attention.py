"""GQA attention (covers MHA/MQA, bias, qk_norm, sliding window,
cross-attention): the full-sequence paths and the KV-cache serving path.
Parameters live in an ``nn.ParameterDict`` named as in the JAX package
(``wq``, ``wk``, ``wv``, ``wo``, optional ``bq``/``bk``/``bv`` and
``q_norm``/``k_norm``), so the weight bridge maps them by name; so do
MLA's (``wq``, ``wdkv``, ``kv_norm``, ``wukv``, ``wo``).

Cache layout (the JAX package's): ``{"k": (B, L, Hkv, hd), "v": (B, L,
Hkv, hd)}`` with L = max_len, or L = window with ring addressing (slot =
pos % window).  RoPE is applied before caching, so slot order does not
enter the attention.  A decode step's ``pos`` may be a 0-dim device
tensor: the row it writes and the keys it attends to are computed from it
on the device, so one captured graph serves every position.

MLA (DeepSeek multi-head latent attention) caches the compressed latent
instead: ``{"ckv": (B, L, kv_lora_rank), "kr": (B, L, qk_rope_head_dim)}``
(the RoPE'd shared key part), and up-projects K and V from it at every
step.  Its query/key width (nope + rope) differs from its value width, so
it attends through plain :func:`attend`, as the JAX package does.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.models.layers import (apply_rope, attend, cast,
                                      causal_mask, dense_init, dot, rms_norm)

Cache = Dict[str, torch.Tensor]


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
        q = q + cast(p["bq"], q.dtype)
        k = k + cast(p["bk"], k.dtype)
        v = v + cast(p["bv"], v.dtype)
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


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> Cache:
    shp = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def gqa_prefill(p: Mapping[str, torch.Tensor], cfg: ModelConfig,
                x: torch.Tensor, *, max_len: int, window: int = 0
                ) -> Tuple[torch.Tensor, Cache]:
    """Causal self-attention over the prompt; returns output + filled
    cache.  With ``window == max_len <= S`` the cache holds the last
    ``window`` rows at slot = position % window (the ring layout
    :func:`gqa_decode` continues); else the rows go to slots 0..S-1."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, x)
    pos = torch.arange(S, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    out = dispatch.attention(q, k, v, impl=cfg.attn_impl, causal=True,
                             window=window, block=cfg.attn_block,
                             scale=1.0 / math.sqrt(cfg.hd))
    # the cache is made like k (dtype, device and, for a DTensor, layout)
    shp = (B, max_len, cfg.n_kv_heads, cfg.hd)
    cache = {"k": k.new_zeros(shp), "v": v.new_zeros(shp)}
    if window and max_len == window and S >= window:
        slots = torch.arange(S - window, S, device=x.device) % window
        cache["k"][:, slots] = k[:, -window:]
        cache["v"][:, slots] = v[:, -window:]
    else:
        if S > max_len:
            raise ValueError(f"a {S}-token prompt does not fit a cache of "
                             f"{max_len} rows")
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
    return dot(out.reshape(B, S, -1), p["wo"]), cache


def _into(dst: Optional[torch.Tensor], src: torch.Tensor) -> torch.Tensor:
    """``src``'s values in ``dst`` (a new tensor when None); nothing is
    copied when ``dst`` already is ``src``'s memory (a cache updated in
    place)."""
    if dst is None:
        return src.clone()
    if dst.data_ptr() != src.data_ptr() or dst.stride() != src.stride():
        dst.copy_(src)
    return dst


def gqa_decode(p: Mapping[str, torch.Tensor], cfg: ModelConfig,
               x: torch.Tensor, cache: Cache, pos, *, ring: bool = False,
               out: Optional[Cache] = None) -> Tuple[torch.Tensor, Cache]:
    """One-token decode.  x (B,1,D); ``pos`` the token's position (an int
    or a 0-dim integer tensor).  The new cache is ``cache`` with the row at
    ``pos`` (``pos % L`` on a ring) replaced; the write lands at the last
    row for a position past the cache, where JAX's
    ``dynamic_update_slice`` clamps it.  It is written into ``out``'s
    tensors when given (``out`` may be ``cache`` itself: then only the row
    is written), else into new ones; ``cache`` is only read otherwise."""
    B = x.shape[0]
    q, k, v = _qkv(p, cfg, x, x)
    pos = torch.as_tensor(pos, dtype=torch.long, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    L = cache["k"].shape[1]
    slot = (pos % L if ring else pos.clamp(0, L - 1)).reshape(1)
    ck = _into(None if out is None else out["k"], cache["k"])
    cv = _into(None if out is None else out["v"], cache["v"])
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cv.index_copy_(1, slot, v.to(cv.dtype))
    valid = (torch.arange(L, device=x.device) <= pos)[None, None, None,
                                                      None, :]
    o = attend(q, ck, cv, valid, 1.0 / math.sqrt(cfg.hd))
    return dot(o.reshape(B, 1, -1), p["wo"]), {"k": ck, "v": cv}


def gqa_cross_cache(p: Mapping[str, torch.Tensor], cfg: ModelConfig,
                    memory: torch.Tensor) -> Cache:
    """Cross-attention K/V precomputed from encoder / image memory."""
    B, S, _ = memory.shape
    k = dot(memory, p["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = dot(memory, p["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    if cfg.qkv_bias:
        k = k + cast(p["bk"], k.dtype).reshape(1, 1, cfg.n_kv_heads, cfg.hd)
        v = v + cast(p["bv"], v.dtype).reshape(1, 1, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    return {"k": k, "v": v}


def gqa_cross_decode(p: Mapping[str, torch.Tensor], cfg: ModelConfig,
                     x: torch.Tensor, kv: Cache) -> torch.Tensor:
    """Cross-attention of one (or a few) query tokens against cached
    memory K/V."""
    B, S, _ = x.shape
    q = dot(x, p["wq"])
    if cfg.qkv_bias:
        q = q + cast(p["bq"], q.dtype)
    q = q.reshape(B, S, cfg.n_heads, cfg.hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
    o = attend(q, kv["k"], kv["v"], None, 1.0 / math.sqrt(cfg.hd))
    return dot(o.reshape(B, S, -1), p["wo"])


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------

def init_mla(cfg: ModelConfig, *, device, generator) -> nn.ParameterDict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    kw = dict(device=device, generator=generator)
    p = {
        "wq": dense_init(d, H * qd, **kw),
        "wdkv": dense_init(d, m.kv_lora_rank + m.qk_rope_head_dim, **kw),
        "kv_norm": torch.zeros(m.kv_lora_rank, device=device),
        "wukv": dense_init(m.kv_lora_rank,
                           H * (m.qk_nope_head_dim + m.v_head_dim), **kw),
        "wo": dense_init(H * m.v_head_dim, d, **kw),
    }
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in p.items()})


def _mla_q(p, cfg: ModelConfig, x: torch.Tensor, pos) -> torch.Tensor:
    m = cfg.mla
    B, S, _ = x.shape
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    q = dot(x, p["wq"]).reshape(B, S, cfg.n_heads, qd)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    return torch.cat([q_nope, q_rope], dim=-1)


def _mla_ckv(p, cfg: ModelConfig, x: torch.Tensor, pos
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    m = cfg.mla
    dkv = dot(x, p["wdkv"])
    ckv, kr = dkv.split([m.kv_lora_rank, m.qk_rope_head_dim], -1)
    ckv = rms_norm(ckv, p["kv_norm"], cfg.rms_eps)
    kr = apply_rope(kr[:, :, None, :], pos, cfg.rope_theta)[:, :, 0, :]
    return ckv, kr


def _mla_attend(p, cfg: ModelConfig, q: torch.Tensor, ckv: torch.Tensor,
                kr: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """q (B,Sq,H,nope+rope); ckv (B,Sk,r); kr (B,Sk,rope)."""
    m = cfg.mla
    B, Sk, _ = ckv.shape
    H = cfg.n_heads
    up = dot(ckv, p["wukv"]).reshape(B, Sk, H,
                                     m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = up.split([m.qk_nope_head_dim, m.v_head_dim], -1)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(
        B, Sk, H, m.qk_rope_head_dim)], dim=-1)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    out = attend(q, k, v, mask, scale)
    return dot(out.reshape(B, q.shape[1], -1), p["wo"])


def mla_full(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    q = _mla_q(p, cfg, x, pos)
    ckv, kr = _mla_ckv(p, cfg, x, pos)
    return _mla_attend(p, cfg, q, ckv, kr,
                       causal_mask(S, S, device=x.device))


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> Cache:
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank),
                               dtype=dtype, device=device),
            "kr": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                              dtype=dtype, device=device)}


def mla_prefill(p, cfg: ModelConfig, x: torch.Tensor, *, max_len: int
                ) -> Tuple[torch.Tensor, Cache]:
    """Causal MLA over the prompt; returns output + the latent cache with
    the prompt's rows at slots 0..S-1."""
    B, S, _ = x.shape
    if S > max_len:
        raise ValueError(f"a {S}-token prompt does not fit a cache of "
                         f"{max_len} rows")
    pos = torch.arange(S, device=x.device)
    q = _mla_q(p, cfg, x, pos)
    ckv, kr = _mla_ckv(p, cfg, x, pos)
    out = _mla_attend(p, cfg, q, ckv, kr,
                      causal_mask(S, S, device=x.device))
    # the cache is made like the latents (dtype, device, DTensor layout)
    cache = {"ckv": ckv.new_zeros((B, max_len, ckv.shape[-1])),
             "kr": kr.new_zeros((B, max_len, kr.shape[-1]))}
    cache["ckv"][:, :S] = ckv
    cache["kr"][:, :S] = kr
    return out, cache


def mla_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: Cache, pos, *,
               out: Optional[Cache] = None) -> Tuple[torch.Tensor, Cache]:
    """One-token decode.  x (B,1,D); ``pos`` an int or a 0-dim integer
    tensor.  The new cache is ``cache`` with the latent row at ``pos``
    replaced (at the last row for a position past the cache, where JAX's
    ``dynamic_update_slice`` clamps it), written into ``out``'s tensors
    when given (``out`` may be ``cache`` itself), else into new ones."""
    pos = torch.as_tensor(pos, dtype=torch.long, device=x.device)
    q = _mla_q(p, cfg, x, pos)
    ckv, kr = _mla_ckv(p, cfg, x, pos)
    L = cache["ckv"].shape[1]
    slot = pos.clamp(0, L - 1).reshape(1)
    cc = _into(None if out is None else out["ckv"], cache["ckv"])
    ck = _into(None if out is None else out["kr"], cache["kr"])
    cc.index_copy_(1, slot, ckv.to(cc.dtype))
    ck.index_copy_(1, slot, kr.to(ck.dtype))
    valid = (torch.arange(L, device=x.device) <= pos)[None, None, None,
                                                      None, :]
    return _mla_attend(p, cfg, q, cc, ck, valid), {"ckv": cc, "kr": ck}
