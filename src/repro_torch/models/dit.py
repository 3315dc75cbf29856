"""Latent DiT denoiser: patchified latent transformer, adaLN-zero timestep
conditioning, cross-attention text conditioning (PixArt-style).

eps = DiT(cfg)(z_t, t, cond)   # epsilon-prediction, z NHWC
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_mlp, dense_init, dot, init_mlp

_TDIM = 256


def timestep_embedding(t: torch.Tensor, dim: int = _TDIM) -> torch.Tensor:
    """Sinusoidal embedding; t (B,) float or int -> (B, dim) f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _ln(x: torch.Tensor) -> torch.Tensor:
    """Parameter-free LayerNorm (affine comes from adaLN modulation)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-6)).to(x.dtype)


def _mod(x: torch.Tensor, shift: torch.Tensor,
         scale: torch.Tensor) -> torch.Tensor:
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def n_tokens(cfg: ModelConfig) -> int:
    return (cfg.latent_size // cfg.patch) ** 2


def patchify(cfg: ModelConfig, z: torch.Tensor) -> torch.Tensor:
    B, H, W, C = z.shape
    p = cfg.patch
    z = z.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    return z.reshape(B, (H // p) * (W // p), p * p * C)


def unpatchify(cfg: ModelConfig, x: torch.Tensor,
               hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    B, n, _ = x.shape
    p, C = cfg.patch, cfg.latent_channels
    hp, wp = (math.isqrt(n),) * 2 if hw is None else hw
    x = x.reshape(B, hp, wp, p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, hp * p, wp * p, C)


def pos_embed(pos: torch.Tensor, cfg: ModelConfig, hp: int,
              wp: int) -> torch.Tensor:
    """Positional table for an (hp, wp) patch grid: the full square table,
    or its top-left window for a smaller latent."""
    hw = cfg.latent_size // cfg.patch
    if (hp, wp) == (hw, hw):
        return pos
    if hp > hw or wp > hw:
        raise ValueError(f"patch grid ({hp},{wp}) exceeds pos table {hw}")
    return pos.reshape(hw, hw, -1)[:hp, :wp].reshape(hp * wp, -1)


def _param(x: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(x)


class DiTBlock(nn.Module):
    """adaLN-zero block: self-attention, cross-attention, MLP."""

    def __init__(self, cfg: ModelConfig, *, device, generator):
        super().__init__()
        d = cfg.d_model
        self.adaln = _param(torch.zeros(d, 6 * d, device=device))
        self.adaln_b = _param(torch.zeros(6 * d, device=device))
        self.attn = attn.init_gqa(cfg, device=device, generator=generator)
        self.lnx = _param(torch.zeros(d, device=device))
        self.xattn = attn.init_gqa(cfg, device=device, generator=generator)
        self.mlp = nn.ParameterDict({
            k: _param(v) for k, v in init_mlp(
                d, cfg.d_ff, cfg.mlp_kind, device=device,
                generator=generator).items()})


class DiT(nn.Module):
    """The denoiser.  Weights are f32 (d_in, d_out); activations run in
    ``cfg.dtype``.  ``device`` defaults to CUDA and raises without a GPU;
    the initial weights come from ``generator`` (seeded 0 on ``device``
    when not given)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.cfg = cfg
        d = cfg.d_model
        p_in = cfg.patch * cfg.patch * cfg.latent_channels
        kw = dict(device=device, generator=generator)
        self.patch_in = _param(dense_init(p_in, d, **kw))
        self.pos = _param(torch.randn((n_tokens(cfg), d), **kw) * 0.02)
        self.t_w1 = _param(dense_init(_TDIM, d, **kw))
        self.t_w2 = _param(dense_init(d, d, **kw))
        self.cond_proj = _param(dense_init(cfg.cond_dim, d, **kw))
        self.blocks = nn.ModuleList(DiTBlock(cfg, **kw)
                                    for _ in range(cfg.n_layers))
        self.final_adaln = _param(torch.zeros(d, 2 * d, device=device))
        self.final_adaln_b = _param(torch.zeros(2 * d, device=device))
        # small (not zero) init, as in the JAX package
        self.out = _param(dense_init(d, p_in, **kw) * 0.02)

    @torch.no_grad()
    def forward(self, z: torch.Tensor, t: torch.Tensor,
                cond: torch.Tensor) -> torch.Tensor:
        """z (B,H,W,C) latents at time t; t (B,); cond (B,Lc,cond_dim)
        -> eps (B,H,W,C) f32."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        hp, wp = z.shape[1] // cfg.patch, z.shape[2] // cfg.patch
        x = dot(patchify(cfg, z).to(dtype), self.patch_in)
        x = x + pos_embed(self.pos, cfg, hp, wp).to(dtype)[None]
        temb = timestep_embedding(t)
        temb = dot(F.silu(dot(temb, self.t_w1)), self.t_w2)       # (B, d)
        c = dot(cond.to(dtype), self.cond_proj)                   # (B, Lc, d)
        tmod = F.silu(temb)
        for bp in self.blocks:
            mod = (tmod @ bp.adaln.to(tmod.dtype)
                   + bp.adaln_b.to(tmod.dtype))
            sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
            h = _mod(_ln(x), sh1.to(dtype), sc1.to(dtype))
            x = x + g1[:, None, :].to(dtype) * attn.gqa_full(
                bp.attn, cfg, h, causal=False)
            hx = _ln(x) * (1.0 + bp.lnx.to(dtype))
            x = x + attn.gqa_full(bp.xattn, cfg, hx, causal=False, memory=c)
            h = _mod(_ln(x), sh2.to(dtype), sc2.to(dtype))
            x = x + g2[:, None, :].to(dtype) * apply_mlp(bp.mlp, h,
                                                         cfg.mlp_kind)
        fmod = (tmod @ self.final_adaln.to(tmod.dtype)
                + self.final_adaln_b.to(tmod.dtype))
        shf, scf = fmod.chunk(2, dim=-1)
        x = _mod(_ln(x), shf.to(dtype), scf.to(dtype))
        out = dot(x, self.out)
        return unpatchify(cfg, out, (hp, wp)).float()
