"""Latent DiT denoiser: patchified latent transformer, adaLN-zero timestep
conditioning, cross-attention text conditioning (PixArt-style).

eps = DiT(cfg)(z_t, t, cond)   # epsilon-prediction, z NHWC (no autograd)

Training runs the same body on the JAX package's parameter layout
(:func:`forward` on :func:`stacked_params`' tree), which the optimizer,
the LoRA adapters and the checkpoints share with it.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, cast, cast_weights_,
                                      dense_init, dot, init_mlp,
                                      named_casts)

_TDIM = 256
#: the parameters the forward reads in the activation dtype (the timestep
#: MLP and the adaLN projections run in f32, the q/k norms in f32)
CAST = ("patch_in", "pos", "cond_proj", "wq", "wk", "wv", "wo", "bq", "bk",
        "bv", "lnx", "wi", "wg", "out")


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
    when not given).  On the meta device nothing is drawn: the shapes
    only, as ``jax.eval_shape`` gives them."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None and device.type != "meta":
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
        # the weights cast_weights_ casts, found once
        self._cast = tuple(named_casts(self, CAST))

    def cast_weights_(self, dtype: Optional[torch.dtype] = None) -> int:
        """Cast the weights the forward reads in ``dtype`` (default: the
        config's activation dtype) once; returns the copies' bytes (0 in
        f32).  Call it again after the weights change in place: stale
        copies are refreshed where they lie."""
        return cast_weights_(self._cast,
                             dtype or getattr(torch, self.cfg.dtype))

    def forward_grad(self, z: torch.Tensor, t: torch.Tensor,
                     cond: torch.Tensor, cfg: Optional[ModelConfig] = None,
                     *, remat: bool = False) -> torch.Tensor:
        """:func:`forward` on the module's own weights, recorded by
        autograd when grad mode is on: ``self(...)`` without the
        ``no_grad``."""
        params = dict(self.named_parameters(recurse=False))
        params["blocks"] = self.blocks
        return forward(params, cfg or self.cfg, z, t, cond, remat=remat)

    @torch.no_grad()
    def forward(self, z: torch.Tensor, t: torch.Tensor,
                cond: torch.Tensor,
                cfg: Optional[ModelConfig] = None) -> torch.Tensor:
        """z (B,H,W,C) latents at time t; t (B,); cond (B,Lc,cond_dim)
        -> eps (B,H,W,C) f32.  ``cfg`` (default ``self.cfg``) is a caller's
        own copy of the config, with its own attention route: a serving
        engine passes its own and never writes into the module."""
        return self.forward_grad(z, t, cond, cfg)


def stacked_params(model: DiT) -> Dict[str, object]:
    """A copy of ``model``'s weights in the layout of the JAX package's
    ``dit.init_params``: nested dicts of tensors, each block weight
    stacked over a leading layer axis."""
    with torch.no_grad():
        tree = {k: v.detach().clone() for k, v in
                model.named_parameters(recurse=False)}
        tree["blocks"] = _stack([_block_tree(b) for b in model.blocks])
    return tree


def init_params(cfg: ModelConfig, *, device="cuda",
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, object]:
    """A fresh :class:`DiT`'s weights in the JAX layout
    (:func:`stacked_params`)."""
    return stacked_params(DiT(cfg, device=device, generator=generator))


def _block_tree(block: nn.Module) -> Dict[str, object]:
    return {**dict(block.named_parameters(recurse=False)),
            **dict(block.named_children())}


def _stack(trees: Sequence[Mapping]) -> Dict[str, object]:
    return {k: (torch.stack([t[k].detach() for t in trees])
                if isinstance(v, torch.Tensor)
                else _stack([t[k] for t in trees]))
            for k, v in trees[0].items()}


def _unstack(tree: Mapping) -> List[Dict[str, object]]:
    """Per-layer views of a stacked block tree (``unbind``: the gradient
    of each leaf comes back as one stacked tensor)."""
    parts = {k: (_unstack(v) if isinstance(v, Mapping) else v.unbind(0))
             for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _layers(blocks) -> List[Mapping]:
    if isinstance(blocks, Mapping):
        return _unstack(blocks)
    return [_block_tree(b) for b in blocks]


def _block(bp: Mapping, x: torch.Tensor, tmod: torch.Tensor,
           c: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One adaLN-zero block: self-attention, cross-attention, MLP."""
    dtype = x.dtype
    mod = tmod @ bp["adaln"].to(tmod.dtype) + bp["adaln_b"].to(tmod.dtype)
    sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
    h = _mod(_ln(x), sh1.to(dtype), sc1.to(dtype))
    x = x + g1[:, None, :].to(dtype) * attn.gqa_full(
        bp["attn"], cfg, h, causal=False)
    hx = _ln(x) * (1.0 + cast(bp["lnx"], dtype))
    x = x + attn.gqa_full(bp["xattn"], cfg, hx, causal=False, memory=c)
    h = _mod(_ln(x), sh2.to(dtype), sc2.to(dtype))
    return x + g2[:, None, :].to(dtype) * apply_mlp(bp["mlp"], h,
                                                    cfg.mlp_kind)


def forward(params: Mapping, cfg: ModelConfig, z: torch.Tensor,
            t: torch.Tensor, cond: torch.Tensor,
            remat: bool = False) -> torch.Tensor:
    """The JAX package's ``dit.forward``: z (B,H,W,C) latents at time t;
    t (B,); cond (B,Lc,cond_dim) -> eps (B,H,W,C) f32.

    ``params`` is the JAX nesting: :func:`stacked_params`' tree (block
    weights stacked over the layer axis, the trainer's), or the module's
    own parameters with ``blocks`` its layer list (:meth:`DiT.forward`).
    ``remat`` recomputes each block in the backward pass
    (``torch.utils.checkpoint``) instead of keeping its activations, as
    ``jax.checkpoint`` does around the JAX scan's body."""
    dtype = getattr(torch, cfg.dtype)
    hp, wp = z.shape[1] // cfg.patch, z.shape[2] // cfg.patch
    x = dot(patchify(cfg, z).to(dtype), params["patch_in"])
    x = x + pos_embed(cast(params["pos"], dtype), cfg, hp, wp)[None]
    temb = timestep_embedding(t)
    temb = dot(F.silu(dot(temb, params["t_w1"])), params["t_w2"])  # (B, d)
    c = dot(cond.to(dtype), params["cond_proj"])                    # (B,Lc,d)
    tmod = F.silu(temb)
    for bp in _layers(params["blocks"]):
        if remat:
            x = checkpoint(_block, bp, x, tmod, c, cfg, use_reentrant=False)
        else:
            x = _block(bp, x, tmod, c, cfg)
    fmod = (tmod @ params["final_adaln"].to(tmod.dtype)
            + params["final_adaln_b"].to(tmod.dtype))
    shf, scf = fmod.chunk(2, dim=-1)
    x = _mod(_ln(x), shf.to(dtype), scf.to(dtype))
    out = dot(x, params["out"])
    return unpatchify(cfg, out, (hp, wp)).float()
