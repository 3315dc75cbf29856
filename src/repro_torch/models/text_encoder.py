"""Two-tower CLIP-style encoders.

* text tower: byte-level causal transformer.  Per-token features feed the
  DiT cross-attention (the ``c`` of Alg. 1/2); the masked-mean-pooled,
  L2-normalised embedding drives semantic grouping (cosine similarity,
  paper §2.2) and the CLIP-proxy metric.
* image tower: small patch transformer for the CLIP-proxy metric.

``contrastive_loss`` trains both towers jointly on (image, prompt) pairs.
The serving path calls ``TextTower.forward`` (no autograd); training calls
``forward_grad`` and :func:`encode_image` under autograd.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, dense_init, dot, init_mlp,
                                      rms_norm)

BOS = 256
PAD = 257       # EOS and padding


def text_cfg(dim: int = 256, layers: int = 4, vocab: int = 258
             ) -> ModelConfig:
    return ModelConfig(name="text-tower", family="dense", n_layers=layers,
                       d_model=dim, n_heads=4, n_kv_heads=4, d_ff=4 * dim,
                       vocab=vocab, mlp_kind="gelu")


def tokenize(prompts: Sequence[str], max_len: int = 64,
             device="cpu") -> torch.Tensor:
    """Byte tokenizer: BOS(256), bytes, then EOS/pad(257) -> (B, L) int64."""
    out = np.full((len(prompts), max_len), PAD, np.int64)
    for i, s in enumerate(prompts):
        bs = list(s.encode("utf-8"))[: max_len - 2]
        out[i, 0] = BOS
        out[i, 1:1 + len(bs)] = bs
    return torch.from_numpy(out).to(device)


class TextBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, generator):
        super().__init__()
        self.ln1 = nn.Parameter(torch.zeros(cfg.d_model, device=device))
        self.attn = attn.init_gqa(cfg, device=device, generator=generator)
        self.ln2 = nn.Parameter(torch.zeros(cfg.d_model, device=device))
        self.mlp = nn.ParameterDict({
            k: nn.Parameter(v) for k, v in init_mlp(
                cfg.d_model, cfg.d_ff, cfg.mlp_kind, device=device,
                generator=generator).items()})


class TextTower(nn.Module):
    """Causal byte-level tower.  ``device`` defaults to CUDA and raises
    without a GPU; initial weights come from ``generator``."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.randn(
            (cfg.vocab, cfg.d_model), device=device,
            generator=generator) * 0.02)
        self.blocks = nn.ModuleList(
            TextBlock(cfg, device=device, generator=generator)
            for _ in range(cfg.n_layers))
        self.ln_f = nn.Parameter(torch.zeros(cfg.d_model, device=device))

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, L) -> (features (B, L, d), pooled (B, d))."""
        return self.forward_grad(tokens)

    def forward_grad(self, tokens: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`forward` recorded by autograd when grad mode is on."""
        x = _blocks(self.blocks, self.cfg, self.embed[tokens], causal=True)
        x = rms_norm(x, self.ln_f)
        # masked mean pool over non-pad tokens, then L2 normalisation
        not_pad = (tokens != PAD).float()[..., None]
        pooled = (x * not_pad).sum(dim=1) / torch.clamp_min(
            not_pad.sum(dim=1), 1.0)
        pooled = pooled / torch.linalg.norm(pooled, dim=-1, keepdim=True)
        return x, pooled


def _blocks(blocks, cfg: ModelConfig, x: torch.Tensor,
            causal: bool) -> torch.Tensor:
    for bp in blocks:
        x = x + attn.gqa_full(bp.attn, cfg, rms_norm(x, bp.ln1),
                              causal=causal)
        x = x + apply_mlp(bp.mlp, rms_norm(x, bp.ln2), cfg.mlp_kind)
    return x


def encode_text(tower: TextTower, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``encode_text``: (features, pooled)."""
    return tower(tokens)


class ImageTower(nn.Module):
    """Patch transformer over (B, image, image, 3) images: ``patch``-sized
    patches, ``layers`` non-causal blocks of width ``dim`` (the text
    tower's block), mean-pooled.  ``cfg_dim`` is the JAX tree's zero-size
    marker leaf, kept so that the two trees have the same leaves."""

    def __init__(self, dim: int = 256, patch: int = 8, image: int = 64,
                 layers: int = 4, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.cfg = text_cfg(dim, layers)
        self.patch = patch
        kw = dict(device=device, generator=generator)
        self.cfg_dim = nn.Parameter(torch.zeros(0, device=device))
        self.patch_in = nn.Parameter(dense_init(patch * patch * 3, dim, **kw))
        self.pos = nn.Parameter(torch.randn(
            ((image // patch) ** 2, dim), **kw) * 0.02)
        self.blocks = nn.ModuleList(TextBlock(self.cfg, **kw)
                                    for _ in range(layers))
        self.ln_f = nn.Parameter(torch.zeros(dim, device=device))


def encode_image(tower: ImageTower, images: torch.Tensor) -> torch.Tensor:
    """images (B,H,W,3) in [-1,1] -> (B,d) L2-normalised."""
    B, H, W, C = images.shape
    p = tower.patch
    x = images.reshape(B, H // p, p, W // p, p, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, -1, p * p * C)
    x = dot(x, tower.patch_in) + tower.pos[None]
    x = _blocks(tower.blocks, tower.cfg, x, causal=False)
    pooled = rms_norm(x, tower.ln_f).mean(dim=1)
    return pooled / torch.linalg.norm(pooled, dim=-1, keepdim=True)


def contrastive_loss(text: TextTower, image: ImageTower,
                     tokens: torch.Tensor, images: torch.Tensor,
                     temp: float = 0.07) -> torch.Tensor:
    """Symmetric InfoNCE over a batch of (prompt, image) pairs."""
    _, te = text.forward_grad(tokens)
    ie = encode_image(image, images)
    logits = te @ ie.T / temp
    li = -torch.log_softmax(logits, dim=1).diagonal().mean()
    lt = -torch.log_softmax(logits, dim=0).diagonal().mean()
    return 0.5 * (li + lt)
