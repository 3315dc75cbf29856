"""Text tower: byte-level causal transformer.  Per-token features feed
the DiT cross-attention (the ``c`` of Alg. 1/2); the masked-mean-pooled,
L2-normalised embedding drives semantic grouping (cosine similarity,
paper §2.2).  The image tower and the contrastive loss come with
training.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_mlp, init_mlp, rms_norm

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
        x = self.embed[tokens]
        for bp in self.blocks:
            x = x + attn.gqa_full(bp.attn, self.cfg, rms_norm(x, bp.ln1))
            x = x + apply_mlp(bp.mlp, rms_norm(x, bp.ln2), self.cfg.mlp_kind)
        x = rms_norm(x, self.ln_f)
        # masked mean pool over non-pad tokens, then L2 normalisation
        not_pad = (tokens != PAD).float()[..., None]
        pooled = (x * not_pad).sum(dim=1) / torch.clamp_min(
            not_pad.sum(dim=1), 1.0)
        pooled = pooled / torch.linalg.norm(pooled, dim=-1, keepdim=True)
        return x, pooled


def encode_text(tower: TextTower, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``encode_text``: (features, pooled)."""
    return tower(tokens)
