"""Evaluation metrics (paper §3.1): FID, CLIP score, inter-group diversity
-- the twins of the JAX package's ``core/metrics.py``.

Offline substitutes, as in the JAX package: no pretrained Inception /
CLIP / AlexNet is available, so each metric keeps the paper's functional
form with a deterministic feature extractor:

* FD-R   -- Fréchet distance over fixed-seed random-conv features;
* CLIP-P -- cosine(text, image) of L2-normalised embeddings;
* DIV    -- mean pairwise feature distance among the images of one group.

The random-conv weights are the JAX package's ``_rf_params()`` (seed 7,
``jax.random`` draws, which torch cannot reproduce), stored as they are in
``rf_features.npz`` beside this file: three HWIO f32 arrays, 23,472
values.  ``tests/test_torch_metrics.py`` recomputes them from the JAX
package and holds the file to them bitwise.
"""
from __future__ import annotations

import functools
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

RF_FILE = Path(__file__).with_name("rf_features.npz")


@functools.lru_cache(maxsize=None)
def rf_params() -> Tuple[np.ndarray, ...]:
    """The three random-conv weights, HWIO (3, 3, c_in, c_out) f32."""
    with np.load(RF_FILE) as data:
        return tuple(data[f"w{i}"] for i in range(3))


def _same_pad(size: int, k: int = 3, stride: int = 2) -> Tuple[int, int]:
    """XLA's "SAME" padding of one side: (before, after).  At stride 2 an
    even side pads 0 before and 1 after, an odd side 1 and 1."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def random_features(images: torch.Tensor) -> torch.Tensor:
    """images (B,H,W,3) in [-1,1] -> (B, 112) multi-scale features: three
    3x3 stride-2 "SAME" convs, each followed by tanh and a spatial mean."""
    h = torch.as_tensor(images).permute(0, 3, 1, 2)             # NCHW
    feats = []
    for w in rf_params():
        weight = torch.from_numpy(w).permute(3, 2, 0, 1).to(h)  # OIHW
        (top, bottom), (left, right) = (_same_pad(s) for s in h.shape[2:])
        h = torch.tanh(F.conv2d(F.pad(h, (left, right, top, bottom)),
                                weight, stride=2))
        feats.append(h.mean(dim=(2, 3)))
    return torch.cat(feats, dim=-1)


def frechet_distance(feat_a: np.ndarray, feat_b: np.ndarray) -> float:
    """FD between Gaussian fits; tr sqrt(C1 C2) via eigenvalues."""
    a, b = np.asarray(feat_a, np.float64), np.asarray(feat_b, np.float64)
    mu1, mu2 = a.mean(0), b.mean(0)
    c1 = np.cov(a, rowvar=False) + 1e-6 * np.eye(a.shape[1])
    c2 = np.cov(b, rowvar=False) + 1e-6 * np.eye(b.shape[1])
    ev = np.linalg.eigvals(c1 @ c2)
    tr_sqrt = np.sum(np.sqrt(np.maximum(ev.real, 0.0)))
    return float(((mu1 - mu2) ** 2).sum() + np.trace(c1) + np.trace(c2)
                 - 2.0 * tr_sqrt)


def fd_r(real_images: torch.Tensor, gen_images: torch.Tensor) -> float:
    fa = random_features(real_images).cpu().double().numpy()
    fb = random_features(gen_images).cpu().double().numpy()
    return frechet_distance(fa, fb)


def clip_proxy(text_embeds: torch.Tensor, image_embeds: torch.Tensor
               ) -> float:
    """Both L2-normalised (B,d); mean pairwise-matched cosine."""
    return float(torch.mean(torch.sum(text_embeds * image_embeds, dim=-1)))


def group_diversity(images: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> float:
    """images (K,N,H,W,3); mean pairwise feature L2 within each group,
    over the members ``mask`` (K, N) keeps (all without one)."""
    K, N = images.shape[:2]
    feats = random_features(images.reshape(K * N, *images.shape[2:]))
    feats = feats.reshape(K, N, -1)
    d = torch.linalg.norm(feats[:, :, None] - feats[:, None, :], dim=-1)
    if mask is None:
        pair = torch.ones((K, N, N), device=d.device)
    else:
        mask = torch.as_tensor(mask, device=d.device).to(d.dtype)
        pair = mask[:, :, None] * mask[:, None, :]
    pair = pair * (1.0 - torch.eye(N, device=d.device))[None]
    return float(torch.sum(d * pair) / torch.clamp_min(torch.sum(pair),
                                                       1e-6))
