"""Procedural text-image dataset (the offline stand-in for MS-COCO 2017).

The port's own copy of the JAX package's ``data/synthetic.py`` (numpy
only): the same index gives the same image and prompt in both packages.
Images are anti-aliased renders of colored geometric shapes on colored
backgrounds; prompts are templated captions ("a red circle on a blue
background").  Prompts sharing shape and color attributes produce similar
text-tower embeddings, so grouping and the trunk cache behave as they
would on captioned natural images.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

SHAPE_KINDS = ("circle", "square", "triangle", "ring", "cross")
COLORS = {
    "red": (0.9, 0.15, 0.15), "green": (0.1, 0.75, 0.2),
    "blue": (0.15, 0.3, 0.9), "yellow": (0.9, 0.85, 0.1),
    "purple": (0.6, 0.2, 0.8), "orange": (0.95, 0.55, 0.1),
    "white": (0.95, 0.95, 0.95), "teal": (0.1, 0.7, 0.7),
}
SIZES = ("small", "large")


def _render(kind: str, fg, bg, size: str, res: int, jitter_rng) -> np.ndarray:
    y, x = np.mgrid[0:res, 0:res].astype(np.float32) / res - 0.5
    cx, cy = jitter_rng.uniform(-0.12, 0.12, 2)
    x, y = x - cx, y - cy
    r = 0.18 if size == "small" else 0.32
    if kind == "circle":
        m = (x * x + y * y) < r * r
    elif kind == "square":
        m = (np.abs(x) < r) & (np.abs(y) < r)
    elif kind == "triangle":
        m = (y > -r) & (np.abs(x) < (r - y) * 0.6) & (y < r)
    elif kind == "ring":
        d = np.sqrt(x * x + y * y)
        m = (d < r) & (d > r * 0.6)
    else:  # cross
        m = ((np.abs(x) < r * 0.35) & (np.abs(y) < r)) | \
            ((np.abs(y) < r * 0.35) & (np.abs(x) < r))
    img = np.empty((res, res, 3), np.float32)
    img[:] = bg
    img[m] = fg
    noise = jitter_rng.normal(0, 0.02, img.shape).astype(np.float32)
    return np.clip(img + noise, 0.0, 1.0) * 2.0 - 1.0


N_COMBOS = len(SHAPE_KINDS) * len(COLORS) * (len(COLORS) - 1) * len(SIZES)


@dataclass
class ShapesDataset:
    """Deterministic procedural dataset; index -> (image, prompt).

    The first N_COMBOS (=560) indices enumerate UNIQUE attribute combos in a
    seed-shuffled order (duplicate prompts would otherwise dominate the
    similarity graph with sim=1.0 pairs and break the (tau_min, tau_max]
    range semantics); beyond that, prompts repeat with fresh image jitter."""
    res: int = 64
    seed: int = 0

    def sample(self, idx: int) -> Tuple[np.ndarray, str]:
        rng = np.random.RandomState(self.seed * 1_000_003 + idx)
        perm = np.random.RandomState(self.seed).permutation(N_COMBOS)
        r = int(perm[idx % N_COMBOS])
        color_names = list(COLORS)
        nc = len(color_names)
        kind = SHAPE_KINDS[r // (nc * (nc - 1) * 2)]
        r %= nc * (nc - 1) * 2
        fg_i = r // ((nc - 1) * 2)
        r %= (nc - 1) * 2
        bg_i = r // 2
        size = SIZES[r % 2]
        fg_name = color_names[fg_i]
        bg_name = color_names[bg_i + (1 if bg_i >= fg_i else 0)]
        img = _render(kind, COLORS[fg_name], COLORS[bg_name], size, self.res,
                      rng)
        prompt = f"a {size} {fg_name} {kind} on a {bg_name} background"
        return img, prompt

    def batch(self, start: int, n: int):
        imgs, prompts = [], []
        for i in range(start, start + n):
            im, p = self.sample(i)
            imgs.append(im)
            prompts.append(p)
        return np.stack(imgs), prompts


def token_stream(vocab: int, batch: int, seq: int, seed: int = 0):
    """Synthetic LM token batches for the transformer-substrate examples."""
    rng = np.random.RandomState(seed)
    while True:
        t = rng.randint(0, vocab, (batch, seq + 1), dtype=np.int64)
        yield {"tokens": t[:, :-1].astype(np.int32),
               "labels": t[:, 1:].astype(np.int32)}
