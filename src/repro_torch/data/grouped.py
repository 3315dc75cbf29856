"""Grouped dataset construction (paper §3.1).

The port's copy of the JAX package's ``data/grouped.py`` (numpy, over the
port's own ``core/grouping.py`` and ``data/synthetic.py``): embed all
prompts with the text tower, build the (tau_min, tau_max] threshold graph,
enumerate greedy cliques of 2..group_max members, and emit packed (K, N)
training groups of (latent, cond) pairs.  The same embeddings give the same
groups and batches as the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from repro_torch.core import grouping
from repro_torch.data.synthetic import ShapesDataset


@dataclass
class GroupedDataset:
    images: np.ndarray            # (M, H, W, 3)
    prompts: List[str]
    embeds: np.ndarray            # (M, d)  pooled text embeddings
    cond: np.ndarray              # (M, Lc, dc)  per-token text features
    groups: List[List[int]]       # clique cover

    def packed(self, group_size: int):
        idx, mask = grouping.pad_groups(self.groups, group_size)
        return idx, mask

    def iter_batches(self, k_groups: int, group_size: int, seed: int = 0):
        """Yields {"images": (K,N,H,W,3), "cond": (K,N,Lc,dc), "mask": (K,N)}."""
        idx, mask = self.packed(group_size)
        rng = np.random.RandomState(seed)
        order = rng.permutation(len(idx))
        for s in range(0, len(order) - k_groups + 1, k_groups):
            sel = order[s:s + k_groups]
            gi = idx[sel]                      # (K, N)
            yield {"images": self.images[gi],
                   "cond": self.cond[gi],
                   "mask": mask[sel]}


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def build_grouped_dataset(encode_fn, n_items: int = 256, res: int = 64,
                          tau_min: float = 0.6, tau_max: float = 0.9,
                          group_max: int = 5, seed: int = 0
                          ) -> GroupedDataset:
    """encode_fn(prompts) -> (cond (M,Lc,dc), pooled (M,d)), tensors or
    arrays — the text tower."""
    ds = ShapesDataset(res=res, seed=seed)
    images, prompts = ds.batch(0, n_items)
    cond, pooled = encode_fn(prompts)
    cond, pooled = _numpy(cond), _numpy(pooled)
    sim = grouping.similarity_matrix(pooled)
    groups = grouping.greedy_clique_groups(sim, tau_min, tau_max,
                                           group_max=group_max)
    return GroupedDataset(images=images, prompts=prompts, embeds=pooled,
                          cond=cond, groups=groups)
