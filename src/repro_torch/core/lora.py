"""LoRA adapters (paper §3.1: SD v1.5 fine-tuned with LoRA).

Functional formulation, as in the JAX package: a LoRA tree maps the
``jax.tree_util.keystr`` of each adapted leaf of the base parameters
(``"['blocks']['attn']['wq']"`` ...) to ``{"a": (..., d_in, r), "b":
(..., r, d_out)}``, stacked over the same leading layer axis as the leaf;
``merge(base, lora)`` gives the effective parameters W + (alpha/r) A @ B for
the forward pass.  Training optimises only the LoRA tree (gradients flow
through ``merge``), so the optimizer state is rank-sized.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree as tu

Params = Dict[str, Any]


def default_filter(path: Tuple, leaf: torch.Tensor) -> bool:
    """Adapt matmul weights — 2-D, or 3-D with a leading stack dim
    (stacked layer blocks).  Skips norms/embeddings/positions/adaLN
    tables."""
    names = "/".join(str(p) for p in path)
    if leaf.ndim not in (2, 3):
        return False
    if min(leaf.shape[-2:]) < 8:
        return False
    skip = ("embed", "pos", "adaln", "norm", "ln", "conv", "lam", "router")
    return not any(s in names for s in skip)


def init_lora(params: Params, rank: int,
              generator: Optional[torch.Generator] = None,
              filt: Callable = default_filter) -> Params:
    """``a`` ~ N(0, 1/d_in) from ``generator`` (a CPU generator, seeded 0
    when not given; the JAX package's ``fold_in`` draws cross the bridge
    instead, ``weights.lora_from_jax``), ``b`` = 0."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    out = {}
    for path, leaf in tu.flatten_with_path(params):
        if filt(path, leaf):
            lead = tuple(leaf.shape[:-2])
            a = (torch.randn(lead + (leaf.shape[-2], rank),
                             generator=generator, dtype=leaf.dtype)
                 / math.sqrt(leaf.shape[-2])).to(leaf.device)
            b = torch.zeros(lead + (rank, leaf.shape[-1]), dtype=leaf.dtype,
                            device=leaf.device)
            out[tu.keystr(path)] = {"a": a, "b": b}
    return out


def merge(params: Params, lora: Params, alpha: float = 1.0) -> Params:
    """Effective params: W + (alpha/r) A@B on adapted leaves (batched
    matmul over any leading stack dims); other leaves are ``params``'
    own tensors."""

    def fix(path, leaf):
        ab = lora.get(tu.keystr(path))
        if ab is None:
            return leaf
        r = ab["a"].shape[-1]
        delta = torch.einsum("...ir,...ro->...io", ab["a"], ab["b"])
        return leaf + (alpha / r) * delta.to(leaf.dtype)

    return tu.tree_map_with_path(fix, params)


def n_params(lora: Params) -> int:
    return sum(x.numel() for x in tu.leaves(lora))
