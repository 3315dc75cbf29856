"""Dependency-free checkpointing: parameter trees -> flat .npz + JSON.

Layout (the JAX package's, so each package reads the other's files):
``<dir>/step_<n:08d>/arrays.npz`` holds the leaves as ``a0, a1, ...`` in
``jax.tree_util`` flatten order (dict keys sorted, ``repro_torch.tree``),
bf16 leaves as their raw ``uint16`` bits; ``tree.json`` holds the leaf
count, the step and each leaf's dtype name.  No structure is stored: a
``like`` tree supplies it on restore.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as tu


def _to_numpy(x) -> tuple:
    """(the array to store, its dtype name)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    a = np.asarray(x)
    if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
        return a.view(np.uint16), "bfloat16"  # npz has no bf16; keep raw
    return a, str(a.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    path = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    path.mkdir(parents=True, exist_ok=True)
    arrays, dtypes = {}, []
    for i, x in enumerate(tu.leaves(tree)):
        arrays[f"a{i}"], name = _to_numpy(x)
        dtypes.append(name)
    np.savez(path / "arrays.npz", **arrays)
    meta = {"n": len(arrays), "step": step, "dtypes": dtypes}
    (path / "tree.json").write_text(json.dumps(meta))
    return str(path)


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = pathlib.Path(ckpt_dir)
    if not p.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in p.iterdir()
             if d.name.startswith("step_")]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like: Any) -> Any:
    """``like``'s structure with the stored leaves as tensors, each on the
    device of ``like``'s leaf where that is a tensor (else the CPU)."""
    path = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    meta = json.loads((path / "tree.json").read_text())
    like_leaves = tu.leaves(like)
    if meta["n"] != len(like_leaves):
        raise ValueError(f"checkpoint {path} holds {meta['n']} leaves, the "
                         f"tree it is restored into {len(like_leaves)}")
    leaves = []
    with np.load(path / "arrays.npz") as data:
        for i, ref in enumerate(like_leaves):
            a = data[f"a{i}"]
            if meta["dtypes"][i] == "bfloat16":
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a)
            if isinstance(ref, torch.Tensor):
                t = t.to(ref.device)
            leaves.append(t)
    return tu.unflatten(like, leaves)
