"""Parameter trees: nested dicts, lists and tuples of tensors, walked in
``jax.tree_util``'s order.

The trainer, the optimizers, the LoRA adapters and the checkpoints keep
their state in the JAX package's nesting, so a leaf index, a LoRA key and
a checkpoint's ``a<i>`` array mean the same leaf in both packages.  As in
JAX, dict keys are visited sorted, lists and tuples in order, and ``None``
is an empty subtree; anything else is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[Any, ...]


def flatten_with_path(tree: Any, path: Path = ()
                      ) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs in JAX flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten_with_path(v, path + (i,))
    elif tree is not None:
        yield path, tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def keystr(path: Path) -> str:
    """``jax.tree_util.keystr``: ``['blocks']['attn']['wq']``, ``[0]``."""
    return "".join(f"[{k!r}]" for k in path)


def unflatten(like: Any, new_leaves) -> Any:
    """``like``'s structure with its leaves replaced, in flatten order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        if t is None:
            return None
        return next(it)

    out = build(like)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return out


_END = object()


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``jax.tree.map``: ``tree`` gives the structure, each of ``rest``
    holds it as a prefix (a leaf of ``tree`` may face a subtree there)."""
    return tree_map_with_path(lambda _, *xs: fn(*xs), tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any,
                       path: Path = ()) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      path=path + (k,)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map_with_path(fn, v, *(r[i] for r in rest),
                               path=path + (i,))
            for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree, *rest)
