"""Partitioning rules: parameter / optimizer / KV-cache sharding specs, the
twins of the JAX package's ``sharding/partition.py``, rule for rule.

Scheme (as in the JAX package):

* tensor parallelism on the ``model`` axis: attention head / FFN-hidden /
  expert / vocab dims;
* optional FSDP: additionally shard a big unsharded dim over ``data``;
* the ``pod`` axis is pure data parallelism (params replicated across
  pods);
* decode caches: batch over data; head-dim (or MLA latent dim) over model.

Rules are name+shape driven over the last two dims; leading stack dims
(the stacked ``blocks``, the MoE expert dim) are handled positionally.  A
spec (:class:`PartitionSpec`) names one mesh axis, a tuple of axes or
None for each tensor dim, as ``jax.sharding.PartitionSpec`` does; trees
are the JAX layout (``transformer.stacked_params``, ``init_cache``, an
optimizer's state), walked by ``repro_torch.tree``.  The rules read only
the mesh's axis sizes (:func:`axis_sizes`): a ``DeviceMesh`` or any
object whose ``shape`` maps axis names to sizes.  :func:`placements` and
:func:`shard_tree` turn a spec into DTensor placements on a
``DeviceMesh``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch import tree as tu
from repro_torch.config import ModelConfig


class PartitionSpec:
    """One entry a tensor dim: a mesh axis name, a tuple of names, or None
    (replicated).  A one-name tuple is that name, as in JAX.  Compares
    equal to the tuple of its entries.  Not a tuple itself, so a tree of
    specs keeps each spec a leaf."""

    __slots__ = ("axes",)

    def __init__(self, *axes):
        self.axes = tuple(a[0] if isinstance(a, tuple) and len(a) == 1
                          else a for a in axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self) -> int:
        return len(self.axes)

    def __getitem__(self, i):
        return self.axes[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self.axes == other.axes
        return isinstance(other, tuple) and self.axes == other

    def __hash__(self) -> int:
        return hash(self.axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.axes!r}"


P = PartitionSpec


def axis_sizes(mesh) -> Dict[str, int]:
    """The mesh's axis sizes by name."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


# weights whose OUTPUT (last dim) carries the parallel dimension
_COL = ("wq", "wk", "wv", "wi", "wg", "wdkv", "wukv", "z_proj", "x_proj",
        "bc_proj", "dt_proj", "wx", "wa", "patch_in", "cond_proj", "adaln",
        "t_w1", "t_w2", "enc_in", "proj", "head", "final_adaln")
# weights whose INPUT (second-to-last dim) carries it (row-parallel)
_ROW = ("wo", "out", "out_proj")
_REPL = ("router", "conv_w", "conv_b", "A_log", "D", "dt_bias", "lam",
         "pos", "ln", "norm", "b", "ba", "bi", "bq", "bk", "bv")


def spec_for(cfg: ModelConfig, path: Tuple, shape: Tuple[int, ...], mesh,
             fsdp: bool = False) -> PartitionSpec:
    """The spec of one parameter at ``path`` (tree keys and list indices)
    with ``shape``."""
    names = [str(p) for p in path]
    leaf = names[-1] if names else ""
    m = _axis_size(mesh, "model")
    d = _axis_size(mesh, "data")
    nd = len(shape)

    if nd == 0:
        return P()
    if nd == 1:
        return P(None)

    is_expert = "moe" in names and leaf in ("wi", "wg", "wo")
    base = 3 if is_expert else 2
    lead = [None] * (nd - base)

    def fits(dim: int, size: int) -> bool:
        return size > 1 and dim % size == 0

    if is_expert:
        # (E, d_model, ff) / (E, ff, d_model): experts over model
        spec = lead + ["model" if fits(shape[-3], m) else None, None, None]
        if fsdp and fits(shape[-2], d):
            spec[-2] = "data"
        return P(*spec)

    if leaf == "embed" or leaf in _ROW:
        spec = lead + ["model" if fits(shape[-2], m) else None, None]
        if fsdp and fits(shape[-1], d):
            spec[-1] = "data"
        return P(*spec)

    if leaf in _COL or leaf.startswith("w"):
        spec = lead + [None, "model" if fits(shape[-1], m) else None]
        if fsdp and fits(shape[-2], d):
            spec[-2] = "data"
        return P(*spec)

    return P(*([None] * nd))


def param_specs(cfg: ModelConfig, params_shapes, mesh, fsdp: bool = False):
    """A tree of specs matching a parameter (shape) tree."""
    return tu.tree_map_with_path(
        lambda path, leaf: spec_for(cfg, path, tuple(leaf.shape), mesh,
                                    fsdp), params_shapes)


def opt_specs(pspecs, opt_state_shapes):
    """Optimizer state mirrors the parameters' sharding (AdamW's ``mu`` /
    ``nu``, adafactor's ``s``: a factored statistic keeps the spec's
    leading entries); scalars are replicated."""

    def fix(path, leaf):
        # walk down pspecs along the path after the top-level state key
        node: Any = None
        for part in path:
            if node is None:
                node = pspecs if part in ("mu", "nu", "s") else "scalar"
                continue
            if node == "scalar":
                break
            if isinstance(node, Mapping) and part in node:
                node = node[part]
            elif isinstance(node, (list, tuple)):
                node = node[int(part)]
            else:
                break
        if isinstance(node, PartitionSpec):
            if len(node) == len(leaf.shape):
                return node
            return P(*list(node)[:len(leaf.shape)])
        return P()

    return tu.tree_map_with_path(fix, opt_state_shapes)


def batch_axes(mesh, batch: int) -> Optional[Tuple[str, ...]]:
    """Largest prefix of (pod, data) whose product divides the batch."""
    sizes = axis_sizes(mesh)
    chosen = []
    prod = 1
    for a in ("pod", "data"):
        if a in sizes and batch % (prod * sizes[a]) == 0:
            chosen.append(a)
            prod *= sizes[a]
    return tuple(chosen) or None


def cache_specs(cfg: ModelConfig, cache_shapes, mesh, batch: int,
                seq_shard: bool = False):
    """KV / state cache sharding for decode.  ``seq_shard`` shards the
    cache's sequence dim over ``model`` instead of heads / head-dim."""
    ba = batch_axes(mesh, batch)
    m = _axis_size(mesh, "model")

    def fix(path, leaf):
        names = [str(p) for p in path]
        leafname = names[-1]
        shape = tuple(leaf.shape)
        # strip the layer-stack dim of the blocks' caches
        has_stack = "blocks" in names and len(shape) >= 3
        lead = [None] if has_stack else []
        core = list(shape[1:]) if has_stack else list(shape)

        def done(spec):
            return P(*(lead + spec))

        if leafname in ("k", "v"):          # (B, L, Hkv, hd)
            hkv, hd = core[2], core[3]
            if seq_shard and core[1] % m == 0:
                return done([ba, "model", None, None])
            if hkv % m == 0:
                return done([ba, None, "model", None])
            if hd % m == 0:
                return done([ba, None, None, "model"])
            return done([ba, None, None, None])
        if leafname == "ckv":               # (B, L, r)
            if seq_shard and core[1] % m == 0:
                return done([ba, "model", None])
            return done([ba, None, "model" if core[2] % m == 0 else None])
        if leafname == "kr":                # (B, L, rope_hd)
            return done([ba, None, None])
        if leafname == "conv":              # (B, K-1, C)
            return done([ba, None, "model" if core[2] % m == 0 else None])
        if leafname == "state":             # ssm (B,H,P,N) / rglru (B,W)
            if len(core) == 4:
                ax = "model" if core[1] % m == 0 else None
                return done([ba, ax, None, None])
            return done([ba, "model" if core[1] % m == 0 else None])
        return done([ba] + [None] * (len(core) - 1))

    return tu.tree_map_with_path(fix, cache_shapes)


def placements(spec: PartitionSpec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one a mesh dim:
    ``Shard(i)`` where tensor dim i names that axis (alone or in a
    tuple), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, a in enumerate(spec)
                if a == name or (isinstance(a, tuple) and name in a)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def shard_tree(tree, specs, mesh, src_data_rank: Optional[int] = 0):
    """Each tensor of ``tree`` distributed over the ``DeviceMesh`` by its
    spec (``distribute_tensor``): the DTensor counterpart of JAX's
    ``NamedSharding``.  ``src_data_rank`` is ``distribute_tensor``'s: the
    rank whose values every rank takes, or None where each rank holds the
    same values already and keeps its own shard of them, with no
    communication.  A fake tensor (``FakeTensorMode``: the dry run) holds
    no values, so its shard is made at its local shape rather than cut
    from it, which would make every rank's chunk."""
    from torch._subclasses.fake_tensor import is_fake
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.utils._python_dispatch import _disable_current_modes

    def one(leaf, spec):
        places = placements(spec, mesh)
        if not is_fake(leaf):
            return distribute_tensor(leaf, mesh, places,
                                     src_data_rank=src_data_rank)
        with _disable_current_modes():      # it reads index values
            shape, _ = compute_local_shape_and_global_offset(
                leaf.shape, mesh, places)
        out = DTensor.from_local(leaf.new_empty(shape), mesh, places,
                                 run_check=False, shape=leaf.shape,
                                 stride=leaf.stride())
        return out.requires_grad_(leaf.requires_grad)
    return tu.tree_map(one, tree, specs)
