"""Dry-run builders: a step function and its fully sharded inputs for
every (architecture x input shape) pair on a ``DeviceMesh``; the twins of
the JAX package's ``launch/specs.py``, builder for builder.

Shapes come from the meta-device models (``transformer.meta_lm``, the DiT
on ``device="meta"``), specs from ``sharding/partition.py``, and each
input is a DTensor distributed by its spec (``partition.shard_tree``).  A
builder makes its tensors with ``fill(shape, dtype)``, by default zeros
on the mesh's device type in whatever mode is active (every rank makes
the same values and keeps its shard of them): under
``FakeTensorMode`` nothing is allocated (the dry run,
``launch/dryrun.py``); given real seeded values on the card, the same
case runs for real.

:func:`dtensor_rules` holds what DTensor needs to run these steps: the
op strategies registered for them and the redistribution that stands in
where DTensor has none.  A step in which a sharded op found no plan at
all, so that every rank ran it whole, is refused
(:class:`Fallbacks`): its count would be that torch version's gap in
DTensor's op coverage, not the sharded step's.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import pathlib
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree as tu
from repro_torch.config import (ModelConfig, OptimConfig, SHAPES, ShapeConfig,
                                get_config)
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import (apply_updates, clip_by_global_norm,
                                          make_optimizer)
from repro_torch.sharding import partition
from repro_torch.sharding.partition import P

# dense/MoE/VLM/enc-dec archs serve long_500k through a sliding-window cache
# of this size (sub-quadratic requirement), as in the JAX package
SERVE_WINDOW = 4096
# audio frontend downsampling: encoder frames per decoder token ratio
ENC_FRAMES_DIV = 4

#: makes one global tensor: fill(shape, dtype) -> tensor
Fill = Callable[[Tuple[int, ...], torch.dtype], torch.Tensor]


class DryrunCase(NamedTuple):
    name: str
    fn: Any
    args: Tuple
    static: Dict[str, Any]


def _zeros(mesh) -> Fill:
    return lambda shape, dtype: torch.zeros(shape, dtype=dtype,
                                            device=mesh.device_type)


def _sds(shape, dtype, mesh, spec, fill: Fill):
    """One input: ``fill``'s tensor distributed over ``mesh`` by ``spec``
    (the twin of a ``ShapeDtypeStruct`` with a ``NamedSharding``).  Every
    rank makes the same values, so each keeps its own shard of them."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(fill(tuple(shape), dtype), mesh,
                             partition.placements(spec, mesh),
                             src_data_rank=None)


def _shard(shapes, specs, mesh, fill: Fill):
    """A tree of shape leaves (meta tensors) made by ``fill`` and
    distributed by ``specs`` (each rank keeps its shard, as in
    :func:`_sds`)."""
    return partition.shard_tree(
        tu.tree_map(lambda s: fill(tuple(s.shape), s.dtype), shapes),
        specs, mesh, src_data_rank=None)


def _extras_specs(cfg: ModelConfig, batch: int, seq: int, mesh, ba,
                  fill: Fill):
    if cfg.family == "vlm":
        return {"image_embeds": _sds((batch, cfg.n_image_tokens,
                                      cfg.vision_dim), torch.bfloat16, mesh,
                                     P(ba, None, None), fill)}
    if cfg.family == "encdec":
        return {"frames": _sds((batch, max(seq // ENC_FRAMES_DIV, 16),
                                cfg.enc_input_dim), torch.bfloat16, mesh,
                               P(ba, None, None), fill)}
    return {}


@functools.lru_cache(maxsize=16)
def _meta(cfg: ModelConfig) -> Tuple[tfm.LM, Any]:
    """The meta-device LM of ``cfg`` and its parameter shape tree, made
    outside any fake mode (so that every mode may read them) and kept
    for the next case of the same config."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        model = tfm.meta_lm(cfg)
        return model, tfm.stacked_params(model)


def _param_shapes(cfg: ModelConfig, dtype=None):
    """The LM's parameter shape tree (meta tensors, the JAX layout);
    ``dtype`` replaces f32 (serving runs bf16 weights)."""
    shapes = _meta(cfg)[1]
    if dtype is not None:
        shapes = tu.tree_map(
            lambda s: s.to(dtype) if s.dtype == torch.float32 else s, shapes)
    return shapes


def _param_structs(cfg: ModelConfig, mesh, fsdp: bool, fill: Fill,
                   dtype=None):
    shapes = _param_shapes(cfg, dtype)
    specs = partition.param_specs(cfg, shapes, mesh, fsdp=fsdp)
    return _shard(shapes, specs, mesh, fill), specs


def _like(leaf):
    """A gradient hook: the gradient redistributed to ``leaf``'s placements
    (a reduce-scatter of the partial sums of a weight the batch shares)."""
    def hook(grad):
        if grad.placements == leaf.placements:
            return grad
        return grad.redistribute(leaf.device_mesh, leaf.placements)
    return hook


def _grads(model, params, batch, remat: bool):
    """``value_and_grad`` of ``tree_loss`` over a DTensor tree, each
    gradient in its parameter's sharding, as JAX's are.  The gradient of
    each layer's view of a stacked leaf is resharded as it arrives (a
    hook), before the views' gradients are stacked: stacking them as
    DTensor's partial sums would hold every layer's whole weight on every
    rank."""
    flat = tfm.module_params(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    for leaf in leaves.values():
        leaf.register_hook(_like(leaf))
    with torch.enable_grad():
        loss = torch.func.functional_call(model, leaves, (batch,),
                                          {"remat": remat}, strict=True)
        got = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True,
            materialize_grads=True)))

    def grad(path, leaf):
        rest = ".".join(map(str, path[1:]))
        if path[0] in tfm.STACKED:
            return torch.stack([got[f"{path[0]}.{i}.{rest}"]
                                for i in range(leaf.shape[0])])
        return got[".".join(map(str, path))]

    return loss.detach(), tu.tree_map_with_path(grad, params)


def build_train(cfg: ModelConfig, shape: ShapeConfig, mesh,
                optim: str = "adamw", fsdp: bool = True,
                remat: bool = True,
                fill: Optional[Fill] = None) -> DryrunCase:
    """One training step: ``tree_loss`` and its gradient (remat on by
    default, as in JAX; :func:`_grads`), the global-norm clip, the
    optimizer's update, ``apply_updates``."""
    fill = fill or _zeros(mesh)
    B, S = shape.global_batch, shape.seq_len
    ba = partition.batch_axes(mesh, B)
    params, pspecs = _param_structs(cfg, mesh, fsdp, fill)
    oc = OptimConfig(kind=optim)
    opt = make_optimizer(oc)
    opt_shapes = opt.init(_param_shapes(cfg))
    opt_state = _shard(opt_shapes, partition.opt_specs(pspecs, opt_shapes),
                       mesh, fill)
    batch = {
        "tokens": _sds((B, S), torch.int32, mesh, P(ba, None), fill),
        "labels": _sds((B, S), torch.int32, mesh, P(ba, None), fill),
        **_extras_specs(cfg, B, S, mesh, ba, fill),
    }
    model = _meta(cfg)[0]

    def train_step(params, opt_state, batch):
        loss, grads = _grads(model, params, batch, remat)
        grads, gnorm = clip_by_global_norm(grads, oc.grad_clip)
        updates, opt_state = opt.update(grads, opt_state, params, oc.lr)
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss, "gnorm": gnorm}

    return DryrunCase(f"{cfg.name}:{shape.name}", train_step,
                      (params, opt_state, batch),
                      {"batch": B, "seq": S, "kind": "train",
                       "donate": (0, 1)})


def build_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  fsdp: bool = False,
                  fill: Optional[Fill] = None) -> DryrunCase:
    fill = fill or _zeros(mesh)
    B, S = shape.global_batch, shape.seq_len
    ba = partition.batch_axes(mesh, B)
    params, _ = _param_structs(cfg, mesh, fsdp, fill, dtype=torch.bfloat16)
    tokens = _sds((B, S), torch.int32, mesh, P(ba, None), fill)
    extras = _extras_specs(cfg, B, S, mesh, ba, fill)
    model = _meta(cfg)[0]

    def prefill_step(params, tokens, extras):
        with tfm.bound(model, params):
            return tfm.prefill(model, tokens, extras=extras, max_len=S)

    return DryrunCase(f"{cfg.name}:{shape.name}", prefill_step,
                      (params, tokens, extras),
                      {"batch": B, "seq": S, "kind": "prefill"})


def build_decode(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 fsdp: bool = False, cache_seq_shard: bool = False,
                 fill: Optional[Fill] = None) -> DryrunCase:
    fill = fill or _zeros(mesh)
    B, S = shape.global_batch, shape.seq_len
    ba = partition.batch_axes(mesh, B)
    params, _ = _param_structs(cfg, mesh, fsdp, fill, dtype=torch.bfloat16)
    # sub-quadratic long-context serving: ring window cache for attention
    window = SERVE_WINDOW if (S > 65536 and cfg.family != "ssm") else 0
    model = _meta(cfg)[0]
    cache_shapes = tfm.init_cache(model, B, S, window=window)
    cspecs = partition.cache_specs(cfg, cache_shapes, mesh, B,
                                   seq_shard=cache_seq_shard)
    cache = _shard(cache_shapes, cspecs, mesh, fill)
    token = _sds((B, 1), torch.int32, mesh, P(ba, None), fill)
    pos = _sds((), torch.int32, mesh, P(), fill)
    ring = bool(window)

    def serve_step(params, cache, token, pos):
        with tfm.bound(model, params):
            return tfm.decode_step(model, cache, token, pos, ring=ring)

    return DryrunCase(f"{cfg.name}:{shape.name}", serve_step,
                      (params, cache, token, pos),
                      {"batch": B, "seq": S, "kind": "decode",
                       "window": window, "donate": (1,)})


def scale_config(cfg: ModelConfig, n_blocks: int) -> ModelConfig:
    """Variant of cfg with ``n_blocks`` scanned super-blocks (prefix and
    remainder layers preserved): cost(k) = base + k * per_block exactly,
    because the blocks are identical."""
    per = len(cfg.pattern) if cfg.pattern else 1
    prefix = cfg.moe.first_moe_layer if cfg.family == "moe" else 0
    rem = len(cfg.remainder)
    n_layers = prefix + per * n_blocks + rem
    kw = {"n_layers": n_layers}
    if cfg.family == "encdec":
        kw["enc_layers"] = n_blocks
    return dataclasses.replace(cfg, **kw)


def build_sage_serve(cfg: ModelConfig, mesh, k_groups: int = 64,
                     group_n: int = 4, no_tp: bool = False,
                     fill: Optional[Fill] = None) -> DryrunCase:
    """The paper's own serving step on the mesh: ONE shared-phase DDIM step
    (CFG over K group latents) + ONE branch-phase step (K*N member
    latents) of Alg. 1, at t = 800 -> 766.  Latents shard over (pod,
    data); the DiT shards over model.  A CFG pair's rows are interleaved
    (unconditional, conditional per latent) rather than stacked as two
    halves: the same rows in another order, kept on the batch's shards
    where stacking halves along a sharded dim would gather the batch."""
    from repro_torch.core import samplers
    from repro_torch.core.guidance import cfg_combine
    from repro_torch.core.schedule import make_schedule
    from repro_torch.models import dit as dit_lib

    fill = fill or _zeros(mesh)
    ba = partition.batch_axes(mesh, k_groups)
    shapes = dit_lib.init_params(cfg, device="meta")
    if no_tp:   # pure data parallel: the DiT replicated in bf16 and f32
        specs = tu.tree_map(lambda s: P(*([None] * s.ndim)), shapes)
    else:
        specs = partition.param_specs(cfg, shapes, mesh, fsdp=False)
    params = _shard(shapes, specs, mesh, fill)
    H = cfg.latent_size
    lat = P(ba, None, None, None)
    z_shared = _sds((k_groups, H, H, cfg.latent_channels), torch.float32,
                    mesh, lat, fill)
    z_branch = _sds((k_groups * group_n, H, H, cfg.latent_channels),
                    torch.float32, mesh, lat, fill)
    cbar = _sds((k_groups, cfg.cond_len, cfg.cond_dim), torch.bfloat16, mesh,
                P(ba, None, None), fill)
    cm = _sds((k_groups * group_n, cfg.cond_len, cfg.cond_dim),
              torch.bfloat16, mesh, P(ba, None, None), fill)

    def pairs(a, b):
        """(B, ...) x2 -> (2B, ...), rows a0, b0, a1, b1, ..."""
        return torch.stack([a, b], 1).reshape((2 * a.shape[0],)
                                              + tuple(a.shape[1:]))

    def sage_step(params, z_s, z_b, cbar, cm):
        sched = make_schedule(1000, device=z_s.device)

        def cfg_eval(z, c, t):
            B = z.shape[0]
            tt = torch.full((2 * B,), t, dtype=torch.int32, device=z.device)
            e = dit_lib.forward(params, cfg, pairs(z, z),
                                tt, pairs(torch.zeros_like(c), c),
                                remat=False)
            e = e.reshape((B, 2) + tuple(e.shape[1:]))
            return cfg_combine(e[:, 0], e[:, 1], 7.5)

        t = torch.tensor(800, dtype=torch.int32, device=z_s.device)
        tn = torch.tensor(766, dtype=torch.int32, device=z_s.device)
        e_s = cfg_eval(z_s, cbar, 800)
        z_s2 = samplers.ddim_step(sched, z_s, t, tn, e_s)
        e_b = cfg_eval(z_b, cm, 800)
        z_b2 = samplers.ddim_step(sched, z_b, t, tn, e_b)
        return z_s2, z_b2

    return DryrunCase(f"{cfg.name}:sage_serve", sage_step,
                      (params, z_shared, z_branch, cbar, cm),
                      {"batch": k_groups, "seq": group_n, "kind": "sage"})


_ALLOWED_KW = {
    "train": ("optim", "fsdp", "remat"),
    "prefill": ("fsdp",),
    "decode": ("fsdp", "cache_seq_shard"),
    "sage": ("no_tp", "k_groups", "group_n"),
}


def build_case(arch: str, shape_name: str, mesh, smoke: bool = False,
               n_blocks: Optional[int] = None,
               attn_impl: Optional[str] = None,
               attn_block: int = 0, fill: Optional[Fill] = None,
               **kw) -> DryrunCase:
    """The case ``arch`` x ``shape_name`` on ``mesh``.  ``attn_impl``
    takes the port's names (``naive``, ``chunked``, ``kernel``: the JAX
    package's ``pallas``); keywords a kind does not take are dropped."""
    cfg = get_config(arch, smoke=smoke)
    if n_blocks is not None:
        cfg = scale_config(cfg, n_blocks)
    if attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    if attn_block:
        cfg = dataclasses.replace(cfg, attn_block=attn_block)
    if shape_name == "sage_serve":
        kw = {k: v for k, v in kw.items() if k in _ALLOWED_KW["sage"]}
        return build_sage_serve(cfg, mesh, fill=fill, **kw)
    shape = SHAPES[shape_name]
    kw = {k: v for k, v in kw.items() if k in _ALLOWED_KW[shape.kind]}
    if shape.kind == "train":
        return build_train(cfg, shape, mesh, fill=fill, **kw)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh, fill=fill, **kw)
    return build_decode(cfg, shape, mesh, fill=fill, **kw)


# ---------------------------------------------------------------------------
# What DTensor needs to run the steps
# ---------------------------------------------------------------------------

def _gather_strategy(op_schema):
    """``aten.gather`` without DTensor's masked-partial rule (a gather from
    a tensor sharded on the gathered dim, as the loss's
    ``take_along_dim`` on vocab-sharded logits does): that rule's mask
    does not follow the ``[..., 0]`` that comes after, so the source is
    gathered on that dim instead.  The rest are DTensor's own rules."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._ops.utils import (
        expand_to_full_mesh_op_strategy)
    mesh = op_schema.get_mesh_from_args()
    inp, dim, index = op_schema.args_schema[:3]
    dim = dim % inp.ndim
    rules = [[Replicate()] * 3, [Shard(dim), Replicate(), Shard(dim)]]
    if inp.ndim == index.ndim:
        rules += [[Shard(d)] * 3 for d in range(inp.ndim) if d != dim]
    return expand_to_full_mesh_op_strategy(mesh, op_schema, rules,
                                           input_index=1)


def _index_strategy(op_schema):
    """``aten.index.Tensor`` (the embedding lookup ``embed[tokens]``, a
    gather by index tensors): the output follows the indices' sharding
    and the source is gathered whole.  DTensor's own rules also let the
    source stay sharded on a dim it is not indexed on, which for the
    embedding table sharded on ``d_model`` over ``data`` (FSDP) it takes
    as the cheaper move for the one op, gathering the tokens instead:
    every activation after it is then hidden-sharded on ``data`` and
    batch-replicated, where the JAX dry run keeps the batch on ``data``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._ops.utils import (
        expand_to_full_mesh_op_strategy)
    mesh = op_schema.get_mesh_from_args()
    indices = op_schema.args_schema[1].children
    idx = [i for i in indices if i is not None]
    dims = [d for d, i in enumerate(indices) if i is not None]
    nb = max(i.ndim for i in idx)
    consecutive = dims == list(range(dims[0], dims[0] + len(dims)))
    insert = dims[0] if consecutive else 0
    rules = [[Replicate()] * (2 + len(idx))]
    for bd in range(nb):
        rule = [Shard(insert + bd), Replicate()]
        for i in idx:
            off = nb - i.ndim
            rule.append(Shard(bd - off) if bd >= off and i.shape[bd - off] > 1
                        else Replicate())
        rules.append(rule)
    return expand_to_full_mesh_op_strategy(mesh, op_schema, rules,
                                           input_index=1)


def _index_copy_strategy(op_schema):
    """``aten.index_copy(_)`` (a decode step's cache write at its
    position): the destination and the source sharded alike on any dim
    but the written one, the index whole.  DTensor has no rule of its
    own, and its decomposition into ``index_put_`` cannot keep an
    in-place destination's placement."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._ops.utils import (
        expand_to_full_mesh_op_strategy)
    mesh = op_schema.get_mesh_from_args()
    inp, dim = op_schema.args_schema[:2]
    dim = dim % inp.ndim
    rules = [[Replicate()] * 4]
    rules += [[Shard(d), Shard(d), Replicate(), Shard(d)]
              for d in range(inp.ndim) if d != dim]
    return expand_to_full_mesh_op_strategy(
        mesh, op_schema, rules, input_index=1,
        inplace_op=op_schema.is_inplace_op())


def _scatter_strategy(op_schema):
    """``aten.scatter(_)`` with a source (the MoE's inverse permutation):
    the destination, the index and the source sharded alike on any dim
    but the scattered one, or everything whole; in place, the
    destination's placement is kept."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._ops.utils import (
        expand_to_full_mesh_op_strategy)
    inp, dim = op_schema.args_schema[:2]
    dim = dim % inp.ndim
    rules = [[Replicate()] * 4]
    rules += [[Shard(d)] * 4 for d in range(inp.ndim) if d != dim]
    return expand_to_full_mesh_op_strategy(
        op_schema.get_mesh_from_args(), op_schema, rules, input_index=1,
        inplace_op=op_schema.is_inplace_op())


def _new_zeros_strategy(op_schema):
    """``aten.new_zeros`` (the backward of a gather makes the source's
    zeros from the gradient): sharded like ``self`` on any dim the new
    shape keeps, or whole.  DTensor's own rule follows ``self`` only when
    the shapes are equal, so the backward of the loss's gather from the
    logits left every rank the whole (batch, seq, vocab) zeros in f32."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._ops.utils import (
        expand_to_full_mesh_op_strategy)
    inp, size = op_schema.args_schema[:2]
    # only sharded where it can be: a replicated ``self`` (the mean's
    # gradient) costs nothing to shard, but DTensor takes a plan that
    # moves nothing over one that moves nothing at no cost
    rules = [[Shard(d)] * 2 for d in range(min(inp.ndim, len(size)))
             if inp.shape[d] == size[d]] or [[Replicate()] * 2]
    return expand_to_full_mesh_op_strategy(
        op_schema.get_mesh_from_args(), op_schema, rules, input_index=1)


def _logsumexp_strategy(op_schema):
    """``aten.logsumexp`` (the loss's normaliser over the vocab): sharded
    on a dim it does not reduce, or whole; DTensor's own rule gathers the
    reduced dim (every rank the whole vocab) where an all-to-all onto the
    batch moves a sixteenth of it."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._ops.utils import (
        expand_to_full_mesh_op_strategy)
    inp, dims = op_schema.args_schema[:2]
    keep = len(op_schema.args_schema) > 2 and op_schema.args_schema[2]
    dims = {d % inp.ndim for d in dims}
    rules = [[Replicate()] * 2]
    for d in range(inp.ndim):
        if d not in dims:
            out = d if keep else d - sum(r < d for r in dims)
            rules.append([Shard(out), Shard(d)])
    return expand_to_full_mesh_op_strategy(
        op_schema.get_mesh_from_args(), op_schema, rules, input_index=1)


def _pad_strategy(op_schema):
    """``aten.constant_pad_nd`` (the causal conv's left pad): sharded alike
    on any dim it does not pad, or whole."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._ops.utils import (
        expand_to_full_mesh_op_strategy)
    inp, pad = op_schema.args_schema[:2]
    padded = range(inp.ndim - len(pad) // 2, inp.ndim)
    rules = [[Replicate()] * 2]
    rules += [[Shard(d)] * 2 for d in range(inp.ndim) if d not in padded]
    return expand_to_full_mesh_op_strategy(
        op_schema.get_mesh_from_args(), op_schema, rules, input_index=1)


def _conv_strategy(op_schema):
    """``aten.convolution`` (the SSM's and the RG-LRU's depthwise causal
    conv): the batch sharded or everything whole.  DTensor's own handler
    for it (a tensor-parallel conv with halo exchange) skips the
    redistribution its rules ask for, so a channel-sharded input met
    the whole depthwise weight."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._op_schema import OpStrategy
    from torch.distributed.tensor._ops.utils import (
        expand_to_full_mesh_op_strategy)
    n = 3 if isinstance(op_schema.args_schema[2], OpStrategy) else 2
    rules = [[Replicate()] * (1 + n),
             [Shard(0), Shard(0)] + [Replicate()] * (n - 1)]
    return expand_to_full_mesh_op_strategy(
        op_schema.get_mesh_from_args(), op_schema, rules, input_index=1)


def _conv_backward_strategy(op_schema):
    """``aten.convolution_backward``, the twin of :func:`_conv_strategy`:
    with the batch sharded the weight's and bias's gradients are partial
    sums."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._ops.utils import (
        expand_to_full_mesh_op_strategy)
    bias = op_schema.args_schema[3] is not None
    rules = [[Replicate(), Replicate(), Replicate() if bias else None]
             + [Replicate()] * 3,
             [Shard(0), Partial(), Partial() if bias else None,
              Shard(0), Shard(0), Replicate()]]
    out = expand_to_full_mesh_op_strategy(
        op_schema.get_mesh_from_args(), op_schema, rules, input_index=3)
    for spec in out.strategies:     # torch 2.11 takes a missing output
        spec.output_specs = list(spec.output_specs)   # only in a list
    return out


def _flip_strategy(op_schema):
    """``aten.flip`` (a cumsum's backward, in the SSD scan's segment
    sums): sharded alike on a dim it does not flip, or whole; torch 2.11
    has no rule for it."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._ops.utils import (
        expand_to_full_mesh_op_strategy)
    inp, dims = op_schema.args_schema[:2]
    dims = {d % inp.ndim for d in dims}
    rules = [[Replicate()] * 2]
    rules += [[Shard(d)] * 2 for d in range(inp.ndim) if d not in dims]
    return expand_to_full_mesh_op_strategy(
        op_schema.get_mesh_from_args(), op_schema, rules, input_index=1)


def _t_strategy(op_schema):
    """``aten.t`` (a linear layer's weight, and in its backward the
    flattened activation of the weight's gradient), by DTensor 2.13's rule
    on every torch version: each input placement kept, a shard's dim (a
    ``_StridedShard``'s too, with its split factor) swapped.  Torch 2.11's
    rule kept a ``_StridedShard``'s dim as it was, so the transpose of an
    activation flattened from a batch and a sequence sharded over both
    mesh dims claimed rows it did not hold, and the gradient's ``mm``
    met shards that disagree."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor.placement_types import _StridedShard

    def swapped(p, ndim):
        if ndim <= 1:
            return p
        if isinstance(p, _StridedShard):
            return _StridedShard(1 - p.dim, split_factor=p.split_factor)
        return Shard(1 - p.dim) if isinstance(p, Shard) else p
    out = []
    for s in op_schema.args_schema[0].strategies:
        spec = s.output_spec
        out.append(OpSpec(DTensorSpec(spec.mesh, tuple(
            swapped(p, spec.ndim) for p in spec.placements)),
            input_specs=(spec,)))
    return OpStrategy(out)


def _index_put_strategy(op_schema):
    """``aten.index_put(_)`` (the embedding's gradient, a ring cache's
    write): DTensor 2.13's own rules, for every torch version: the index
    tensors whole, ``self`` and the output sharded alike on a dim that is
    not indexed, with ``values`` sharded on the dim that lands there (or
    whole where it is broadcast), or all partial but the indices, or all
    whole; in place, ``self``'s placement is kept.  Expanded by
    :func:`_expand`, which also takes torch 2.11's form of an index list
    that holds None (its index tensors unwrapped, without a strategy:
    2.11's own rule refused the ring write, and DTensor's expansion there
    left those tensors out of the plan)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    inp, indices, values = op_schema.args_schema[:3]
    indices = getattr(indices, "children", indices)   # a list holding None
    indexed = [d for d, i in enumerate(indices) if i is not None]
    n = len(indexed)
    bnd = max((len(indices[d].shape) for d in indexed), default=0)
    contiguous = not indexed or indexed[-1] - indexed[0] + 1 == n
    free = [d for d in range(inp.ndim) if d not in indexed]
    rules = [[Replicate()] * (3 + n), [Partial(), Partial()]
             + [Replicate()] * n + [Partial()]]
    for i, d in enumerate(free):
        if contiguous and indexed:
            vd = d if d < indexed[0] else d - n + bnd
        else:
            vd = bnd + i
        vd -= bnd + len(free) - values.ndim
        vp = (Shard(vd) if vd >= 0 and values.shape[vd] != 1
              else Replicate())
        rules.append([Shard(d), Shard(d)] + [Replicate()] * n + [vp])
    return _expand(op_schema, rules, uneven=False)


def _searchsorted_strategy(op_schema):
    """``aten.searchsorted.Tensor`` (the MoE's group-wise routing: each
    token group searches its own sorted expert ids): the sorted sequence,
    the values and the output sharded alike on a leading (group) dim, or
    all whole."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._ops.utils import (
        expand_to_full_mesh_op_strategy)
    seq = op_schema.args_schema[0]
    rules = [[Replicate()] * 3]
    rules += [[Shard(d)] * 3 for d in range(seq.ndim - 1)]
    return expand_to_full_mesh_op_strategy(
        op_schema.get_mesh_from_args(), op_schema, rules, input_index=1)


def _matmul_strategy(op_schema):
    """``aten.mm`` / ``aten.bmm``: every plan of DTensor's own rules
    (rows, columns, the contraction split into partial sums, a partial
    operand passed through, the batch of a ``bmm``, or everything whole)
    expanded over the mesh (:func:`_expand`), a shard being a
    ``_StridedShard`` where an operand holds one (the rows of an
    einsum's merged dims, which then need no reshard), so that the choice
    among them can weigh the product's compute (:func:`_compute_us`),
    which DTensor's search over its rules does not."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    b = op_schema.args_schema[0].ndim - 2      # 1 for a bmm's batch dim
    rules = [[_Sh(b), _Sh(b), Replicate()],
             [_Sh(b + 1), Replicate(), _Sh(b + 1)],
             [Partial(), _Sh(b + 1), _Sh(b)],
             [Partial(), Partial(), Replicate()],
             [Partial(), Replicate(), Partial()]]
    if not b:
        rules = [[Shard(p.dim) if isinstance(p, _Sh) else p for p in r]
                 for r in rules]
        return _expand(op_schema, rules, uneven=False, nest=False)
    rules.append([_Sh(0)] * 3)
    return _expand(op_schema, rules, uneven=False, nest=False, cost=_cost)


class _Sh(NamedTuple):
    """A placeholder in a one-mesh-dim rule: tensor dim ``dim`` sharded
    the way the op's inputs shard (``Shard``, and ``_StridedShard`` of
    each split factor an input holds)."""
    dim: int


def _tensor_specs(op_schema):
    """The current spec of each tensor argument of an op schema, in order
    (torch 2.11 leaves a DTensor in a list that also holds None, an index
    list, as its spec, without a strategy)."""
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpStrategy
    out = []
    for x in torch.utils._pytree.tree_leaves(
            (op_schema.args_schema, list(op_schema.kwargs_schema.values()))):
        if isinstance(x, OpStrategy):
            out.append(x.strategies[0].output_spec)
        elif isinstance(x, DTensorSpec):
            out.append(x)
    return out


def _expand(op_schema, rules, uneven: bool = True, nest: bool = True,
            cost=None):
    """An ``OpStrategy`` from one-mesh-dim ``rules`` ([output, *tensor
    arguments], placements or :class:`_Sh`): DTensor 2.13's expansion of a
    single-dim strategy, the same on every torch version.  The
    all-replicate rule is added where missing, placeholders are filled,
    the rules are combined over the mesh dims, and a combination is
    dropped where it mixes partial kinds, would move an in-place op's
    ``self`` or output, or shards an input unevenly (``uneven``: kept where
    the input is already so placed); each kept one is costed by DTensor's
    own redistribution costs (or ``cost(src, dst)``).  Without ``nest``, a
    combination that shards an input's dim over a second mesh dim is
    dropped too: DTensor cannot view such a dim apart again (an einsum's
    merged batch and heads), so a product that made one had its scores
    gathered whole afterwards."""
    import itertools
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._collective_utils import redistribute_cost
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import is_tensor_shardable
    from torch.distributed.tensor.placement_types import _StridedShard
    cost = cost or redistribute_cost
    current = _tensor_specs(op_schema)
    width = 1 + len(current)
    rules = [list(r) for r in rules if len(r) == width]
    if not any(all(isinstance(p, Replicate) for p in r) for r in rules):
        rules.insert(0, [Replicate()] * width)
    held = [p for c in current for p in c.placements]
    builders = [Shard] if any(type(p) is Shard for p in held) else []
    builders += [functools.partial(_StridedShard, split_factor=f)
                 for f in sorted({p.split_factor for p in held
                                  if isinstance(p, _StridedShard)})]
    filled = []
    for r in rules:
        if any(isinstance(p, _Sh) for p in r):
            filled += [[b(p.dim) if isinstance(p, _Sh) else p for p in r]
                       for b in builders]
        else:
            filled.append(r)
    mesh = current[0].mesh
    # a spec holding a _StridedShard takes the flag of the input that
    # holds one (else its shard order is unknown and its cost infinite)
    strided = next((c.use_strided_shard_as_shard_order for c in current
                    if any(isinstance(p, _StridedShard)
                           for p in c.placements)), None)

    def spec(pl, meta=None):
        flag = (strided if any(isinstance(p, _StridedShard) for p in pl)
                else None)
        return DTensorSpec(mesh, pl, tensor_meta=meta,
                           use_strided_shard_as_shard_order=flag)

    inplace = op_schema.is_inplace_op()
    out = []
    for comb in itertools.product(filled, repeat=mesh.ndim):
        places = list(zip(*comb))
        if any(_mixed_partials(pl) for pl in places):
            continue
        if inplace and not (places[0] == places[1]
                            == current[0].placements):
            continue
        if not nest and any(_nested(pl) - _nested(c.placements)
                            for pl, c in zip(places[1:], current)):
            continue
        if any(p.is_partial() and not q.is_partial()
               for pl, c in zip(places[1:], current)
               for p, q in zip(pl, c.placements)):
            continue
        ins = [spec(pl, c.tensor_meta) for pl, c in zip(places[1:], current)]
        if not all(is_tensor_shardable(c.shape, s)
                   or (uneven and c.placements == s.placements)
                   for c, s in zip(current, ins)):
            continue
        out.append(OpSpec(output_specs=spec(places[0]), input_specs=ins,
                          redistribute_cost=[[cost(c, d)] for c, d
                                             in zip(current, ins)]))
    return OpStrategy(out)


def _cost(src, dst) -> float:
    """DTensor's cost of redistributing ``src`` to ``dst``, but with a
    ``_StridedShard`` costed as the ``Shard`` of its dim (DTensor costs
    every move out of one at 0, so a plan that gathers a strided score
    tensor looked free), and a move between the two on a mesh dim as
    that dim's gather."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._collective_utils import redistribute_cost
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor.placement_types import _StridedShard
    if not any(isinstance(p, _StridedShard)
               for p in src.placements + dst.placements):
        return redistribute_cost(src, dst)

    def plain(pl):
        return tuple(Shard(p.dim) if isinstance(p, _StridedShard) else p
                     for p in pl)

    def spec(pl):
        return DTensorSpec(src.mesh, pl, tensor_meta=src.tensor_meta)

    a, b = plain(src.placements), plain(dst.placements)
    cost = redistribute_cost(spec(a), spec(b))
    for i, (x, y) in enumerate(zip(src.placements, dst.placements)):
        if x != y and a[i] == b[i]:
            cost += redistribute_cost(
                spec(a), spec(a[:i] + (Replicate(),) + a[i + 1:]))
    return cost


def _nested(placements) -> set:
    """The tensor dims that ``placements`` shard over more than one mesh
    dim."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    dims = [p.dim for p in placements
            if isinstance(p, (Shard, _StridedShard))]
    return {d for d in dims if dims.count(d) > 1}


def _mixed_partials(placements) -> bool:
    """Whether ``placements`` hold partials of more than one kind (sum
    and avg of one type commute and may mix)."""
    from torch.distributed.tensor import Partial
    kinds = {(type(p), p.reduce_op) for p in placements
             if isinstance(p, Partial)}
    return len(kinds) > 1 and not (len({t for t, _ in kinds}) == 1 and {
        r for _, r in kinds} == {"sum", "avg"})


def _broadcast_map(common, shape):
    """For each dim of the broadcast shape ``common``, the dim of
    ``shape`` it comes from, or -1 where ``shape`` is broadcast."""
    out = [-1] * len(common)
    for i in range(1, len(shape) + 1):
        if shape[-i] == common[-i]:
            out[-i] = len(shape) - i
    return out


@functools.lru_cache(maxsize=1)
def _partial_rules():
    """The partial placements DTensor 2.13 lets each pointwise op keep
    (``_ops/_pointwise_ops.py``): [output, *tensor inputs]."""
    from torch.distributed.tensor import Partial, Replicate
    aten = torch.ops.aten
    P, R = Partial, Replicate
    unary_linear = [[P("sum"), P("sum")], [P("avg"), P("avg")]]
    additive = [[P("sum")] * 3, [P("avg")] * 3, [P("avg"), P("avg"), R()],
                [P("max"), P("max"), R()], [P("min"), P("min"), R()],
                [P("avg"), R(), P("avg")]]
    mul = [[P("sum"), P("sum"), R()], [P("avg"), P("avg"), R()],
           [P("sum"), R(), P("sum")], [P("avg"), R(), P("avg")]]
    div = [[P("sum"), P("sum"), R()], [P("avg"), P("avg"), R()]]
    rising = [[P("max"), P("max")], [P("min"), P("min")]]
    falling = [[P("min"), P("max")], [P("max"), P("min")]]
    keep = [[P(r), P(r)] for r in ("sum", "avg", "max", "min")]
    keep2 = [[P(r)] * 3 for r in ("sum", "avg", "max", "min")]
    monotone = [[P("max"), P("max"), R()], [P("max"), R(), P("max")],
                [P("min"), P("min"), R()], [P("min"), R(), P("min")]]
    table = {}
    for name in ("add", "sub"):
        table[getattr(aten, name).Tensor] = additive
        table[getattr(aten, name + "_").Tensor] = additive
    for op in (aten.mul.Tensor, aten.mul_.Tensor):
        table[op] = unary_linear + mul
    for op in (aten.div.Tensor, aten.div_.Tensor):
        table[op] = unary_linear + div
    for op in (aten.div.Scalar, aten.div_.Scalar, aten.mul.Scalar,
               aten.mul_.Scalar):
        table[op] = unary_linear
    for name in ("asinh", "atan", "ceil", "deg2rad", "erf", "exp", "exp2",
                 "expm1", "floor", "rad2deg", "relu", "sgn", "sigmoid",
                 "sign", "sinh", "tanh", "trunc", "nan_to_num"):
        table[getattr(aten, name).default] = rising
        table[getattr(aten, name + "_").default] = rising
    for op in (aten.round.default, aten.round.decimals,
               aten.hardshrink.default, aten.threshold.default):
        table[op] = rising
    for op in (aten.erfc.default, aten.erfc_.default):
        table[op] = falling
    for op in (aten.neg.default, aten.neg_.default):
        table[op] = unary_linear + falling
    for op in (aten.to.dtype, aten.positive.default):
        table[op] = keep
    table[aten.copy_.default] = keep2
    for op in (aten.logaddexp.default, aten.logaddexp2.default):
        table[op] = monotone
    for op in (aten.clamp_min.Tensor, aten.fmax.default,
               aten.maximum.default):
        table[op] = monotone + [[P("max")] * 3]
    for op in (aten.clamp_max.Tensor, aten.fmin.default,
               aten.minimum.default):
        table[op] = monotone + [[P("min")] * 3]
    return table


@functools.lru_cache(maxsize=1)
def _pointwise_ops() -> Tuple[Any, ...]:
    """The pointwise ops DTensor knows (``torch.Tag.pointwise``; not the
    ``out=`` overloads), and the linear ops 2.13 adds to them."""
    from torch.distributed.tensor import DTensor
    aten = torch.ops.aten
    prop = DTensor._op_dispatcher.sharding_propagator
    known = set(prop.op_strategy_funcs) | set(
        prop.op_single_dim_strategy_funcs)
    ops = {op for op in known if torch.Tag.pointwise in op.tags
           and "out" not in op._overloadname}
    ops |= {aten.copy_.default, aten.to.dtype, aten.positive.default}
    return tuple(sorted(ops, key=str))


def _pointwise_strategy(op_schema):
    """A pointwise op, by DTensor 2.13's rules on every torch version: the
    output and every input sharded alike on any dim of the broadcast shape
    (an input that broadcasts there whole), the partial placements the op
    is linear or monotone in (:func:`_partial_rules`), or all whole.
    torch 2.11 follows the most-sharded input instead, so a partial input
    to a non-linear op was all-reduced where 2.13 reduce-scatters it
    (the norms of the DiT, whose every ``model`` rank then ran all heads
    of its batch shard)."""
    from torch.distributed.tensor import Replicate
    shapes = [c.shape for c in _tensor_specs(op_schema)]
    common = torch.broadcast_shapes(*shapes)
    maps = [_broadcast_map(common, s) for s in shapes]
    rules = [[_Sh(i)] + [_Sh(m[i]) if m[i] >= 0 else Replicate()
                         for m in maps] for i in range(len(common))]
    return _expand(op_schema,
                   rules + _partial_rules().get(op_schema.op, []))


def _to_copy_strategy(op_schema):
    """``aten._to_copy`` (a dtype cast), by DTensor 2.13's rule on every
    torch version: sharded alike on any dim, or partial where the cast
    commutes with the partial's reduction."""
    from torch.distributed.tensor import Partial
    inp = op_schema.args_schema[0]
    src = inp.strategies[0].output_spec.tensor_meta.dtype
    dst = op_schema.kwargs_schema.get("dtype")
    rules = [[_Sh(d), _Sh(d)] for d in range(inp.ndim)]
    for op in ("sum", "avg", "max", "min"):
        keeps = (dst is None or dst == src or (
            dst != torch.bool and (op in ("max", "min") or not (
                src.is_floating_point and not dst.is_floating_point))))
        if keeps:
            rules.append([Partial(op), Partial(op)])
    return _expand(op_schema, rules)


def _input_dims(spec) -> list:
    """The input dims a view's output dim spec reads."""
    from torch.distributed.tensor._ops._view_ops import InputDim
    dims = []
    for x in spec.inputs():
        dims += [x.input_dim] if isinstance(x, InputDim) else _input_dims(x)
    return dims


def _view_placements(placements, shape, new_shape, mesh_sizes):
    """The placements of a view of ``shape`` as ``new_shape`` of a tensor
    placed so, by DTensor 2.13's rules, or None where one cannot pass
    without a move.  A kept dim keeps its shard; in a flattened group the
    first sharded dim stays a ``Shard`` and a later one becomes a
    ``_StridedShard`` over the local sizes before it; a split dim's shard
    goes to the piece whose local sizes before it multiply to its split
    factor (1 for a ``Shard``), where that piece divides evenly.  Mesh dims
    are taken in order, each after the shards of the ones before."""
    import math
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._ops._view_ops import (Flatten, InputDim,
                                                         Split, view_groups)
    from torch.distributed.tensor.placement_types import _StridedShard
    rule = view_groups(tuple(shape), tuple(new_shape))
    in_local, out_local = list(shape), list(new_shape)
    sharded = set()              # input dims an earlier mesh dim shards
    out = []
    for m, p in zip(mesh_sizes, placements):
        if not isinstance(p, (Shard, _StridedShard)):
            out.append(p)
            continue
        d = p.dim
        sf = p.split_factor if isinstance(p, _StridedShard) else 1
        got = None
        for o, spec in enumerate(rule):
            if isinstance(spec, InputDim) and spec.input_dim == d:
                got = o, sf
            elif isinstance(spec, Flatten) and d in _input_dims(spec):
                dims = [getattr(x, "input_dim", None) for x in spec.input_dims]
                k = dims.index(d)
                if None in dims or sharded & set(dims[k + 1:]):
                    return None
                got = o, sf * math.prod(in_local[x] for x in dims[:k])
            elif (isinstance(spec, Split) and spec.split_id == 0
                  and isinstance(spec.input_dim, InputDim)
                  and spec.input_dim.input_dim == d):
                pieces = [o + j for j in range(len(spec.group_shape))]
                before = 1
                for piece in pieces:
                    if before == sf:
                        got = piece, 1
                        break
                    before *= out_local[piece]
            elif d in _input_dims(spec):
                return None      # a regroup across dims, or a split's tail
            if got is not None:
                break
        if got is None or out_local[got[0]] % m:
            return None
        o, f = got
        out.append(Shard(o) if f == 1 else _StridedShard(o, split_factor=f))
        in_local[d] //= m
        out_local[o] //= m
        sharded.add(d)
    return out


def _view_strategy(op_schema):
    """``aten.view`` / ``aten._unsafe_view`` by :func:`_view_placements`, on
    every torch version: torch 2.11's own rule refuses to flatten dims of
    which a later one is sharded (an einsum's merged batch and heads, or
    its merged heads and query sequence), which 2.13 places as a
    ``_StridedShard``; a view that cannot pass without a move is refused
    (:class:`_NoPlan`: the fallback moves it)."""
    import math
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    src = op_schema.args_schema[0].strategies[0].output_spec
    new = list(op_schema.args_schema[1])
    if -1 in new:
        new[new.index(-1)] = math.prod(src.shape) // math.prod(
            n for n in new if n != -1)
    mesh = src.mesh
    out = _view_placements(src.placements, src.shape, new,
                           [mesh.size(i) for i in range(mesh.ndim)])
    if out is None:
        raise _NoPlan(f"{op_schema.op}: {src} cannot be viewed as {new} "
                      "without a move")
    # a _StridedShard here is a layout, not a shard order (as DTensor's
    # own view rule marks it)
    return OpStrategy([OpSpec(
        DTensorSpec(mesh, tuple(out), use_strided_shard_as_shard_order=False),
        input_specs=[src], redistribute_cost=[[0.0]])])


def _compute_us(op_spec) -> float:
    """The microseconds a matmul plan takes on one rank beyond its inputs'
    moves: its FLOPs at the H100's bf16 datasheet rate, over the mesh
    dims on which an input is sharded (on the others every rank does the
    whole product), and for a ``bmm`` the reduce-scatter at the NVLink
    rate that a partial output owes over each mesh dim where it is
    partial (DTensor costs only a plan's inputs, so a contraction split
    that left attention's scores partial looked cheaper than gathering a
    small operand; a projection's partial output, a row-parallel
    product's, is left to its consumer, which reduces it as it needs)."""
    import math
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    from repro_torch.launch.costs import NVLINK_BW, PEAK_FLOPS
    a, b = op_spec.input_specs
    flops = 2 * math.prod(a.shape) * b.shape[-1]
    out_bytes = (math.prod(a.shape[:-1]) * b.shape[-1]
                 * a.tensor_meta.dtype.itemsize)
    mesh = a.mesh
    for i in range(mesh.ndim):
        if any(isinstance(s.placements[i], (Shard, _StridedShard))
               for s in op_spec.input_specs):
            flops /= mesh.size(i)
        if isinstance(op_spec.output_spec.placements[i],
                      (Shard, _StridedShard)):
            out_bytes /= mesh.size(i)
    moved = sum(out_bytes * (mesh.size(i) - 1) / mesh.size(i)
                for i, p in enumerate(op_spec.output_spec.placements)
                if isinstance(p, Partial)) if len(a.shape) == 3 else 0
    return (flops / PEAK_FLOPS + moved / NVLINK_BW) * 1e6


def _moved(x, dims, onto: Optional[int]):
    """An op schema's arguments with every DTensor spec's placement on the
    mesh dims ``dims`` replaced: by ``Shard(onto)`` (None where a spec has
    no such dim, or it cannot take the shard evenly, or the spec already
    is so placed) or, where ``onto`` is None, by ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    if isinstance(x, DTensorSpec):
        places = list(x.placements)
        if onto is not None:
            if onto >= len(x.shape) or all(
                    places[i] == Shard(onto) for i in dims):
                return None
            ways = 1
            for i, p in enumerate(places):
                if i in dims or (isinstance(p, Shard) and p.dim == onto):
                    ways *= x.mesh.size(i)
            if x.shape[onto] % ways:
                return None
        for i in dims:
            places[i] = Replicate() if onto is None else Shard(onto)
        return DTensorSpec(x.mesh, tuple(places), tensor_meta=x.tensor_meta)
    if isinstance(x, (list, tuple)):
        out = [_moved(v, dims, onto) for v in x]
        if any(o is None and v is not None for o, v in zip(out, x)):
            return None
        return type(x)(out)
    return x


def _local_numel(spec) -> int:
    """The elements of this rank's shard of a DTensor spec (computed with
    every dispatch mode off: it reads index values)."""
    import math
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        shape, _ = compute_local_shape_and_global_offset(
            spec.shape, spec.mesh, spec.placements)
    return math.prod(shape)


def _fallbacks(ndim: int, rank: int):
    """The moves tried in order, as (mesh dims, tensor dim or None): each
    mesh dim from the last (``model``) resharded onto a tensor dim, the
    first (the batch) first, else replicated; then all replicated."""
    out = []
    for i in reversed(range(ndim)):
        out += [((i,), d) for d in range(rank)] + [((i,), None)]
    return out + [(tuple(range(ndim)), None)]


class StrategyFault(RuntimeError):
    """An error raised in one of this module's DTensor strategies: a fault
    of the dry run, never taken for a missing plan."""


class _NoPlan(ValueError):
    """A plan of DTensor's that :func:`dtensor_rules` refuses."""


def _strided_like_inputs(out, op_schema):
    """``out``, a plan of ``op_schema``, with each spec in it that holds a
    ``_StridedShard`` reading it as the op's inputs read theirs (a layout
    or a shard order; as inputs that disagree, a shard order): torch
    2.13's fix-up after every strategy, which 2.11 lacks, so its
    redistribution took a strided layout for a shard order it could not
    decode."""
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor.placement_types import _StridedShard

    def specs(tree):
        return [s for s in torch.utils._pytree.tree_leaves(tree)
                if isinstance(s, DTensorSpec) and any(
                    isinstance(p, _StridedShard) for p in s.placements)]

    flags = {s.use_strided_shard_as_shard_order
             for s in specs(op_schema.args_schema)}
    if not flags:
        return out
    flag = len(flags) > 1 or flags.pop()
    schema = out.redistribute_schema
    for spec in specs((out.output_spec,
                       schema.args_schema if schema else ())):
        if spec.use_strided_shard_as_shard_order != flag:
            spec.use_strided_shard_as_shard_order = flag
            spec.shard_order = (None if flag else
                                DTensorSpec.compute_default_shard_order(
                                    spec.placements))
    return out


def _faults_raise(strategy):
    """``strategy`` with any error it raises made a
    :class:`StrategyFault`, but its refusals (:class:`_NoPlan`)."""
    @functools.wraps(strategy)
    def run(op_schema):
        try:
            return strategy(op_schema)
        except _NoPlan:
            raise
        except Exception as e:
            raise StrategyFault(f"{strategy.__name__} on {op_schema.op}: "
                                f"{type(e).__name__}: {e}") from e
    return run


def _raised_at(e: BaseException) -> Tuple[pathlib.PurePath, int]:
    """The file and line where ``e`` was raised."""
    tb = e.__traceback__
    while tb.tb_next is not None:
        tb = tb.tb_next
    return pathlib.PurePath(tb.tb_frame.f_code.co_filename), tb.tb_lineno


def _no_plan(e: BaseException) -> bool:
    """Whether ``e`` is DTensor saying it has no plan for an op at its
    placements: raised in DTensor's own package (no strategy registered,
    or a rule that cannot take the placements), or a refusal of
    :func:`dtensor_rules` (:class:`_NoPlan`).  Anything else (an op's
    shapes that do not fit, a :class:`StrategyFault`) is raised."""
    if isinstance(e, StrategyFault):
        return False
    if isinstance(e, _NoPlan):
        return True
    parts = _raised_at(e)[0].parts
    return ("torch", "distributed", "tensor") in zip(parts, parts[1:],
                                                     parts[2:])


@dataclasses.dataclass
class Fallbacks:
    """The ops that took :func:`dtensor_rules`' fallback, by name, with
    the first error DTensor gave for each (``why``); ``whole``: those of
    them that then ran whole on every rank of a mesh of more than one,
    their sharded inputs gathered, because no move found a plan (a view,
    which does no work, is not counted there: its gather is a counted
    collective)."""
    taken: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    whole: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    why: Dict[str, str] = dataclasses.field(default_factory=dict)

    def refuse_whole(self) -> None:
        """Raise if an op ran whole on every rank: the step's count would
        be this torch version's gap in DTensor's op coverage."""
        if self.whole:
            raise RuntimeError(
                f"torch {torch.__version__}: DTensor found no plan for "
                f"{dict(self.whole)}, so every rank ran them whole; the "
                "count would not be the sharded step's.  Register a "
                "strategy in launch/specs.py.  DTensor said: "
                + "; ".join(f"{op}: {self.why.get(op, '')}"
                            for op in self.whole))


@contextlib.contextmanager
def dtensor_rules():
    """What DTensor needs to run the dry-run steps, for the duration of the
    block; yields the :class:`Fallbacks` of the ops that took the
    fallback below.

    * ``implicit_replication``: a plain tensor the model makes (a RoPE
      table, a mask, an index) counts as replicated;
    * DTensor's plans are weighed at the roofline's NVLink rate
      (``launch/costs.py``, every mesh dim; DTensor's own model takes
      87.7 GB/s, and a fifth of it across hosts), and a matmul's plan
      also by the time its product takes on one rank at the bf16 peak
      and by the reduce-scatter a partial output owes
      (:func:`_compute_us`): weighing bytes alone, DTensor keeps an
      activation partial and all-gathers the weight, so every ``model``
      rank computes the whole product;
    * the strategies of this module, the same on every torch version
      (DTensor's own differ: 2.11 follows the most-sharded input of a
      pointwise op, 2.13 weighs a shard of every dim), for every
      pointwise op (2.13's rules, :func:`_pointwise_strategy`),
      ``aten._to_copy``, ``aten.gather``, ``aten.index``,
      ``aten.index_copy(_)``, ``aten.convolution`` and its backward
      (whose tensor-parallel handler DTensor's dispatcher skips too),
      ``aten.mm``, ``aten.bmm``, ``aten.scatter(_)``,
      ``aten.searchsorted``, ``aten.index_put(_)``, ``aten.flip``, ``aten.t``,
      ``aten.constant_pad_nd``, ``aten.new_zeros`` and
      ``aten.logsumexp``; those expanded by :func:`_expand` never make a
      replicated input partial (a residual stream kept partial is reduced
      again by every consumer, each choosing for itself);
    * the fallback: where DTensor has no strategy for an op, or its rule
      cannot take the op's placements (a head split of a dim sharded
      wider than the heads, a view of a layout it cannot express), the
      inputs are resharded over one mesh dim (``model`` first, then
      ``data``, then ``pod``): onto their first dim that takes it evenly
      (the batch first), else replicated; else they are replicated over
      all of them, and the op runs on what each rank then holds.  The
      moves are the dry run's collectives and the replicated work is
      each rank's: nothing leaves the counts.  Only DTensor's own
      refusals take this path (:func:`_no_plan`), and a view whose plan
      gathers a mesh dim (GQA's head split of heads sharded wider than
      the KV heads, 10 heads over 16 ranks), which moves that mesh dim
      onto another dim where one takes it (the query sequence); an op
      with sharded inputs that ends up whole on every rank is noted in
      ``whole`` (:meth:`Fallbacks.refuse_whole`);
    * a reshard from one dim to another is an all-to-all, as on NCCL
      (DTensor takes a CPU mesh for gloo's, which has none, and
      all-gathers the whole tensor instead);
    * DTensor's own bookkeeping runs with every dispatch mode off: the
      op it runs on global-shaped fake tensors to learn an output's
      shape, which no rank computes, and ``_StridedShard``'s shard sizes
      (which read index values; kept, as they depend on shapes only).
    """
    from torch.utils._python_dispatch import _disable_current_modes
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor import placement_types as pt
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
    from torch.distributed.tensor._op_schema import (OpSchema, OutputSharding,
                                                    RuntimeSchemaInfo)
    from torch.distributed.tensor.experimental import implicit_replication

    aten = torch.ops.aten
    dispatcher = DTensor._op_dispatcher
    prop = dispatcher.sharding_propagator
    fallbacks = Fallbacks()
    plain = prop.propagate_op_sharding_non_cached

    views = (aten.view.default, aten._unsafe_view.default)

    def mesh_of(op_schema):
        """The mesh of the op's first DTensor argument (an op whose first
        argument is a scalar, ``pow.Scalar``, has its DTensor later)."""
        return next(s.mesh for s in torch.utils._pytree.tree_leaves(
            (op_schema.args_schema, op_schema.kwargs_schema))
            if isinstance(s, DTensorSpec))

    def checked(op_schema):
        """DTensor's sharding of ``op_schema``, refused where a spec has not
        a placement for each mesh dim (a decomposition's plan over a
        one-dim mesh, in some torch versions) or, for a view, unless the
        input's shard and the output's hold as many elements (a guard on
        :func:`_view_placements`)."""
        out = plain(op_schema)
        mesh = mesh_of(op_schema)
        specs = [s for s in torch.utils._pytree.tree_leaves(
            (out.output_spec, out.redistribute_schema.args_schema
             if out.redistribute_schema else ()))
                 if isinstance(s, DTensorSpec)]
        if any(len(s.placements) != mesh.ndim for s in specs):
            raise _NoPlan(f"{op_schema.op}: a plan over part of the mesh")
        if op_schema.op in views:
            src = (out.redistribute_schema or op_schema).args_schema[0]
            if _local_numel(src) != _local_numel(out.output_spec):
                raise _NoPlan(f"{op_schema.op}: the shards of {src} "
                              f"and {out.output_spec} differ")
        return out

    def rank_of(op_schema) -> int:
        return max(len(s.shape) for s in torch.utils._pytree.tree_leaves(
            op_schema.args_schema) if isinstance(s, DTensorSpec))

    def moved(op_schema, dims, onto):
        """``op_schema`` with its inputs moved (:func:`_moved`) and its
        plan for them, or None where they cannot move so or no plan
        takes them."""
        args = _moved(op_schema.args_schema, dims, onto)
        kwargs = {k: _moved(v, dims, onto)
                  for k, v in op_schema.kwargs_schema.items()}
        if args is None or any(v is None for v in kwargs.values()):
            return None
        rep = OpSchema(op_schema.op, args, kwargs,
                       schema_info=op_schema.schema_info)
        try:
            return rep, checked(rep)
        except Exception as e:  # noqa: BLE001 (sorted by _no_plan)
            if not _no_plan(e):
                raise
            return None

    def resharded(rep, out):
        """The plan ``out`` of the moved schema ``rep``, as the plan of
        the schema it was moved from."""
        return OutputSharding(
            out.output_spec, redistribute_schema=out.redistribute_schema or rep,
            needs_redistribute=True,
            use_val_from_redistribute_schema=(
                out.use_val_from_redistribute_schema))

    def sharded(op_schema) -> bool:
        """Whether an op that does work has a sharded input (a view does
        none: its gather is a counted collective)."""
        specs = [s for s in torch.utils._pytree.tree_leaves(
            (op_schema.args_schema, op_schema.kwargs_schema))
                 if isinstance(s, DTensorSpec)]
        return op_schema.op not in views and any(
            not (p.is_replicate() or p.is_partial())
            for s in specs for p in s.placements)

    def propagate(op_schema):
        return _strided_like_inputs(planned(op_schema), op_schema)

    def planned(op_schema):
        try:
            return checked(op_schema)
        except Exception as e:  # noqa: BLE001 (sorted by _no_plan)
            if (op_schema.op is aten._local_scalar_dense.default
                    or not _no_plan(e)):
                raise
            path, line = _raised_at(e)
            why = f"{type(e).__name__} at {path.name}:{line}: {e}"
        mesh = mesh_of(op_schema)
        name = str(op_schema.op)
        fallbacks.taken[name] += 1
        fallbacks.why.setdefault(name, why.splitlines()[0][:300])
        for dims, onto in _fallbacks(mesh.ndim, rank_of(op_schema)):
            got = moved(op_schema, dims, onto)
            if got is None:
                continue
            if len(dims) == mesh.ndim and mesh.size() > 1 and sharded(
                    op_schema):
                fallbacks.whole[name] += 1
            return resharded(*got)
        # no strategy at all: the op runs whole on each rank
        if mesh.size() > 1 and sharded(op_schema):
            fallbacks.whole[name] += 1
        rep = OpSchema(op_schema.op, _moved(op_schema.args_schema, dims,
                                            None),
                       {k: _moved(v, dims, None)
                        for k, v in op_schema.kwargs_schema.items()},
                       schema_info=op_schema.schema_info)
        meta = meta_quiet(rep)

        def spec(m):
            return None if m is None else DTensorSpec(
                mesh, (Replicate(),) * mesh.ndim, tensor_meta=m)

        out = (spec(meta) if meta is None or isinstance(meta, TensorMeta)
               else tuple(spec(m) for m in meta))
        return OutputSharding(out, redistribute_schema=rep,
                              needs_redistribute=True)

    strided = pt._StridedShard.local_shard_size_and_offset
    sizes: Dict[Any, Any] = {}

    def strided_sizes(self, *args, **kwargs):
        key = (self.dim, self.split_factor, args,
               tuple(sorted(kwargs.items())))
        if key not in sizes:
            with _disable_current_modes():
                sizes[key] = strided(self, *args, **kwargs)
        return sizes[key]

    meta_of = prop._propagate_tensor_meta_non_cached

    def meta_quiet(op_schema):
        with _disable_current_modes():
            return meta_of(op_schema)

    from torch.distributed.tensor import _collective_utils, _sharding_prop
    from repro_torch.launch.costs import NVLINK_BW
    topo = _collective_utils.MeshTopoInfo
    build_topo = topo.__dict__["build_from_mesh"]

    def nvlink_topo(mesh):
        return topo(mesh, [mesh.size(i) for i in range(mesh.ndim)],
                    [NVLINK_BW / 1e9] * mesh.ndim, [0.6] * mesh.ndim)

    select = _sharding_prop._select_min_cost_strategy
    matmuls = (aten.mm.default, aten.bmm.default)

    def select_with_compute(strategy, op_schema=None):
        if (op_schema is not None and op_schema.op in matmuls
                and len(strategy.strategies) > 1):
            for spec in strategy.strategies:
                spec.redistribute_cost[0] = [
                    c + _compute_us(spec) for c in spec.redistribute_cost[0]]
        return select(strategy, op_schema)

    from torch.distributed import _functional_collectives as funcol

    def alltoall(tensor, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            tensor, gather_dim, shard_dim,
            funcol._resolve_group_name((mesh, mesh_dim)))

    gloo_alltoall = pt.shard_dim_alltoall
    handlers = dispatcher._custom_op_handlers
    conv = (aten.convolution.default, aten.convolution_backward.default)
    saved_handlers = {op: handlers.pop(op) for op in conv if op in handlers}
    ours = {op: _pointwise_strategy for op in _pointwise_ops()}
    ours.update({aten._to_copy.default: _to_copy_strategy,
                 aten.view.default: _view_strategy,
                 aten._unsafe_view.default: _view_strategy,
                 aten.gather.default: _gather_strategy,
                 aten.index.Tensor: _index_strategy,
                 aten.index_copy.default: _index_copy_strategy,
                 aten.index_copy_.default: _index_copy_strategy,
                 aten.convolution.default: _conv_strategy,
                 aten.convolution_backward.default: _conv_backward_strategy,
                 aten.mm.default: _matmul_strategy,
                 aten.bmm.default: _matmul_strategy,
                 aten.searchsorted.Tensor: _searchsorted_strategy,
                 aten.flip.default: _flip_strategy,
                 aten.t.default: _t_strategy,
                 aten.index_put.default: _index_put_strategy,
                 aten.index_put_.default: _index_put_strategy,
                 aten.scatter.src: _scatter_strategy,
                 aten.scatter_.src: _scatter_strategy,
                 aten.constant_pad_nd.default: _pad_strategy,
                 aten.new_zeros.default: _new_zeros_strategy,
                 aten.logsumexp.default: _logsumexp_strategy})
    saved = {op: (prop.op_strategy_funcs.get(op),
                  prop.op_single_dim_strategy_funcs.pop(op, None),
                  prop.op_to_schema_info.get(op))
             for op in ours}
    prop.op_strategy_funcs.update(
        {op: _faults_raise(f) for op, f in ours.items()})
    for op in (aten.index.Tensor, aten.index_put.default,
               aten.index_put_.default):
        prop.op_to_schema_info[op] = RuntimeSchemaInfo(needs_pytree=True)
    for op in (aten.index_copy.default, aten.index_copy_.default,
               aten.scatter.src, aten.scatter_.src):
        prop.op_to_schema_info[op] = RuntimeSchemaInfo(static_argnum=1)
    for op in (aten.convolution.default, aten.convolution_backward.default):
        prop.op_to_schema_info[op] = RuntimeSchemaInfo(static_argnum=3)
    for op in (aten.logsumexp.default, aten.flip.default):
        prop.op_to_schema_info[op] = RuntimeSchemaInfo(static_argnum=1)
    prop.op_to_schema_info[aten.searchsorted.Tensor] = RuntimeSchemaInfo(
        static_kwargkey=["out_int32", "right", "side"])
    for op in (aten.constant_pad_nd.default, aten.new_zeros.default):
        prop.op_to_schema_info[op] = RuntimeSchemaInfo(
            static_argnum=1, static_kwargkey=["dtype"])
    prop.op_to_schema_info[aten._to_copy.default] = RuntimeSchemaInfo(
        static_kwargkey=["dtype"])
    copy_spec = DTensorSpec.shallow_copy_with_tensor_meta

    def keep_layout(self, tensor_meta):
        """torch 2.13's copy of a spec, which keeps how its
        ``_StridedShard`` reads (a layout or a shard order); 2.11's drops
        it, and its redistribution then fails to decode a strided layout
        as a shard order."""
        return DTensorSpec(
            self.mesh, self.placements, tensor_meta=tensor_meta,
            use_strided_shard_as_shard_order=(
                self.use_strided_shard_as_shard_order))

    cached = prop.propagate_op_sharding
    DTensorSpec.shallow_copy_with_tensor_meta = keep_layout
    prop.propagate_op_sharding_non_cached = propagate
    prop.propagate_op_sharding = type(cached)(propagate)
    prop._propagate_tensor_meta_non_cached = meta_quiet
    _sharding_prop._select_min_cost_strategy = select_with_compute
    topo.build_from_mesh = staticmethod(nvlink_topo)
    pt.shard_dim_alltoall = alltoall
    pt._StridedShard.local_shard_size_and_offset = strided_sizes
    try:
        with implicit_replication():
            yield fallbacks
    finally:
        DTensorSpec.shallow_copy_with_tensor_meta = copy_spec
        pt._StridedShard.local_shard_size_and_offset = strided
        _sharding_prop._select_min_cost_strategy = select
        topo.build_from_mesh = build_topo
        pt.shard_dim_alltoall = gloo_alltoall
        prop.propagate_op_sharding = cached
        del prop.propagate_op_sharding_non_cached
        del prop._propagate_tensor_meta_non_cached
        for op, (f, single, info) in saved.items():
            for table, v in ((prop.op_strategy_funcs, f),
                             (prop.op_single_dim_strategy_funcs, single),
                             (prop.op_to_schema_info, info)):
                if v is None:
                    table.pop(op, None)
                else:
                    table[op] = v
        handlers.update(saved_handlers)
