"""Model assembly: the LM runtime behind the JAX package's API, for the
families ported so far.

The JAX package scans stacked layer params (``lax.scan`` over ``blocks``);
here ``blocks`` is an ``nn.ModuleList`` walked in a loop, while the cache
keeps the JAX structure ``{"prefix", "blocks", "suffix"}`` with every
``blocks`` leaf stacked along a leading n_blocks axis, so cache code
(``serving/kvcache.py``) and parity tests see the same trees.

Public API (the model stands in for ``(params, cfg)``)
------------------------------------------------------
LM(cfg, device=, generator=)                        -> model  (init_params)
forward_train(model, tokens, remat=)                -> (logits (B,S,V), aux)
lm_loss(model, batch, remat=)                       -> scalar loss
init_cache(model, batch, max_len, dtype=, window=)  -> zero cache
prefill(model, tokens, max_len=, window=)           -> (last_logits, cache)
decode_step(model, cache, token, pos, ring=, out=)  -> (logits, cache)

Ported: the ``dense`` family (GQA ``attn`` layers with a dense SwiGLU or
GELU MLP) and ``ssm`` layers (mamba2), each with MLP kind ``dense`` or
``none``.  The other families raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.config import MIX_ATTN, MIX_SSM, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, cast, cast_weights_, dot,
                                      init_mlp, named_casts, rms_norm)
from repro_torch.models.ssm import Mamba2Mixer

Cache = Dict[str, Any]
#: the parameters the LM reads in its activation dtype: the embedding (the
#: tied head) and head, the attention and MLP matrices and biases, the SSM
#: projections (the norms, the conv and the SSM's dt/A run in f32)
CAST = ("embed", "head", "wq", "wk", "wv", "wo", "bq", "bk", "bv", "wi",
        "wg", "z_proj", "x_proj", "bc_proj", "dt_proj", "out_proj", "D")

_NOT_PORTED = ("not ported yet: ROADMAP.md §1, item 4 (the rest of the "
               "LLM substrate, in order: the hybrid's RG-LRU and local "
               "attention, MoE with MLA, the VLM's cross-attention, "
               "encdec)")
_PORTED_FAMILIES = ("dense", "ssm")


def plan(cfg: ModelConfig) -> Tuple[Tuple[str, ...], Tuple[str, ...], int,
                                    Tuple[str, ...]]:
    """How layers are grouped into (prefix, scanned block, n_blocks,
    suffix): the JAX package's ``plan`` for the families ported so far;
    every other family raises here."""
    if cfg.family not in _PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} {_NOT_PORTED}")
    if cfg.pattern:
        n_blocks = (cfg.n_layers - len(cfg.remainder)) // len(cfg.pattern)
        return (), tuple(cfg.pattern), n_blocks, tuple(cfg.remainder)
    return (), (MIX_ATTN,), cfg.n_layers, ()


def _mlp_kind(cfg: ModelConfig) -> str:
    """'dense' | 'none' for a layer (the JAX ``_mlp_kind`` without MoE)."""
    if cfg.moe is not None:
        raise NotImplementedError(f"MoE MLPs {_NOT_PORTED}")
    return "none" if cfg.d_ff == 0 else "dense"


def uses_pos(cfg: ModelConfig) -> bool:
    """Whether a decode step reads its position (attention caches do)."""
    return MIX_ATTN in plan(cfg)[1]


class Layer(nn.Module):
    """One residual layer (``init_layer``): ``ln1`` and its mixer
    (``mix``), then ``ln2`` and a dense ``mlp`` unless the MLP kind is
    ``none``."""

    def __init__(self, cfg: ModelConfig, kind: str, *, device, generator):
        super().__init__()
        d = cfg.d_model
        self.kind, self.mlpk = kind, _mlp_kind(cfg)
        self.ln1 = nn.Parameter(torch.zeros(d, device=device))
        if kind == MIX_ATTN:
            self.mix = attn.init_gqa(cfg, device=device, generator=generator)
        elif kind == MIX_SSM:
            self.mix = Mamba2Mixer(cfg, device=device, generator=generator)
        else:
            raise NotImplementedError(f"mixer {kind!r} {_NOT_PORTED}")
        if self.mlpk == "dense":
            self.ln2 = nn.Parameter(torch.zeros(d, device=device))
            self.mlp = nn.ParameterDict({
                k: nn.Parameter(v) for k, v in init_mlp(
                    d, cfg.d_ff, cfg.mlp_kind, device=device,
                    generator=generator).items()})

    def init_cache(self, cfg: ModelConfig, batch: int, max_len: int, dtype,
                   window: int = 0) -> Cache:
        """``init_layer_cache``: this layer's zero cache."""
        if self.kind == MIX_ATTN:
            return attn.gqa_cache_init(cfg, batch, window or max_len, dtype,
                                       self.ln1.device)
        return self.mix.ssm_cache_init(batch, dtype)


def apply_layer(layer: Layer, cfg: ModelConfig, x: torch.Tensor, *,
                mode: str, cache=None, pos=None, window: int = 0,
                ring: bool = False, max_len: int = 0,
                out=None) -> Tuple[torch.Tensor, Any]:
    """``mode`` "train" | "prefill" | "decode" -> (x, new_cache), the new
    cache None in train.  In decode, ``out`` (optional) holds the tensors
    the new cache is written into."""
    h = rms_norm(x, layer.ln1, cfg.rms_eps)
    new_cache = None
    if layer.kind == MIX_ATTN:
        if mode == "train":
            a = attn.gqa_full(layer.mix, cfg, h, window=window)
        elif mode == "prefill":
            L = min(window, max_len) if window else max_len
            a, new_cache = attn.gqa_prefill(layer.mix, cfg, h, max_len=L,
                                            window=window)
        elif mode == "decode":
            if pos is None:
                raise ValueError("an attention layer's decode step needs "
                                 "its position")
            a, new_cache = attn.gqa_decode(layer.mix, cfg, h, cache, pos,
                                           ring=ring, out=out)
        else:
            raise ValueError(f"unknown mode {mode!r}")
    else:
        if mode == "train":
            a = layer.mix.ssm_full(h)
        elif mode == "prefill":
            a, new_cache = layer.mix.ssm_full(h, return_cache=True)
        elif mode == "decode":
            a, new_cache = layer.mix.ssm_decode(h, cache, out=out)
        else:
            raise ValueError(f"unknown mode {mode!r}")
    x = x + a
    if layer.mlpk == "dense":
        x = x + apply_mlp(layer.mlp, rms_norm(x, layer.ln2, cfg.rms_eps),
                          cfg.mlp_kind)
    return x, new_cache


class LM(nn.Module):
    """The language model (``init_params``'s tree as modules): ``embed``,
    ``ln_f``, ``prefix`` / ``suffix`` layer lists, ``blocks`` (one
    ``ModuleDict`` of ``l{j}`` layers per scanned block) and ``head`` when
    the embeddings are not tied.  Weights are f32; activations run in
    ``cfg.dtype``.  ``device`` defaults to CUDA and raises without a GPU."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        prefix, block, n_blocks, suffix = plan(cfg)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        kw = dict(device=device, generator=generator)
        self.cfg = cfg
        d = cfg.d_model
        self.embed = nn.Parameter(torch.randn((cfg.vocab, d), **kw) * 0.02)
        self.ln_f = nn.Parameter(torch.zeros(d, device=device))
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(torch.randn((d, cfg.vocab), **kw)
                                     / d ** 0.5)
        self.prefix = nn.ModuleList(
            Layer(cfg, k, **kw) for k in prefix)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({f"l{j}": Layer(cfg, k, **kw)
                           for j, k in enumerate(block)})
            for _ in range(n_blocks))
        self.suffix = nn.ModuleList(
            Layer(cfg, k, **kw) for k in suffix)
        # the weights cast_weights_ casts, found once
        self._cast = tuple(named_casts(self, CAST))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def embed_tokens(self, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        return self.embed[tokens].to(getattr(torch, self.cfg.dtype))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.ln_f, self.cfg.rms_eps)
        if self.cfg.tie_embeddings:
            return x @ cast(self.embed, x.dtype).t()
        return dot(x, self.head)

    def cast_weights_(self, dtype: Optional[torch.dtype] = None) -> int:
        """Cast the weights read in ``dtype`` (default: the config's
        activation dtype) once; returns the copies' bytes (0 in f32).  Call
        it again after the weights change in place: stale copies are
        refreshed where they lie."""
        return cast_weights_(self._cast,
                             dtype or getattr(torch, self.cfg.dtype))


def _stack(trees: Sequence[Any]) -> Any:
    """Stack a list of equal-structure cache trees along a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(list(trees))


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _unbind(tree: Any, n: int) -> List[Any]:
    """The n per-layer views of a tree stacked along axis 0."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def _block(bm: nn.ModuleDict, cfg: ModelConfig,
           x: torch.Tensor) -> torch.Tensor:
    for layer in bm.values():
        x, _ = apply_layer(layer, cfg, x, mode="train")
    return x


def forward_train(model: LM, tokens, remat: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) -> (logits (B,S,V), aux).  Differentiable; ``remat``
    recomputes each scanned block in the backward (``jax.checkpoint`` of
    the scan body).  ``aux`` is 0: no ported MLP has a router."""
    cfg = model.cfg
    x = model.embed_tokens(tokens)
    for layer in model.prefix:
        x, _ = apply_layer(layer, cfg, x, mode="train")
    for bm in model.blocks:
        if remat and torch.is_grad_enabled():
            x = checkpoint(_block, bm, cfg, x, use_reentrant=False)
        else:
            x = _block(bm, cfg, x)
    for layer in model.suffix:
        x, _ = apply_layer(layer, cfg, x, mode="train")
    return model.logits(x), torch.zeros((), device=x.device)


def lm_loss(model: LM, batch: Dict[str, Any], remat: bool = False
            ) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (logits in f32), plus the aux loss."""
    logits, aux = forward_train(model, batch["tokens"], remat=remat)
    logits = logits.float()
    labels = torch.as_tensor(batch["labels"], dtype=torch.long,
                             device=logits.device)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    return torch.mean(logz - gold) + aux


@torch.no_grad()
def init_cache(model: LM, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None, window: int = 0
               ) -> Cache:
    """Zero cache for pure decode runs (no prefill), in the activation
    dtype by default (the SSM states stay f32)."""
    cfg = model.cfg
    dtype = dtype or getattr(torch, cfg.dtype)
    n = len(model.blocks)
    one = {name: layer.init_cache(cfg, batch, max_len, dtype, window)
           for name, layer in model.blocks[0].items()} if n else {}
    return {"prefix": [layer.init_cache(cfg, batch, max_len, dtype, window)
                       for layer in model.prefix],
            "blocks": _map(lambda a: a.expand((n,) + a.shape).clone(), one),
            "suffix": [layer.init_cache(cfg, batch, max_len, dtype, window)
                       for layer in model.suffix]}


@torch.no_grad()
def prefill(model: LM, tokens, max_len: int = 0, window: int = 0
            ) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt (B,S), build the cache; returns last-position
    logits (B,1,V).  ``max_len`` (default S) sizes attention caches;
    ``window`` caps them at the window, in the ring layout when the prompt
    fills it."""
    cfg = model.cfg
    x = model.embed_tokens(tokens)
    max_len = max_len or x.shape[1]
    kw = dict(mode="prefill", max_len=max_len, window=window)
    caches: Cache = {"prefix": [], "suffix": []}
    for layer in model.prefix:
        x, c = apply_layer(layer, cfg, x, **kw)
        caches["prefix"].append(c)
    blk: List[Dict[str, Any]] = []
    for bm in model.blocks:
        cs = {}
        for name, layer in bm.items():
            x, cs[name] = apply_layer(layer, cfg, x, **kw)
        blk.append(cs)
    caches["blocks"] = _stack(blk)
    for layer in model.suffix:
        x, c = apply_layer(layer, cfg, x, **kw)
        caches["suffix"].append(c)
    return model.logits(x[:, -1:]), caches


@torch.no_grad()
def decode_step(model: LM, cache: Cache, token, pos=None, ring: bool = False,
                out: Optional[Cache] = None) -> Tuple[torch.Tensor, Cache]:
    """token (B,1) at position ``pos`` (an int or a 0-dim integer tensor;
    attention caches need it, SSM states do not) -> (logits (B,1,V),
    cache).  ``ring`` addresses attention caches as ring buffers.  The
    new cache is written into ``out``'s tensors when given (a cache of the
    same structure and shapes; ``out`` may be ``cache`` itself, updated in
    place, which only a cache that nothing else reads may be), else into
    new ones, and ``cache`` is left as it is (forked caches may share
    it)."""
    cfg = model.cfg
    x = model.embed_tokens(token)
    kw = dict(mode="decode", pos=pos, ring=ring)
    n = len(model.blocks)
    if out is None:
        # each layer writes its new cache into its slot of freshly allocated
        # stacked leaves: nothing is re-stacked per step
        out = {"prefix": [None] * len(model.prefix),
               "blocks": _map(torch.empty_like, cache["blocks"]),
               "suffix": [None] * len(model.suffix)}
    new: Cache = {"prefix": [], "blocks": out["blocks"], "suffix": []}
    for layer, c, o in zip(model.prefix, cache["prefix"], out["prefix"]):
        x, nc = apply_layer(layer, cfg, x, cache=c, out=o, **kw)
        new["prefix"].append(nc)
    for bm, bc, bn in zip(model.blocks, _unbind(cache["blocks"], n),
                          _unbind(out["blocks"], n)):
        for name, layer in bm.items():
            x, _ = apply_layer(layer, cfg, x, cache=bc[name], out=bn[name],
                               **kw)
    for layer, c, o in zip(model.suffix, cache["suffix"], out["suffix"]):
        x, nc = apply_layer(layer, cfg, x, cache=c, out=o, **kw)
        new["suffix"].append(nc)
    return model.logits(x), new
