"""Model assembly: the LM runtime behind the JAX package's API, for the
mixers ported so far.

The JAX package scans stacked layer params (``lax.scan`` over ``blocks``);
here ``blocks`` is an ``nn.ModuleList`` walked in a loop, while the cache
keeps the JAX structure ``{"prefix", "blocks", "suffix"}`` with every
``blocks`` leaf stacked along a leading n_blocks axis, so cache code
(``serving/kvcache.py``) and parity tests see the same trees.

Public API (the model stands in for ``(params, cfg)``)
------------------------------------------------------
LM(cfg, device=, generator=)                     -> model  (init_params)
prefill(model, tokens, max_len)                  -> (last_logits, cache)
decode_step(model, cache, token, pos, out=)      -> (logits, cache)

Ported: ``ssm`` layers with MLP kind ``none`` (mamba2).  Any other mixer
or MLP kind raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.config import MIX_SSM, ModelConfig
from repro_torch.models.layers import (cast, cast_weights_, dot,
                                      named_casts, rms_norm)
from repro_torch.models.ssm import Mamba2Mixer

Cache = Dict[str, Any]
#: the parameters the LM reads in its activation dtype (the tied embedding
#: as the output head; the norms, the conv and the SSM's dt/A run in f32)
CAST = ("embed", "head", "z_proj", "x_proj", "bc_proj", "dt_proj",
        "out_proj", "D")

_NOT_PORTED = ("not ported yet: ROADMAP.md §1, item 4 (the rest of the "
               "LLM substrate: attention KV cache, MoE, RG-LRU, MLA, "
               "cross-attention)")


def plan(cfg: ModelConfig) -> Tuple[Tuple[str, ...], Tuple[str, ...], int,
                                    Tuple[str, ...]]:
    """How layers are grouped into (prefix, scanned block, n_blocks,
    suffix) — the JAX package's ``plan`` for the layer patterns ported so
    far (mamba2's ``("ssm",)``); every other family raises here."""
    if cfg.family in ("moe", "encdec") or not cfg.pattern:
        raise NotImplementedError(f"family {cfg.family!r} {_NOT_PORTED}")
    n_blocks = (cfg.n_layers - len(cfg.remainder)) // len(cfg.pattern)
    return (), tuple(cfg.pattern), n_blocks, tuple(cfg.remainder)


class Layer(nn.Module):
    """One residual layer: ``ln1`` and its mixer (``init_layer``)."""

    def __init__(self, cfg: ModelConfig, kind: str, *, device, generator):
        super().__init__()
        if kind != MIX_SSM:
            raise NotImplementedError(f"mixer {kind!r} {_NOT_PORTED}")
        if cfg.d_ff or cfg.moe is not None:
            raise NotImplementedError(f"MLPs {_NOT_PORTED}")
        self.ln1 = nn.Parameter(torch.zeros(cfg.d_model, device=device))
        self.mix = Mamba2Mixer(cfg, device=device, generator=generator)


def apply_layer(layer: Layer, cfg: ModelConfig, x: torch.Tensor, *,
                mode: str, cache=None, out=None) -> Tuple[torch.Tensor, Any]:
    """``mode`` "prefill" | "decode" -> (x, new_cache).  In decode, ``out``
    (optional) holds the tensors the new cache is written into."""
    h = rms_norm(x, layer.ln1, cfg.rms_eps)
    if mode == "prefill":
        a, new_cache = layer.mix.ssm_full(h, return_cache=True)
    elif mode == "decode":
        a, new_cache = layer.mix.ssm_decode(h, cache, out=out)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return x + a, new_cache


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
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        kw = dict(device=device, generator=generator)
        self.cfg = cfg
        prefix, block, n_blocks, suffix = plan(cfg)
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


def _tokens(model: LM, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, dtype=torch.long, device=model.device)


@torch.no_grad()
def prefill(model: LM, tokens, max_len: int = 0
            ) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt (B,S), build the cache; returns last-position
    logits (B,1,V).  ``max_len`` sizes attention caches, which the ported
    mixers do not have."""
    cfg = model.cfg
    x = model.embed[_tokens(model, tokens)].to(getattr(torch, cfg.dtype))
    caches: Cache = {"prefix": [], "suffix": []}
    for layer in model.prefix:
        x, c = apply_layer(layer, cfg, x, mode="prefill")
        caches["prefix"].append(c)
    blk: List[Dict[str, Any]] = []
    for bm in model.blocks:
        cs = {}
        for name, layer in bm.items():
            x, cs[name] = apply_layer(layer, cfg, x, mode="prefill")
        blk.append(cs)
    caches["blocks"] = _stack(blk)
    for layer in model.suffix:
        x, c = apply_layer(layer, cfg, x, mode="prefill")
        caches["suffix"].append(c)
    return model.logits(x[:, -1:]), caches


@torch.no_grad()
def decode_step(model: LM, cache: Cache, token, pos=None,
                out: Optional[Cache] = None) -> Tuple[torch.Tensor, Cache]:
    """token (B,1) -> (logits (B,1,V), cache).  ``pos`` places attention
    caches' writes, which the ported mixers do not have.  The input cache is
    left as it is (forked caches may share it); the new one is written into
    ``out``'s tensors when given (a cache of the same structure and shapes,
    as a decode graph's second cache set), else into new ones."""
    cfg = model.cfg
    x = model.embed[_tokens(model, token)].to(getattr(torch, cfg.dtype))
    if out is None:
        # each layer writes its new cache into its slot of freshly allocated
        # stacked leaves: nothing is re-stacked per step
        out = {"prefix": [None] * len(model.prefix),
               "blocks": _map(torch.empty_like, cache["blocks"]),
               "suffix": [None] * len(model.suffix)}
    new: Cache = {"prefix": [], "blocks": out["blocks"], "suffix": []}
    for layer, c, o in zip(model.prefix, cache["prefix"], out["prefix"]):
        x, nc = apply_layer(layer, cfg, x, mode="decode", cache=c, out=o)
        new["prefix"].append(nc)
    n = len(model.blocks)
    for bm, bc, bn in zip(model.blocks, _unbind(cache["blocks"], n),
                          _unbind(out["blocks"], n)):
        for name, layer in bm.items():
            x, _ = apply_layer(layer, cfg, x, mode="decode", cache=bc[name],
                               out=bn[name])
    for layer, c, o in zip(model.suffix, cache["suffix"], out["suffix"]):
        x, nc = apply_layer(layer, cfg, x, mode="decode", cache=c, out=o)
        new["suffix"].append(nc)
    return model.logits(x), new
