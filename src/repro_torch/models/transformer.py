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
forward_train(model, tokens, extras=, remat=)       -> (logits (B,S,V), aux)
lm_loss(model, batch, remat=)                       -> scalar loss
stacked_params(model)                               -> params  (JAX layout)
tree_loss(model, params, batch, remat=)             -> lm_loss over params
bound(model, params)                                -> model with params (ctx)
module_params(params)                               -> {dotted name: view}
meta_lm(cfg)                                        -> shapes only (eval_shape)
encode(model, frames, remat=)                       -> encoder memory
init_cache(model, batch, max_len, dtype=, window=)  -> zero cache
prefill(model, tokens, extras=, max_len=, window=)  -> (last_logits, cache)
decode_step(model, cache, token, pos, ring=, out=)  -> (logits, cache)

Every LM family of the JAX package: ``dense`` (GQA ``attn`` layers with a
dense SwiGLU or GELU MLP), ``ssm`` layers (mamba2), the ``hybrid`` (RG-LRU
and local attention super-blocks with an unrolled remainder:
recurrentgemma), ``moe`` (a prefix of dense layers, then layers with a
routed MLP; GQA or MLA attention: deepseek-v2-lite, kimi-k2), the ``vlm``
(``(attn x4, cross_attn)`` super-blocks attending to projected image
embeddings, ``extras["image_embeds"]``: llama-3.2-vision) and ``encdec``
(a bidirectional encoder over ``extras["frames"]``, then ``cross_attn``
decoder layers: seamless-m4t).  A ``cross_attn`` layer is a GQA
self-attention layer followed by ``lnx`` and a cross-attention block
``xattn`` to the memory; its cache is ``{"self": <GQA cache>, "cross":
{"k", "v"}}``, the memory's K/V computed once in the prefill, which a
decode step reads and passes on untouched.  The ``dit`` family is not an
LM and raises ``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn.utils.stateless import _reparametrize_module
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch import tree as tu
from repro_torch.config import (MIX_ATTN, MIX_CROSS_ATTN, MIX_LOCAL_ATTN,
                                MIX_RGLRU, MIX_SSM, ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models.layers import (apply_mlp, cast, cast_weights_,
                                      dense_init, dot, init_mlp, named_casts,
                                      rms_norm)
from repro_torch.models.ssm import Mamba2Mixer

Cache = Dict[str, Any]
#: the parameters the LM reads in its activation dtype: the embedding (the
#: tied head) and head, the attention (GQA, cross and MLA) and MLP matrices
#: and biases (the MoE experts' stacked ones too), the SSM and RG-LRU
#: projections, the VLM's image projector and the encoder's input
#: projection (the norms, the convs, the SSM's dt/A, the RG-LRU's gate
#: biases and Lambda, and the router run in f32)
CAST = ("embed", "head", "wq", "wk", "wv", "wo", "bq", "bk", "bv", "wi",
        "wg", "z_proj", "x_proj", "bc_proj", "dt_proj", "out_proj", "D",
        "wdkv", "wukv", "wx", "wa", "out", "proj", "enc_in")

_NOT_AN_LM = ("is not an LM family: the DiT is models/dit.py (ROADMAP.md "
              "§1 lists the ported modules)")
_LM_FAMILIES = ("dense", "ssm", "hybrid", "moe", "vlm", "encdec")
#: the mixers that keep an attention cache (GQA or MLA; a cross-attention
#: layer's self-attention too)
_ATTN_MIXERS = (MIX_ATTN, MIX_LOCAL_ATTN, MIX_CROSS_ATTN)
#: the memory length of an encdec decode-only zero cache (``init_cache``)
_ENC_LEN = 4096


def plan(cfg: ModelConfig) -> Tuple[Tuple[str, ...], Tuple[str, ...], int,
                                    Tuple[str, ...]]:
    """How layers are grouped into (prefix, scanned block, n_blocks,
    suffix): the JAX package's ``plan``; a family that is not an LM raises
    here."""
    if cfg.family not in _LM_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} {_NOT_AN_LM}")
    kinds = cfg.layer_kinds()
    if cfg.family == "moe":
        f = cfg.moe.first_moe_layer
        return kinds[:f], (MIX_ATTN,), cfg.n_layers - f, ()
    if cfg.family == "encdec":
        return (), (MIX_CROSS_ATTN,), cfg.n_layers, ()
    if cfg.pattern:
        n_blocks = (cfg.n_layers - len(cfg.remainder)) // len(cfg.pattern)
        return (), tuple(cfg.pattern), n_blocks, tuple(cfg.remainder)
    return (), (MIX_ATTN,), cfg.n_layers, ()


def _mlp_kind(cfg: ModelConfig, in_scan: bool) -> str:
    """'moe' | 'dense' | 'none' for a layer position (in the scanned
    blocks or not)."""
    if cfg.d_ff == 0 and cfg.moe is None:
        return "none"
    if cfg.moe is not None and in_scan:
        return "moe"
    return "dense"


def uses_pos(cfg: ModelConfig) -> bool:
    """Whether a decode step reads its position: any layer that keeps an
    attention cache does (GQA, local, MLA, or a cross-attention layer's
    self-attention)."""
    prefix, block, _, suffix = plan(cfg)
    return any(k in _ATTN_MIXERS for k in prefix + block + suffix)


class Layer(nn.Module):
    """One residual layer (``init_layer``): ``ln1`` and its mixer
    (``mix``: GQA or MLA attention, the SSM, the RG-LRU), for a
    ``cross_attn`` layer then ``lnx`` and the GQA cross-attention block
    ``xattn``, then ``ln2`` and a dense ``mlp`` or a routed ``moe`` unless
    the MLP kind is ``none``."""

    def __init__(self, cfg: ModelConfig, kind: str, mlpk: str, *, device,
                 generator):
        super().__init__()
        d = cfg.d_model
        kw = dict(device=device, generator=generator)
        self.kind, self.mlpk = kind, mlpk
        self.ln1 = nn.Parameter(torch.zeros(d, device=device))
        if kind in _ATTN_MIXERS:
            self.mix = (attn.init_mla(cfg, **kw) if cfg.attn_kind == "mla"
                        else attn.init_gqa(cfg, **kw))
            if kind == MIX_CROSS_ATTN:
                self.lnx = nn.Parameter(torch.zeros(d, device=device))
                self.xattn = attn.init_gqa(cfg, **kw)
        elif kind == MIX_SSM:
            self.mix = Mamba2Mixer(cfg, **kw)
        elif kind == MIX_RGLRU:
            self.mix = rglru_lib.init_rglru(cfg, **kw)
        else:
            raise ValueError(f"unknown mixer {kind!r}")
        if mlpk == "dense":
            ff = (cfg.moe.d_ff_dense if (cfg.moe and cfg.moe.d_ff_dense)
                  else cfg.d_ff)
            self.ln2 = nn.Parameter(torch.zeros(d, device=device))
            self.mlp = nn.ParameterDict({
                k: nn.Parameter(v) for k, v in init_mlp(
                    d, ff, cfg.mlp_kind, **kw).items()})
        elif mlpk == "moe":
            self.ln2 = nn.Parameter(torch.zeros(d, device=device))
            self.moe = moe_lib.init_moe(cfg, **kw)

    def init_cache(self, cfg: ModelConfig, batch: int, max_len: int, dtype,
                   window: int = 0) -> Cache:
        """``init_layer_cache``: this layer's zero cache.  A
        ``cross_attn`` layer's memory K/V hold ``n_image_tokens`` rows (the
        VLM) or ``_ENC_LEN`` (encdec)."""
        dev = self.ln1.device
        if self.kind in (MIX_ATTN, MIX_CROSS_ATTN):
            if cfg.attn_kind == "mla":
                c = attn.mla_cache_init(cfg, batch, window or max_len,
                                        dtype, dev)
            else:
                c = attn.gqa_cache_init(cfg, batch, window or max_len,
                                        dtype, dev)
            if self.kind == MIX_CROSS_ATTN:
                n_mem = (cfg.n_image_tokens if cfg.family == "vlm"
                         else _ENC_LEN)
                c = {"self": c,
                     "cross": attn.gqa_cache_init(cfg, batch, n_mem, dtype,
                                                  dev)}
            return c
        if self.kind == MIX_LOCAL_ATTN:
            return attn.gqa_cache_init(cfg, batch, min(cfg.window, max_len),
                                       dtype, dev)
        if self.kind == MIX_RGLRU:
            return rglru_lib.rglru_cache_init(cfg, batch, dtype, dev)
        return self.mix.ssm_cache_init(batch, dtype)


def apply_layer(layer: Layer, cfg: ModelConfig, x: torch.Tensor, *,
                mode: str, cache=None, pos=None, memory=None,
                window: int = 0, ring: bool = False, max_len: int = 0,
                out=None, ssd_impl: str = "kernel"
                ) -> Tuple[torch.Tensor, Any, Optional[torch.Tensor]]:
    """``mode`` "train" | "prefill" | "decode" -> (x, new_cache, aux), the
    new cache None in train, aux the router's load-balance loss of an MoE
    layer (None for the others).  A local-attention layer attends within
    ``cfg.window`` whatever the call's ``window``, and its decode is always
    a ring.  A cross-attention layer attends to ``memory`` (train,
    prefill) or to its cache's ``cross`` K/V (decode).  In decode, ``out``
    (optional) holds the tensors the new cache is written into.  In train,
    ``ssd_impl`` is an SSM layer's scan route (``dispatch.ssd``)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    h = rms_norm(x, layer.ln1, cfg.rms_eps)
    new_cache = aux = None
    cross = layer.kind == MIX_CROSS_ATTN
    if cross and mode == "decode":
        cache, xkv = cache["self"], cache["cross"]
        if out is not None:
            out, xout = out["self"], out["cross"]
            xkv = {k: attn._into(xout[k], v) for k, v in xkv.items()}
    if layer.kind in _ATTN_MIXERS:
        w = cfg.window if layer.kind == MIX_LOCAL_ATTN else window
        mla = cfg.attn_kind == "mla"
        if mode == "train":
            a = (attn.mla_full(layer.mix, cfg, h) if mla
                 else attn.gqa_full(layer.mix, cfg, h, window=w))
        elif mode == "prefill":
            if mla:
                a, new_cache = attn.mla_prefill(layer.mix, cfg, h,
                                                max_len=max_len)
            else:
                L = min(w, max_len) if w else max_len
                a, new_cache = attn.gqa_prefill(layer.mix, cfg, h, max_len=L,
                                                window=w)
        else:
            if pos is None:
                raise ValueError("an attention layer's decode step needs "
                                 "its position")
            if mla:
                a, new_cache = attn.mla_decode(layer.mix, cfg, h, cache, pos,
                                               out=out)
            else:
                a, new_cache = attn.gqa_decode(
                    layer.mix, cfg, h, cache, pos,
                    ring=ring or layer.kind == MIX_LOCAL_ATTN, out=out)
    elif layer.kind == MIX_RGLRU:
        if mode == "train":
            a = rglru_lib.rglru_full(layer.mix, cfg, h)
        elif mode == "prefill":
            a, new_cache = rglru_lib.rglru_full(layer.mix, cfg, h,
                                                return_cache=True)
        else:
            a, new_cache = rglru_lib.rglru_decode(layer.mix, cfg, h, cache,
                                                  out=out)
    else:
        if mode == "train":
            a = layer.mix.ssm_full(h, ssd_impl=ssd_impl)
        elif mode == "prefill":
            a, new_cache = layer.mix.ssm_full(h, return_cache=True)
        else:
            a, new_cache = layer.mix.ssm_decode(h, cache, out=out)
    x = x + a
    if cross:
        hx = rms_norm(x, layer.lnx, cfg.rms_eps)
        if mode == "decode":
            x = x + attn.gqa_cross_decode(layer.xattn, cfg, hx, xkv)
            new_cache = {"self": new_cache, "cross": xkv}
        else:
            x = x + attn.gqa_full(layer.xattn, cfg, hx, causal=False,
                                  memory=memory)
            if mode == "prefill":
                new_cache = {"self": new_cache,
                             "cross": attn.gqa_cross_cache(layer.xattn, cfg,
                                                           memory)}
    if layer.mlpk == "dense":
        x = x + apply_mlp(layer.mlp, rms_norm(x, layer.ln2, cfg.rms_eps),
                          cfg.mlp_kind)
    elif layer.mlpk == "moe":
        y, aux = moe_lib.apply_moe(layer.moe, cfg,
                                   rms_norm(x, layer.ln2, cfg.rms_eps))
        x = x + y
    return x, new_cache, aux


class LM(nn.Module):
    """The language model (``init_params``'s tree as modules): ``embed``,
    ``ln_f``, ``prefix`` / ``suffix`` layer lists, ``blocks`` (one
    ``ModuleDict`` of ``l{j}`` layers per scanned block) and ``head`` when
    the embeddings are not tied; the VLM's image projector ``proj``; the
    encdec encoder's ``enc_in``, ``enc_blocks`` (one ``{"l0": <dense GQA
    layer>}`` a layer) and ``enc_ln``.  Weights are f32; activations run in
    ``cfg.dtype``.  ``device`` defaults to CUDA and raises without a GPU;
    on the meta device nothing is drawn (:func:`meta_lm`).  Calling the
    model is :func:`lm_loss` (``model(batch, remat=)``), which
    :func:`tree_loss` runs over a parameter tree."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        prefix, block, n_blocks, suffix = plan(cfg)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        kw = dict(device=device, generator=generator)
        self.cfg = cfg
        d = cfg.d_model
        self.embed = nn.Parameter(torch.randn((cfg.vocab, d), **kw) * 0.02)
        self.ln_f = nn.Parameter(torch.zeros(d, device=device))
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(torch.randn((d, cfg.vocab), **kw)
                                     / d ** 0.5)
        outer, inner = _mlp_kind(cfg, False), _mlp_kind(cfg, True)
        self.prefix = nn.ModuleList(
            Layer(cfg, k, outer, **kw) for k in prefix)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({f"l{j}": Layer(cfg, k, inner, **kw)
                           for j, k in enumerate(block)})
            for _ in range(n_blocks))
        self.suffix = nn.ModuleList(
            Layer(cfg, k, outer, **kw) for k in suffix)
        if cfg.family == "vlm":
            self.proj = nn.Parameter(dense_init(cfg.vision_dim, d, **kw))
        if cfg.family == "encdec":
            self.enc_in = nn.Parameter(dense_init(cfg.enc_input_dim, d, **kw))
            self.enc_blocks = nn.ModuleList(
                nn.ModuleDict({"l0": Layer(cfg, MIX_ATTN, "dense", **kw)})
                for _ in range(cfg.enc_layers))
            self.enc_ln = nn.Parameter(torch.zeros(d, device=device))
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

    def forward(self, batch: Dict[str, Any], remat: bool = False
                ) -> torch.Tensor:
        return lm_loss(self, batch, remat)


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


def _fresh(tree: Any) -> Any:
    """New tensors shaped as ``tree``'s, but for its ``cross`` subtrees
    (memory K/V, which a decode step only reads): those are ``tree``'s
    own."""
    if isinstance(tree, dict):
        return {k: v if k == "cross" else _fresh(v) for k, v in tree.items()}
    return torch.empty_like(tree)


def _unbind(tree: Any, n: int) -> List[Any]:
    """The n per-layer views of a tree stacked along axis 0."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def _block(bm: nn.ModuleDict, cfg: ModelConfig, x: torch.Tensor,
           memory: Optional[torch.Tensor] = None, ssd_impl: str = "kernel"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    aux = torch.zeros((), device=x.device)
    for layer in bm.values():
        x, _, a = apply_layer(layer, cfg, x, mode="train", memory=memory,
                              ssd_impl=ssd_impl)
        if a is not None:
            aux = aux + a
    return x, aux


def _activations(model: LM, x) -> torch.Tensor:
    """An extras array (numpy or tensor) on the model's device, in its
    activation dtype."""
    return torch.as_tensor(x, device=model.device).to(
        getattr(torch, model.cfg.dtype))


def _remat(fn, module: nn.Module, *args):
    """``checkpoint(fn, module, *args)`` with the module's parameters as
    the checkpoint's inputs, rebound when the backward recomputes: the
    recomputation sees the weights the forward saw, also where they were
    bound only for the forward (:func:`tree_loss`, whose
    ``functional_call`` has put the module's own back by then)."""
    def run(params, *args):
        with _reparametrize_module(module, params):
            return fn(module, *args)
    return checkpoint(run, dict(module.named_parameters()), *args,
                      use_reentrant=False)


def encode(model: LM, frames, remat: bool = False) -> torch.Tensor:
    """The encdec encoder: frames (B, T, enc_input_dim) -> memory (B, T,
    d_model), bidirectional self-attention with RoPE (through the kernel
    dispatch, non-causal) and a dense MLP a layer, then ``enc_ln``.
    ``remat`` recomputes each layer in the backward."""
    cfg = model.cfg
    x = dot(_activations(model, frames), model.enc_in)
    for bm in model.enc_blocks:
        if remat and torch.is_grad_enabled():
            x = _remat(_enc_layer, bm["l0"], cfg, x)
        else:
            x = _enc_layer(bm["l0"], cfg, x)
    return rms_norm(x, model.enc_ln, cfg.rms_eps)


def _enc_layer(layer: Layer, cfg: ModelConfig,
               x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, layer.ln1, cfg.rms_eps)
    x = x + attn.gqa_full(layer.mix, cfg, h, causal=False)
    return x + apply_mlp(layer.mlp, rms_norm(x, layer.ln2, cfg.rms_eps),
                         cfg.mlp_kind)


def _memory(model: LM, extras: Optional[Dict[str, Any]],
            remat: bool = False) -> Optional[torch.Tensor]:
    """What the cross-attention layers attend to: the projected image
    embeddings (VLM), the encoder's output (encdec), else None."""
    if model.cfg.family == "vlm":
        return dot(_activations(model, extras["image_embeds"]), model.proj)
    if model.cfg.family == "encdec":
        return encode(model, extras["frames"], remat)
    return None


def forward_train(model: LM, tokens, extras: Optional[Dict[str, Any]] = None,
                  remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) -> (logits (B,S,V), aux).  Differentiable; ``remat``
    recomputes each scanned block (and encoder layer) in the backward
    (``jax.checkpoint`` of the scan body).  ``extras`` holds the VLM's
    ``image_embeds`` (B, n_image_tokens, vision_dim) or encdec's
    ``frames`` (B, T, enc_input_dim).  ``aux`` is the sum of the MoE
    layers' router load-balance losses (0 without MoE layers).

    The SSM layers' scan takes its plain route while autograd records
    (grad mode on), since the SSD kernel has no backward, and the kernel
    under ``torch.no_grad()``, as a prefill does."""
    cfg = model.cfg
    x = model.embed_tokens(tokens)
    memory = _memory(model, extras, remat)
    ssd_impl = "reference" if torch.is_grad_enabled() else "kernel"
    kw = dict(mode="train", memory=memory, ssd_impl=ssd_impl)
    aux = torch.zeros((), device=x.device)
    for layer in model.prefix:
        x, _, a = apply_layer(layer, cfg, x, **kw)
        if a is not None:
            aux = aux + a
    for bm in model.blocks:
        if remat and torch.is_grad_enabled():
            x, a = _remat(_block, bm, cfg, x, memory, ssd_impl)
        else:
            x, a = _block(bm, cfg, x, memory, ssd_impl)
        aux = aux + a
    for layer in model.suffix:
        x, _, a = apply_layer(layer, cfg, x, **kw)
        if a is not None:
            aux = aux + a
    return model.logits(x), aux


def lm_loss(model: LM, batch: Dict[str, Any], remat: bool = False
            ) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (logits in f32), plus the aux loss; every other
    key of ``batch`` is passed to ``forward_train`` as an extra."""
    logits, aux = forward_train(
        model, batch["tokens"],
        extras={k: v for k, v in batch.items()
                if k not in ("tokens", "labels")}, remat=remat)
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
def prefill(model: LM, tokens, extras: Optional[Dict[str, Any]] = None,
            max_len: int = 0, window: int = 0
            ) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt (B,S), build the cache; returns last-position
    logits (B,1,V).  ``extras`` as in ``forward_train``: the memory's
    cross K/V go into the cache.  ``max_len`` (default S) sizes attention
    caches; ``window`` caps them at the window, in the ring layout when
    the prompt fills it."""
    cfg = model.cfg
    x = model.embed_tokens(tokens)
    max_len = max_len or x.shape[1]
    kw = dict(mode="prefill", max_len=max_len, window=window,
              memory=_memory(model, extras))
    caches: Cache = {"prefix": [], "suffix": []}
    for layer in model.prefix:
        x, c, _ = apply_layer(layer, cfg, x, **kw)
        caches["prefix"].append(c)
    blk: List[Dict[str, Any]] = []
    for bm in model.blocks:
        cs = {}
        for name, layer in bm.items():
            x, cs[name], _ = apply_layer(layer, cfg, x, **kw)
        blk.append(cs)
    caches["blocks"] = _stack(blk)
    for layer in model.suffix:
        x, c, _ = apply_layer(layer, cfg, x, **kw)
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
    it).  A cross-attention layer's memory K/V are read, never written:
    the new cache holds ``cache``'s own (or ``out``'s, holding the same
    values)."""
    cfg = model.cfg
    x = model.embed_tokens(token)
    kw = dict(mode="decode", pos=pos, ring=ring)
    n = len(model.blocks)
    if out is None:
        # each layer writes its new cache into its slot of freshly allocated
        # stacked leaves: nothing is re-stacked per step, and the memory
        # K/V are passed on as they are
        out = {"prefix": [None] * len(model.prefix),
               "blocks": _fresh(cache["blocks"]),
               "suffix": [None] * len(model.suffix)}
    new: Cache = {"prefix": [], "blocks": out["blocks"], "suffix": []}
    for layer, c, o in zip(model.prefix, cache["prefix"], out["prefix"]):
        x, nc, _ = apply_layer(layer, cfg, x, cache=c, out=o, **kw)
        new["prefix"].append(nc)
    for bm, bc, bn in zip(model.blocks, _unbind(cache["blocks"], n),
                          _unbind(out["blocks"], n)):
        for name, layer in bm.items():
            x, _, _ = apply_layer(layer, cfg, x, cache=bc[name],
                                  out=bn[name], **kw)
    for layer, c, o in zip(model.suffix, cache["suffix"], out["suffix"]):
        x, nc, _ = apply_layer(layer, cfg, x, cache=c, out=o, **kw)
        new["suffix"].append(nc)
    return model.logits(x), new


#: the top-level subtrees whose leaves the JAX package stacks over layers
#: (``jax.vmap`` in ``init_params``); the module keeps one entry a layer
STACKED = ("blocks", "enc_blocks")
#: the top-level subtrees that are lists in the JAX tree
_LISTS = ("prefix", "suffix")


def stacked_params(model: LM) -> Dict[str, Any]:
    """A copy of ``model``'s weights in the layout of the JAX package's
    ``init_params``: nested dicts, the ``prefix`` / ``suffix`` layer lists,
    and each leaf of ``blocks`` / ``enc_blocks`` stacked over a leading
    layer axis, so an optimizer sees JAX's leaves (adafactor factors and
    clips a whole stacked leaf).  On the meta device: the shape tree."""
    flat: Dict[str, torch.Tensor] = {}
    layers: Dict[str, List[torch.Tensor]] = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            top, _, rest = name.partition(".")
            if top in STACKED:
                # blocks.{i}.<leaf>, met in layer order
                layers.setdefault(f"{top}.{rest.partition('.')[2]}",
                                  []).append(p.detach())
            else:
                flat[name] = p.detach().clone()
        flat.update({k: torch.stack(v) for k, v in layers.items()})
    tree: Dict[str, Any] = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf
    for k in _LISTS:
        layers = tree.get(k, {})
        tree[k] = [layers[str(i)] for i in range(len(layers))]
    return tree


def module_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX-layout tree as the module's dotted parameter names: each
    stacked leaf unbound into per-layer views (``blocks.{i}.<leaf>``), so
    the gradient of a stacked leaf comes back as one stacked tensor."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in tu.flatten_with_path(params):
        rest = ".".join(map(str, path[1:]))
        if path[0] in STACKED:
            for i, view in enumerate(leaf.unbind(0)):
                out[f"{path[0]}.{i}.{rest}"] = view
        else:
            out[".".join(map(str, path))] = leaf
    return out


def tree_loss(model: LM, params: Dict[str, Any], batch: Dict[str, Any],
              remat: bool = False) -> torch.Tensor:
    """:func:`lm_loss` with ``params`` (the JAX layout,
    :func:`stacked_params`) in place of ``model``'s own weights, every one
    of which it must give: the JAX ``lm_loss(params, cfg, batch)``, and
    differentiable in ``params``.  ``model`` only supplies the structure,
    so it may live on the meta device (:func:`meta_lm`)."""
    return torch.func.functional_call(model, module_params(params),
                                      (batch,), {"remat": remat},
                                      strict=True)


@contextlib.contextmanager
def bound(model: LM, params: Dict[str, Any]):
    """``model`` with ``params`` (the JAX layout, every weight) in place of
    its own weights while the block runs: the JAX functions that take
    ``params`` (``prefill``, ``decode_step``) over a parameter tree, which
    may hold DTensors."""
    with _reparametrize_module(model, module_params(params), strict=True):
        yield model


def meta_lm(cfg: ModelConfig) -> LM:
    """An :class:`LM` on the meta device, the counterpart of
    ``jax.eval_shape``: nothing is drawn or allocated, so any config
    builds in well under a second.  :func:`stacked_params` of it is the
    parameter shape tree, :func:`init_cache` the cache's, an optimizer's
    ``init`` the state's; :func:`tree_loss` runs over it."""
    return LM(cfg, device="meta")
