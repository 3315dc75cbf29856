"""Weight bridge: JAX parameter pytrees (as numpy arrays) -> the port's
modules, and the DiT and the LM back (:func:`dit_to_jax`,
:func:`lm_to_jax`).

The JAX package keeps parameters as nested dicts (``dit.init_params``,
``text_encoder.init_text``, ``vae.init_params``); hand them over as
``jax.tree.map(np.asarray, params)``.  The bridge itself imports no JAX:

* nested dict keys and list indices become dotted module paths
  (``blocks.attn.wq``, ``prefix.0.ln1`` ...);
* the stacked leading axis that ``jax.vmap`` builds (an LM's or a DiT's
  ``blocks``, an encoder's ``enc_blocks``) is split into one entry per
  ``nn.ModuleList`` layer;
* VAE conv weights go from HWIO to OIHW for ``F.conv2d``;
* a LoRA tree (``core.lora.init_lora``'s ``fold_in`` draws) crosses as it
  is, keyed by the JAX ``keystr`` of each adapted leaf;
* an ``LshIndex``'s hyperplanes (``jax.random`` draws, which torch cannot
  reproduce) are carried into the port's index as they are.

Loading is strict: a missing, extra or mis-shaped parameter raises.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch import tree as tu
from repro_torch.config import ModelConfig
from repro_torch.models.dit import DiT, stacked_params
from repro_torch.models.text_encoder import ImageTower, TextTower
from repro_torch.models import transformer
from repro_torch.models.transformer import LM
from repro_torch.models.vae import VAEDecoder, VAEEncoder
from repro_torch.serving.ann_index import LshIndex


def _flatten(tree: Mapping, prefix: str = ""
             ) -> Iterator[Tuple[str, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, f"{prefix}{k}.")
        elif isinstance(v, (list, tuple)):
            yield from _flatten(dict(enumerate(v)), f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


#: the top-level subtrees whose leaves ``jax.vmap`` stacks over layers
_STACKED = ("blocks", "enc_blocks")


def _unstack_blocks(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``flat`` with each leaf of a stacked subtree (``_STACKED``) split
    along its leading layer axis: ``blocks.l0.wq`` of shape (n, ...) ->
    ``blocks.{i}.l0.wq``."""
    out = {}
    for name, arr in flat.items():
        top, _, rest = name.partition(".")
        if top in _STACKED and rest:
            for i in range(arr.shape[0]):
                out[f"{top}.{i}.{rest}"] = arr[i]
        else:
            out[name] = arr
    return out


def load_numpy(module: nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Copy numpy arrays into ``module``'s parameters by dotted name (on
    the module's device and dtype).  Raises on any name or shape
    mismatch."""
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, arr in flat.items():
            p = params[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape} != "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.tensor(arr))


def dit_from_jax(params: Mapping, cfg: ModelConfig, *,
                 device="cuda") -> DiT:
    """A :class:`DiT` holding ``dit.init_params``-layout weights."""
    model = DiT(cfg, device=device)
    load_numpy(model, _unstack_blocks(dict(_flatten(params))))
    return model


def dit_to_jax(model: DiT) -> Dict:
    """The inverse of :func:`dit_from_jax`: ``model``'s weights as a
    ``dit.init_params``-layout tree of numpy arrays, ``blocks.{i}.*``
    stacked back over the layer axis."""
    return tu.tree_map(lambda x: x.cpu().numpy(), stacked_params(model))


def lora_from_jax(lora: Mapping, *, device="cuda") -> Dict:
    """A JAX LoRA tree (``{keystr: {"a", "b"}}``) as tensors on
    ``device``, for ``core.lora.merge`` and the trainer."""
    device = resolve_device(device)
    out = {}
    for key, ab in lora.items():
        if set(ab) != {"a", "b"}:
            raise KeyError(f"LoRA entry {key!r} holds {sorted(ab)}, not a/b")
        a, b = np.asarray(ab["a"]), np.asarray(ab["b"])
        if a.shape[-1] != b.shape[-2] or a.shape[:-2] != b.shape[:-2]:
            raise ValueError(f"LoRA entry {key!r}: a {a.shape}, b {b.shape}")
        out[key] = {"a": torch.tensor(a, device=device),
                    "b": torch.tensor(b, device=device)}
    return out


def text_from_jax(params: Mapping, cfg: ModelConfig, *,
                  device="cuda") -> TextTower:
    """A :class:`TextTower` holding ``text_encoder.init_text`` weights."""
    model = TextTower(cfg, device=device)
    load_numpy(model, _unstack_blocks(dict(_flatten(params))))
    return model


def vae_from_jax(params: Mapping, *, device="cuda",
                 dtype: torch.dtype = torch.float32) -> VAEDecoder:
    """A :class:`VAEDecoder` holding the decoder half of
    ``vae.init_params`` (HWIO convs transposed to OIHW)."""
    dec = {k: np.asarray(v) for k, v in params["dec"].items()}
    image_channels = dec["out"].shape[-1]
    latent_channels = dec["in"].shape[-2]
    model = VAEDecoder(image_channels, latent_channels, device=device,
                       dtype=dtype)
    load_numpy(model, {f"dec.{k}": v.transpose(3, 2, 0, 1)
                       for k, v in dec.items()})
    return model


def vae_encoder_from_jax(params: Mapping, *, device="cuda") -> VAEEncoder:
    """A :class:`VAEEncoder` holding the encoder half of
    ``vae.init_params`` (HWIO convs transposed to OIHW)."""
    enc = {k: np.asarray(v) for k, v in params["enc"].items()}
    image_channels = enc["w0"].shape[-2]
    latent_channels = enc["out"].shape[-1] // 2
    model = VAEEncoder(image_channels, latent_channels, device=device)
    load_numpy(model, {f"enc.{k}": v.transpose(3, 2, 0, 1)
                       for k, v in enc.items()})
    return model


def image_from_jax(params: Mapping, *, device="cuda") -> ImageTower:
    """An :class:`ImageTower` holding ``text_encoder.init_image`` weights
    (sizes read off the arrays)."""
    flat = _unstack_blocks(dict(_flatten(params)))
    p_in, dim = flat["patch_in"].shape
    patch = math.isqrt(p_in // 3)
    image = math.isqrt(flat["pos"].shape[0]) * patch
    layers = np.asarray(params["blocks"]["ln1"]).shape[0]
    model = ImageTower(dim, patch, image, layers, device=device)
    load_numpy(model, flat)
    return model


def lm_from_jax(params: Mapping, cfg: ModelConfig, *, device="cuda") -> LM:
    """An :class:`LM` holding ``transformer.init_params`` weights:
    ``embed``, ``ln_f``, the ``prefix`` / ``suffix`` layer lists (an MoE
    config's dense first layers; the hybrid's remainder), the stacked
    ``blocks`` split per layer (``ln1``, the mixer's ``mix.*``: GQA ``wq`` /
    ``wk`` / ``wv`` / ``wo`` with its optional biases and q/k norms, MLA's
    ``wq`` / ``wdkv`` / ``kv_norm`` / ``wukv`` / ``wo``, the SSM's or the
    RG-LRU's; ``ln2`` and ``mlp.wi`` / ``wg`` / ``wo`` for a dense MLP, or
    ``moe.router``, the per-expert stacks ``moe.wi`` / ``wg`` / ``wo`` and
    ``moe.shared.*`` for a routed one; a ``cross_attn`` layer's ``lnx`` and
    ``xattn.*``), ``head`` unless the embeddings are tied, the VLM's
    ``proj``, and the encdec encoder's ``enc_in``, ``enc_ln`` and stacked
    ``enc_blocks`` split per layer (``enc_blocks.{i}.l0.*``)."""
    model = LM(cfg, device=device)
    load_numpy(model, _unstack_blocks(dict(_flatten(params))))
    return model


def lm_to_jax(model: LM) -> Dict:
    """The inverse of :func:`lm_from_jax`: ``model``'s weights as a
    ``transformer.init_params``-layout tree of numpy arrays, ``blocks`` and
    ``enc_blocks`` stacked back over the layer axis, ``prefix`` / ``suffix``
    lists."""
    return tu.tree_map(lambda x: x.cpu().numpy(),
                       transformer.stacked_params(model))


def lsh_from_jax(planes: Mapping[int, np.ndarray], *, n_tables: int = 8,
                 n_bits: int = 6, seed: int = 0) -> LshIndex:
    """A port :class:`LshIndex` hashing with a JAX ``LshIndex``'s planes:
    ``planes`` maps an embedding dim to its (n_tables * n_bits, dim)
    array (``{d: np.asarray(p) for d, p in index._planes.items()}``).
    Dims not given are drawn by the port's own generator on first use."""
    index = LshIndex(n_tables=n_tables, n_bits=n_bits, seed=seed)
    for dim, arr in planes.items():
        arr = np.asarray(arr, np.float32)
        if arr.shape != (n_tables * n_bits, int(dim)):
            raise ValueError(f"planes for dim {dim}: shape {arr.shape} != "
                             f"{(n_tables * n_bits, int(dim))}")
        index._planes[int(dim)] = arr.copy()
    return index
