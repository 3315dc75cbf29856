"""Weight bridge: JAX parameter pytrees (as numpy arrays) -> the port's
modules.

The JAX package keeps parameters as nested dicts (``dit.init_params``,
``text_encoder.init_text``, ``vae.init_params``); hand them over as
``jax.tree.map(np.asarray, params)``.  The bridge itself imports no JAX:

* nested dict keys become dotted module paths (``blocks.attn.wq`` ...);
* the stacked leading ``blocks`` axis that ``jax.vmap(init_block)`` builds
  is split into one entry per ``nn.ModuleList`` layer;
* VAE conv weights go from HWIO to OIHW for ``F.conv2d``.

Loading is strict: a missing, extra or mis-shaped parameter raises.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models.dit import DiT
from repro_torch.models.text_encoder import TextTower
from repro_torch.models.vae import VAEDecoder


def _flatten(tree: Mapping, prefix: str = ""
             ) -> Iterator[Tuple[str, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _unstack_blocks(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for name, arr in flat.items():
        if name.startswith("blocks."):
            rest = name[len("blocks."):]
            for i in range(arr.shape[0]):
                out[f"blocks.{i}.{rest}"] = arr[i]
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
