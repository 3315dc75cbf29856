"""Decoder of the small convolutional VAE: latent (B, h, w, 4) -> image
(B, 8h, 8w, 3) in [-1, 1] through a 1x1 conv, then three (nearest 2x
resize, 3x3 SAME conv) stages with silu between and tanh at the end.
Conv weights are OIHW for ``F.conv2d``; the public layout stays NHWC.
``encode`` and ``sample`` come with the training slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device

_CH = (32, 64, 128)


def _conv_init(k: int, cin: int, cout: int, *, device,
               generator) -> nn.Parameter:
    return nn.Parameter(torch.randn((cout, cin, k, k), device=device,
                                    generator=generator)
                        / math.sqrt(k * k * cin))


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME conv on NCHW (odd kernels: pad k // 2)."""
    return F.conv2d(x, w.to(x.dtype), padding=w.shape[-1] // 2)


class VAEDecoder(nn.Module):
    """``dtype`` is the activation dtype (weights stay f32 and are cast at
    each conv, as the DiT's matmuls do); the output is f32."""

    def __init__(self, image_channels: int = 3, latent_channels: int = 4, *,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.dtype = dtype
        kw = dict(device=device, generator=generator)
        dec = {"in": _conv_init(1, latent_channels, _CH[-1], **kw)}
        cin = _CH[-1]
        for i, ch in enumerate(reversed(_CH[:-1])):
            dec[f"w{i}"] = _conv_init(3, cin, ch, **kw)
            cin = ch
        dec["out"] = _conv_init(3, cin, image_channels, **kw)
        self.dec = nn.ParameterDict(dec)

    @torch.no_grad()
    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, h, w, C) -> image (B, 8h, 8w, 3) f32 in [-1, 1]."""
        p = self.dec
        h = F.silu(_conv(z.to(self.dtype).permute(0, 3, 1, 2), p["in"]))
        for i in range(len(_CH) - 1):
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = F.silu(_conv(h, p[f"w{i}"]))
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        return torch.tanh(_conv(h, p["out"])).permute(0, 2, 3, 1).float()


def decode(vae: VAEDecoder, z: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``decode``: latents (B, h, w, C) -> images."""
    return vae(z)
