"""The small convolutional VAE of the latent-diffusion substrate.

Encoder: image (B, H, W, 3) in [-1, 1] -> three stride-2 3x3 SAME convs
with silu, then a 1x1 conv to the (mean, logvar) of a (B, H/8, W/8, 4)
latent.  Decoder: latent -> image through a 1x1 conv, then three (nearest
2x resize, 3x3 SAME conv) stages with silu between and tanh at the end.
Conv weights are OIHW for ``F.conv2d``; the public layout stays NHWC.
The serving path calls the decoder (``VAEDecoder.forward``, no autograd);
training calls :func:`vae_loss`, which runs both halves under autograd.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

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


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1
          ) -> torch.Tensor:
    """SAME conv on NCHW.  Stride 1 with an odd kernel pads k // 2 on each
    side; a stride-2 conv pads as XLA's SAME does, the odd pixel at the
    end (bottom / right)."""
    k = w.shape[-1]
    if stride == 1:
        return F.conv2d(x, w.to(x.dtype), padding=k // 2)
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w.to(x.dtype), stride=stride)


class VAEEncoder(nn.Module):
    """The encoder half (f32), ``enc`` named as in the JAX package."""

    def __init__(self, image_channels: int = 3, latent_channels: int = 4, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        kw = dict(device=device, generator=generator)
        enc, cin = {}, image_channels
        for i, ch in enumerate(_CH):
            enc[f"w{i}"] = _conv_init(3, cin, ch, **kw)
            cin = ch
        enc["out"] = _conv_init(1, cin, 2 * latent_channels, **kw)
        self.enc = nn.ParameterDict(enc)


def encode(encoder: VAEEncoder, x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,H,W,3) in [-1,1] -> (mean, logvar), each (B, H/8, W/8, C)."""
    p = encoder.enc
    h = x.permute(0, 3, 1, 2)
    for i in range(len(_CH)):
        h = F.silu(_conv(h, p[f"w{i}"], stride=2))
    mean, logvar = _conv(h, p["out"]).permute(0, 2, 3, 1).chunk(2, dim=-1)
    return mean, torch.clamp(logvar, -10.0, 10.0)


def sample(mean: torch.Tensor, logvar: torch.Tensor,
           noise: torch.Tensor) -> torch.Tensor:
    """The reparameterised draw, ``noise`` ~ N(0, 1) of mean's shape (the
    JAX package draws it from a key)."""
    return mean + torch.exp(0.5 * logvar) * noise


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
        return self.forward_grad(z)

    def forward_grad(self, z: torch.Tensor) -> torch.Tensor:
        """:meth:`forward` recorded by autograd when grad mode is on."""
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


def vae_loss(encoder: VAEEncoder, decoder: VAEDecoder, x: torch.Tensor,
             noise: torch.Tensor, kl_weight: float = 1e-3):
    """Reconstruction MSE + ``kl_weight`` x KL to N(0, I), and its parts;
    ``noise`` is :func:`sample`'s draw."""
    mean, logvar = encode(encoder, x)
    recon = decoder.forward_grad(sample(mean, logvar, noise))
    rec = torch.mean((recon - x) ** 2)
    kl = 0.5 * torch.mean(mean ** 2 + torch.exp(logvar) - 1.0 - logvar)
    return rec + kl_weight * kl, {"rec": rec, "kl": kl}
