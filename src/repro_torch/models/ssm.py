"""Mamba2 / SSD (state-space duality) mixer.  [arXiv:2405.21060]

Chunked SSD for training and prefill (quadratic intra-chunk + linear
inter-chunk recurrence, through ``kernels.dispatch.ssd``: the kernel, or
its plain scan where a gradient is recorded) and an O(1)-state
single-step recurrence for decode.  Single B/C group (n_groups = 1), as in
the JAX package.

Cache: {"conv": (B, K-1, conv_dim), "state": (B, H, P, N) f32}.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.models.layers import cast, dense_init, dot, rms_norm

Cache = Dict[str, torch.Tensor]


def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,S,C), w (K,C) depthwise causal, in f32 -> (B,S,C).  A
    cross-correlation, as ``conv_general_dilated`` is: no flip."""
    K, C = w.shape
    xp = F.pad(x.float().transpose(1, 2), (K - 1, 0))          # (B, C, S+K-1)
    out = F.conv1d(xp, w.float().t()[:, None, :], groups=C)
    return out.transpose(1, 2).to(x.dtype)


def conv_step(window: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """window (B,K,C) — the last K inputs (newest last) -> (B,C)."""
    return torch.einsum("bkc,kc->bc", window.float(),
                        w.float()).to(window.dtype)


def ssm_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return s, d_in, d_in // s.head_dim


class Mamba2Mixer(nn.Module):
    """Separate z / x / BC / dt projections, as the JAX package keeps them
    (``init_ssm``), with its initial values: A_log = log(1..H), D = 1,
    zero dt_bias, conv bias and norm."""

    def __init__(self, cfg: ModelConfig, *, device, generator):
        super().__init__()
        s, d_in, H = ssm_dims(cfg)
        d = cfg.d_model
        conv_dim = d_in + 2 * s.d_state
        kw = dict(device=device, generator=generator)
        self.cfg = cfg
        P = nn.Parameter
        self.z_proj = P(dense_init(d, d_in, **kw))
        self.x_proj = P(dense_init(d, d_in, **kw))
        self.bc_proj = P(dense_init(d, 2 * s.d_state, **kw))
        self.dt_proj = P(dense_init(d, H, **kw))
        self.conv_w = P(torch.randn((s.conv_kernel, conv_dim), **kw)
                        / s.conv_kernel)
        self.conv_b = P(torch.zeros(conv_dim, device=device))
        self.A_log = P(torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                              device=device)))
        self.D = P(torch.ones(H, device=device))
        self.dt_bias = P(torch.zeros(H, device=device))
        self.norm = P(torch.zeros(d_in, device=device))
        self.out_proj = P(dense_init(d_in, d, **kw))

    def _split(self, u):
        """u (B,S,D) -> z (B,S,d_in), xBC (B,S,conv_dim), dt (B,S,H)."""
        z = dot(u, self.z_proj)
        xBC = torch.cat([dot(u, self.x_proj), dot(u, self.bc_proj)], dim=-1)
        return z, xBC, dot(u, self.dt_proj)

    def _conv_act(self, xBC_conv, dtype):
        return F.silu(xBC_conv.float() + self.conv_b.float()).to(dtype)

    def _post(self, y, z):
        y = y * F.silu(z.float()).to(y.dtype)
        return dot(rms_norm(y, self.norm, self.cfg.rms_eps), self.out_proj)

    def ssm_full(self, u: torch.Tensor, init_state=None,
                 return_cache: bool = False, ssd_impl: str = "kernel"):
        """Train / prefill path.  u (B,S,D) -> (B,S,D) [, cache].
        ``ssd_impl`` is ``dispatch.ssd``'s route: ``"reference"`` where
        autograd records through the scan."""
        s, d_in, H = ssm_dims(self.cfg)
        B, S, _ = u.shape
        z, xBC, dt = self._split(u)
        xBC_c = self._conv_act(causal_conv1d(xBC, self.conv_w), u.dtype)
        x, B_, C_ = xBC_c.split([d_in, s.d_state, s.d_state], dim=-1)
        x = x.reshape(B, S, H, s.head_dim)
        dt = F.softplus(dt.float() + self.dt_bias)                # (B,S,H)
        A = -torch.exp(self.A_log)                                # (H,)
        y, final = dispatch.ssd(x * dt[..., None].to(x.dtype), dt * A, B_,
                                C_, s.chunk, init_state, impl=ssd_impl)
        y = y + x * cast(self.D, x.dtype)[None, None, :, None]
        out = self._post(y.reshape(B, S, d_in), z)
        if not return_cache:
            return out
        K = s.conv_kernel
        conv_tail = (xBC[:, S - (K - 1):] if S >= K - 1
                     else F.pad(xBC, (0, 0, K - 1 - S, 0)))
        return out, {"conv": conv_tail, "state": final}

    def ssm_cache_init(self, batch: int, dtype) -> Cache:
        s, d_in, H = ssm_dims(self.cfg)
        dev = self.conv_w.device
        return {"conv": torch.zeros((batch, s.conv_kernel - 1,
                                     d_in + 2 * s.d_state), dtype=dtype,
                                    device=dev),
                "state": torch.zeros((batch, H, s.head_dim, s.d_state),
                                     dtype=torch.float32, device=dev)}

    def ssm_decode(self, u: torch.Tensor, cache: Cache,
                   out: Optional[Cache] = None):
        """One-step recurrence (plain torch; no kernel counterpart).
        u (B,1,D) -> ((B,1,D), cache).  The new cache is written into
        ``out``'s tensors when given (the LM's stacked cache slots), else
        into new ones; ``cache`` is only read."""
        s, d_in, H = ssm_dims(self.cfg)
        B = u.shape[0]
        z, xBC, dt = self._split(u)
        window = torch.cat([cache["conv"], xBC], dim=1)           # (B,K,conv)
        xBC_c = self._conv_act(conv_step(window, self.conv_w), u.dtype)
        x, B_, C_ = xBC_c.split([d_in, s.d_state, s.d_state], dim=-1)
        x = x.reshape(B, H, s.head_dim)
        dt1 = F.softplus(dt[:, 0].float() + self.dt_bias)         # (B,H)
        dA = torch.exp(dt1 * -torch.exp(self.A_log))
        xf = x.float() * dt1[..., None]
        state = (torch.empty_like(cache["state"]) if out is None
                 else out["state"])
        torch.mul(cache["state"], dA[..., None, None], out=state)
        state.add_(xf[..., None] * B_.float()[:, None, None, :])
        y = torch.einsum("bhpn,bn->bhp", state, C_.float()).to(u.dtype)
        y = y + x * cast(self.D, x.dtype)[None, :, None]
        res = self._post(y.reshape(B, 1, d_in), z)
        conv = window[:, 1:]
        if out is not None:
            conv = out["conv"].copy_(conv)
        return res, {"conv": conv, "state": state}
