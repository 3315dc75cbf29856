"""The served models in plain PyTorch float32: the DiT denoiser, the byte-level
text tower and the small VAE decoder, written from their equations.

Nothing here imports the program.  Weights are a flat ``{name: tensor}``
dict whose names and shapes :func:`dit_shapes`, :func:`text_shapes` and
:func:`vae_shapes` define; the benchmark draws them from the seed
(``perfbench.weights``) and loads the same tensors into the program.

Every matrix product goes through ``mm`` (default: the float32 product),
and every convolution of the decoder through ``conv``, so the control of
``perfbench.control`` can put a lower precision in their place.
Call :func:`no_tf32` before running on a GPU: a float32 product there may
otherwise run in TF32.

The DiT departs from the published DiT (Peebles and Xie, 2212.09748) where
the served model does, and follows the served model:

* text conditioning by cross-attention to the tower's token features
  (PixArt-style), after a pre-norm scaled by ``1 + lnx``, with no gate;
* RMS norm with a ``1 + scale`` gain on queries and keys (qk-norm);
* rotary position embedding over the flattened token index on
  self-attention, on top of the learned position table;
* adaLN modulation from the timestep embedding alone (no class label);
* GELU in its tanh form.
"""
from __future__ import annotations

import math
from typing import Callable, List, Mapping, Tuple

import torch
import torch.nn.functional as F

Params = Mapping[str, torch.Tensor]
Mm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
Conv = Callable[..., torch.Tensor]       # F.conv2d's signature
TDIM = 256                       # sinusoidal timestep features
VAE_CHANNELS = (32, 64, 128)
BOS, PAD = 256, 257              # byte tokenizer: BOS, then EOS and padding


def f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def no_tf32() -> None:
    """Keep float32 products and convolutions in float32 on a GPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- parameter layouts: (name, shape, init std) ------------------------------
# the std of a weight drawn from the seed: a dense (d_in, d_out) matrix
# 1/sqrt(d_in); the adaLN projections, norms, gains and tables 0.02 (the
# program starts the adaLN and norm parameters at zero, which would switch
# whole branches off: a benchmark gives them seeded values)

def _attn_shapes(pre: str, d: int, heads: int, hd: int,
                 qk_norm: bool) -> List[Tuple[str, Tuple[int, ...], float]]:
    out = [(f"{pre}.wq", (d, heads * hd), d ** -0.5),
           (f"{pre}.wk", (d, heads * hd), d ** -0.5),
           (f"{pre}.wv", (d, heads * hd), d ** -0.5),
           (f"{pre}.wo", (heads * hd, d), (heads * hd) ** -0.5)]
    if qk_norm:
        out += [(f"{pre}.q_norm", (hd,), 0.02), (f"{pre}.k_norm", (hd,), 0.02)]
    return out


def dit_shapes(m: Mapping) -> List[Tuple[str, Tuple[int, ...], float]]:
    """The DiT's parameters for the configuration's ``model`` dict."""
    d, hd, H = m["d_model"], m["head_dim"] or m["d_model"] // m["n_heads"], \
        m["n_heads"]
    p_in = m["patch"] ** 2 * m["latent_channels"]
    S = (m["latent_size"] // m["patch"]) ** 2
    out = [("patch_in", (p_in, d), p_in ** -0.5), ("pos", (S, d), 0.02),
           ("t_w1", (TDIM, d), TDIM ** -0.5), ("t_w2", (d, d), d ** -0.5),
           ("cond_proj", (m["cond_dim"], d), m["cond_dim"] ** -0.5)]
    for i in range(m["n_layers"]):
        b = f"blocks.{i}"
        out += [(f"{b}.adaln", (d, 6 * d), 0.02),
                (f"{b}.adaln_b", (6 * d,), 0.02)]
        out += _attn_shapes(f"{b}.attn", d, H, hd, m["qk_norm"])
        out += [(f"{b}.lnx", (d,), 0.02)]
        out += _attn_shapes(f"{b}.xattn", d, H, hd, m["qk_norm"])
        out += [(f"{b}.mlp.wi", (d, m["d_ff"]), d ** -0.5),
                (f"{b}.mlp.wo", (m["d_ff"], d), m["d_ff"] ** -0.5)]
    out += [("final_adaln", (d, 2 * d), 0.02),
            ("final_adaln_b", (2 * d,), 0.02),
            ("out", (d, p_in), 0.02 * d ** -0.5)]
    return out


def text_shapes(t: Mapping) -> List[Tuple[str, Tuple[int, ...], float]]:
    d = t["d_model"]
    out = [("embed", (t["vocab"], d), 0.02)]
    for i in range(t["n_layers"]):
        b = f"blocks.{i}"
        out += [(f"{b}.ln1", (d,), 0.02)]
        out += _attn_shapes(f"{b}.attn", d, t["n_heads"], d // t["n_heads"],
                            False)
        out += [(f"{b}.ln2", (d,), 0.02),
                (f"{b}.mlp.wi", (d, t["d_ff"]), d ** -0.5),
                (f"{b}.mlp.wo", (t["d_ff"], d), t["d_ff"] ** -0.5)]
    return out + [("ln_f", (d,), 0.02)]


def vae_shapes(latent_channels: int) -> List[Tuple[str, Tuple[int, ...],
                                                  float]]:
    c = list(reversed(VAE_CHANNELS))          # 128, 64, 32
    out = [("dec.in", (c[0], latent_channels, 1, 1), latent_channels ** -0.5)]
    for i in range(len(c) - 1):
        out.append((f"dec.w{i}", (c[i + 1], c[i], 3, 3), (9 * c[i]) ** -0.5))
    return out + [("dec.out", (3, c[-1], 3, 3), (9 * c[-1]) ** -0.5)]


# -- building blocks ----------------------------------------------------------

def layer_norm(x: torch.Tensor) -> torch.Tensor:
    """Parameter-free LayerNorm, eps 1e-6."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6)


def rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + 1e-6) \
        * (1.0 + scale)


def rope(x: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding over the sequence index; x (B, S, H, hd), the
    feature halves rotated as a pair."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None,
                                                                None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: Params, pre: str, x: torch.Tensor, kv: torch.Tensor,
              heads: int, *, rotary: bool, causal: bool, qk_norm: bool,
              mm: Mm) -> torch.Tensor:
    """Multi-head attention of ``x`` over ``kv`` with materialised scores."""
    B, S, _ = x.shape
    Sk = kv.shape[1]
    q = mm(x, p[f"{pre}.wq"]).reshape(B, S, heads, -1)
    k = mm(kv, p[f"{pre}.wk"]).reshape(B, Sk, heads, -1)
    v = mm(kv, p[f"{pre}.wv"]).reshape(B, Sk, heads, -1)
    if qk_norm:
        q, k = rms_norm(q, p[f"{pre}.q_norm"]), rms_norm(k, p[f"{pre}.k_norm"])
    if rotary:
        q, k = rope(q), rope(k)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))     # (B, H, S, hd)
    s = mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        keep = torch.ones(S, Sk, dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    o = mm(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(B, S, -1)
    return mm(o, p[f"{pre}.wo"])


def gelu_mlp(p: Params, pre: str, x: torch.Tensor, mm: Mm) -> torch.Tensor:
    return mm(F.gelu(mm(x, p[f"{pre}.wi"]), approximate="tanh"),
              p[f"{pre}.wo"])


# -- the DiT -------------------------------------------------------------------

def timestep_features(t: torch.Tensor) -> torch.Tensor:
    half = TDIM // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None]) + shift[:, None]


def dit_forward(p: Params, m: Mapping, z: torch.Tensor, t: torch.Tensor,
                cond: torch.Tensor, mm: Mm = f32_mm) -> torch.Tensor:
    """eps for latents z (B, H, W, C) at integer times t (B,) under text
    features cond (B, Lc, cond_dim)."""
    B, Hh, Ww, C = z.shape
    P, d, heads = m["patch"], m["d_model"], m["n_heads"]
    hp, wp = Hh // P, Ww // P
    x = z.reshape(B, hp, P, wp, P, C).permute(0, 1, 3, 2, 4, 5).reshape(
        B, hp * wp, P * P * C)
    x = mm(x, p["patch_in"]) + p["pos"][None]
    temb = mm(F.silu(mm(timestep_features(t), p["t_w1"])), p["t_w2"])
    c = mm(cond, p["cond_proj"])
    tmod = F.silu(temb)
    qk = m["qk_norm"]
    for i in range(m["n_layers"]):
        b = f"blocks.{i}"
        sh1, sc1, g1, sh2, sc2, g2 = (mm(tmod, p[f"{b}.adaln"])
                                      + p[f"{b}.adaln_b"]).chunk(6, dim=-1)
        h = _modulate(layer_norm(x), sh1, sc1)
        x = x + g1[:, None] * attention(p, f"{b}.attn", h, h, heads,
                                        rotary=True, causal=False,
                                        qk_norm=qk, mm=mm)
        hx = layer_norm(x) * (1.0 + p[f"{b}.lnx"])
        x = x + attention(p, f"{b}.xattn", hx, c, heads, rotary=False,
                          causal=False, qk_norm=qk, mm=mm)
        h = _modulate(layer_norm(x), sh2, sc2)
        x = x + g2[:, None] * gelu_mlp(p, f"{b}.mlp", h, mm)
    shf, scf = (mm(tmod, p["final_adaln"]) + p["final_adaln_b"]).chunk(2, -1)
    out = mm(_modulate(layer_norm(x), shf, scf), p["out"])
    return out.reshape(B, hp, wp, P, P, C).permute(0, 1, 3, 2, 4, 5).reshape(
        B, Hh, Ww, C)


# -- the text tower ------------------------------------------------------------

def tokenize(prompts, length: int, device) -> torch.Tensor:
    """BOS, the prompt's UTF-8 bytes (at most ``length`` - 2), then PAD."""
    out = torch.full((len(prompts), length), PAD, dtype=torch.long)
    for i, s in enumerate(prompts):
        bs = list(s.encode("utf-8"))[:length - 2]
        out[i, 0] = BOS
        out[i, 1:1 + len(bs)] = torch.tensor(bs, dtype=torch.long)
    return out.to(device)


def text_forward(p: Params, t: Mapping, tokens: torch.Tensor,
                 mm: Mm = f32_mm) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, L) -> (token features (B, L, d), pooled (B, d)): a causal
    pre-norm transformer, then the mean over non-pad tokens, L2-normalised."""
    x = p["embed"][tokens]
    for i in range(t["n_layers"]):
        b = f"blocks.{i}"
        h = rms_norm(x, p[f"{b}.ln1"])
        x = x + attention(p, f"{b}.attn", h, h, t["n_heads"], rotary=True,
                          causal=True, qk_norm=False, mm=mm)
        x = x + gelu_mlp(p, f"{b}.mlp", rms_norm(x, p[f"{b}.ln2"]), mm)
    x = rms_norm(x, p["ln_f"])
    keep = (tokens != PAD).float()[..., None]
    pooled = (x * keep).sum(1) / keep.sum(1).clamp_min(1.0)
    return x, pooled / pooled.norm(dim=-1, keepdim=True)


# -- the VAE decoder -------------------------------------------------------------

def vae_decode(p: Params, z: torch.Tensor,
               conv: Conv = F.conv2d) -> torch.Tensor:
    """latents (B, h, w, C) -> images (B, 8h, 8w, 3) in [-1, 1]: a 1x1 conv,
    then nearest 2x upsampling and 3x3 convs, silu between, tanh at the
    end."""
    h = F.silu(conv(z.permute(0, 3, 1, 2), p["dec.in"]))
    for i in range(len(VAE_CHANNELS) - 1):
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        h = F.silu(conv(h, p[f"dec.w{i}"], padding=1))
    h = F.interpolate(h, scale_factor=2, mode="nearest")
    return torch.tanh(conv(h, p["dec.out"], padding=1)).permute(0, 2, 3, 1)

