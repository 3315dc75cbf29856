"""The numerics of the two tensor-core kernels that keep f32 accuracy,
emulated in plain torch on the CPU.

``csrc/flash_attention.cu`` (the f32 route) and ``csrc/ssd_scan.cu`` run
their products as 3xTF32 on Hopper's tensor cores: each f32 operand is
split as ``a = hi + lo`` with ``hi = cvt.rna.tf32.f32(a)`` and ``lo`` the
exact f32 remainder ``a - hi`` (rounded to TF32 again when it is handed to
the tensor core), and ``hi*hi + hi*lo + lo*hi`` is summed in f32.  For the
SSD tile with bf16 inputs, B, C and x are TF32 values already: C·Bᵀ takes
one pass, and the two products with an f32 left operand (S_h·x_h and
(x_h·decay_h)ᵀ·B) take two, ``hi*b + lo*b``.

Here ``tf32_rna`` rounds as ``cvt.rna.tf32.f32`` does, with integer
operations on the f32 bits, and the designs are run at the main path's
shapes against the plain versions the kernels are held to on the card, at
``chip_smoke.py``'s tolerances.  Plain 1xTF32 (``hi*hi`` only) must fail
those tolerances, so the tests tell a design that drops the lo terms.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd_scan.ref import cumsum_f32, ssd_intra_chunk_ref

TF32_DROPPED_BITS = 13          # f32 keeps 23 mantissa bits, TF32 10


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports only the standard library
    at the top)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOL = _chip_smoke().TOL


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round an f32 tensor to TF32's 10 mantissa
    bits, to nearest with ties away from zero, on the bits: add half of the
    dropped field to the magnitude and clear the field.  A carry moves into
    the exponent, as the rounding's does (past 2^128 it reaches inf)."""
    bits = x.float().contiguous().view(torch.int32)
    sign = bits & torch.tensor(-2 ** 31, dtype=torch.int32)
    mag = bits & 0x7FFFFFFF
    half, keep = 1 << (TF32_DROPPED_BITS - 1), ~((1 << TF32_DROPPED_BITS) - 1)
    rounded = ((mag.long() + half) & keep).to(torch.int32)
    return (sign | rounded).view(torch.float32)


def split(a: torch.Tensor):
    """``(hi, lo)`` as the kernels make them: hi = tf32(a), lo = tf32(a - hi)
    (``a - hi`` is exact in f32)."""
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


def mm_3x(a, b):
    """f32 A @ B as 3xTF32: lo*hi + hi*lo + hi*hi, summed in f32."""
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_2x(a, b):
    """f32 A @ B with B already TF32 (bf16 values): lo*b + hi*b."""
    ah, al = split(a)
    return al @ b + ah @ b


def mm_1x(a, b):
    """Plain TF32: each operand rounded once."""
    return tf32_rna(a) @ tf32_rna(b)


def _within(got, want, tol):
    """``chip_smoke._check``'s criterion: |got - want| <= tol (1 + |want|)
    everywhere; returns the worst ratio of the two sides."""
    return ((got - want).abs() / (tol * (1 + want.abs()))).max().item()


# ---------------------------------------------------------------- the split

def _split_inputs():
    rng = np.random.default_rng(15)
    random = (rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096))
    p2 = 2.0 ** np.arange(-126, 128, 7, dtype=np.float64)
    f32 = np.float32
    eps = np.finfo(f32).eps
    near_p2 = np.concatenate([p2 * (1 + k * eps) for k in (-3, -1, 1, 3)]
                             + [p2 * (1 - eps / 2)])
    # 1 + (2^11 + 1) ulp: the remainder has 12 significant bits, more than
    # TF32's 11, so tf32(lo) is inexact there (the 3xTF32 error)
    tricky = np.array([1 + 2049 * eps, -(1 + 2049 * eps), 1 + 4095 * eps,
                       1 + 0.5 ** 11, 1 + 0.5 ** 11 + eps])
    tiny = np.finfo(f32).tiny
    limits = np.array([tiny, -tiny, tiny * (1 + eps), tiny / 2, tiny / 3,
                       np.finfo(f32).smallest_subnormal, 0.0, -0.0,
                       2.0 ** 127 * (2 - 2.0 ** -10),   # TF32 max
                       2.0 ** 127 * (2 - 2.0 ** -10 + 2.0 ** -12),
                       -2.0 ** 127 * 1.5, 2.0 ** 127])
    return {"random": random, "near_powers_of_two": near_p2,
            "twelve_bit_remainders": tricky, "f32_limits": limits}


@pytest.mark.parametrize("kind", sorted(_split_inputs()))
def test_split_is_exact_in_f32(kind):
    """hi is a TF32 value within half a TF32 ulp of a; a - hi is exact in
    f32, so hi + (a - hi) == a bit for bit; tf32(a - hi), the lo the
    tensor core reads, is within half a TF32 ulp of the remainder."""
    a = torch.from_numpy(_split_inputs()[kind].astype(np.float32))
    a = a[torch.isfinite(a)]
    hi = tf32_rna(a)
    rem = a - hi
    assert torch.isfinite(hi).all()
    assert torch.equal(hi + rem, a)
    assert torch.equal(rem.double(), a.double() - hi.double())
    low = (1 << TF32_DROPPED_BITS) - 1
    for t in (hi, tf32_rna(rem)):
        assert not (t.view(torch.int32) & low).any()
    # TF32's ulp at a; below 2^-126 its grid is fixed at 2^-136
    ulp = torch.clamp_min(torch.ldexp(torch.ones_like(a.double()),
                                      torch.frexp(a.double()).exponent - 11),
                          2.0 ** -136)
    assert (rem.double().abs() <= ulp / 2).all()
    lo = tf32_rna(rem).double()
    floor = 2.0 ** -137
    assert ((lo - rem.double()).abs()
            <= torch.clamp_min(2.0 ** -11 * rem.double().abs(), floor)).all()
    # hi + lo misses a by at most 2^-22 of |a|: the lo*lo-sized term
    assert ((hi.double() + lo - a.double()).abs()
            <= torch.clamp_min(2.0 ** -22 * a.double().abs(), floor)).all()


def test_rna_rounds_ties_away_and_overflows_to_inf():
    """A tie rounds away from zero (not to even), and the largest f32
    values round to inf, as IEEE rounding past TF32's largest value does:
    the kernels never see such inputs."""
    eps = np.finfo(np.float32).eps
    a = torch.tensor([1 + 2 ** 12 * eps, -(1 + 2 ** 12 * eps),
                      1 + 3 * 2 ** 12 * eps, np.finfo(np.float32).max],
                     dtype=torch.float32)
    got = tf32_rna(a).tolist()
    assert got[:3] == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1 + 2.0 ** -9]
    assert got[3] == math.inf


# -------------------------------------------------- the f32 flash route

def _flash_3x(q, k, v, scale, causal, mm, block=32):
    """The kernel's f32 flash route: S = Q Kᵀ, the online softmax over
    32-key tiles, P split again before P V, O / l at the end."""
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    Sq, Sk = qf.shape[2], kf.shape[2]
    m = torch.full(qf.shape[:3] + (1,), -math.inf)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qf)
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, block):
        kt, vt = kf[:, :, k0:k0 + block], vf[:, :, k0:k0 + block]
        s = mm(qf, kt.transpose(-1, -2)) * scale
        cols = torch.arange(k0, k0 + kt.shape[2])[None, :]
        if causal:
            s = s.masked_fill(cols > rows, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp(m - m_use)
        p = torch.exp(s - m_use)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + mm(p, vt)
        m = m_new
    o = torch.where(l > 0, o / l, 0.0)
    return o.permute(0, 2, 1, 3)


@pytest.mark.parametrize("design", ["3xtf32", "1xtf32"])
def test_text_tower_attention(design):
    """The text tower's causal 8 x 77 x 77, 4 heads of 192, in f32:
    3xTF32 (P split included) holds the f32 flash tolerance, 1xTF32 does
    not."""
    rng = np.random.default_rng(77)
    q, k, v = (torch.from_numpy(rng.standard_normal((8, 77, 4, 192))
                                .astype(np.float32)) for _ in range(3))
    scale = 1.0 / math.sqrt(192)
    want = attention_ref(q, k, v, causal=True, scale=scale)
    mm = {"3xtf32": mm_3x, "1xtf32": mm_1x}[design]
    got = _flash_3x(q, k, v, scale, True, mm)
    worst = _within(got, want, TOL[("flash_attention", "float32")])
    assert (worst <= 1.0) == (design == "3xtf32"), worst


# ------------------------------------------------------------ the SSD tile

def _ssd_tiles(dtype, heads=(0, 11, 47), Q=128, P=64, N=128, H=48):
    """One (b, c) chunk at mamba2-780m width built as chip_smoke's
    ``_ssd_inputs`` builds them (x * dt, dA = dt * A with A = -(1..48)),
    for a few heads: dA (G, Q) f32, x (G, Q, P), B, C (Q, N) in dtype."""
    rng = np.random.default_rng(128)
    dt = np.log1p(np.exp(rng.standard_normal((Q, H)))).astype(np.float32)
    A = -np.arange(1, H + 1, dtype=np.float32)
    x = rng.standard_normal((Q, H, P)).astype(np.float32) * dt[..., None]
    B, C = (rng.standard_normal((Q, N)).astype(np.float32) for _ in range(2))
    idx = list(heads)
    dA = torch.from_numpy((dt * A)[:, idx].T.copy())
    x = torch.from_numpy(x[:, idx].transpose(1, 0, 2).copy()).to(dtype)
    B, C = (torch.from_numpy(t).to(dtype) for t in (B, C))
    return dA, x, B, C


def _ssd_design(dA, x, B, C, passes):
    """The kernel's tile: C·Bᵀ once for every head, then per head S_h =
    (C·Bᵀ) ∘ L_h with the upper triangle selected, y_h = S_h x_h and
    state_h = (x_h · decay_h)ᵀ B.  ``passes`` names the products' design:
    "3x" (f32 inputs), "bf16" (one pass for C·Bᵀ, two for the others) or
    "1x" (plain TF32)."""
    x, B, C = x.float(), B.float(), C.float()
    if passes == "3x":
        cb, mm = mm_3x(C, B.T), mm_3x
    elif passes == "bf16":
        cb, mm = C @ B.T, mm_2x        # bf16 x bf16 is exact in f32
    else:
        cb, mm = mm_1x(C, B.T), mm_1x
    cum = cumsum_f32(dA)
    Q = dA.shape[-1]
    tril = torch.ones((Q, Q), dtype=torch.bool).tril()
    ys, states = [], []
    for g in range(dA.shape[0]):
        seg = cum[g][:, None] - cum[g][None, :]
        S = torch.where(tril, cb * torch.exp(seg), 0.0)
        ys.append(mm(S, x[g]))
        decay = torch.exp(cum[g, -1:] - cum[g])
        states.append(mm((x[g] * decay[:, None]).T, B))
    return torch.stack(ys), torch.stack(states)


@pytest.mark.parametrize("dtype,design", [
    ("float32", "3x"), ("bfloat16", "bf16"),
    ("float32", "1x"), ("bfloat16", "1x")])
def test_ssd_tile_designs(dtype, design):
    """At mamba2-780m width (Q = N = 128, P = 64), 3xTF32 on f32 inputs and
    the one-pass / two-pass design on bf16 inputs hold the SSD tiles'
    tolerance against ``ssd_intra_chunk_ref``; 1xTF32 does not."""
    dA, x, B, C = _ssd_tiles(getattr(torch, dtype))
    G = dA.shape[0]
    want = ssd_intra_chunk_ref(dA, x, B.expand(G, -1, -1),
                               C.expand(G, -1, -1))
    got = _ssd_design(dA, x, B, C, design)
    tol = TOL[("ssd_scan", dtype)]
    worst = max(_within(g, w, tol) for g, w in zip(got, want))
    assert (worst <= 1.0) == (design != "1x"), worst
