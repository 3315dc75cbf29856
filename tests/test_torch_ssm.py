"""The port's Mamba2 SSD scan and mixer held against the JAX package on the
CPU, on the same seeded numpy inputs.

* ``ssd_intra_chunk_ref`` (the CUDA kernel's plain twin) against the
  Pallas ``ssd_intra_chunk`` in interpret mode, at the shapes of
  ``tests/test_kernel_ssd.py``;
* the port's ``ssd_chunked_kernel`` (on a CPU tensor: the wrapper with the
  plain tile in the kernel's place) against JAX ``ssd_chunked_kernel`` and
  ``models.ssm.ssd_chunked``, with a ragged tail, an initial state and a
  split sequence;
* ``Mamba2Mixer`` against ``ssm_full`` / ``ssm_decode`` at ``mamba2-smoke``.

Tolerances are the JAX kernel sweep's: 1e-4 in f32 (the frameworks sum in
other orders), 6e-2 in bf16 (inputs rounded to 8 bits of mantissa).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import replace as jax_replace
from repro.kernels.ssd_scan.ops import ssd_chunked_kernel as jax_ssd_kernel
from repro.kernels.ssd_scan.ssd_scan import ssd_intra_chunk
from repro.models import ssm as jax_ssm
from repro_torch.config import get_config, replace
from repro_torch.kernels.ssd_scan.ops import ssd_chunked_kernel
from repro_torch.kernels.ssd_scan.ops import \
    ssd_intra_chunk as port_intra_chunk
from repro_torch.kernels.ssd_scan.ref import (cumsum_f32, ssd_chunked_ref,
                                              ssd_intra_chunk_ref,
                                              ssd_tiles_ref)
from repro_torch.models.ssm import Mamba2Mixer
from repro_torch.weights import load_numpy

TOL = {"float32": 1e-4, "bfloat16": 6e-2}
SHAPES = [(1, 16, 2, 8, 16, 8), (2, 32, 3, 16, 8, 16),
          (1, 64, 2, 32, 32, 32)]          # (b, l, h, p, n, chunk)


def _data(seed, b, l, h, p, n):
    """x, dA = -softplus(noise), B, C as f32 numpy (test_kernel_ssd's)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dA = -np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    B = rng.standard_normal((b, l, n)).astype(np.float32)
    C = rng.standard_normal((b, l, n)).astype(np.float32)
    return x, dA, B, C


def _cast(arrays, dtype):
    """The same values for both frameworks: rounded to ``dtype`` once."""
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    j = [jnp.asarray(a.float().numpy()).astype(dtype) for a in t]
    return t, j


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_intra_chunk_ref_matches_pallas(shape, dtype):
    b, l, h, p, n, chunk = shape
    G, Q = b * h * (l // chunk), chunk
    rng = np.random.default_rng(G * 10 + Q)
    dA = -np.log1p(np.exp(rng.standard_normal((G, Q)))).astype(np.float32)
    x = rng.standard_normal((G, Q, p)).astype(np.float32)
    B = rng.standard_normal((G, Q, n)).astype(np.float32)
    C = rng.standard_normal((G, Q, n)).astype(np.float32)
    (tx, tB, tC), (jx, jB, jC) = _cast((x, B, C), dtype)
    y, s = ssd_intra_chunk_ref(torch.from_numpy(dA), tx, tB, tC)
    jy, js = ssd_intra_chunk(jnp.asarray(dA), jx, jB, jC, interpret=True)
    assert y.dtype == s.dtype == torch.float32
    _close(y, jy, TOL[dtype])
    _close(s, js, TOL[dtype])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_kernel_matches_jax(shape, dtype):
    """Against both JAX functions: the Pallas wrapper and the model's
    ``ssd_chunked``."""
    b, l, h, p, n, chunk = shape
    x, dA, B, C = _data(b * 100 + l, b, l, h, p, n)
    (tx, tB, tC), (jx, jB, jC) = _cast((x, B, C), dtype)
    y, s = ssd_chunked_kernel(tx, torch.from_numpy(dA), tB, tC, chunk)
    assert y.dtype == tx.dtype and s.dtype == torch.float32
    for jfn in (lambda *a: jax_ssd_kernel(*a, interpret=True),
                jax_ssm.ssd_chunked):
        jy, js = jfn(jx, jnp.asarray(dA), jB, jC, chunk)
        _close(y.float(), jy, TOL[dtype])
        _close(s, js, TOL[dtype])


@pytest.mark.parametrize("fn", [ssd_chunked_kernel, ssd_chunked_ref])
@pytest.mark.parametrize("case", ["ragged", "init_state"])
def test_ssd_chunked_contract_matches_jax(fn, case):
    """The parts of ``ssd_chunked``'s contract the JAX kernel wrapper does
    not take: a ragged tail (l % chunk != 0) and an initial state."""
    b, l, h, p, n, chunk = (2, 27, 3, 8, 16, 8)
    x, dA, B, C = _data(5, b, l, h, p, n)
    init = (np.random.default_rng(6).standard_normal((b, h, p, n))
            .astype(np.float32) if case == "init_state" else None)
    y, s = fn(*map(torch.from_numpy, (x, dA, B, C)), chunk,
              None if init is None else torch.from_numpy(init))
    jy, js = jax_ssm.ssd_chunked(*map(jnp.asarray, (x, dA, B, C)), chunk,
                                 None if init is None else jnp.asarray(init))
    assert y.shape == (b, l, h, p)
    _close(y, jy, TOL["float32"])
    _close(s, js, TOL["float32"])


@pytest.mark.parametrize("shape", SHAPES)
def test_cb_once_per_chunk_gives_the_per_head_tiles(shape):
    """The kernel computes C·Bᵀ once per (b, c) and applies each head's
    decay mask L_h to it (B and C are shared by the heads); that gives the
    same f32 tiles as ``ssd_tiles_ref``, which broadcasts B and C over the
    heads and forms C·Bᵀ per head."""
    b, l, h, p, n, chunk = shape
    x, dA, B, C = (torch.from_numpy(a) for a in _data(b + l + h, b, l, h,
                                                      p, n))
    y_want, st_want = ssd_tiles_ref(x, dA, B, C, chunk)
    c, Q = l // chunk, chunk
    cum = cumsum_f32(dA.reshape(b, c, Q, h).permute(0, 1, 3, 2))
    cb = (C.reshape(b, c, Q, n) @ B.reshape(b, c, Q, n).transpose(-1, -2))
    seg = cum[..., :, None] - cum[..., None, :]               # (b,c,h,Q,Q)
    tril = torch.ones((Q, Q), dtype=torch.bool).tril()
    S = torch.where(tril, cb[:, :, None] * torch.exp(seg), 0.0)
    xs = x.reshape(b, c, Q, h, p).permute(0, 1, 3, 2, 4)      # (b,c,h,Q,p)
    y = (S @ xs).permute(0, 1, 3, 2, 4).reshape(b, l, h, p)
    decay = torch.exp(cum[..., -1:] - cum)                    # (b,c,h,Q)
    st = (xs * decay[..., None]).transpose(-1, -2) @ \
        B.reshape(b, c, 1, Q, n)
    _close(y, y_want, 1e-6)
    _close(st, st_want, 1e-6)


def test_ssd_chunked_kernel_state_continuity():
    """The final state of the first part, fed as the second part's initial
    state, continues the sequence: equal y and state to one pass (and to
    another chunking)."""
    x, dA, B, C = (torch.from_numpy(a) for a in _data(7, 1, 40, 2, 8, 16))
    y_full, s_full = ssd_chunked_kernel(x, dA, B, C, 16)
    y1, s1 = ssd_chunked_kernel(x[:, :19], dA[:, :19], B[:, :19], C[:, :19],
                                16)
    y2, s2 = ssd_chunked_kernel(x[:, 19:], dA[:, 19:], B[:, 19:], C[:, 19:],
                                16, init_state=s1)
    _close(torch.cat([y1, y2], dim=1), y_full, 1e-4)
    _close(s2, s_full, 1e-4)
    _, s8 = ssd_chunked_kernel(x, dA, B, C, 8)
    _close(s8, s_full, 1e-4)


@pytest.mark.parametrize("bad", ["ragged", "B", "dA"])
def test_ssd_intra_chunk_rejects_mismatched_inputs(bad):
    """The kernel's wrapper checks shapes before any pointer is passed (on
    every device: the CPU route runs the same checks)."""
    x, dA, B, C = (torch.from_numpy(a) for a in _data(9, 1, 16, 2, 8, 16))
    if bad == "ragged":
        x, dA, B, C = x[:, :15], dA[:, :15], B[:, :15], C[:, :15]
    elif bad == "B":
        B = B[:, :, :8]
    else:
        dA = dA[:, :, :1]
    with pytest.raises(ValueError):
        port_intra_chunk(x, dA, B, C, 8)


def _mixer_pair(dtype="float32"):
    """JAX ``init_ssm`` params at mamba2-smoke (the zero-initialised conv
    bias, dt bias and norm given seeded values so every term is live) and
    the port's mixer holding the same numbers."""
    jcfg = jax_replace(jax_get_config("mamba2-780m", smoke=True), dtype=dtype)
    cfg = replace(get_config("mamba2-780m", smoke=True), dtype=dtype)
    rng = np.random.default_rng(3)
    params = {k: np.asarray(v) for k, v in
              jax_ssm.init_ssm(jax.random.PRNGKey(0), jcfg).items()}
    for k in ("conv_b", "dt_bias", "norm"):
        params[k] = (0.1 * rng.standard_normal(params[k].shape)
                     ).astype(np.float32)
    mixer = Mamba2Mixer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    load_numpy(mixer, params)
    return jcfg, {k: jnp.asarray(v) for k, v in params.items()}, mixer


@pytest.fixture(scope="module")
def mixer_f32():
    jcfg, jp, mixer = _mixer_pair()
    u = np.random.default_rng(4).standard_normal(
        (2, 41, jcfg.d_model)).astype(np.float32)     # 41: a ragged tail
    return jcfg, jp, mixer, u


def test_mixer_ssm_full_and_decode_match_jax(mixer_f32):
    jcfg, jp, mixer, u = mixer_f32
    with torch.no_grad():
        out, cache = mixer.ssm_full(torch.from_numpy(u[:, :40]),
                                    return_cache=True)
        out1, cache1 = mixer.ssm_decode(torch.from_numpy(u[:, 40:]), cache)
    jout, jcache = jax_ssm.ssm_full(jp, jcfg, jnp.asarray(u[:, :40]),
                                    return_cache=True)
    jout1, jcache1 = jax_ssm.ssm_decode(jp, jcfg, jnp.asarray(u[:, 40:]),
                                        jcache)
    assert float(np.abs(np.asarray(jout)).mean()) > 1e-2
    for got, want in ((out, jout), (out1, jout1),
                      (cache["conv"], jcache["conv"]),
                      (cache["state"], jcache["state"]),
                      (cache1["conv"], jcache1["conv"]),
                      (cache1["state"], jcache1["state"])):
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want, TOL["float32"])


def test_mixer_prefill_then_decode_equals_longer_prefill(mixer_f32):
    """ssm_full(return_cache) + ssm_decode == ssm_full over the longer
    sequence (tests/test_ssm_properties.py's property, in f32 here)."""
    _, _, mixer, u = mixer_f32
    u = torch.from_numpy(u)
    with torch.no_grad():
        full = mixer.ssm_full(u)
        _, cache = mixer.ssm_full(u[:, :38], return_cache=True)
        outs = []
        for t in (38, 39, 40):
            o, cache = mixer.ssm_decode(u[:, t:t + 1], cache)
            outs.append(o)
    _close(torch.cat(outs, dim=1), full[:, 38:], TOL["float32"])


def test_mixer_short_prompt_cache_matches_jax():
    """A prompt shorter than the conv window pads the conv cache on the
    left (bf16 activations, as the model runs them)."""
    jcfg, jp, mixer = _mixer_pair("bfloat16")
    u = np.random.default_rng(8).standard_normal((1, 2, jcfg.d_model)
                                                 ).astype(np.float32)
    tu = torch.from_numpy(u).bfloat16()
    with torch.no_grad():
        out, cache = mixer.ssm_full(tu, return_cache=True)
    jout, jcache = jax_ssm.ssm_full(jp, jcfg, jnp.asarray(u, jnp.bfloat16),
                                    return_cache=True)
    assert cache["conv"].shape == (1, 3, mixer.conv_w.shape[1])
    assert not cache["conv"][:, 0].any()
    _close(out.float(), jout, TOL["bfloat16"])
    _close(cache["state"], jcache["state"], TOL["bfloat16"])
