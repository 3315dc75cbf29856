"""The port's GQA serving functions (``models/attention.py``: the KV cache's
prefill and decode, the ring layout, cross-attention) and the layer helpers
they bring (``causal_mask(q_offset=)``, ``layer_norm``, ``apply_rope`` at a
0-dim position) held against the JAX package on the CPU, with the same
weights and inputs (numpy, from a seed).

Tolerances: f32 1e-5 (both frameworks compute the same f32 products in
another order; observed errors ~1e-6), bf16 3e-2 (the JAX arch tests'
bar).  The port's ``"kernel"`` route on a CPU tensor runs the kernel's plain
version, held against JAX's ``"pallas"`` route in interpret mode within
1e-4 (``tests/test_kernel_dispatch.py``'s bar for ``gqa_prefill``).
Cache shapes, dtypes and the rows written must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import replace as jax_replace
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro_torch.config import get_config, replace
from repro_torch.models import attention, layers

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# MHA with QKV bias, GQA with qk_norm (h8/2), MQA (h4/1)
ARCHS = ("qwen1.5-32b", "qwen3-32b", "granite-20b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, dtype="float32", impl=None):
    """(JAX cfg, port cfg, JAX params, port ParameterDict): init_gqa's
    weights with the zero-initialised biases and norms given seeded values,
    so every term is live."""
    jcfg = jax_replace(jax_get_config(arch, smoke=True), dtype=dtype)
    cfg = replace(get_config(arch, smoke=True), dtype=dtype)
    if impl is not None:
        jcfg = jax_replace(jcfg, attn_impl=impl[0])
        cfg = replace(cfg, attn_impl=impl[1])
    rng = np.random.default_rng(7)
    jp = {k: np.asarray(v) for k, v in
          jax_attn.init_gqa(jax.random.PRNGKey(3), jcfg).items()}
    jp = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
          if not v.any() else v for k, v in jp.items()}
    p = attention.init_gqa(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for k, v in jp.items():
            p[k].copy_(torch.from_numpy(v))
    p.requires_grad_(False)          # serving: the kernels have no backward
    return jcfg, cfg, {k: jnp.asarray(v) for k, v in jp.items()}, p


def _x(shape, seed, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x, jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(got, want, dtype="float32", tol=None):
    tol = TOL[dtype] if tol is None else tol
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def _cache_close(got, want, dtype="float32", tol=None):
    assert sorted(got) == sorted(want) == ["k", "v"]
    for name in ("k", "v"):
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)
        _close(got[name], want[name], dtype, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_prefill_matches_jax(arch, dtype):
    jcfg, cfg, jp, p = _pair(arch, dtype)
    jx, x = _x((2, 11, cfg.d_model), 1, dtype)
    out, cache = attention.gqa_prefill(p, cfg, x, max_len=16)
    jout, jcache = jax_attn.gqa_prefill(jp, jcfg, jx, max_len=16)
    _close(out, jout, dtype)
    _cache_close(cache, jcache, dtype)
    assert not cache["k"][:, 11:].any()          # rows past the prompt


@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_prefill_ring_layout_matches_jax(arch):
    """window == max_len < S: the last ``window`` rows at slot = position %
    window, attention within the window."""
    jcfg, cfg, jp, p = _pair(arch)
    jx, x = _x((2, 20, cfg.d_model), 2)
    out, cache = attention.gqa_prefill(p, cfg, x, max_len=8, window=8)
    jout, jcache = jax_attn.gqa_prefill(jp, jcfg, jx, max_len=8, window=8)
    _close(out, jout)
    _cache_close(cache, jcache)
    # slot 20 % 8 = 4 holds position 12's key (the oldest in the window)
    _, full = attention.gqa_prefill(p, cfg, x, max_len=20)
    torch.testing.assert_close(cache["k"][:, 4], full["k"][:, 12], rtol=0,
                               atol=0)


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_decode_matches_jax(arch, ring):
    """Three decode steps from a prefilled cache, the position an int and
    a 0-dim tensor; on the ring they wrap around the 8-row cache."""
    jcfg, cfg, jp, p = _pair(arch)
    S, L = (10, 8) if ring else (10, 16)
    jx, x = _x((2, S, cfg.d_model), 3)
    _, cache = attention.gqa_prefill(p, cfg, x, max_len=L,
                                     window=L if ring else 0)
    _, jcache = jax_attn.gqa_prefill(jp, jcfg, jx, max_len=L,
                                     window=L if ring else 0)
    for i, pos in enumerate((S, torch.tensor(S + 1), S + 2)):
        jt, t = _x((2, 1, cfg.d_model), 10 + i)
        before = {k: v.clone() for k, v in cache.items()}
        out, new = attention.gqa_decode(p, cfg, t, cache, pos, ring=ring)
        jout, jcache = jax_attn.gqa_decode(jp, jcfg, jt, jcache,
                                           jnp.int32(int(pos)), ring=ring)
        _close(out, jout)
        _cache_close(new, jcache)
        for k in cache:                          # functional, as in JAX
            assert torch.equal(cache[k], before[k])
        cache = new


def test_gqa_decode_in_place_equals_functional():
    """``out=cache`` writes only the row, into the cache's own memory, and
    gives the functional step's values bitwise; a position past the cache
    writes the last row, as JAX's clamped ``dynamic_update_slice``."""
    jcfg, cfg, jp, p = _pair("qwen3-32b")
    jx, x = _x((2, 6, cfg.d_model), 4)
    _, cache = attention.gqa_prefill(p, cfg, x, max_len=8)
    _, jcache = jax_attn.gqa_prefill(jp, jcfg, jx, max_len=8)
    for i, pos in enumerate((6, 7, 9)):
        jt, t = _x((2, 1, cfg.d_model), 20 + i)
        want, wc = attention.gqa_decode(p, cfg, t, cache, pos)
        ptr = cache["k"].data_ptr()
        got, gc = attention.gqa_decode(p, cfg, t, cache, torch.tensor(pos),
                                       out=cache)
        assert gc["k"] is cache["k"] and cache["k"].data_ptr() == ptr
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        for k in ("k", "v"):
            torch.testing.assert_close(gc[k], wc[k], rtol=0, atol=0)
        jout, jcache = jax_attn.gqa_decode(jp, jcfg, jt, jcache,
                                           jnp.int32(pos))
        _close(got, jout)
        _cache_close(gc, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_cross_cache_and_decode_match_jax(arch):
    jcfg, cfg, jp, p = _pair(arch)
    jm, m = _x((2, 13, cfg.d_model), 5)
    kv = attention.gqa_cross_cache(p, cfg, m)
    jkv = jax_attn.gqa_cross_cache(jp, jcfg, jm)
    _cache_close(kv, jkv)
    jx, x = _x((2, 3, cfg.d_model), 6)
    _close(attention.gqa_cross_decode(p, cfg, x, kv),
           jax_attn.gqa_cross_decode(jp, jcfg, jx, jkv))


@pytest.mark.parametrize("window", [0, 8])
def test_kernel_route_matches_jax_pallas_interpret(window):
    """``attn_impl="kernel"`` on a CPU tensor (the kernel's plain version)
    against JAX's ``"pallas"`` (the Pallas kernel in interpret mode) through
    ``gqa_prefill``, GQA h8/2 with qk_norm."""
    jcfg, cfg, jp, p = _pair("qwen3-32b", impl=("pallas", "kernel"))
    jx, x = _x((2, 24, cfg.d_model), 7)
    L = window or 32
    out, cache = attention.gqa_prefill(p, cfg, x, max_len=L, window=window)
    jout, jcache = jax_attn.gqa_prefill(jp, jcfg, jx, max_len=L,
                                        window=window)
    _close(out, jout, tol=1e-4)
    _cache_close(cache, jcache)


@pytest.mark.parametrize("q_offset,window", [(0, 0), (5, 0), (3, 4),
                                             (0, 2)])
def test_causal_mask_matches_jax(q_offset, window):
    got = layers.causal_mask(6, 11, q_offset=q_offset, window=window)
    want = jax_layers.causal_mask(6, 11, q_offset=q_offset, window=window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(8)
    x = (3 * rng.standard_normal((2, 5, 64)) + 1).astype(np.float32)
    s, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    for dtype in ("float32", "bfloat16"):
        got = layers.layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                                torch.from_numpy(s), torch.from_numpy(b))
        want = jax_layers.layer_norm(jnp.asarray(x, jnp.dtype(dtype)),
                                     jnp.asarray(s), jnp.asarray(b))
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        _close(got, want, dtype)


def test_apply_rope_at_one_position_matches_jax():
    """A decode step's position as a 0-dim tensor and as a 1-element one,
    against JAX's ``pos[None]``."""
    x = np.random.default_rng(9).standard_normal((2, 1, 4, 32)
                                                 ).astype(np.float32)
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.int32(37)[None], 1e6)
    for pos in (torch.tensor(37), torch.tensor([37])):
        _close(layers.apply_rope(torch.from_numpy(x), pos, 1e6), want)
