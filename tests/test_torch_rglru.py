"""The port's RG-LRU block (``models/rglru.py``) held against the JAX
package on the CPU at ``recurrentgemma-smoke`` width, with
``rglru.init_rglru`` weights handed over by name: ``rglru_full`` with and
without a carried state (its output, conv tail and state), the conv tail's
padding branch (S < K - 1), ``rglru_decode`` (functional and in place),
and the scan against the one-step recurrence (the JAX package's
``tests/test_ssm_properties.py`` property, at every length 1..16).

Tolerance in f32: 1e-4 relative and 1e-5 absolute (``tests/
test_torch_lm_dense.py``'s bar: the log-depth scan combines in another
order than ``jax.lax.associative_scan``); the scan against the step at
1e-5 / 1e-6 (one framework, two orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.config import get_config as jax_get_config
from repro.models import rglru as jax_rglru
from repro_torch.config import get_config
from repro_torch.models import rglru

ARCH = "recurrentgemma-2b"
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def block():
    """JAX ``init_rglru`` weights (the zero biases given seeded values)
    and the same weights in the port's ``ParameterDict``."""
    jcfg = jax_get_config(ARCH, smoke=True)
    params = {k: np.asarray(v) for k, v in jax_rglru.init_rglru(
        jax.random.PRNGKey(0), jcfg).items()}
    rng = np.random.default_rng(1)
    for k, v in params.items():
        if not v.any():
            params[k] = (0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
    cfg = get_config(ARCH, smoke=True)
    p = rglru.init_rglru(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    assert sorted(p) == sorted(params)
    with torch.no_grad():
        for k, v in params.items():
            assert tuple(p[k].shape) == v.shape, k
            p[k].copy_(torch.tensor(v))
    return dict(cfg=cfg, jcfg=jcfg, p=p,
                jp={k: jnp.asarray(v) for k, v in params.items()})


def _u(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("S", [1, 2, 7, 33])
@pytest.mark.parametrize("carried", [False, True])
def test_rglru_full_matches_jax(block, S, carried):
    """Output, conv tail (zero-padded in front when S < K - 1) and final
    state, from a zero or a carried state."""
    cfg, p, jp = block["cfg"], block["p"], block["jp"]
    u = _u(cfg, 2, S, seed=S)
    h0 = (np.random.default_rng(9).standard_normal((2, cfg.d_model))
          .astype(np.float32) if carried else None)
    out, cache = rglru.rglru_full(
        p, cfg, torch.tensor(u), init_state=None if h0 is None
        else torch.tensor(h0), return_cache=True)
    jout, jcache = jax_rglru.rglru_full(
        jp, block["jcfg"], jnp.asarray(u), init_state=None if h0 is None
        else jnp.asarray(h0), return_cache=True)
    _close(out, jout)
    assert cache["conv"].dtype == torch.float32
    assert cache["state"].dtype == torch.float32
    _close(cache["conv"], jcache["conv"])
    _close(cache["state"], jcache["state"])
    if S < cfg.rglru.conv_kernel - 1:
        assert not cache["conv"][:, :cfg.rglru.conv_kernel - 1 - S].any()
    with torch.no_grad():
        plain = rglru.rglru_full(p, cfg, torch.tensor(u),
                                 init_state=None if h0 is None
                                 else torch.tensor(h0))
    torch.testing.assert_close(plain, out, rtol=0, atol=0)


def test_rglru_decode_matches_jax_in_place_too(block):
    """Five decode steps from a prefill's cache against JAX's: the
    functional step leaves its input cache as it was, and the in-place
    step (``out=cache``, as the decode graph runs it) gives the same
    output and cache bitwise."""
    cfg, p, jp, jcfg = block["cfg"], block["p"], block["jp"], block["jcfg"]
    u = _u(cfg, 3, 15, seed=4)
    with torch.no_grad():
        _, cache = rglru.rglru_full(p, cfg, torch.tensor(u[:, :10]),
                                    return_cache=True)
    _, jcache = jax_rglru.rglru_full(jp, jcfg, jnp.asarray(u[:, :10]),
                                     return_cache=True)
    inplace = {k: v.clone() for k, v in cache.items()}
    for t in range(10, 15):
        x = torch.tensor(u[:, t:t + 1])
        before = {k: v.clone() for k, v in cache.items()}
        with torch.no_grad():
            out, cache = rglru.rglru_decode(p, cfg, x, cache)
            out2, new = rglru.rglru_decode(p, cfg, x, inplace, out=inplace)
        jout, jcache = jax_rglru.rglru_decode(jp, jcfg,
                                              jnp.asarray(u[:, t:t + 1]),
                                              jcache)
        _close(out, jout)
        for k in ("conv", "state"):
            _close(cache[k], jcache[k])
            assert new[k] is inplace[k]
            assert torch.equal(new[k], cache[k]), k
            assert not torch.equal(before[k], cache[k]), k
        assert torch.equal(out2, out)


@pytest.mark.parametrize("S", list(range(1, 17)))
def test_scan_matches_step(block, S):
    """``rglru_full`` over S tokens against S one-step decodes from the
    zero cache (the JAX package's property test); and the log-depth
    ``linear_scan`` against the sequential recurrence."""
    cfg, p = block["cfg"], block["p"]
    u = torch.tensor(_u(cfg, 1, S, seed=100 + S))
    with torch.no_grad():
        full = rglru.rglru_full(p, cfg, u)
        cache = rglru.rglru_cache_init(cfg, 1, u.dtype, u.device)
        steps = []
        for t in range(S):
            o, cache = rglru.rglru_decode(p, cfg, u[:, t:t + 1], cache)
            steps.append(o)
    torch.testing.assert_close(torch.cat(steps, 1), full, rtol=1e-5,
                               atol=1e-6)
    g = torch.Generator().manual_seed(S)
    a = torch.rand((2, S, 5), generator=g)
    b = torch.randn((2, S, 5), generator=g)
    h, seq = torch.zeros((2, 5)), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    torch.testing.assert_close(rglru.linear_scan(a, b), torch.stack(seq, 1),
                               rtol=1e-5, atol=1e-6)


def test_rglru_gradients_match_jax(block):
    """The gradient of a scalar of ``rglru_full``'s output with respect to
    every parameter and the input, leaf by leaf (the scan's backward)."""
    cfg, p, jp, jcfg = block["cfg"], block["p"], block["jp"], block["jcfg"]
    u = _u(cfg, 2, 12, seed=7)
    w = np.random.default_rng(8).standard_normal((2, 12, cfg.d_model)
                                                 ).astype(np.float32)
    jg = jax.grad(lambda q, x: jnp.sum(jax_rglru.rglru_full(q, jcfg, x)
                                       * w), argnums=(0, 1))(
        jp, jnp.asarray(u))
    x = torch.tensor(u, requires_grad=True)
    params = nn.ParameterDict({k: nn.Parameter(v.detach().clone())
                               for k, v in p.items()})
    (rglru.rglru_full(params, cfg, x) * torch.tensor(w)).sum().backward()
    for k, g in jg[0].items():
        scale = float(np.abs(np.asarray(g)).max())
        np.testing.assert_allclose(params[k].grad.numpy(), np.asarray(g),
                                   rtol=RTOL, atol=ATOL * max(scale, 1e-3),
                                   err_msg=k)
    _close(x.grad, jg[1], atol=ATOL * max(float(np.abs(jg[1]).max()), 1e-3))
