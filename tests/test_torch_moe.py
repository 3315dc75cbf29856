"""The port's MoE MLP (``models/moe.py``) and MLA attention (the ``mla_*``
functions of ``models/attention.py``) held against the JAX package on
the CPU at ``deepseek-v2-lite-smoke`` width, with the JAX init trees'
weights handed over by name.

MoE: ``apply_moe`` at the config's capacity factor 1.25 with a router
skewed so that experts overflow (outputs, the aux loss, and exactly the
set of (token, k) entries JAX drops), over one token group and over
padded groups; at 8.0 nothing drops and it equals the all-expert oracle
``apply_moe_dense_ref``, in both packages.  MLA: ``mla_full``,
``mla_prefill`` and ``mla_decode`` (functional, in place, and past the
cache's end, where JAX's ``dynamic_update_slice`` clamps the write).

Tolerance in f32: 1e-4 relative and 1e-5 absolute (``tests/
test_torch_lm_dense.py``'s bar); capacities, drops and caches' shapes and
dtypes exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import replace as jax_replace
from repro.models import attention as jax_attn
from repro.models import moe as jax_moe
from repro_torch.config import get_config, replace
from repro_torch.models import attention as attn
from repro_torch.models import moe

ARCH = "deepseek-v2-lite-16b"
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**moe_over):
    jcfg = jax_get_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)
    if moe_over:
        jcfg = jax_replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                          **moe_over))
        cfg = replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_over))
    return (replace(cfg, dtype="float32"),
            jax_replace(jcfg, dtype="float32"))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.fixture(scope="module")
def experts():
    """JAX ``init_moe`` weights, the router's expert-0 column raised so
    that expert 0 overflows its capacity on inputs with a positive mean
    (:func:`_x`), in both packages."""
    cfg, jcfg = _cfgs()
    jp = jax.tree.map(np.asarray, jax_moe.init_moe(jax.random.PRNGKey(0),
                                                   jcfg))
    jp["router"] = jp["router"].copy()
    jp["router"][:, 0] += 0.05
    p = moe.init_moe(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    flat = dict(_flat(jp))
    assert sorted(flat) == sorted(n for n, _ in p.named_parameters())
    with torch.no_grad():
        for name, t in p.named_parameters():
            assert tuple(t.shape) == flat[name].shape, name
            t.copy_(torch.tensor(flat[name]))
    return dict(p=p, jp=jax.tree.map(jnp.asarray, jp))


def _x(cfg, B, S, seed):
    return (0.3 + np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model))).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=rtol, atol=atol)


def _jax_dropped(jp, jcfg, x, g):
    """The (token, k) entries JAX's ``_route_group`` drops, in the tokens'
    order: its sorted ``keep`` put back through the stable sort."""
    m = jcfg.moe
    xt = x.reshape(-1, x.shape[-1])
    T = xt.shape[0]
    probs = jax.nn.softmax(xt @ jp["router"], axis=-1)
    wk, idx = jax.lax.top_k(probs, m.top_k)
    n_groups = -(-T // g)
    idx = np.pad(np.asarray(idx), ((0, n_groups * g - T), (0, 0)))
    C = jax_moe._capacity(g, m.top_k, m.n_routed, m.capacity_factor)
    drop = np.zeros((n_groups, g * m.top_k), bool)
    route = jax.jit(lambda ii: jax_moe._route_group(
        jnp.zeros((g, 1)), ii, jnp.ones(ii.shape), m.n_routed, C)[1][3])
    for i, ig in enumerate(idx.reshape(n_groups, g, m.top_k)):
        keep = route(jnp.asarray(ig))
        order = np.argsort(ig.reshape(-1), kind="stable")
        drop[i, order] = ~np.asarray(keep)
    return drop.reshape(-1, m.top_k)[:T]


@pytest.mark.parametrize("B,S,group", [(2, 32, 0), (1, 50, 16)])
def test_apply_moe_drops_match_jax(experts, B, S, group):
    """At capacity factor 1.25 with a skewed router: outputs and aux equal
    JAX's within tolerance, and the dropped (token, k) entries are exactly
    JAX's (some are dropped); with a group size that does not divide the
    tokens, the padded groups too."""
    cfg, jcfg = _cfgs()
    x = _x(cfg, B, S, seed=S)
    with torch.no_grad():
        y, aux = moe.apply_moe(experts["p"], cfg, torch.tensor(x),
                               group_size=group)
    jy, jaux = jax.jit(lambda q, xx: jax_moe.apply_moe(
        q, jcfg, xx, group_size=group))(experts["jp"], jnp.asarray(x))
    _close(y, jy)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)
    m, T = cfg.moe, B * S
    g = group or min(T, 4096)
    n_groups = -(-T // g)
    xt = torch.tensor(x).reshape(T, -1)
    _, wk, idx = moe._router(experts["p"], cfg, xt)
    pad = n_groups * g - T
    ig = torch.nn.functional.pad(idx, (0, 0, 0, pad)).reshape(n_groups, g, -1)
    wg = torch.nn.functional.pad(wk, (0, 0, 0, pad)).reshape(n_groups, g, -1)
    C = moe._capacity(g, m.top_k, m.n_routed, m.capacity_factor)
    assert C == jax_moe._capacity(g, m.top_k, m.n_routed, m.capacity_factor)
    _, (_, _, keep) = moe._route_group(
        torch.nn.functional.pad(xt, (0, 0, 0, pad)).reshape(n_groups, g, -1),
        ig, wg, m.n_routed, C)
    dropped = (~keep).reshape(-1, m.top_k)[:T].numpy()
    want = _jax_dropped(experts["jp"], jcfg, jnp.asarray(x), g)
    np.testing.assert_array_equal(dropped, want)
    assert want.any()


def test_apply_moe_without_drops_is_the_dense_oracle(experts):
    """At capacity factor 8.0 nothing is dropped: ``apply_moe`` equals
    ``apply_moe_dense_ref`` (the port's and JAX's) and JAX's
    ``apply_moe``."""
    cfg, jcfg = _cfgs(capacity_factor=8.0)
    x = _x(cfg, 2, 24, seed=3)
    with torch.no_grad():
        y, aux = moe.apply_moe(experts["p"], cfg, torch.tensor(x))
        ref = moe.apply_moe_dense_ref(experts["p"], cfg, torch.tensor(x))
    jy, jaux = jax.jit(lambda q, xx: jax_moe.apply_moe(q, jcfg, xx))(
        experts["jp"], jnp.asarray(x))
    jref = jax.jit(lambda q, xx: jax_moe.apply_moe_dense_ref(q, jcfg, xx))(
        experts["jp"], jnp.asarray(x))
    _close(y, jy)
    _close(ref, jref)
    torch.testing.assert_close(y, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)


@pytest.mark.parametrize("tokens", [1, 4, 100, 4096, 10_000])
def test_capacity_matches_jax(tokens):
    for top_k, n, cf in ((6, 64, 1.25), (2, 4, 1.25), (8, 384, 8.0)):
        assert (moe._capacity(tokens, top_k, n, cf)
                == jax_moe._capacity(tokens, top_k, n, cf))


def test_apply_moe_gradients_match_jax(experts):
    """The gradient of a scalar of ``apply_moe``'s output plus its aux
    loss with respect to every expert, router and shared weight and the
    input, leaf by leaf, with entries dropped."""
    cfg, jcfg = _cfgs()
    x = _x(cfg, 2, 32, seed=32)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def jloss(q, xx):
        y, aux = jax_moe.apply_moe(q, jcfg, xx)
        return jnp.sum(y * w) + aux
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(experts["jp"],
                                                  jnp.asarray(x))
    p = moe.init_moe(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    p.load_state_dict(experts["p"].state_dict())
    xx = torch.tensor(x, requires_grad=True)
    y, aux = moe.apply_moe(p, cfg, xx)
    ((y * torch.tensor(w)).sum() + aux).backward()
    want = dict(_flat(jax.tree.map(np.asarray, jg[0])))
    for name, t in p.named_parameters():
        scale = float(np.abs(want[name]).max())
        np.testing.assert_allclose(t.grad.numpy(), want[name], rtol=RTOL,
                                   atol=ATOL * max(scale, 1e-3),
                                   err_msg=name)
    _close(xx.grad, jg[1], atol=ATOL * max(float(np.abs(jg[1]).max()), 1e-3))


@pytest.fixture(scope="module")
def mla():
    cfg, jcfg = _cfgs()
    jp = {k: np.asarray(v) for k, v in jax_attn.init_mla(
        jax.random.PRNGKey(3), jcfg).items()}
    jp["kv_norm"] = (0.1 * np.random.default_rng(4).standard_normal(
        jp["kv_norm"].shape)).astype(np.float32)
    p = attn.init_mla(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    assert sorted(p) == sorted(jp)
    with torch.no_grad():
        for k, v in jp.items():
            p[k].copy_(torch.tensor(v))
    return dict(cfg=cfg, jcfg=jcfg, p=p,
                jp={k: jnp.asarray(v) for k, v in jp.items()})


def test_mla_full_and_prefill_match_jax(mla):
    cfg, jcfg, p, jp = mla["cfg"], mla["jcfg"], mla["p"], mla["jp"]
    x = _x(cfg, 2, 11, seed=11)
    with torch.no_grad():
        full = attn.mla_full(p, cfg, torch.tensor(x))
        out, cache = attn.mla_prefill(p, cfg, torch.tensor(x), max_len=16)
    _close(full, jax_attn.mla_full(jp, jcfg, jnp.asarray(x)))
    jout, jcache = jax_attn.mla_prefill(jp, jcfg, jnp.asarray(x), max_len=16)
    _close(out, jout)
    assert set(cache) == {"ckv", "kr"}
    for k in cache:
        assert cache[k].shape == jcache[k].shape
        assert cache[k].dtype == torch.float32
        _close(cache[k], jcache[k])
    with pytest.raises(ValueError, match="does not fit"):
        attn.mla_prefill(p, cfg, torch.tensor(x), max_len=10)


def test_mla_decode_matches_jax_in_place_and_clamped(mla):
    """Decode steps from a prefill's cache, positions as ints and as 0-dim
    tensors, the last two past the cache's 12 rows (the write clamped to
    its last row, every row attended); the in-place step gives the same
    output and cache bitwise."""
    cfg, jcfg, p, jp = mla["cfg"], mla["jcfg"], mla["p"], mla["jp"]
    x = _x(cfg, 2, 14, seed=16)
    with torch.no_grad():
        _, cache = attn.mla_prefill(p, cfg, torch.tensor(x[:, :10]),
                                    max_len=12)
    _, jcache = jax_attn.mla_prefill(jp, jcfg, jnp.asarray(x[:, :10]),
                                     max_len=12)
    jdecode = jax.jit(lambda c, xx, ps: jax_attn.mla_decode(jp, jcfg, xx, c,
                                                            ps))
    inplace = {k: v.clone() for k, v in cache.items()}
    for pos in range(10, 14):
        xt = torch.tensor(x[:, pos:pos + 1])
        ps = pos if pos % 2 else torch.tensor(pos)
        with torch.no_grad():
            out, cache = attn.mla_decode(p, cfg, xt, cache, ps)
            out2, new = attn.mla_decode(p, cfg, xt, inplace, ps, out=inplace)
        jout, jcache = jdecode(jcache, jnp.asarray(x[:, pos:pos + 1]),
                               jnp.int32(pos))
        _close(out, jout)
        assert torch.equal(out2, out)
        for k in cache:
            _close(cache[k], jcache[k])
            assert new[k] is inplace[k] and torch.equal(new[k], cache[k])
