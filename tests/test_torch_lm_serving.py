"""The port's LM runtime and AR shared-prefix serving held against the JAX
package at ``mamba2-smoke`` size on the CPU, with ``transformer.
init_params`` weights handed over through ``weights.lm_from_jax``.

f32 comparisons are tight (the frameworks sum in other orders: observed
errors ~1e-6); in bf16 the frameworks round at other places, so the port's
logits are held to JAX's own bf16 error against f32, x1.25.  Discrete
outputs (prefix length, token-step counts, cache shapes) must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import replace as jax_replace
from repro.models import transformer as jax_tfm
from repro.serving import kvcache as jax_kv
from repro.serving import shared_prefill as jax_sp
from repro_torch import weights
from repro_torch.config import get_config, replace
from repro_torch.launch.serve import serve
from repro_torch.models import transformer as tfm
from repro_torch.serving import kvcache, shared_prefill

RTOL, ATOL = 1e-4, 1e-5


def _params(seed=0):
    """JAX init_params at mamba2-smoke as numpy, with the zero-initialised
    norms and biases given seeded values so every term is live."""
    jcfg = jax_get_config("mamba2-780m", smoke=True)
    params = jax.tree.map(np.asarray,
                          jax_tfm.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)

    def live(x):
        if x.size and not x.any():
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return x
    return jax.tree.map(live, params)


@pytest.fixture(scope="module")
def lm():
    params = _params()
    jp = jax.tree.map(jnp.asarray, params)
    jcfg = jax_replace(jax_get_config("mamba2-780m", smoke=True),
                       dtype="float32")
    cfg = replace(get_config("mamba2-780m", smoke=True), dtype="float32")
    model = weights.lm_from_jax(params, cfg, device="cpu")
    return dict(params=params, jp=jp, jcfg=jcfg, model=model)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_trees_close(got, want, rtol=RTOL, atol=ATOL):
    g = {jax.tree_util.keystr(k): v
         for k, v in _leaves(jax.tree.map(lambda t: t.numpy(), got))}
    w = {jax.tree_util.keystr(k): np.asarray(v) for k, v in _leaves(want)}
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_allclose(g[k].astype(np.float32),
                                   w[k].astype(np.float32), rtol=rtol,
                                   atol=atol, err_msg=k)


def test_prefill_and_decode_match_jax(lm):
    tokens = np.random.default_rng(0).integers(0, 512, (2, 37))
    logits, cache = tfm.prefill(lm["model"], tokens)
    jl, jc = jax_tfm.prefill(lm["jp"], lm["jcfg"], jnp.asarray(tokens))
    assert cache["blocks"]["l0"]["state"].shape[0] == 2   # n_blocks axis
    assert float(np.abs(np.asarray(jl)).std()) > 1e-2
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    _assert_trees_close(cache, jc)
    tok = np.array([[3], [511]])
    logits1, cache1 = tfm.decode_step(lm["model"], cache, tok, 37)
    jl1, jc1 = jax_tfm.decode_step(lm["jp"], lm["jcfg"], jc,
                                   jnp.asarray(tok), jnp.int32(37))
    np.testing.assert_allclose(logits1.numpy(), np.asarray(jl1), rtol=RTOL,
                               atol=ATOL)
    _assert_trees_close(cache1, jc1)


def test_decode_step_leaves_its_input_cache_unchanged(lm):
    """decode_step writes each layer's new cache into freshly allocated
    stacked leaves: the input cache (which forked caches may share) keeps
    its values, and two steps from one cache give equal results."""
    tokens = np.random.default_rng(2).integers(0, 512, (2, 21))
    _, cache = tfm.prefill(lm["model"], tokens)
    before = {jax.tree_util.keystr(k): v.clone() for k, v in _leaves(cache)}
    tok = np.array([[7], [100]])
    l1, c1 = tfm.decode_step(lm["model"], cache, tok, 21)
    l2, c2 = tfm.decode_step(lm["model"], cache, tok, 21)
    for k, v in _leaves(cache):
        torch.testing.assert_close(v, before[jax.tree_util.keystr(k)],
                                   rtol=0, atol=0)
    torch.testing.assert_close(l1, l2, rtol=0, atol=0)
    for (k, a), (_, b), (_, c) in zip(_leaves(c1), _leaves(c2),
                                      _leaves(cache)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert a.shape == c.shape and a.data_ptr() != c.data_ptr(), k


def test_bf16_logits_error_no_worse_than_jax(lm):
    """bf16 activations: both packages' logits held against JAX's f32
    logits after a prefill and two decode steps (observed mean errors:
    0.00256 for the port against 0.00242 for JAX)."""
    cfg = get_config("mamba2-780m", smoke=True)                 # bf16
    jcfg = jax_get_config("mamba2-780m", smoke=True)
    model = weights.lm_from_jax(lm["params"], cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(0, 512, (2, 45))

    def run_jax(c):
        lg, ca = jax_tfm.prefill(lm["jp"], c, jnp.asarray(tokens[:, :43]))
        out = [lg]
        for pos in (43, 44):
            lg, ca = jax_tfm.decode_step(lm["jp"], c, ca,
                                         jnp.asarray(tokens[:, pos:pos + 1]),
                                         jnp.int32(pos))
            out.append(lg)
        return np.concatenate([np.asarray(o, np.float32) for o in out], 1)

    lg, ca = tfm.prefill(model, tokens[:, :43])
    port = [lg]
    for pos in (43, 44):
        lg, ca = tfm.decode_step(model, ca, tokens[:, pos:pos + 1], pos)
        port.append(lg)
    port = torch.cat(port, 1).float().numpy()
    want = run_jax(lm["jcfg"])
    jax_err = float(np.abs(run_jax(jcfg) - want).mean())
    port_err = float(np.abs(port - want).mean())
    assert np.isfinite(port).all()
    assert 0 < jax_err < 0.1                       # bf16 really was in play
    assert port_err <= 1.25 * jax_err + 1e-3, (port_err, jax_err)


def test_fork_and_select_match_jax(lm):
    tokens = np.random.default_rng(2).integers(0, 512, (1, 9))
    _, cache = tfm.prefill(lm["model"], tokens)
    _, jc = jax_tfm.prefill(lm["jp"], lm["jcfg"], jnp.asarray(tokens))
    forked = kvcache.fork_model_cache(cache, 3)
    jforked = jax_kv.fork_model_cache(jc, 3)
    assert forked["blocks"]["l0"]["state"].shape[:2] == (2, 3)
    _assert_trees_close(forked, jforked)
    flat = {"k": torch.arange(12.0).reshape(2, 3, 2)[0:1]}
    f = kvcache.fork_cache(flat, 3)
    assert f["k"].shape == (3, 3, 2)
    assert torch.equal(f["k"][0], f["k"][2])
    s = kvcache.select_rows(f, [2, 0])
    js = jax_kv.select_rows(jax_kv.fork_cache(
        {"k": jnp.asarray(flat["k"].numpy())}, 3), jnp.array([2, 0]))
    np.testing.assert_array_equal(s["k"].numpy(), np.asarray(js["k"]))
    assert kvcache.cache_bytes(forked) == jax_kv.cache_bytes(jforked)


def test_common_prefix_len_matches_jax():
    rows = [np.array([[1, 2, 3, 4], [1, 2, 9, 4], [1, 2, 3, 7]]),
            np.array([[1, 2, 3]]), np.array([[5, 6], [5, 6]]),
            np.array([[0, 1], [1, 1]])]
    for t in rows:
        assert (shared_prefill.common_prefix_len(t)
                == jax_sp.common_prefix_len(t))
    assert shared_prefill.common_prefix_len(rows[0]) == 2


def test_group_requests_matches_jax():
    e = np.random.default_rng(3).standard_normal((7, 16)).astype(np.float32)
    e[3] = e[0] + 0.01
    e[5] = e[0] - 0.01
    assert (shared_prefill.group_requests(e, 0.5, group_max=3)
            == jax_sp.group_requests(e, 0.5, group_max=3))


@pytest.mark.parametrize("prefix,tail", [(24, 6), (5, 1)])
def test_shared_prefix_prefill_matches_jax_and_independent(lm, prefix, tail):
    """Counts equal to the JAX function's; forked-and-caught-up logits
    equal to JAX's and to the port's own independent prefill."""
    rng = np.random.RandomState(0)
    N = 3
    tokens = np.concatenate([rng.randint(0, 512, (1, prefix)).repeat(N, 0),
                             rng.randint(0, 512, (N, tail))], axis=1)
    tokens[:, prefix] = [7, 8, 9]                  # tails differ at once
    model, jp, jcfg = lm["model"], lm["jp"], lm["jcfg"]
    logits, caches, pos, stats = shared_prefill.shared_prefix_prefill(
        lambda t, m: tfm.prefill(model, t, max_len=m),
        lambda c, t, p: tfm.decode_step(model, c, t, p), tokens,
        max_len=prefix + tail + 4)
    jl, jc, jpos, jstats = jax_sp.shared_prefix_prefill(
        lambda t, m: jax_tfm.prefill(jp, jcfg, jnp.asarray(t), max_len=m),
        lambda c, t, p: jax_tfm.decode_step(jp, jcfg, c, jnp.asarray(t), p),
        tokens, max_len=prefix + tail + 4)
    assert stats == jstats and pos == jpos
    assert stats["prefix_len"] == prefix
    assert stats["token_steps"] == prefix + N * tail
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    _assert_trees_close(caches, jc)
    ref, _ = tfm.prefill(model, tokens)
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=RTOL,
                               atol=ATOL)


def _jax_greedy(jp, jcfg, prompt, batch, gen):
    """The JAX launcher's shared-prefix loop (launch/serve.py:52-72)."""
    logits, trunk = jax_tfm.prefill(jp, jcfg, jnp.asarray(prompt))
    cache = jax_kv.fork_model_cache(trunk, batch)
    tok = jnp.repeat(jnp.argmax(logits[:, -1:], axis=-1), batch, 0)
    out = []
    for i in range(gen):
        logits, cache = jax_tfm.decode_step(jp, jcfg, cache, tok,
                                            jnp.int32(prompt.shape[1] + i))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.concatenate(out, 1), np.asarray(logits)


@pytest.mark.parametrize("shared", [False, True])
def test_serve_function_on_cpu(lm, shared):
    r = serve("mamba2-780m", smoke=True, batch=3, prompt_len=20, gen=4,
              shared_prefix=shared, device="cpu", model=lm["model"])
    assert r["tokens"].shape == (3, 4) and r["device"] == "cpu"
    assert r["token_steps"] == (20 + 3 * 4 if shared else 3 * (20 + 4))
    assert r["cache_bytes"] == 2 * 3 * (3 * 576 * 4 + 8 * 64 * 32 * 4)
    assert torch.isfinite(r["logits"]).all()
    if shared:       # same weights and prompt as the JAX launcher's loop
        prompt = np.random.RandomState(0).randint(0, 512, (1, 20))
        toks, jl = _jax_greedy(lm["jp"], lm["jcfg"], prompt, 3, 4)
        np.testing.assert_array_equal(r["tokens"], toks)
        np.testing.assert_allclose(r["logits"].numpy(), jl, rtol=RTOL,
                                   atol=ATOL)


def test_lm_from_jax_is_strict(lm):
    cfg = replace(get_config("mamba2-780m", smoke=True), dtype="float32")
    params = dict(lm["params"])
    params["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="extra"):
        weights.lm_from_jax(params, cfg, device="cpu")
    params = dict(lm["params"])
    del params["ln_f"]
    with pytest.raises(KeyError, match="ln_f"):
        weights.lm_from_jax(params, cfg, device="cpu")
    params = dict(lm["params"])
    params["embed"] = params["embed"][:-1]
    with pytest.raises(ValueError, match="embed"):
        weights.lm_from_jax(params, cfg, device="cpu")


def test_unported_mixers_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfm.LM(get_config("sage-dit", smoke=True), device="cpu")


def test_lm_entry_points_default_to_cuda_and_raise_without_it(lm):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    cfg = get_config("mamba2-780m", smoke=True)
    with pytest.raises(RuntimeError, match="cuda"):
        tfm.LM(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        weights.lm_from_jax(lm["params"], cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        serve("mamba2-780m", smoke=True)
