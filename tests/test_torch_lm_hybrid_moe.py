"""The port's hybrid (RG-LRU + local attention) and MoE (MLA or GQA
attention, a dense first layer, routed experts) LMs held against the JAX
package on the CPU, with ``transformer.init_params`` weights handed over
through ``weights.lm_from_jax``: ``recurrentgemma-smoke`` as registered
(one ``(rglru, rglru, local_attn)`` super-block, no remainder) and with a
remainder (5 layers, the two-layer ``suffix`` the full config has),
``deepseek-v2-lite-smoke`` and ``kimi-k2-smoke``.

Per config: the weight tree leaf for leaf; ``forward_train``, ``lm_loss``
with the router's aux loss and the first-step gradients leaf by leaf;
``prefill`` and ``decode_step`` (for the hybrid across the local
attention's ring: a prefill that fills the window, and decode steps that
wrap it); the launcher's greedy tokens in both modes; ``fork_model_cache``;
and ``cached_prefix_prefill``'s ledger, hits and payload CRC.

Tolerance in f32: 1e-4 relative and 1e-5 absolute (``tests/
test_torch_lm_dense.py``'s bar), gradients scaled by each leaf's largest;
greedy tokens, token steps, cache shapes and dtypes, cache bytes and the
trunk cache's ledger exactly.  The JAX functions are jitted once a config
(they would otherwise run op by op).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import replace as jax_replace
from repro.models import transformer as jax_tfm
from repro.serving import faults as jax_faults
from repro.serving import kvcache as jax_kv
from repro.serving import shared_prefill as jax_sp
from repro.serving.trunk_cache import TrunkCache as JaxTrunkCache
from repro_torch import weights
from repro_torch.config import get_config, replace
from repro_torch.launch.serve import serve
from repro_torch.models import transformer as tfm
from repro_torch.serving import faults, kvcache, shared_prefill
from repro_torch.serving.trunk_cache import TrunkCache

RTOL, ATOL = 1e-4, 1e-5
REMAINDER = dict(n_layers=5, remainder=("rglru", "rglru"))
CASES = {"recurrentgemma": ("recurrentgemma-2b", {}),
         "recurrentgemma+remainder": ("recurrentgemma-2b", REMAINDER),
         "deepseek": ("deepseek-v2-lite-16b", {}),
         "kimi": ("kimi-k2-1t-a32b", {})}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(CASES))
def lm(request):
    """JAX ``init_params`` at the smoke config (zero-initialised norms and
    biases given seeded values), the port's model on the same weights, and
    the JAX functions jitted once."""
    arch, over = CASES[request.param]
    jcfg = jax_replace(jax_get_config(arch, smoke=True), dtype="float32",
                       **over)
    cfg = replace(get_config(arch, smoke=True), dtype="float32", **over)
    params = jax.tree.map(np.asarray,
                          jax_tfm.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda x: (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if x.size and not x.any() else x, params)
    jp = jax.tree.map(jnp.asarray, params)
    return dict(
        name=request.param, arch=arch, cfg=cfg, jcfg=jcfg, params=params,
        jp=jp, model=weights.lm_from_jax(params, cfg, device="cpu"),
        jforward=jax.jit(lambda p, t: jax_tfm.forward_train(p, jcfg, t)),
        jprefill=jax.jit(lambda t, m: jax_tfm.prefill(jp, jcfg, t,
                                                      max_len=m),
                         static_argnums=1),
        jdecode=jax.jit(lambda c, t, p: jax_tfm.decode_step(jp, jcfg, c, t,
                                                            p)))


def _flat(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_close(got, want, rtol=RTOL, atol=ATOL):
    g = _flat(jax.tree.map(lambda t: t, got))
    w = _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert tuple(g[k].shape) == w[k].shape, k
        assert str(g[k].dtype).split(".")[-1] == str(w[k].dtype), k
        np.testing.assert_allclose(g[k].float().numpy(),
                                   np.asarray(w[k], np.float32), rtol=rtol,
                                   atol=atol, err_msg=k)


def _close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=rtol, atol=atol)


def test_lm_from_jax_carries_the_tree_leaf_for_leaf(lm):
    """Every leaf of the init_params tree (the RG-LRU mixer, the remainder's
    ``suffix`` layers, the MoE layers' stacked experts and shared experts,
    MLA's latent projections) lands on the port's parameter of the same
    dotted name, bitwise."""
    flat = weights._unstack_blocks(dict(weights._flatten(lm["params"])))
    got = dict(lm["model"].named_parameters())
    assert sorted(got) == sorted(flat)
    want = {"hybrid": {"blocks.0.l0.mix.lam", "blocks.0.l1.mix.conv_w",
                       "blocks.0.l2.mix.wk", "blocks.0.l0.mlp.wg"},
            "moe": {"prefix.0.mlp.wi", "blocks.0.l0.moe.router",
                    "blocks.0.l0.moe.wi", "blocks.0.l0.moe.shared.wo"}}
    assert want[lm["cfg"].family] <= set(got)
    if lm["cfg"].remainder:
        assert {"suffix.0.mix.wx", "suffix.1.mlp.wo"} <= set(got)
    if lm["cfg"].attn_kind == "mla":
        assert {"prefix.0.mix.wdkv", "blocks.0.l0.mix.kv_norm"} <= set(got)
    for name, arr in flat.items():
        np.testing.assert_array_equal(got[name].detach().numpy(), arr,
                                      err_msg=name)
    assert tfm.uses_pos(lm["cfg"])


def test_forward_train_loss_and_grads_match_jax(lm):
    """``forward_train`` logits and aux (the router losses summed; 0 for
    the hybrid), ``lm_loss`` with the aux and its gradient leaf by leaf."""
    model, jcfg = lm["model"], lm["jcfg"]
    tokens = np.random.default_rng(1).integers(0, lm["cfg"].vocab, (2, 16))
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits, jaux = lm["jforward"](lm["jp"], jbatch["tokens"])
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_tfm.lm_loss(p, jcfg, jbatch)))(lm["jp"])
    with torch.no_grad():
        logits, aux = tfm.forward_train(model, tokens)
    _close(logits, jlogits)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL, atol=1e-7)
    assert (float(aux) > 0) == (lm["cfg"].moe is not None)
    model.zero_grad(set_to_none=True)
    loss = tfm.lm_loss(model, batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    want = weights._unstack_blocks(dict(weights._flatten(
        jax.tree.map(np.asarray, jgrads))))
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        scale = float(np.abs(want[name]).max())
        np.testing.assert_allclose(g.numpy(), want[name], rtol=RTOL,
                                   atol=ATOL * max(scale, 1e-3),
                                   err_msg=name)


def test_prefill_and_decode_steps_match_jax(lm):
    """``prefill`` logits and every cache leaf, then decode steps
    (positions as ints and as 0-dim tensors), each step's logits and cache.
    The hybrid's window is 64: a 60-token prompt fills slots 0..59 of the
    64-row local ring, and the steps at 60..67 wrap it; a 66-token prompt
    lays the ring out in the prefill itself."""
    model, cfg = lm["model"], lm["cfg"]
    hybrid = cfg.family == "hybrid"
    runs = ((60, 72, 8), (66, 72, 3)) if hybrid else ((13, 20, 5),)
    for S, max_len, n in runs:
        tokens = np.random.default_rng(S).integers(0, cfg.vocab, (2, S + n))
        logits, cache = tfm.prefill(model, tokens[:, :S], max_len=max_len)
        jl, jc = lm["jprefill"](jnp.asarray(tokens[:, :S]), max_len)
        if hybrid:
            assert cache["blocks"]["l2"]["k"].shape[2] == cfg.window
        _close(logits, jl)
        _assert_trees_close(cache, jc)
        for pos in range(S, S + n):
            tok = tokens[:, pos:pos + 1]
            p = pos if pos % 2 else torch.tensor(pos)
            logits, cache = tfm.decode_step(model, cache, tok, p)
            jl, jc = lm["jdecode"](jc, jnp.asarray(tok), jnp.int32(pos))
            _close(logits, jl)
            _assert_trees_close(cache, jc)


def _jax_launcher(lm, batch, prompt_len, gen, shared):
    """The JAX launcher's loop (``src/repro/launch/serve.py:50-72``) on the
    same weights: its greedy tokens, last logits, token steps and cache
    bytes."""
    rng = np.random.RandomState(0)
    max_len = prompt_len + gen + 8
    vocab = lm["jcfg"].vocab
    if shared:
        prompt = rng.randint(0, vocab, (1, prompt_len))
        logits, trunk = lm["jprefill"](jnp.asarray(prompt), max_len)
        cache = jax_kv.fork_model_cache(trunk, batch)
        steps = prompt_len + batch * gen
    else:
        prompts = rng.randint(0, vocab, (batch, prompt_len))
        logits, cache = lm["jprefill"](jnp.asarray(prompts), max_len)
        steps = batch * (prompt_len + gen)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    if tok.shape[0] == 1 and batch > 1:
        tok = jnp.repeat(tok, batch, 0)
    out = []
    for i in range(gen):
        logits, cache = lm["jdecode"](cache, tok, jnp.int32(prompt_len + i))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(np.asarray(tok))
    return (np.concatenate(out, 1), np.asarray(logits), steps,
            jax_kv.cache_bytes(cache))


@pytest.mark.parametrize("shared", [False, True])
def test_serve_matches_the_jax_launcher(lm, shared):
    """Greedy tokens, last logits, token steps and cache bytes; the
    hybrid's 66-token prompts fill its 64-row local ring in the prefill."""
    r = serve(lm["arch"], smoke=True, batch=3, prompt_len=66, gen=4,
              shared_prefix=shared, device="cpu", model=lm["model"])
    toks, jl, steps, nbytes = _jax_launcher(lm, 3, 66, 4, shared)
    np.testing.assert_array_equal(r["tokens"], toks)
    _close(r["logits"], jl)
    assert r["token_steps"] == steps == (66 + 3 * 4 if shared
                                         else 3 * (66 + 4))
    assert r["cache_bytes"] == nbytes


def test_fork_of_the_cache_matches_jax(lm):
    """Prefix, stacked block and suffix leaves forked on their batch axes,
    as JAX forks them; the bytes as JAX counts them."""
    _, cache = tfm.prefill(lm["model"], np.arange(9)[None], max_len=12)
    jcache = jax.tree.map(lambda t: jnp.asarray(t.numpy()), cache)
    forked = kvcache.fork_model_cache(cache, 3)
    jforked = jax_kv.fork_model_cache(jcache, 3)
    g, w = _flat(forked), _flat(jforked)
    assert sorted(g) == sorted(w) and len(g) > 2
    for k in w:
        np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]),
                                      err_msg=k)
    assert kvcache.cache_bytes(forked) == jax_kv.cache_bytes(jforked)
    rows = kvcache.select_rows(forked["prefix"] + forked["suffix"], [2, 0])
    want = jax_kv.select_rows(jforked["prefix"] + jforked["suffix"],
                              jnp.asarray([2, 0]))
    for a, b in zip(kvcache._leaves(rows), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _cached_run(cache, fns, groups, order, cents):
    prefill_fn, decode_fn = fns
    out = []
    for g in order:
        logits, caches, _, st = (jax_sp if isinstance(cache, JaxTrunkCache)
                                 else shared_prefill).cached_prefix_prefill(
            prefill_fn, decode_fn, groups[g], 16, cache=cache,
            centroid=cents[g])
        out.append((logits, caches, st))
    return out


def test_cached_prefix_prefill_ledger_and_crcs_match_jax(lm):
    """g0, g1, g0, g1 through a trunk cache of one payload on the device
    and two on the host, in both packages: the same hits, misses, spills
    and promotions, token steps and hit logits; a hit's logits and caches
    are bitwise its miss's; the payload's CRC (RG-LRU states, local KV,
    MLA latents) is the JAX ``array_crc`` of the same bytes."""
    model = lm["model"]
    vocab = lm["cfg"].vocab
    rng = np.random.RandomState(5)
    groups = [np.concatenate([rng.randint(0, vocab, (1, 10)).repeat(3, 0),
                              rng.randint(0, vocab, (3, 2))], 1)
              for _ in range(2)]
    cents = np.random.RandomState(3).randn(2, 16)
    port_fns = (lambda t, m: tfm.prefill(model, t, max_len=m),
                lambda c, t, p: tfm.decode_step(model, c, t, p))
    jax_fns = (lambda t, m: lm["jprefill"](jnp.asarray(t), m),
               lambda c, t, p: lm["jdecode"](c, jnp.asarray(t),
                                             jnp.int32(p)))
    payload = port_fns[0](groups[0][:1, :10], 16)
    one = kvcache.cache_bytes(payload)
    assert one == jax_kv.cache_bytes(jax_fns[0](groups[0][:1, :10], 16))
    cache = TrunkCache(tau_trunk=0.9, max_bytes=one, host_bytes=2 * one)
    jcache = JaxTrunkCache(tau_trunk=0.9, max_bytes=one, host_bytes=2 * one)
    order = (0, 1, 0, 1)
    got = _cached_run(cache, port_fns, groups, order, cents)
    want = _cached_run(jcache, jax_fns, groups, order, cents)
    assert cache.stats == jcache.stats
    assert (cache.stats["misses"], cache.stats["hits_host"],
            cache.stats["spills"], cache.stats["promotions"],
            cache.stats["integrity_drops"]) == (2, 2, 3, 2, 0)
    for i, ((lg, cs, st), (jl, _, jst)) in enumerate(zip(got, want)):
        assert st == jst
        _close(lg, jl)
        if st["trunk_cache_hit"]:
            mlg, mcs, _ = got[i - 2]
            assert torch.equal(lg, mlg)
            assert all(torch.equal(a, b) for a, b in zip(
                faults._sorted_leaves(cs), faults._sorted_leaves(mcs)))
    as_jax = jax.tree.map(lambda t: jnp.asarray(t.numpy()), payload)
    assert faults.array_crc(payload) == jax_faults.array_crc(as_jax)


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports only the standard library
    at the top)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_floors_on_the_cpu(lm):
    """``chip_smoke.py``'s bookkeeping for these layers: the in-place decode
    step (the graph's) moves at least the step's byte floor and less than
    the functional step; for MoE, the floor with only the experts the
    step's tokens reach is the all-expert floor less the others' weights;
    a prefill's FLOPs count a local layer's pairs within its window."""
    cs, model, cfg = _chip_smoke(), lm["model"], lm["cfg"]
    prompts = np.random.RandomState(0).randint(0, cfg.vocab, (2, 70))
    logits, cache = tfm.prefill(model, prompts, max_len=76)
    tok = logits.argmax(dim=-1)
    in_place, _ = cs._op_bytes(lambda: tfm.decode_step(
        model, cache, tok, torch.tensor(70), out=cache))
    functional, _ = cs._op_bytes(lambda: tfm.decode_step(model, cache, tok,
                                                         70))
    floor = cs._decode_floor_bytes(model, 2, 70, max_len=76)
    assert floor <= in_place < functional
    layers = cs._lm_layers(model)
    if cfg.moe is not None:
        used = cs._active_experts(model, lambda: tfm.decode_step(
            model, cache, tok, 70))
        moe = [lay.moe for lay in layers if lay.mlpk == "moe"]
        assert len(used) == len(moe) and all(
            1 <= n <= cfg.moe.n_routed for n in used)
        few = cs._decode_floor_bytes(model, 2, 70, max_len=76, active=used)
        per = [sum(w.numel() for w in (m.wi, m.wg, m.wo)) * 4 for m in moe]
        gone = sum(b * (1 - n / cfg.moe.n_routed) for b, n in zip(per, used))
        assert abs(floor - few - gone) <= 1
    n_local = sum(lay.kind == "local_attn" for lay in layers)
    S, w = 100, cfg.window
    pairs = (w * (w + 1) // 2 + (S - w) * w) if n_local else 0
    full = cs._prefill_flops(model, 1, S)
    if n_local:
        assert S > w
        model.cfg = replace(cfg, window=S)
        try:
            wide = cs._prefill_flops(model, 1, S)
        finally:
            model.cfg = cfg
        assert wide - full == 2.0 * cfg.n_heads * (
            S * (S + 1) // 2 - pairs) * 2 * cfg.hd * n_local


def test_init_cache_matches_jax(lm):
    """``init_cache``: the JAX tree's structure, shapes and dtypes (the
    local ring capped at the window, the RG-LRU state in f32, MLA's
    latents), all zeros; a decode step from it matches JAX's."""
    rows = 72 if lm["cfg"].family == "hybrid" else 20    # as prefilled above
    cache = tfm.init_cache(lm["model"], 2, rows)
    jc = jax_tfm.init_cache(lm["jcfg"], 2, rows)
    _assert_trees_close(cache, jc, rtol=0, atol=0)
    tok = np.array([[5], [7]])
    logits, cache = tfm.decode_step(lm["model"], cache, tok, 0)
    jl, jc = lm["jdecode"](jc, jnp.asarray(tok), jnp.int32(0))
    _close(logits, jl)
    _assert_trees_close(cache, jc)
