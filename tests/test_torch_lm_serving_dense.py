"""AR serving on the port's dense LM held against the JAX package at
``phi3-mini-smoke`` size on the CPU, with ``transformer.init_params``
weights handed over through ``weights.lm_from_jax``: the launcher
(``launch/serve.py``) in both modes, ``shared_prefix_prefill`` and
``cached_prefix_prefill`` on KV caches (forks of the stacked ``(n_blocks,
B, L, Hkv, hd)`` leaves, ``cache_bytes``, the trunk cache's CRC over a KV
payload), and the ``shared_prefill_llm`` example.

In f32, logits within 1e-4 relative and 1e-5 absolute (observed ~5e-6);
greedy tokens, token-step counts, prefix lengths, cache bytes and the
trunk cache's ledger must be equal.
"""
import importlib.util
import sys
from pathlib import Path

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
from repro_torch.examples import shared_prefill_llm as example
from repro_torch.launch.serve import serve
from repro_torch.models import transformer as tfm
from repro_torch.serving import faults, kvcache, shared_prefill
from repro_torch.serving.trunk_cache import TrunkCache

ARCH = "phi3-mini-3.8b"
RTOL, ATOL = 1e-4, 1e-5
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_get_config(ARCH, smoke=True)
    params = jax.tree.map(np.asarray,
                          jax_tfm.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda x: (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if x.size and not x.any() else x, params)
    cfg = replace(get_config(ARCH, smoke=True), dtype="float32")
    return dict(jp=jax.tree.map(jnp.asarray, params),
                jcfg=jax_replace(jcfg, dtype="float32"), cfg=cfg,
                model=weights.lm_from_jax(params, cfg, device="cpu"))


def _fns(lm):
    model, jp, jcfg = lm["model"], lm["jp"], lm["jcfg"]
    port = (lambda t, m: tfm.prefill(model, t, max_len=m),
            lambda c, t, p: tfm.decode_step(model, c, t, p))
    jax_ = (lambda t, m: jax_tfm.prefill(jp, jcfg, jnp.asarray(t), max_len=m),
            lambda c, t, p: jax_tfm.decode_step(jp, jcfg, c, jnp.asarray(t),
                                                p))
    return port, jax_


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL)


def _jax_launcher(lm, batch, prompt_len, gen, shared):
    """The JAX launcher's loop (``src/repro/launch/serve.py:50-72``) on the
    same weights: its greedy tokens, last logits, token steps and cache
    bytes."""
    jp, jcfg = lm["jp"], lm["jcfg"]
    rng = np.random.RandomState(0)
    max_len = prompt_len + gen + 8
    if shared:
        prompt = rng.randint(0, jcfg.vocab, (1, prompt_len))
        logits, trunk = jax_tfm.prefill(jp, jcfg, jnp.asarray(prompt),
                                        max_len=max_len)
        cache = jax_kv.fork_model_cache(trunk, batch)
        steps = prompt_len + batch * gen
    else:
        prompts = rng.randint(0, jcfg.vocab, (batch, prompt_len))
        logits, cache = jax_tfm.prefill(jp, jcfg, jnp.asarray(prompts),
                                        max_len=max_len)
        steps = batch * (prompt_len + gen)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    if tok.shape[0] == 1 and batch > 1:
        tok = jnp.repeat(tok, batch, 0)
    out = []
    for i in range(gen):
        logits, cache = jax_tfm.decode_step(jp, jcfg, cache, tok,
                                            jnp.int32(prompt_len + i))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(np.asarray(tok))
    return (np.concatenate(out, 1), np.asarray(logits), steps,
            jax_kv.cache_bytes(cache))


@pytest.mark.parametrize("shared", [False, True])
def test_serve_matches_the_jax_launcher(lm, shared):
    r = serve(ARCH, smoke=True, batch=3, prompt_len=12, gen=4,
              shared_prefix=shared, device="cpu", model=lm["model"])
    toks, jl, steps, nbytes = _jax_launcher(lm, 3, 12, 4, shared)
    np.testing.assert_array_equal(r["tokens"], toks)
    _close(r["logits"], jl)
    assert r["token_steps"] == steps == (12 + 3 * 4 if shared
                                         else 3 * (12 + 4))
    # 2 layers x (k, v) x batch 3 x 24 rows x 4 heads x 64 x 4 B
    assert r["cache_bytes"] == nbytes == 2 * 2 * 3 * 24 * 4 * 64 * 4


def test_shared_prefix_prefill_matches_jax_and_independent(lm):
    """Counts equal to the JAX function's; the forked KV caches (the
    stacked leaves forked on their batch axis) and the caught-up logits
    equal to JAX's and to the port's own independent prefill."""
    rng = np.random.RandomState(0)
    N, prefix, tail = 3, 14, 3
    tokens = np.concatenate([rng.randint(0, 512, (1, prefix)).repeat(N, 0),
                             rng.randint(0, 512, (N, tail))], axis=1)
    tokens[:, prefix] = [7, 8, 9]                  # tails differ at once
    (pf, df), (jpf, jdf) = _fns(lm)
    max_len = prefix + tail + 4
    logits, caches, pos, stats = shared_prefill.shared_prefix_prefill(
        pf, df, tokens, max_len=max_len)
    jl, jc, jpos, jstats = jax_sp.shared_prefix_prefill(
        jpf, jdf, tokens, max_len=max_len)
    assert stats == jstats and pos == jpos
    assert stats["prefix_len"] == prefix
    assert stats["token_steps"] == prefix + N * tail
    assert caches["blocks"]["l0"]["k"].shape == (2, N, max_len, 4, 64)
    _close(logits, jl)
    for name in ("k", "v"):
        _close(caches["blocks"]["l0"][name], jc["blocks"]["l0"][name])
    assert kvcache.cache_bytes(caches) == jax_kv.cache_bytes(jc)
    ref, _ = tfm.prefill(lm["model"], tokens)
    _close(logits, ref.numpy())


def test_fork_of_a_kv_cache_matches_jax(lm):
    _, cache = tfm.prefill(lm["model"], np.arange(9)[None], max_len=12)
    jcache = jax.tree.map(lambda t: jnp.asarray(t.numpy()), cache)
    forked = kvcache.fork_model_cache(cache, 3)
    jforked = jax_kv.fork_model_cache(jcache, 3)
    assert forked["blocks"]["l0"]["k"].shape == (2, 3, 12, 4, 64)
    for name in ("k", "v"):
        np.testing.assert_array_equal(forked["blocks"]["l0"][name].numpy(),
                                      np.asarray(jforked["blocks"]["l0"][name]))
    assert kvcache.cache_bytes(forked) == jax_kv.cache_bytes(jforked)


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
    are bitwise its miss's; the CRC of a KV payload is the JAX
    ``array_crc`` of the same bytes (leaves in ``jax.tree.leaves``
    order)."""
    rng = np.random.RandomState(5)
    groups = [np.concatenate([rng.randint(0, 512, (1, 10)).repeat(3, 0),
                              rng.randint(0, 512, (3, 2))], 1)
              for _ in range(2)]
    cents = np.random.RandomState(3).randn(2, 16)
    port_fns, jax_fns = _fns(lm)
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
    for tree in (payload, jax.tree.map(lambda t: t.to(torch.bfloat16),
                                       payload)):
        as_jax = jax.tree.map(lambda t: jnp.asarray(
            t.float().numpy(), jnp.dtype(str(t.dtype).split(".")[-1])), tree)
        assert faults.array_crc(tree) == jax_faults.array_crc(as_jax)


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_shared_prefill_llm", ROOT / "examples" / "shared_prefill_llm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _counts(text):
    """The example's output without its wall-clock figure."""
    return [line.split(" (")[0] if line.startswith("arch=") else line
            for line in text.splitlines()]


@pytest.mark.parametrize("cached", [False, True])
def test_example_prints_the_jax_examples_counts(monkeypatch, capsys, cached):
    argv = ["--groups", "3", "--members", "2", "--prefix", "8", "--tail",
            "2"] + (["--trunk-cache"] if cached else [])
    records = example.main(argv + ["--device", "cpu"])
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["shared_prefill_llm.py"] + argv)
    _jax_example().main()
    assert _counts(port) == _counts(capsys.readouterr().out)
    assert [r["stats"].get("trunk_cache_hit") for r in records] == (
        [False, False, True] if cached else [None] * 3)
    assert ("[cache hit]" in port) == cached
    for r in records:
        assert r["logits"].shape == (2, 1, 512)
        assert torch.isfinite(r["logits"]).all()


def test_example_serve_groups_takes_a_model(lm):
    """:func:`serve_groups` on a given model: one record a group, the
    JAX example's token draws (prefix_len 12, 12 + 2 x 3 token steps)."""
    logs = []
    records = example.serve_groups(lm["model"], groups=2, members=2,
                                   prefix=12, tail=3, log=logs.append)
    assert [r["stats"]["token_steps"] for r in records] == [18, 18]
    assert all(r["tokens"].shape == (2, 15) for r in records)
    assert records[0]["caches"]["blocks"]["l0"]["k"].shape == (2, 2, 47, 4,
                                                               64)
    assert len(logs) == 2 and logs[0].startswith("group 0: prefix=12")
    assert all(r["prefill_s"] > 0 and r["wall_s"] >= r["prefill_s"]
               for r in records)


def test_example_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        example.main(["--groups", "1"])


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports only the standard library
    at the top)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cached", [False, True])
def test_chip_smoke_llm_example_lines_are_the_examples(monkeypatch, capsys,
                                                       cached):
    """``chip_smoke.py``'s child process (the example's ``main()`` with its
    default flags, then the tokens its groups served): the group lines it
    prints are those ``llm_example_lines`` finds for those tokens."""
    cs = _chip_smoke()
    monkeypatch.setattr(sys, "argv", ["-c", "--device", "cpu"] + (
        ["--trunk-cache"] if cached else []))
    exec(cs.LLM_EXAMPLE_CHILD, {})
    printed, got, want = cs.llm_example_check(capsys.readouterr().out,
                                              cached)
    assert len(got) == 3 and got == want
    assert not any(ln.startswith("tokens ") for ln in printed)
    assert [("[cache hit]" in ln) for ln in got] == [False, False, cached]


@pytest.mark.parametrize("fault", [None, "bf16 decode one position early"])
def test_chip_smoke_prefill_decode_consistency(monkeypatch, capsys, fault):
    """``chip_smoke.py``'s prefill/decode check against ``forward_train``
    at smoke size in the config's bf16: a sound model passes, and a fault
    in the bf16 decode alone fails it (its bar comes from the bf16
    ``forward_train``, not from the pair under test)."""
    cs = _chip_smoke()
    cfg = replace(get_config(ARCH, smoke=True), attn_impl="kernel")
    model = tfm.LM(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    model.cast_weights_()
    if fault:
        real = tfm.decode_step

        def decode_step(m, cache, tok, pos, **kw):
            if m.cfg.dtype == "bfloat16":
                pos = pos - 1
            return real(m, cache, tok, pos, **kw)
        monkeypatch.setattr(tfm, "decode_step", decode_step)
    failures = []
    cs._prefill_decode_consistency("phi3 smoke", model, 24, failures)
    line = capsys.readouterr().out
    assert model.cfg.dtype == "bfloat16"
    assert ("FAIL" in line) == bool(fault) and len(failures) == int(
        bool(fault)), line


def test_chip_smoke_decode_bytes_bookkeeping_on_the_cpu(lm):
    """``chip_smoke.py``'s byte counts of a decode step: the in-place step
    (the decode graph's) moves at least the step's floor, and the
    functional step exactly the cache's copy (a read and a write) more."""
    cs, model = _chip_smoke(), lm["model"]
    prompts = np.random.RandomState(0).randint(0, 512, (2, 10))
    logits, cache = tfm.prefill(model, prompts, max_len=16)
    tok = logits.argmax(dim=-1)
    in_place, by_op = cs._op_bytes(lambda: tfm.decode_step(
        model, cache, tok, torch.tensor(10), out=cache))
    functional, _ = cs._op_bytes(lambda: tfm.decode_step(model, cache, tok,
                                                         10))
    floor = cs._decode_floor_bytes(model, 2, 10)
    cfg = lm["cfg"]
    n = sum(p.numel() for p in model.parameters())
    row = 2 * 2 * cfg.n_kv_heads * cfg.hd * 4 * cfg.n_layers
    assert floor == (4 * (n - model.embed.numel()) + 2 * cfg.d_model * 4
                     + row * 11 + row + 2 * cfg.vocab * 4)
    assert floor <= in_place < functional
    assert functional - in_place == 2 * kvcache.cache_bytes(cache)
    # the new K and V rows of every layer, read and written, and each
    # write's one-element int64 index
    assert by_op["index_copy_"] == 2 * row + 2 * cfg.n_layers * 8
    assert by_op["mm"] > 0
