"""The port's dense-family LM (GQA attention with a KV cache, dense SwiGLU
or GELU MLPs) held against the JAX package on the CPU, for each of the four
dense smoke configs (``phi3-mini-3.8b``: MHA; ``qwen3-32b``: GQA h8/2 with
qk_norm; ``qwen1.5-32b``: QKV bias; ``granite-20b``: MQA with a GELU MLP),
with ``transformer.init_params`` weights handed over through
``weights.lm_from_jax``.

Tolerance in f32: 1e-4 relative and 1e-5 absolute (``tests/
test_torch_ssm.py``'s bar; the frameworks sum in other orders, observed
errors ~5e-6).  In the configs' default bf16, the JAX arch test's 3e-2
(``tests/test_arch_smoke.py``).  Cache shapes and dtypes must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import replace as jax_replace
from repro.models import transformer as jax_tfm
from repro_torch import weights
from repro_torch.config import (ModelConfig, MoEConfig, RGLRUConfig,
                                get_config, replace)
from repro_torch.models import transformer as tfm

ARCHS = ("phi3-mini-3.8b", "qwen3-32b", "qwen1.5-32b", "granite-20b")
RTOL, ATOL = 1e-4, 1e-5
BF16_TOL = 3e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def live_params(arch, seed=0):
    """JAX init_params at the smoke config as numpy, with the
    zero-initialised norms and biases given seeded values so every term is
    live."""
    jcfg = jax_get_config(arch, smoke=True)
    params = jax.tree.map(np.asarray,
                          jax_tfm.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)

    def live(x):
        if x.size and not x.any():
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return x
    return jax.tree.map(live, params)


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    arch = request.param
    params = live_params(arch)
    jcfg = jax_replace(jax_get_config(arch, smoke=True), dtype="float32")
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    return dict(arch=arch, params=params, jcfg=jcfg, cfg=cfg,
                jp=jax.tree.map(jnp.asarray, params),
                model=weights.lm_from_jax(params, cfg, device="cpu"))


def _flat(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_close(got, want, rtol=RTOL, atol=ATOL):
    g = _flat(jax.tree.map(lambda t: t.float().numpy(), got))
    w = _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_allclose(g[k], np.asarray(w[k], np.float32),
                                   rtol=rtol, atol=atol, err_msg=k)


def _close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=rtol, atol=atol)


def _batch(vocab, seed=1, B=2, S=16):
    tokens = np.random.default_rng(seed).integers(0, vocab, (B, S))
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


def test_lm_from_jax_carries_the_dense_tree_leaf_for_leaf(lm):
    """Every leaf of the dense init_params tree lands on the port's
    parameter of the same dotted name (the stacked blocks split per
    layer), bitwise."""
    flat = weights._unstack_blocks(dict(weights._flatten(lm["params"])))
    got = dict(lm["model"].named_parameters())
    assert sorted(got) == sorted(flat)
    cfg = lm["cfg"]
    want = {"embed", "ln_f", "head", "blocks.1.l0.ln1", "blocks.1.l0.ln2",
            "blocks.0.l0.mix.wq", "blocks.0.l0.mix.wk", "blocks.0.l0.mix.wv",
            "blocks.0.l0.mix.wo", "blocks.0.l0.mlp.wi", "blocks.0.l0.mlp.wo"}
    want |= {"blocks.0.l0.mlp.wg"} if cfg.mlp_kind == "swiglu" else set()
    want |= ({f"blocks.0.l0.mix.b{c}" for c in "qkv"} if cfg.qkv_bias
             else set())
    want |= ({"blocks.0.l0.mix.q_norm", "blocks.0.l0.mix.k_norm"}
             if cfg.qk_norm else set())
    assert want <= set(got)
    for name, arr in flat.items():
        np.testing.assert_array_equal(got[name].detach().numpy(), arr,
                                      err_msg=name)


def test_forward_train_loss_and_grads_match_jax(lm):
    """``forward_train`` logits, ``lm_loss`` and its gradient leaf by leaf
    (the port's per-layer gradients stacked back over the layer axis); the
    remat gradients equal the plain ones."""
    model, batch = lm["model"], _batch(lm["cfg"].vocab)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits, _ = jax_tfm.forward_train(lm["jp"], lm["jcfg"],
                                       jbatch["tokens"])
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_tfm.lm_loss(p, lm["jcfg"], jbatch))(lm["jp"])
    with torch.no_grad():
        logits, aux = tfm.forward_train(model, batch["tokens"])
    _close(logits, jlogits)
    assert float(aux) == 0.0
    grads = {}
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        loss = tfm.lm_loss(model, batch, remat=remat)
        loss.backward()
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()}
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    model.zero_grad(set_to_none=True)
    want = weights._unstack_blocks(dict(weights._flatten(
        jax.tree.map(np.asarray, jgrads))))
    assert sorted(grads[False]) == sorted(want)
    for name, g in grads[False].items():
        scale = float(np.abs(want[name]).max())
        np.testing.assert_allclose(g.numpy(), want[name], rtol=RTOL,
                                   atol=ATOL * max(scale, 1e-3),
                                   err_msg=name)
        torch.testing.assert_close(grads[True][name], g, rtol=1e-6,
                                   atol=1e-7 * max(scale, 1e-3), msg=name)


def test_prefill_and_decode_steps_match_jax(lm):
    """``prefill`` logits and every cache leaf, then five ``decode_step``s
    (positions as ints and as 0-dim tensors), each step's logits and
    cache."""
    model, jp, jcfg = lm["model"], lm["jp"], lm["jcfg"]
    tokens = np.random.default_rng(2).integers(0, lm["cfg"].vocab, (2, 18))
    logits, cache = tfm.prefill(model, tokens[:, :13], max_len=20)
    jl, jc = jax_tfm.prefill(jp, jcfg, jnp.asarray(tokens[:, :13]),
                             max_len=20)
    assert cache["blocks"]["l0"]["k"].shape == (
        lm["cfg"].n_layers, 2, 20, lm["cfg"].n_kv_heads, lm["cfg"].hd)
    assert float(np.abs(np.asarray(jl)).std()) > 1e-2
    _close(logits, jl)
    _assert_trees_close(cache, jc)
    for pos in range(13, 18):
        tok = tokens[:, pos:pos + 1]
        p = pos if pos % 2 else torch.tensor(pos)
        logits, cache = tfm.decode_step(model, cache, tok, p)
        jl, jc = jax_tfm.decode_step(jp, jcfg, jc, jnp.asarray(tok),
                                     jnp.int32(pos))
        _close(logits, jl)
        _assert_trees_close(cache, jc)


def test_decode_from_init_cache_matches_jax(lm):
    """``init_cache`` (zeros, the JAX tree's shapes and dtypes) and six
    decode steps from it; the last logits also match ``forward_train``'s at
    that position."""
    model, jp, jcfg = lm["model"], lm["jp"], lm["jcfg"]
    tokens = np.random.default_rng(3).integers(0, lm["cfg"].vocab, (2, 6))
    cache = tfm.init_cache(model, 2, 10)
    jc = jax_tfm.init_cache(jcfg, 2, 10)
    _assert_trees_close(cache, jc, rtol=0, atol=0)
    for i in range(6):
        tok = tokens[:, i:i + 1]
        logits, cache = tfm.decode_step(model, cache, tok, i)
        jl, jc = jax_tfm.decode_step(jp, jcfg, jc, jnp.asarray(tok),
                                     jnp.int32(i))
        _close(logits, jl)
    _assert_trees_close(cache, jc)
    full, _ = tfm.forward_train(model, tokens)
    _close(logits[:, 0], full[:, 5].detach(), rtol=1e-4, atol=1e-4)


def test_bf16_prefill_decode_consistency_and_jax(lm):
    """In the config's bf16: prefill(S-1) then decode(S) against
    ``forward_train`` at S-2 and S-1 (the JAX arch test, 3e-2); and the
    port's bf16 logits held, as JAX's own, against JAX's f32 logits: the
    port's mean error no more than 1.25x JAX's plus 1e-3 (the two round at
    other places; ``tests/test_torch_lm_serving.py``'s bar)."""
    cfg = get_config(lm["arch"], smoke=True)
    jcfg = jax_get_config(lm["arch"], smoke=True)
    assert cfg.dtype == "bfloat16"
    model = weights.lm_from_jax(lm["params"], cfg, device="cpu")
    model.cast_weights_()
    tokens = _batch(cfg.vocab, seed=4)["tokens"]
    S = tokens.shape[1]
    with torch.no_grad():
        full, _ = tfm.forward_train(model, tokens)
    last, cache = tfm.prefill(model, tokens[:, :S - 1], max_len=S + 4)
    dec, _ = tfm.decode_step(model, cache, tokens[:, S - 1:], S - 1)
    assert dec.dtype == torch.bfloat16
    for got, col in ((last, S - 2), (dec, S - 1)):
        np.testing.assert_allclose(got[:, 0].float().numpy(),
                                   full[:, col].float().numpy(),
                                   rtol=BF16_TOL, atol=BF16_TOL)

    def run_jax(c):
        jl, jc = jax_tfm.prefill(lm["jp"], c, jnp.asarray(tokens[:, :S - 1]),
                                 max_len=S + 4)
        jd, _ = jax_tfm.decode_step(lm["jp"], c, jc,
                                    jnp.asarray(tokens[:, S - 1:]),
                                    jnp.int32(S - 1))
        return np.concatenate([np.asarray(jl, np.float32),
                               np.asarray(jd, np.float32)], 1)
    want = run_jax(lm["jcfg"])
    jax_err = float(np.abs(run_jax(jcfg) - want).mean())
    port = torch.cat([last, dec], 1).float().numpy()
    port_err = float(np.abs(port - want).mean())
    assert 0 < jax_err < 0.1                       # bf16 really was in play
    assert port_err <= 1.25 * jax_err + 1e-3, (port_err, jax_err)


@pytest.mark.parametrize("family,extra", [
    ("moe", {}), ("hybrid", {"pattern": ("rglru", "rglru", "local_attn")}),
    ("vlm", {"pattern": ("attn",) * 4 + ("cross_attn",)}),
    ("encdec", {})])
def test_unported_families_still_raise(family, extra):
    """The families ported since the dense slice (the hybrid, MoE, the VLM
    and encdec) build, prefill (the VLM over image embeddings, encdec over
    frames) and serve one decode step on the CPU; none raises any more."""
    n = len(extra.get("pattern", ())) or 2
    if family == "moe":
        extra = {"moe": MoEConfig(n_routed=4, top_k=2, d_ff_expert=32,
                                  n_shared=1, first_moe_layer=1,
                                  d_ff_dense=128)}
    if family == "hybrid":
        extra = dict(extra, rglru=RGLRUConfig(lru_width=64), window=8)
    if family == "vlm":
        extra = dict(extra, n_image_tokens=3, vision_dim=16)
    if family == "encdec":
        extra = dict(extra, enc_layers=1, enc_input_dim=16)
    cfg = ModelConfig(name=f"{family}-test", family=family, n_layers=n,
                      d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                      vocab=32, **extra)
    extras = ({"image_embeds": np.ones((1, 3, 16), np.float32)}
              if family == "vlm" else
              {"frames": np.ones((1, 5, 16), np.float32)}
              if family == "encdec" else None)
    model = tfm.LM(cfg, device="cpu")
    _, cache = tfm.prefill(model, np.arange(6)[None] % cfg.vocab, extras,
                           max_len=10)
    logits, cache = tfm.decode_step(model, cache, np.array([[3]]), 6)
    assert logits.shape == (1, 1, cfg.vocab)
    assert torch.isfinite(logits).all()
