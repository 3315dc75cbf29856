"""The port's cross-attention LMs held against the JAX package on the CPU
at their smoke configs: the VLM (``llama-3.2-vision-11b``: ``(attn x4,
cross_attn)`` super-blocks attending to projected image embeddings) and
encdec (``seamless-m4t-large-v2``: a bidirectional encoder over frame
embeddings, then ``cross_attn`` decoder layers), with
``transformer.init_params`` weights handed over through
``weights.lm_from_jax``.

Per config: the configs and ``n_params``; the weight tree leaf for leaf
(``proj``, ``enc_in``, ``enc_blocks.*``, ``enc_ln``, ``lnx``, ``xattn.*``)
and the bridge's refusals; ``forward_train``, ``lm_loss`` and the
first-step gradients leaf by leaf, ``remat`` bitwise; the memory
(``encode`` alone); ``prefill`` and ``decode_step`` with and without a
window; ``init_cache``; the launcher in both modes; ``fork_model_cache``;
``shared_prefix_prefill`` and ``cached_prefix_prefill`` with the payload
CRC; a decode step that passes the memory K/V on without copying them;
the decode runner; a bf16 prefill/decode pair.

Every comparison but the launcher's feeds seeded non-zero ``image_embeds``
or ``frames``: the launcher's memory is zeros, and with bias-free layers a
zero memory makes each cross-attention add exactly 0, in both packages
(``test_zero_extras_make_each_cross_block_add_exactly_zero``), so its
tokens cannot show a broken cross path.

Tolerance in f32: 1e-4 relative and 1e-5 absolute (``tests/
test_torch_lm_hybrid_moe.py``'s bar), gradients scaled by each leaf's
largest; greedy tokens, token steps, cache shapes and dtypes, cache bytes,
CRCs and the trunk cache's ledger exactly.  The JAX functions are jitted
once a config.
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
from repro.models import transformer as jax_tfm
from repro.models.layers import rms_norm as jax_rms_norm
from repro.serving import faults as jax_faults
from repro.serving import kvcache as jax_kv
from repro.serving import shared_prefill as jax_sp
from repro.serving.trunk_cache import TrunkCache as JaxTrunkCache
from repro_torch import weights
from repro_torch.config import get_config, replace
from repro_torch.launch.serve import launcher_extras, serve
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import rms_norm
from repro_torch.serving import faults, kvcache, runners, shared_prefill
from repro_torch.serving.trunk_cache import TrunkCache

RTOL, ATOL = 1e-4, 1e-5
# the bf16 pair against the f32 forward_train: within these multiples of
# the bf16 forward_train's own largest and mean error (tests/
# test_torch_lm_dense.py's and chip_smoke.DENSE_BF16's bar)
BF16_BAR = {"max": 1.5, "mean": 1.25}
ARCHS = {"vlm": "llama-3.2-vision-11b", "encdec": "seamless-m4t-large-v2"}
#: the memory's rows in the seeded extras (frames for encdec)
N_FRAMES = 12
#: the launcher's cache rows (a 12-token prompt, 4 steps, 8 spare), which
#: the other JAX calls share so that each jitted function compiles once a
#: shape
PROMPT, GEN = 12, 4
MAX_LEN = PROMPT + GEN + 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _extras(cfg, batch, seed):
    """Seeded non-zero memory inputs: the VLM's image embeddings or
    encdec's frames."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"image_embeds": rng.standard_normal(
            (batch, cfg.n_image_tokens, cfg.vision_dim)).astype(np.float32)}
    return {"frames": rng.standard_normal(
        (batch, N_FRAMES, cfg.enc_input_dim)).astype(np.float32)}


def _jx(extras):
    return {k: jnp.asarray(v) for k, v in extras.items()}


@pytest.fixture(scope="module", params=list(ARCHS))
def family(request):
    return request.param


@pytest.fixture(scope="module")
def lm(family):
    """JAX ``init_params`` at the smoke config in f32 (zero-initialised
    norms given seeded values), the port's model on the same weights, the
    seeded extras of batch 2, and the JAX functions jitted once."""
    arch = ARCHS[family]
    jcfg = jax_replace(jax_get_config(arch, smoke=True), dtype="float32")
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    params = jax.tree.map(np.asarray,
                          jax_tfm.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda x: (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if x.size and not x.any() else x, params)
    jp = jax.tree.map(jnp.asarray, params)
    return dict(
        family=family, arch=arch, cfg=cfg, jcfg=jcfg, params=params,
        jp=jp, model=weights.lm_from_jax(params, cfg, device="cpu"),
        extras=_extras(cfg, 2, 2),
        jforward=jax.jit(lambda p, t, ex: jax_tfm.forward_train(p, jcfg, t,
                                                                ex)),
        jprefill=jax.jit(lambda t, ex, m, w: jax_tfm.prefill(
            jp, jcfg, t, ex, max_len=m, window=w), static_argnums=(2, 3)),
        jdecode=jax.jit(lambda c, t, p, r: jax_tfm.decode_step(
            jp, jcfg, c, t, p, ring=r), static_argnums=3))


def _flat(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_close(got, want, rtol=RTOL, atol=ATOL):
    g, w = _flat(got), _flat(want)
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


def _cross_layers(model):
    return [layer for bm in model.blocks for layer in bm.values()
            if layer.kind == "cross_attn"]


@pytest.mark.parametrize("smoke", [False, True])
def test_configs_and_n_params_match_jax(family, smoke):
    """Every field of ``full()`` and ``smoke()`` as the JAX package
    registers it, and the analytic parameter count (10,115,973,120 for the
    VLM, 1,532,489,728 for seamless); at smoke size the port's module
    holds exactly as many parameters as the JAX tree."""
    arch = ARCHS[family]
    cfg, jcfg = get_config(arch, smoke=smoke), jax_get_config(arch,
                                                              smoke=smoke)
    want = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
            if f.name != "kernel_interpret"}
    assert dataclasses.asdict(cfg) == want
    assert cfg.n_params() == jcfg.n_params()
    if not smoke:
        assert cfg.n_params() == {"llama-3.2-vision-11b": 10_115_973_120,
                                  "seamless-m4t-large-v2": 1_532_489_728
                                  }[arch]
        return
    model = tfm.LM(cfg, device="cpu")
    tree = jax.eval_shape(lambda: jax_tfm.init_params(
        jcfg, jax.random.PRNGKey(0)))
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))


def test_every_registered_lm_config_builds():
    """The port registers every config the JAX package does; each LM
    family's smoke model builds (its full config plans) and reads its
    decode position where it keeps an attention cache; only the ``dit``
    family, which is not an LM, is refused."""
    from repro.config import list_archs as jax_list_archs
    from repro_torch.config import list_archs
    assert list(list_archs()) == list(jax_list_archs())
    for arch in list_archs():
        cfg = get_config(arch, smoke=True)
        if cfg.family == "dit":
            with pytest.raises(NotImplementedError, match="not an LM"):
                tfm.plan(get_config(arch))
            continue
        tfm.plan(get_config(arch))
        model = tfm.LM(cfg, device="cpu")
        assert sum(p.numel() for p in model.parameters()) > 0
        assert tfm.uses_pos(cfg) == (cfg.family != "ssm")


def test_lm_from_jax_carries_the_tree_leaf_for_leaf(lm):
    """Every leaf of the init_params tree, the stacked ``enc_blocks`` split
    per layer as ``blocks`` are, lands on the port's parameter of the same
    dotted name, bitwise; both families read their decode position."""
    flat = weights._unstack_blocks(dict(weights._flatten(lm["params"])))
    got = dict(lm["model"].named_parameters())
    assert sorted(got) == sorted(flat)
    cross = "blocks.0.l4" if lm["family"] == "vlm" else "blocks.1.l0"
    want = {f"{cross}.lnx", f"{cross}.xattn.wq", f"{cross}.xattn.wk",
            f"{cross}.xattn.wv", f"{cross}.xattn.wo", f"{cross}.mix.wq"}
    want |= ({"proj"} if lm["family"] == "vlm" else
             {"enc_in", "enc_ln", "enc_blocks.0.l0.ln1",
              "enc_blocks.1.l0.mix.wq", "enc_blocks.1.l0.mlp.wo"})
    assert want <= set(got)
    for name, arr in flat.items():
        np.testing.assert_array_equal(got[name].detach().numpy(), arr,
                                      err_msg=name)
    assert tfm.uses_pos(lm["cfg"])


def test_lm_from_jax_refuses_a_missing_or_misshapen_leaf(lm):
    """The encoder's stacked leaves split on their layer axis (a tree whose
    ``enc_blocks`` stayed stacked would not load), and a tree without one
    of the new leaves, or with one misshapen, is refused."""
    flat = weights._unstack_blocks(dict(weights._flatten(lm["params"])))
    cfg = lm["cfg"]
    if cfg.family == "encdec":
        assert "enc_blocks.l0.ln1" not in flat
        assert flat["enc_blocks.1.l0.ln1"].shape == (cfg.d_model,)
    leaf = "proj" if cfg.family == "vlm" else "enc_in"
    params = dict(lm["params"])
    del params[leaf]
    with pytest.raises(KeyError, match=leaf):
        weights.lm_from_jax(params, cfg, device="cpu")
    params = dict(lm["params"], **{leaf: lm["params"][leaf][:-1]})
    with pytest.raises(ValueError, match=leaf):
        weights.lm_from_jax(params, cfg, device="cpu")
    blocks = jax.tree.map(lambda x: x, lm["params"]["blocks"])
    cross = "l4" if cfg.family == "vlm" else "l0"
    del blocks[cross]["lnx"]
    with pytest.raises(KeyError, match="lnx"):
        weights.lm_from_jax(dict(lm["params"], blocks=blocks), cfg,
                            device="cpu")


def test_forward_train_loss_and_grads_match_jax(lm):
    """``forward_train`` logits and aux (0), ``lm_loss`` with the extras
    riding in the batch and its gradient leaf by leaf (the memory's
    ``proj`` / encoder leaves and the cross blocks' included); ``remat``
    gives the same loss and gradients bitwise."""
    model, jcfg = lm["model"], lm["jcfg"]
    tokens = np.random.default_rng(1).integers(0, lm["cfg"].vocab, (2, 16))
    batch = dict(lm["extras"], tokens=tokens,
                 labels=np.roll(tokens, -1, axis=1))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits, jaux = lm["jforward"](lm["jp"], jbatch["tokens"],
                                   _jx(lm["extras"]))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_tfm.lm_loss(p, jcfg, jbatch)))(lm["jp"])
    with torch.no_grad():
        logits, aux = tfm.forward_train(model, tokens, lm["extras"])
    _close(logits, jlogits)
    assert float(aux) == float(jaux) == 0.0
    grads, losses = {}, {}
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        loss = tfm.lm_loss(model, batch, remat=remat)
        loss.backward()
        losses[remat] = loss.detach()
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    np.testing.assert_allclose(losses[False].item(), float(jloss), rtol=RTOL)
    assert torch.equal(losses[True], losses[False])
    want = weights._unstack_blocks(dict(weights._flatten(
        jax.tree.map(np.asarray, jgrads))))
    assert sorted(grads[False]) == sorted(want)
    for name, g in grads[False].items():
        scale = float(np.abs(want[name]).max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), want[name], rtol=RTOL,
                                   atol=ATOL * max(scale, 1e-3),
                                   err_msg=name)
        assert torch.equal(grads[True][name], g), name


def test_memory_and_encode_match_jax(lm):
    """The memory the cross layers attend to: the projected image
    embeddings, or ``encode`` alone (bidirectional, RoPE'd self-attention
    over the frames)."""
    model, jp, jcfg = lm["model"], lm["jp"], lm["jcfg"]
    with torch.no_grad():
        got = tfm._memory(model, lm["extras"])
    want = jax_tfm._memory(jp, jcfg, _jx(lm["extras"]))
    _close(got, want)
    if lm["family"] == "encdec":
        frames = lm["extras"]["frames"]
        with torch.no_grad():
            enc = tfm.encode(model, frames)
        _close(enc, jax_tfm.encode(jp, jcfg, jnp.asarray(frames)))
        # bidirectional: the first frame's output reads the last frame
        moved = frames.copy()
        moved[:, -1] += 1.0
        with torch.no_grad():
            assert not torch.equal(tfm.encode(model, moved)[:, 0], enc[:, 0])


@pytest.mark.parametrize("window", [0, 8])
def test_prefill_and_decode_steps_match_jax(lm, window):
    """``prefill`` last logits and every cache leaf (the self K/V and the
    memory's cross K/V), then 4 ``decode_step``s (positions as ints and as
    0-dim tensors), each step's logits and cache; with a window of 8 the
    10-token prompt lays the self caches out as rings, which the steps
    continue."""
    model, cfg = lm["model"], lm["cfg"]
    S, max_len = 10, MAX_LEN
    tokens = np.random.default_rng(S + window).integers(0, cfg.vocab,
                                                        (2, S + 4))
    logits, cache = tfm.prefill(model, tokens[:, :S], lm["extras"],
                                max_len=max_len, window=window)
    jl, jc = lm["jprefill"](jnp.asarray(tokens[:, :S]), _jx(lm["extras"]),
                            max_len, window)
    layer = "l4" if lm["family"] == "vlm" else "l0"
    rows = cfg.n_image_tokens if lm["family"] == "vlm" else N_FRAMES
    assert cache["blocks"][layer]["cross"]["k"].shape == (
        len(model.blocks), 2, rows, cfg.n_kv_heads, cfg.hd)
    assert cache["blocks"][layer]["self"]["k"].shape[2] == (window
                                                            or max_len)
    _close(logits, jl)
    _assert_trees_close(cache, jc)
    for pos in range(S, S + 4):
        tok = tokens[:, pos:pos + 1]
        p = pos if pos % 2 else torch.tensor(pos)
        logits, cache = tfm.decode_step(model, cache, tok, p,
                                        ring=bool(window))
        jl, jc = lm["jdecode"](jc, jnp.asarray(tok), jnp.int32(pos),
                               bool(window))
        _close(logits, jl)
        _assert_trees_close(cache, jc)


def test_init_cache_matches_jax(lm):
    """``init_cache``: the JAX tree's structure, shapes and dtypes, all
    zeros, the memory K/V of ``n_image_tokens`` rows (16, the VLM) or
    ``_ENC_LEN`` (4096, encdec); a decode step from it matches JAX's."""
    cache = tfm.init_cache(lm["model"], 2, MAX_LEN)
    jc = jax_tfm.init_cache(lm["jcfg"], 2, MAX_LEN)
    _assert_trees_close(cache, jc, rtol=0, atol=0)
    layer = "l4" if lm["family"] == "vlm" else "l0"
    n_mem = {"vlm": 16, "encdec": 4096}[lm["family"]]
    assert cache["blocks"][layer]["cross"]["k"].shape[2] == n_mem
    tok = np.array([[5], [7]])
    logits, cache = tfm.decode_step(lm["model"], cache, tok, 0)
    jl, jc = lm["jdecode"](jc, jnp.asarray(tok), jnp.int32(0), False)
    _close(logits, jl)
    _assert_trees_close(cache, jc)


def _jax_launcher(lm, batch, prompt_len, gen, shared):
    """The JAX launcher's loop (``src/repro/launch/serve.py:37-72``, its
    zero extras) on the same weights: greedy tokens, last logits, token
    steps and cache bytes."""
    rng = np.random.RandomState(0)
    max_len = prompt_len + gen + 8
    jcfg = lm["jcfg"]
    extras = {}
    if jcfg.family == "vlm":
        extras["image_embeds"] = jnp.zeros(
            (batch, jcfg.n_image_tokens, jcfg.vision_dim))
    if jcfg.family == "encdec":
        extras["frames"] = jnp.zeros((batch, 32, jcfg.enc_input_dim))
    if shared:
        prompt = rng.randint(0, jcfg.vocab, (1, prompt_len))
        logits, trunk = lm["jprefill"](
            jnp.asarray(prompt), {k: v[:1] for k, v in extras.items()},
            max_len, 0)
        cache = jax_kv.fork_model_cache(trunk, batch)
        steps = prompt_len + batch * gen
    else:
        prompts = rng.randint(0, jcfg.vocab, (batch, prompt_len))
        logits, cache = lm["jprefill"](jnp.asarray(prompts), extras,
                                       max_len, 0)
        steps = batch * (prompt_len + gen)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    if tok.shape[0] == 1 and batch > 1:
        tok = jnp.repeat(tok, batch, 0)
    out = []
    for i in range(gen):
        logits, cache = lm["jdecode"](cache, tok, jnp.int32(prompt_len + i),
                                      False)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(np.asarray(tok))
    return (np.concatenate(out, 1), np.asarray(logits), steps,
            jax_kv.cache_bytes(cache))


@pytest.mark.parametrize("shared", [False, True])
def test_serve_matches_the_jax_launcher(lm, shared):
    """``serve(..., device="cpu")`` on the JAX launcher's zero extras:
    greedy tokens, last logits, token steps and cache bytes (the memory's
    K/V of 16 image tokens or 32 frames included)."""
    r = serve(lm["arch"], smoke=True, batch=3, prompt_len=PROMPT, gen=GEN,
              shared_prefix=shared, device="cpu", model=lm["model"])
    toks, jl, steps, nbytes = _jax_launcher(lm, 3, PROMPT, GEN, shared)
    np.testing.assert_array_equal(r["tokens"], toks)
    _close(r["logits"], jl)
    assert r["token_steps"] == steps == (PROMPT + 3 * GEN if shared
                                         else 3 * (PROMPT + GEN))
    assert r["cache_bytes"] == nbytes


def test_zero_extras_make_each_cross_block_add_exactly_zero(lm):
    """The launcher's zero image embeddings or frames give a memory of
    zeros (the encoder's too: its layers have no bias), so every cross K/V
    and every cross block's output is exactly 0, in both packages, for a
    prefill and a decode step alike."""
    model, jp, jcfg, cfg = lm["model"], lm["jp"], lm["jcfg"], lm["cfg"]
    extras = launcher_extras(cfg, 2)
    with torch.no_grad():
        memory = tfm._memory(model, extras)
    jmemory = jax_tfm._memory(jp, jcfg, _jx(extras))
    assert not memory.any() and not np.asarray(jmemory).any()
    hx = torch.randn((2, 5, cfg.d_model), generator=torch.Generator(
        ).manual_seed(3))
    jblocks = jax.tree.map(lambda x: x, jp["blocks"])
    name = "l4" if cfg.family == "vlm" else "l0"
    for i, layer in enumerate(_cross_layers(model)):
        with torch.no_grad():
            xkv = attn.gqa_cross_cache(layer.xattn, cfg, memory)
            full = attn.gqa_full(layer.xattn, cfg, hx, causal=False,
                                 memory=memory)
            step = attn.gqa_cross_decode(layer.xattn, cfg, hx[:, :1], xkv)
        jx = jax.tree.map(lambda x: x[i], jblocks[name]["xattn"])
        jfull = jax_attn.gqa_full(jx, jcfg, jnp.asarray(hx.numpy()),
                                  causal=False, memory=jmemory)
        jxkv = jax_attn.gqa_cross_cache(jx, jcfg, jmemory)
        assert all(not t.any() for t in xkv.values())
        assert not full.any() and not step.any()
        assert not np.asarray(jfull).any()
        assert all(not np.asarray(t).any() for t in jxkv.values())
    tokens = np.arange(6)[None].repeat(2, 0) % cfg.vocab
    _, cache = tfm.prefill(model, tokens, extras, max_len=8)
    assert not cache["blocks"][name]["cross"]["k"].any()
    # the cross layer's norm in both packages, on the same input
    h = rms_norm(hx, _cross_layers(model)[0].lnx, cfg.rms_eps)
    jh = jax_rms_norm(jnp.asarray(hx.numpy()),
                      jblocks[name]["lnx"][0], jcfg.rms_eps)
    _close(h, jh)


def test_fork_of_the_cache_matches_jax(lm):
    """The stacked block leaves (the nested ``self`` and ``cross`` K/V)
    forked on their batch axis, as JAX forks them; the bytes as JAX
    counts them."""
    one = {k: v[:1] for k, v in lm["extras"].items()}
    _, cache = tfm.prefill(lm["model"], np.arange(9)[None], one, max_len=12)
    jcache = jax.tree.map(lambda t: jnp.asarray(t.numpy()), cache)
    forked = kvcache.fork_model_cache(cache, 3)
    jforked = jax_kv.fork_model_cache(jcache, 3)
    g, w = _flat(forked), _flat(jforked)
    assert sorted(g) == sorted(w) and any("cross" in k for k in g)
    for k in w:
        np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]),
                                      err_msg=k)
    assert kvcache.cache_bytes(forked) == jax_kv.cache_bytes(jforked)


def _cached_run(mod, cache, fns, groups, order, cents):
    prefill_fn, decode_fn = fns
    out = []
    for g in order:
        logits, caches, _, st = mod.cached_prefix_prefill(
            prefill_fn, decode_fn, groups[g], MAX_LEN, cache=cache,
            centroid=cents[g])
        out.append((logits, caches, st))
    return out


def test_shared_and_cached_prefix_prefill_match_jax(lm):
    """Two groups of 3 (a 12-token shared prefix, 2-token tails), the
    memory of one request riding in the ``prefill_fn`` closure as in JAX:
    ``shared_prefix_prefill`` per group (logits, token steps), then
    ``cached_prefix_prefill`` over g0, g1, g0, g1 through a trunk cache of
    one payload on the device and two on the host: the same hits, misses,
    spills and promotions, token steps and logits; a hit's logits and
    caches bitwise its miss's; the payload's CRC (its ``cross`` K/V before
    ``self``, JAX's leaf order) is the JAX ``array_crc`` of the same
    bytes."""
    model = lm["model"]
    vocab = lm["cfg"].vocab
    rng = np.random.RandomState(5)
    groups = [np.concatenate([rng.randint(0, vocab, (1, PROMPT)).repeat(3, 0),
                              rng.randint(0, vocab, (3, 2))], 1)
              for _ in range(2)]
    cents = np.random.RandomState(3).randn(2, 16)
    one = {k: v[:1] for k, v in lm["extras"].items()}
    port_fns = (lambda t, m: tfm.prefill(model, t, one, max_len=m),
                lambda c, t, p: tfm.decode_step(model, c, t, p))
    jax_fns = (lambda t, m: lm["jprefill"](jnp.asarray(t), _jx(one), m, 0),
               lambda c, t, p: lm["jdecode"](c, jnp.asarray(t),
                                             jnp.int32(p), False))
    for tokens in groups:
        lg, _, nxt, st = shared_prefill.shared_prefix_prefill(
            *port_fns, tokens, MAX_LEN)
        jl, _, jnxt, jst = jax_sp.shared_prefix_prefill(*jax_fns, tokens,
                                                        MAX_LEN)
        _close(lg, jl)
        assert (nxt, st) == (jnxt, jst)
        assert st["token_steps"] == PROMPT + 3 * 2
    payload = port_fns[0](groups[0][:1, :PROMPT], MAX_LEN)
    nbytes = kvcache.cache_bytes(payload)
    assert nbytes == jax_kv.cache_bytes(jax_fns[0](groups[0][:1, :PROMPT],
                                                   MAX_LEN))
    cache = TrunkCache(tau_trunk=0.9, max_bytes=nbytes, host_bytes=2 * nbytes)
    jcache = JaxTrunkCache(tau_trunk=0.9, max_bytes=nbytes,
                           host_bytes=2 * nbytes)
    order = (0, 1, 0, 1)
    got = _cached_run(shared_prefill, cache, port_fns, groups, order, cents)
    want = _cached_run(jax_sp, jcache, jax_fns, groups, order, cents)
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


def test_decode_step_passes_the_memory_kv_on_uncopied(lm):
    """A decode step reads the memory K/V and never writes them: in place
    (``out=cache``, as the decode graph runs it) the new cache holds the
    same tensors and nothing is written into them (their version counters
    stand still while the self K/V's move); the functional step writes a
    new self cache and passes the cross K/V on as they are; into another
    cache's tensors it copies them, with their values."""
    model = lm["model"]
    tokens = np.random.default_rng(6).integers(0, lm["cfg"].vocab, (2, 9))
    logits, cache = tfm.prefill(model, tokens, lm["extras"], max_len=14)
    tok = logits.argmax(-1)
    layer = "l4" if lm["family"] == "vlm" else "l0"
    blk = cache["blocks"][layer]
    xk, xv = blk["cross"]["k"], blk["cross"]["v"]
    versions = (xk._version, xv._version, blk["self"]["k"]._version)
    want, _ = tfm.decode_step(model, cache, tok, 9)
    got, new = tfm.decode_step(model, cache, tok, torch.tensor(9), out=cache)
    assert torch.equal(got, want)
    assert new["blocks"][layer]["cross"]["k"] is xk
    assert new["blocks"][layer]["cross"]["v"] is xv
    assert (xk._version, xv._version) == versions[:2]
    assert blk["self"]["k"]._version > versions[2]
    _, fresh = tfm.decode_step(model, cache, tok, 10)
    assert fresh["blocks"][layer]["cross"]["k"] is xk
    assert fresh["blocks"][layer]["self"]["k"] is not blk["self"]["k"]
    assert (xk._version, xv._version) == versions[:2]
    other = kvcache._map(torch.zeros_like, cache)
    _, into = tfm.decode_step(model, cache, tok, 10, out=other)
    assert into["blocks"][layer]["cross"]["v"] is (
        other["blocks"][layer]["cross"]["v"])
    assert torch.equal(into["blocks"][layer]["cross"]["v"], xv)


class _CpuGraph:
    """A stand-in for a captured graph on the CPU: a replay reruns the
    function on the static inputs and writes into the capture's
    outputs."""

    def __init__(self, fn, args, out):
        self.fn, self.args, self.out = fn, args, out

    def replay(self):
        new = self.fn(*self.args)
        for o, n in zip(kvcache._leaves(self.out), kvcache._leaves(new)):
            if isinstance(o, torch.Tensor) and o.data_ptr() != n.data_ptr():
                o.copy_(n)


def test_decode_runner_matches_eager_decode(lm, monkeypatch):
    """``DecodeRunner`` (graphs stood in for on the CPU) over a forked
    trunk: each step's logits and the set's cache bitwise the eager
    ``decode_step``'s, one graph for every position, the memory K/V
    joining the static set once; a step without its position raises."""
    def record(fn, args):
        out = fn(*args)
        return _CpuGraph(fn, args, out), out
    monkeypatch.setattr(runners, "_warm_up", lambda fn, args: fn(*args))
    monkeypatch.setattr(runners, "_record", record)
    monkeypatch.setattr(runners, "kernel_symbols", lambda g: [])
    model = lm["model"]
    one = {k: v[:1] for k, v in lm["extras"].items()}
    tokens = np.random.RandomState(3).randint(0, lm["cfg"].vocab, (1, 11))
    logits, trunk = tfm.prefill(model, tokens, one, max_len=19)
    cache = kvcache.fork_model_cache(trunk, 2)
    run = runners.DecodeRunner(model)
    tok = logits.argmax(-1).repeat_interleave(2, 0)
    eager, graph = cache, cache
    for i in range(5):
        want, eager = tfm.decode_step(model, eager, tok, 11 + i)
        got, graph = run(graph, tok, 11 + i)
        assert torch.equal(got, want)
        for a, b in zip(kvcache._leaves(graph), kvcache._leaves(eager)):
            assert torch.equal(a, b)
        tok = want.argmax(-1)
    assert len(run.graphs) == 1 and run.replays == 5
    with pytest.raises(ValueError, match="position"):
        run(graph, tok)


def test_bf16_prefill_decode_against_the_f32_forward_train(lm):
    """In bf16 (the config's dtype, weights cast once): prefill(S-1) then
    decode(S) held against the f32 ``forward_train`` at S-2 and S-1,
    within 1.5x the largest and 1.25x the mean error of the bf16
    ``forward_train`` against the same f32 logits."""
    model, cfg = lm["model"], lm["cfg"]
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 16))
    S = tokens.shape[1]
    with torch.no_grad():
        ref32, _ = tfm.forward_train(model, tokens, lm["extras"])
    ref32 = ref32[:, S - 2:]
    model.cfg = replace(cfg, dtype="bfloat16")
    try:
        model.cast_weights_()
        with torch.no_grad():
            own, _ = tfm.forward_train(model, tokens, lm["extras"])
        last, cache = tfm.prefill(model, tokens[:, :S - 1], lm["extras"],
                                  max_len=S + 4)
        dec, _ = tfm.decode_step(model, cache, tokens[:, S - 1:], S - 1)
    finally:
        model.cfg = cfg
    assert dec.dtype == torch.bfloat16
    pair = (torch.cat([last, dec], 1).float() - ref32).abs()
    bf16 = (own[:, S - 2:].float() - ref32).abs()
    assert 0 < bf16.mean() < 0.1                   # bf16 really was in play
    assert pair.max() <= BF16_BAR["max"] * bf16.max(), (pair.max(),
                                                        bf16.max())
    assert pair.mean() <= BF16_BAR["mean"] * bf16.mean(), (pair.mean(),
                                                           bf16.mean())


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


def test_chip_smoke_floors_on_the_cpu(lm, capsys):
    """``chip_smoke.py``'s bookkeeping for the cross-attention LMs: the
    in-place decode step (the graph's) moves at least the step's byte
    floor (the memory K/V read once, the weights that only make the
    memory not read) and less than the functional step, and its cross
    blocks' bytes are printed; a prefill's FLOPs grow with the memory by
    its projection (or encoder), the cross K/V projections and the
    queries' attention over it."""
    cs, model, cfg = _chip_smoke(), lm["model"], lm["cfg"]
    failures = []
    spec = dict(batch=2, prompt_len=10, gen=4)
    cs._decode_bytes(failures, model, spec, lm["family"],
                     extras=lm["extras"], n_mem=lm["extras"][next(iter(
                         lm["extras"]))].shape[1])
    assert failures == []
    assert "cross blocks' ops move" in capsys.readouterr().out
    n_mem = 7
    B, S = 2, 10
    grow = cs._prefill_flops(model, B, S, n_mem) - cs._prefill_flops(
        model, B, S, 0)
    cross = _cross_layers(model)
    kv = sum(lay.xattn[k].numel() for lay in cross for k in ("wk", "wv"))
    want = (2.0 * B * n_mem * kv + len(cross) * 2.0 * B * cfg.n_heads * S
            * n_mem * 2 * cfg.hd)
    if cfg.family == "vlm":
        want += 2.0 * B * n_mem * model.proj.numel()
    else:
        enc = sum(p.numel() for n, p in model.named_parameters()
                  if p.ndim == 2 and n.startswith("enc_"))
        want += (2.0 * B * n_mem * enc + cfg.enc_layers * 2.0 * B
                 * cfg.n_heads * n_mem * n_mem * 2 * cfg.hd)
    assert grow == want
    # a decode step reads none of the memory-only weights
    read = cs._decode_floor_bytes(model, B, S, max_len=S + 4, n_mem=0)
    whole = sum(p.numel() * 4 for p in model.parameters())
    assert read < whole
