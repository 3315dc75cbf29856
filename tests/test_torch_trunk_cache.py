"""The port's trunk cache (``serving/trunk_cache.py``), its CRC and
corruption model (``serving/faults.py``) and its admission policies
(``serving/policies.py``) held against the JAX package's.

Seeded operation sequences (inserts, lookups, overwrites, spills,
promotions, evictions, popularity admission, forced misses, corruption)
run op for op through both caches on the same numpy payloads: the stats,
the byte ledgers, the resident keys with their tiers and CRCs, and every
lookup's answer must be equal after every operation.  ``array_crc`` must
give the JAX value on the same bytes (bf16 leaves and dict trees too).
``cached_prefix_prefill`` is held to the JAX function at ``mamba2-smoke``.

The machine with the card has no JAX: JAX is imported inside the tests
that need it, and the ``cuda`` test (spill and promotion of CUDA payloads)
runs there with
``python -m pytest --noconftest -m cuda tests/test_torch_trunk_cache.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.serving import faults, policies
from repro_torch.serving.faults import FaultPlan, array_crc, corrupt_array
from repro_torch.serving.kvcache import cache_bytes
from repro_torch.serving.trunk_cache import HBM, HOST, TrunkCache, TrunkEntry

from test_torch_streaming import one_torch_thread  # noqa: F401

DIM = 16
SHAPES = ((1, 2, 2, 1), (1, 4, 2, 1))


def _bf16(bits: np.ndarray, jax_side: bool = True):
    """The same bf16 bytes for both packages: (numpy via ml_dtypes, or None
    where JAX is not wanted, and torch)."""
    t = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    if not jax_side:
        return None, t
    import ml_dtypes
    return bits.view(ml_dtypes.bfloat16), t


def _payload(rng, kind, shape, jax_side=True):
    """One payload as (JAX numpy tree, port torch tree) of equal bytes:
    a latent, or an AR-prefix (logits, cache dict) tree with a bf16 leaf
    and keys out of sorted order."""
    z = rng.standard_normal(shape).astype(np.float32)
    if kind == "trunk":
        return z, torch.from_numpy(z.copy())
    bits = rng.integers(0, 2 ** 15, (2, 3)).astype(np.uint16)
    jb, tb = _bf16(bits, jax_side)
    st = rng.standard_normal((2, 2)).astype(np.float32)
    jax_tree = (z, {"suffix": [], "blocks": {"state": st, "conv": jb},
                    "prefix": [st[:1]]})
    port_tree = (torch.from_numpy(z.copy()),
                 {"suffix": [], "blocks": {"state": torch.from_numpy(
                     st.copy()), "conv": tb},
                  "prefix": [torch.from_numpy(st[:1].copy())]})
    return jax_tree, port_tree


def _host(tree):
    """Leaves as numpy (bf16 as its raw bits), in sorted order."""
    out = []
    for leaf in faults._sorted_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.dtype == torch.bfloat16:
                leaf = leaf.view(torch.int16)
            leaf = leaf.numpy()
        else:
            leaf = np.asarray(leaf)
            if leaf.dtype.name == "bfloat16":
                leaf = leaf.view(np.int16)
        out.append(leaf)
    return out


CONFIGS = {
    "lru-evict": dict(admission="always", host=0, index="scan"),
    "lru-spill": dict(admission="always", host=5, index="scan"),
    "popularity-spill-lsh": dict(admission="popularity", host=3,
                                 index="lsh"),
    "faults-spill-lsh": dict(admission="always", host=4, index="lsh",
                             faults=dict(seed=3, p_cache_miss=0.2,
                                         p_cache_corrupt=0.2)),
    "no-history": dict(admission="always", host=2, index="scan",
                       store_history=False),
}


def _twins(cfg):
    """A JAX cache and a port cache of the same configuration (the LSH
    planes carried over)."""
    from repro.serving.ann_index import LshIndex as JaxLsh
    from repro.serving.faults import FaultPlan as JaxFaultPlan
    from repro.serving.trunk_cache import TrunkCache as JaxCache
    from repro_torch import weights
    unit = 4 * 8 * 2                     # a small latent with its history
    kw = dict(tau_trunk=0.9, max_bytes=3 * unit, host_bytes=cfg["host"] * unit,
              store_history=cfg.get("store_history", True))
    jidx = pidx = cfg["index"]
    if cfg["index"] == "lsh":
        jidx = JaxLsh(n_tables=4, n_bits=3, seed=1)
        pidx = weights.lsh_from_jax(
            {DIM: np.asarray(jidx._planes_for(DIM))}, n_tables=4, n_bits=3,
            seed=1)
    jf = pf = None
    if "faults" in cfg:
        jf, pf = JaxFaultPlan(**cfg["faults"]), FaultPlan(**cfg["faults"])
    return (JaxCache(admission=cfg["admission"], index=jidx, faults=jf, **kw),
            TrunkCache(admission=cfg["admission"], index=pidx, faults=pf,
                       **kw))


def _assert_same_state(jc, pc, where):
    assert pc.stats == jc.stats, where
    assert (pc.bytes, pc.tier_bytes, len(pc)) == \
        (jc.bytes, jc.tier_bytes, len(jc)), where
    assert pc.ledger_bytes() == pc.bytes and pc.tier_ledger() == \
        pc.tier_bytes, where
    assert [(k, e.tier, e.crc, e.nbytes) for k, e in pc._entries.items()] \
        == [(k, e.tier, e.crc, e.nbytes) for k, e in jc._entries.items()], \
        where
    assert pc.hit_rate == jc.hit_rate, where


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_op_sequences_equal_jax_after_every_op(name):
    from repro.serving.trunk_cache import TrunkEntry as JaxEntry
    cfg = CONFIGS[name]
    jc, pc = _twins(cfg)
    rng = np.random.default_rng(sorted(CONFIGS).index(name))
    themes = rng.standard_normal((4, DIM)).astype(np.float32)
    # a handful of (theme, beta, cfg_key, payload, shape) classes, so keys
    # recur: exact repeats, near duplicates and far strangers of each
    classes = [(t, (0.3, 0.4)[i % 2], ("ddim-30", "ddim-15")[i % 3 // 2],
                kind, shape)
               for i, (t, kind, shape) in enumerate(
                   [(0, "trunk", SHAPES[0]), (1, "trunk", SHAPES[0]),
                    (2, "trunk", SHAPES[1]), (0, "ar_prefix", (7,)),
                    (3, "trunk", SHAPES[0]), (1, "trunk", SHAPES[1])])]
    hits = 0
    for op in range(160):
        t, beta, ck, kind, shape = classes[rng.integers(len(classes))]
        noise = rng.choice([0.0, 0.0, 0.05, 2.0])
        c = themes[t] + noise * rng.standard_normal(DIM).astype(np.float32)
        if rng.random() < 0.45:
            jz, pz = _payload(rng, kind, shape if kind == "trunk"
                              else SHAPES[0])
            with_hist = kind == "trunk" and rng.random() < 0.7
            je, pe = (None, None)
            if with_hist:
                je, pe = _payload(rng, "trunk", shape)
            stored = (jc.insert(JaxEntry(jz, je, 3, beta, op, c, ck, kind),
                                shape=shape),
                      pc.insert(TrunkEntry(pz, pe, 3, beta, op, c, ck, kind),
                                shape=shape))
            assert stored[0] == stored[1]
        else:
            got = (jc.lookup(c, beta, ck, shape, payload=kind),
                   pc.lookup(c, beta, ck, shape, payload=kind))
            assert (got[0] is None) == (got[1] is None), op
            if got[1] is not None:
                hits += 1
                assert got[1].rng_fold == got[0].rng_fold
                # (a popularity victim may be the entry just promoted)
                assert got[1].tier == got[0].tier
                for a, b in zip(_host(got[1].z), _host(got[0].z)):
                    assert np.array_equal(a, b)
        _assert_same_state(jc, pc, f"{name} op {op}")
    st = pc.stats
    assert hits and st["misses"] and st["inserts"]
    if cfg["host"]:
        assert st["spills"] and st["promotions"] and st["hits_host"]
    else:
        assert st["evictions"] and not st["spills"]
    if cfg["admission"] == "popularity":
        assert st["admission_rejects"]
        assert pc.admission.counts == jc.admission.counts
    if "faults" in cfg:
        assert st["fault_forced_misses"] and st["integrity_drops"]
        assert pc.faults.injected == jc.faults.injected
        assert pc.faults.queries == jc.faults.queries
    if cfg.get("store_history") is False:
        assert all(e.eps_prev is None for e in pc._entries.values())


def test_overwrite_keeps_the_ledger_and_an_oversized_trunk_stays():
    c = TrunkCache(tau_trunk=0.9, max_bytes=10, host_bytes=0)
    v = np.ones(DIM, np.float32)
    for tag in (1.0, 2.0):
        c.insert(TrunkEntry(torch.full((1, 4), tag), None, 1, 0.3, 0, v,
                            "k"))
    assert c.stats["overwrites"] == 1 and len(c) == 1
    assert c.bytes == c.ledger_bytes() == 16 > c.max_bytes
    assert float(c.lookup(v, 0.3, "k", (1, 4)).z[0, 0]) == 2.0


# ---------------------------------------------------------------------------
# CRC and corruption against the JAX functions
# ---------------------------------------------------------------------------

def _crc_cases():
    rng = np.random.default_rng(11)
    f = rng.standard_normal((3, 5)).astype(np.float32)
    jb, tb = _bf16(rng.integers(0, 2 ** 15, (4, 2)).astype(np.uint16))
    i64 = rng.integers(0, 99, (2, 3))
    return {
        "f32": (f, torch.from_numpy(f.copy())),
        "bf16": (jb, tb),
        "scalar": (np.float32(2.5), torch.tensor(2.5)),
        "strided": (f.T, torch.from_numpy(f.copy()).T),
        "dict": ({"z": f, "a": [i64, None, (jb, 7)], "m": {"y": f[:1],
                                                           "b": i64}},
                 {"z": torch.from_numpy(f.copy()),
                  "a": [torch.from_numpy(i64.copy()), None, (tb, 7)],
                  "m": {"y": torch.from_numpy(f[:1].copy()),
                        "b": torch.from_numpy(i64.copy())}}),
    }


@pytest.mark.parametrize("case", sorted(_crc_cases()))
def test_array_crc_equals_jax_on_the_same_bytes(case):
    from repro.serving import faults as jax_faults
    jx, px = _crc_cases()[case]
    want = jax_faults.array_crc(jx)
    assert array_crc(px) == want
    assert array_crc(jx) == want                 # numpy leaves too


@pytest.mark.parametrize("case", sorted(_crc_cases()))
def test_corrupt_array_equals_jax_and_leaves_the_input(case):
    from repro.serving import faults as jax_faults
    jx, px = _crc_cases()[case]
    before = array_crc(px)
    bad = corrupt_array(px)
    assert array_crc(bad) == jax_faults.array_crc(jax_faults.corrupt_array(
        jx)) != before
    assert array_crc(px) == before
    assert type(bad) is type(px)
    if case == "dict":
        # the first leaf in sorted order is a["a"][0]; the rest are shared
        assert not torch.equal(bad["a"][0], px["a"][0])
        assert bad["z"] is px["z"] and bad["a"][2][1] == 7
        assert bad["a"][1] is None


def test_cache_bytes_counts_tensor_leaves_only():
    t = torch.zeros((2, 3), dtype=torch.bfloat16)
    assert cache_bytes((t, None, {"a": [t, 3]})) == 24


# ---------------------------------------------------------------------------
# cache admission
# ---------------------------------------------------------------------------

def test_cache_admissions_equal_jax_case_for_case():
    from repro.serving import policies as jax_policies
    rng = np.random.default_rng(5)
    for spec, kw in (("always", {}), ("popularity", {}),
                     ("popularity", dict(threshold=3, max_keys=6))):
        mine = policies.make_cache_admission(spec, **kw)
        ref = jax_policies.make_cache_admission(spec, **kw)
        assert mine.name == ref.name
        for _ in range(200):
            k = ("k", int(rng.integers(12)))
            mine.on_lookup(k)
            ref.on_lookup(k)
            keys = [("k", int(x)) for x in rng.permutation(12)[:5]]
            for tier in (HBM, HOST):
                assert mine.victim(keys, tier=tier) == ref.victim(keys,
                                                                  tier=tier)
            assert mine.admit(k) == ref.admit(k)
        assert getattr(mine, "counts", None) == getattr(ref, "counts", None)
        assert mine.victim([]) is None
    with pytest.raises(ValueError, match="unknown cache admission"):
        policies.make_cache_admission("lfu")
    with pytest.raises(ValueError, match="threshold"):
        policies.PopularityAdmission(threshold=0)


def test_cache_validation_errors_equal_jax():
    from repro.serving.trunk_cache import TrunkCache as JaxCache
    for bad in (dict(tau_trunk=0.0), dict(tau_trunk=1.5),
                dict(host_bytes=-1)):
        with pytest.raises(ValueError) as want:
            JaxCache(**bad)
        with pytest.raises(ValueError) as got:
            TrunkCache(**bad)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# cached_prefix_prefill at mamba2-smoke against the JAX function
# ---------------------------------------------------------------------------

def test_cached_prefix_prefill_equals_jax():
    """Two groups served g0, g1, g0, g1 through both caches (budgets in
    payloads: 1 on the device, 2 on the host): miss, miss with a spill,
    then host hits with promotions; stats, ledgers and token-step counts
    equal after each call, logits within the LM tests' f32 tolerance, and
    each hit bitwise equal to that group's miss in the port."""
    import jax
    import jax.numpy as jnp
    from repro.config import get_config as jax_get_config
    from repro.config import replace as jax_replace
    from repro.models import transformer as jax_tfm
    from repro.serving import shared_prefill as jax_sp
    from repro.serving.trunk_cache import TrunkCache as JaxCache
    from test_torch_lm_serving import ATOL, RTOL, _params
    from repro_torch import weights
    from repro_torch.config import get_config, replace
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import shared_prefill

    params = _params()
    jp = jax.tree.map(jnp.asarray, params)
    jcfg = jax_replace(jax_get_config("mamba2-780m", smoke=True),
                       dtype="float32")
    model = weights.lm_from_jax(
        params, replace(get_config("mamba2-780m", smoke=True),
                        dtype="float32"), device="cpu")
    rng = np.random.RandomState(4)
    groups = [np.concatenate([rng.randint(0, 512, (1, 20)).repeat(3, 0),
                              rng.randint(0, 512, (3, 5))], 1)
              for _ in range(2)]
    cents = rng.randn(2, DIM).astype(np.float32)
    one = cache_bytes(tfm.prefill(model, groups[0][:1, :20])[:2])
    caches = (JaxCache(tau_trunk=0.9, max_bytes=one, host_bytes=2 * one),
              TrunkCache(tau_trunk=0.9, max_bytes=one, host_bytes=2 * one))
    first, hits = {}, []
    for g in (0, 1, 0, 1):
        jl, _, _, jst = jax_sp.cached_prefix_prefill(
            lambda t, m: jax_tfm.prefill(jp, jcfg, jnp.asarray(t),
                                         max_len=m),
            lambda c, t, p: jax_tfm.decode_step(jp, jcfg, c, jnp.asarray(t),
                                                p),
            groups[g], 32, cache=caches[0], centroid=cents[g])
        pl, pcache, pos, pst = shared_prefill.cached_prefix_prefill(
            lambda t, m: tfm.prefill(model, t, max_len=m),
            lambda c, t, p: tfm.decode_step(model, c, t, p), groups[g], 32,
            cache=caches[1], centroid=cents[g])
        assert pst == jst and pos == 25
        assert caches[1].stats == caches[0].stats
        assert (caches[1].bytes, caches[1].tier_bytes) == \
            (caches[0].bytes, caches[0].tier_bytes)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
        if g in first:
            hits.append(pst["token_steps"])
            assert torch.equal(pl, first[g][0])
            for a, b in zip(faults._sorted_leaves(pcache),
                            faults._sorted_leaves(first[g][1])):
                assert torch.equal(a, b)
        else:
            first[g] = (pl, pcache)
    st = caches[1].stats
    assert (st["misses"], st["hits_host"], st["spills"],
            st["promotions"]) == (2, 2, 3, 2)
    assert hits == [15, 15]                      # 3 x 5 tail steps, no 20


def test_cached_prefix_prefill_without_a_cache_or_a_key():
    from repro_torch.serving.shared_prefill import (cached_prefix_prefill,
                                                    prefix_cache_key)
    with pytest.raises(ValueError, match="embeds or centroid"):
        cached_prefix_prefill(None, None, np.zeros((2, 3), np.int64), 8,
                              cache=None)
    a = prefix_cache_key(np.arange(4), 16)
    assert a == ("ar_prefix", 16, 4, np.arange(4, dtype=np.int32).tobytes())
    assert a != prefix_cache_key(np.arange(4), 17)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_spill_and_promotion_are_bitwise_and_return_home():
    """CUDA payloads (a latent with its history, and an AR-prefix tree with
    a bf16 leaf) spill to CPU tensors and are promoted back to the device
    they were stored from, bitwise, the CRC intact; a corrupted device
    payload is caught on the hit path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a device tier to spill from")
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    rng = np.random.default_rng(0)
    c = TrunkCache(tau_trunk=0.9, max_bytes=1, host_bytes=1 << 20)
    cents = rng.standard_normal((3, DIM)).astype(np.float32)
    kept = []
    for i, kind in enumerate(("trunk", "ar_prefix", "trunk")):
        _, z = _payload(rng, kind, SHAPES[0], jax_side=False)
        z = torch.utils._pytree.tree_map(lambda t: t.to(dev), z)
        ep = None if kind != "trunk" else torch.randn(SHAPES[0], device=dev)
        c.insert(TrunkEntry(z, ep, 3, 0.3, i, cents[i], "k", kind),
                 shape=(9,))
        kept.append((kind, [t.cpu() for t in faults._sorted_leaves(z)],
                     array_crc(z)))
    assert c.stats["spills"] == 2
    assert all(e.device == dev for e in c._entries.values())
    for i, (kind, leaves, crc) in enumerate(kept[:2]):
        e = list(c._entries.values())[0]
        assert e.tier == HOST and all(
            t.device.type == "cpu" for t in faults._sorted_leaves(e.z))
        got = c.lookup(cents[i], 0.3, "k", (9,), payload=kind)
        assert got is e and got.tier == HBM and got.crc == crc
        assert array_crc(got.z) == crc
        for t, want in zip(faults._sorted_leaves(got.z), leaves):
            assert t.device == dev and torch.equal(t.cpu(), want)
        if got.eps_prev is not None:
            assert got.eps_prev.device == dev
    assert c.stats["promotions"] == 2
    bad = TrunkCache(tau_trunk=0.9, faults=FaultPlan(p_cache_corrupt=1.0))
    bad.insert(TrunkEntry(torch.ones(SHAPES[0], device=dev), None, 1, 0.3, 0,
                          cents[0], "k"))
    assert bad.lookup(cents[0], 0.3, "k", SHAPES[0]) is None
    assert bad.stats["integrity_drops"] == 1 and len(bad) == 0
