"""The port's centroid indexes (``serving/ann_index.py``) held against the
JAX package's.

With a JAX ``LshIndex``'s planes carried over (``weights.lsh_from_jax``),
the port's codes and candidate lists must be the JAX ones exactly; a
projection within 1e-6 of 0 could take either sign in two frameworks'
f32 products, so such centroids are left out of the comparison and
counted (none are expected).  With its own planes (a ``torch.Generator``
seeded from ``(seed, dim)``) the port's LSH must recall at least 0.95 of
the scan oracle's hits at every ``tau_trunk >= 0.9`` and never accept what
the scan rejects.
"""
import numpy as np
import pytest

from repro_torch import weights
from repro_torch.serving.ann_index import LshIndex, ScanIndex, make_index
from repro_torch.serving.trunk_cache import TrunkCache, TrunkEntry

TAUS = (0.90, 0.95, 0.99)
SHAPE = (1, 2, 2, 1)
EDGE = 1e-6


def _unit_rows(rng, n, dim):
    v = rng.randn(n, dim).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _near_queries(rng, pop, tau, n_queries):
    """Perturbed copies of stored centroids whose cosine to their source
    stays >= tau (so the scan oracle hits every one)."""
    dim = pop.shape[1]
    scale = 0.5 * np.sqrt(2.0 * (1.0 - tau) / dim)
    out = []
    while len(out) < n_queries:
        i = rng.randint(len(pop))
        q = pop[i] + scale * rng.randn(dim).astype(np.float32)
        q /= np.linalg.norm(q)
        if float(pop[i] @ q) >= tau:
            out.append(q)
    return np.asarray(out, np.float32)


def _entry(centroid, tag):
    import torch
    return TrunkEntry(z=torch.full(SHAPE, float(tag)), eps_prev=None,
                      step_idx=2, beta_bucket=0.5, rng_fold=0,
                      centroid=np.asarray(centroid, np.float32),
                      cfg_key="cfg")


def _carried(dims, seed=0, **kw):
    """A JAX ``LshIndex`` with its planes drawn for ``dims``, and the port
    index hashing with the same planes."""
    from repro.serving.ann_index import LshIndex as JaxLsh
    jidx = JaxLsh(seed=seed, **kw)
    planes = {d: np.asarray(jidx._planes_for(d)) for d in dims}
    return jidx, weights.lsh_from_jax(planes, seed=seed, **kw)


def _near_edge(planes, c):
    return bool((np.abs(planes @ c) < EDGE).any())


@pytest.mark.parametrize("dim", [16, 48, 768])
@pytest.mark.parametrize("kw", [{}, dict(n_tables=4, n_bits=3)])
def test_carried_planes_give_the_jax_codes_and_candidates(dim, kw):
    rng = np.random.RandomState(dim)
    jidx, idx = _carried([dim], seed=3, **kw)
    pop = _unit_rows(rng, 64, dim)
    queries = np.concatenate([_near_queries(rng, pop, 0.9, 32),
                              _unit_rows(rng, 16, dim)])
    planes = idx._planes[dim]
    edge = sum(_near_edge(planes, c) for c in np.concatenate([pop, queries]))
    assert edge == 0, f"{edge} centroids project within {EDGE} of a plane"
    for i, c in enumerate(pop):
        assert idx.signature(c) == jidx.signature(c)
        jidx.add(("k", i), c)
        idx.add(("k", i), c)
    for k in range(0, 64, 5):                    # removals keep order too
        jidx.discard(("k", k))
        idx.discard(("k", k))
    for q in queries:
        assert idx.candidates(q) == jidx.candidates(q)
    assert idx.stats == jidx.stats
    assert len(idx) == len(jidx)


def test_carried_planes_rebuild_equal_jax():
    rng = np.random.RandomState(1)
    jidx, idx = _carried([24])
    pop = _unit_rows(rng, 30, 24)
    for i, c in enumerate(pop):
        jidx.add(("k", i), c)
        idx.add(("k", i), c)
    idx.add(("k", 0), pop[1])                    # re-add rehashes
    jidx.add(("k", 0), pop[1])
    jidx.rebuild()
    idx.rebuild()
    assert idx._buckets == jidx._buckets
    assert idx.stats == jidx.stats
    assert idx.mean_candidates == jidx.mean_candidates


@pytest.mark.parametrize("tau", TAUS)
def test_own_planes_recall_against_the_scan_oracle(tau):
    """Cache-level recall (LSH hits / scan hits on one population and
    query stream) of at least 0.95, and every LSH hit a scan hit of at
    least the same cosine."""
    rng = np.random.RandomState(7)
    scan = TrunkCache(tau_trunk=tau, index="scan")
    lsh = TrunkCache(tau_trunk=tau, index="lsh")
    pop = _unit_rows(rng, 256, 64)
    for i, v in enumerate(pop):
        for c in (scan, lsh):
            c.insert(_entry(v, i), shape=SHAPE)
    queries = np.concatenate([_near_queries(rng, pop, tau, 200),
                              _unit_rows(rng, 50, 64)])
    hits_scan = hits_lsh = 0
    for q in queries:
        got_s = scan.lookup(q, 0.5, "cfg", SHAPE)
        got_l = lsh.lookup(q, 0.5, "cfg", SHAPE)
        hits_scan += got_s is not None
        hits_lsh += got_l is not None
        if got_l is not None:
            assert float(got_l.centroid @ q) >= tau
            assert got_s is not None
            assert float(got_s.centroid @ q) >= float(got_l.centroid @ q) \
                - 1e-6
    assert hits_scan >= 200
    assert hits_lsh / hits_scan >= 0.95


def test_own_planes_are_seeded_per_dim():
    a, b = LshIndex(seed=5), LshIndex(seed=5)
    assert np.array_equal(a._planes_for(32), b._planes_for(32))
    assert a._planes_for(32).shape == (48, 32)
    assert a._planes_for(32).dtype == np.float32
    assert not np.array_equal(a._planes_for(32)[:, :16], a._planes_for(16))
    assert not np.array_equal(LshIndex(seed=6)._planes_for(32),
                              a._planes_for(32))


def test_lsh_narrows_candidates():
    rng = np.random.RandomState(3)
    idx = LshIndex()
    pop = _unit_rows(rng, 512, 64)
    for i, v in enumerate(pop):
        idx.add(("k", i), v)
    scale = 0.5 * np.sqrt(2.0 * (1.0 - 0.90) / 64)
    found = 0
    for i in range(100):
        q = pop[i] + scale * rng.randn(64).astype(np.float32)
        q /= np.linalg.norm(q)
        found += (float(pop[i] @ q) < 0.90
                  or ("k", i) in idx.candidates(q))
    assert found >= 95
    assert idx.mean_candidates < 0.5 * len(pop)


def test_dims_never_collide_and_empty_index():
    idx = LshIndex()
    assert idx.candidates(np.ones(8, np.float32)) == []
    idx.add("a", np.ones(8, np.float32))
    assert idx.candidates(np.ones(16, np.float32)) == []
    assert idx.candidates(np.ones(8, np.float32)) == ["a"]
    idx.discard("a")
    idx.discard("a")                       # discarding twice is a no-op
    assert len(idx) == 0 and not idx._buckets


def test_scan_index_and_make_index():
    s = make_index("scan")
    assert isinstance(s, ScanIndex) and s.candidates(np.ones(3)) is None
    s.add("a", np.ones(3))
    s.discard("b")
    assert len(s) == 1
    assert isinstance(make_index(None), ScanIndex)
    assert make_index("lsh", n_tables=2).n_tables == 2
    inst = LshIndex()
    assert make_index(inst) is inst
    with pytest.raises(ValueError, match="unknown cache index"):
        make_index("kd")
    with pytest.raises(ValueError, match="n_tables/n_bits"):
        LshIndex(n_bits=0)


def test_lsh_from_jax_checks_the_planes_shape():
    with pytest.raises(ValueError, match="planes for dim 8"):
        weights.lsh_from_jax({8: np.zeros((47, 8), np.float32)})
    idx = weights.lsh_from_jax({8: np.ones((48, 8))}, seed=2)
    assert idx._planes[8].dtype == np.float32 and idx.seed == 2
