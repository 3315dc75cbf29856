"""Trace "C" of ``chip_smoke.STREAM_TRACES`` with every class on
DPM-Solver++(2M), served by the JAX scheduler and the port's on the CPU
through a trunk cache with the scan index, then one with the LSH index
(the JAX planes carried over): a hit forks into branching with the solver
history restarted, so its warm-up step rides the fork.  Outcome, records,
images (within 1e-3), stats, ``summary()``, the cache ledgers and the 2-D
packs must equal the JAX scheduler's (``test_torch_cache_serving.py`` does
the same on DDIM, with the corrupt and cache-free passes).
"""
import pytest

from test_torch_cache_serving import records, serve_passes
from test_torch_streaming import (assert_images_close,  # noqa: F401
                                  one_torch_thread)

PASSES = ("scan", "lsh")


@pytest.fixture(scope="module")
def passes():
    return serve_passes("dpmpp", passes=PASSES)


@pytest.mark.parametrize("name", PASSES)
def test_dpmpp_trace_c_outcome_and_records_equal_jax(passes, name):
    jax_side, port = passes[name]["jax"], passes[name]["port"]
    assert port[0] == jax_side[0]
    assert port[0]["cache"]["hit_groups"] == [2, 3]
    assert port[0]["cache"]["hits_host"] == port[0]["cache"]["hits_hbm"] == 1
    assert records(port[1]) == records(jax_side[1])
    assert_images_close(port[1], jax_side[1])


@pytest.mark.parametrize("name", PASSES)
def test_dpmpp_trace_c_stats_summary_and_ledgers_equal_jax(passes, name):
    jax_side, port = passes[name]["jax"], passes[name]["port"]
    assert port[2] == jax_side[2]          # summary()
    assert port[3] == jax_side[3]          # cache ledger
    assert port[4] == jax_side[4] == 4     # packs with a 2-D grid
    assert port[5] == jax_side[5]          # stats
