"""Shared pytest fixtures.

``jax.clear_caches()`` between modules bounds the compiled-executable
state a single tier-1 process accumulates.  Every test module builds
fresh engines/schedulers (each with their own jit caches), so by the
time the suite's later modules compile, hundreds of executables from
earlier modules are still resident; past a threshold that deterministically
segfaults XLA's CPU backend inside ``backend_compile`` (observed on the
1-vCPU CI image once the suite grew past ~300 tests).  Per-module
clearing costs a few cross-module recompiles and keeps the process
bounded no matter how large the suite grows.
"""
import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    yield
    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA graphs, the hand-written "
        "kernels); the test skips itself without one")
