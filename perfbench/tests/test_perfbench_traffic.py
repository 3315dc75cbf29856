"""The traffic generators: the same seed gives the same traffic, another
seed other traffic of the same size."""
from __future__ import annotations

import numpy as np
import pytest

from perfbench import harness


def _rng(seed):
    return np.random.default_rng([seed, 7])


@pytest.mark.parametrize("n", [16, 64])
def test_themed_prompts_follow_the_seed(n):
    gen = harness.load_part("traffic", "themed")
    p = {"paraphrases": 4}
    a = gen.prompts(p, _rng(2 ** 33 + 1), n)
    assert a == gen.prompts(p, _rng(2 ** 33 + 1), n)
    assert a != gen.prompts(p, _rng(2 ** 33 + 2), n)
    assert len(a) == len(set(a)) == n
    assert all(0 < len(s.encode()) <= 75 for s in a)


def test_poisson_arrivals_follow_the_seed_and_keep_their_count():
    """The arrival times follow the workload's fixed stream, and every run
    seed offers the same ones: the seed draws the prompts alone."""
    gen = harness.load_part("traffic", "poisson")
    p = {"rate": 25.0, "stream": 1}
    a = gen.arrivals(p, _rng(5), 20.0)
    assert np.array_equal(a, gen.arrivals(p, _rng(6), 20.0))
    b = gen.arrivals(dict(p, stream=2), _rng(5), 20.0)
    assert len(a) == len(b) == 500 and not np.array_equal(a, b)
    assert np.all(np.diff(a) >= 0) and 0 <= a[0] and a[-1] < 20.0


def test_weights_and_noise_follow_the_seed():
    import torch
    from perfbench import weights as W
    layout = [("a", (3, 4), 0.5), ("b", (5,), 0.02)]
    x = W.draw(layout, 2 ** 40 + 3, W.DIT, "cpu")
    y = W.draw(layout, 2 ** 40 + 3, W.DIT, "cpu")
    z = W.draw(layout, 2 ** 40 + 3, W.TEXT, "cpu")
    assert all(torch.equal(x[k], y[k]) for k in x)
    assert not torch.equal(x["a"], z["a"])
    n1 = W.group_noise(7, 3, (1, 4, 4, 4), "cpu")
    assert torch.equal(n1, W.group_noise(7, 3, (1, 4, 4, 4), "cpu"))
    assert not torch.equal(n1, W.group_noise(7, 4, (1, 4, 4, 4), "cpu"))
