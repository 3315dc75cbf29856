"""The plain float32 reference against the port at smoke size, and the
output check: a sound run passes, and a run whose timed path is broken
underneath, or the control in the program's place, fails."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from perfbench import check, harness
from perfbench.reference import model as M
from perfbench.reference import sampling as S
from perfbench.tests import smoke


@pytest.fixture(scope="module")
def system():
    return harness.System(smoke.config(), smoke.SEED, "cpu")


def test_reference_models_equal_the_port_in_float32(system):
    from repro_torch.config import replace
    cfg = system.config
    m = cfg["model"]
    ref = check.Reference(cfg, smoke.SEED, "cpu")
    gen = torch.Generator().manual_seed(3)
    S = m["latent_size"]
    z = torch.randn(3, S, S, 4, generator=gen)
    t = torch.tensor([999, 500, 17])
    c = torch.randn(3, m["cond_len"], m["cond_dim"], generator=gen)
    got = system.dit(z, t, c, cfg=replace(system.mcfg, attn_impl="naive"))
    want = M.dit_forward(ref.dit, m, z, t, c)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)
    prompts = ["a red fox on a misty hill", "an owl at dusk, watercolor"]
    feats, pooled = system.text(M.tokenize(prompts, m["cond_len"], "cpu"))
    rf, rp = ref.embed(prompts)
    assert torch.allclose(feats, rf, atol=1e-5)
    assert np.allclose(pooled.numpy(), rp, atol=1e-5)
    assert torch.allclose(system.vae(z), M.vae_decode(ref.vae, z), atol=1e-5)


@pytest.mark.parametrize("loop", ["offline", "open"])
def test_a_sound_run_is_correct(loop):
    cell = smoke.cell(loop)
    res = harness.run_cell(cell, smoke.SEED, 0.5, False, "cpu", 0.0)
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == set(cell.end_to_end)
    assert list(res)[-1] == "compared"


def test_the_open_windows_trace_and_counters_end_at_its_close():
    """An open window's traced span and counters end when its load stops;
    the drain's completions are counted apart."""
    from perfbench import devtrace
    cell = smoke.cell("open")
    system = harness.System(cell.config, smoke.SEED, "cpu")
    prof = devtrace.profiler("cpu")
    w = harness.open_window(system, cell.workload, 0.5,
                            np.random.default_rng([smoke.SEED, 7]), prof=prof)
    t = devtrace.summarize(prof, w)
    spans = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name() in devtrace.WINDOWS}
    (a, b), (lo, hi) = spans["bench.load"], spans["bench.window"]
    assert lo <= a and b <= hi and b - a >= 0.45e9
    assert t.window_s == pytest.approx((b - a) / 1e9)
    assert (w.stats["completed"] + w.notes["completed_in_drain"]
            == len(w.requests))


def _unchanged_step(monkeypatch):
    """The fused CFG + DDIM update returns the latents it was given."""
    from repro_torch.kernels import dispatch
    monkeypatch.setattr(dispatch, "cfg_ddim_step", lambda z, *a, **k: z)


def _altered_answer(monkeypatch):
    """The VAE decoder's images come out altered where they are made."""
    from repro_torch.models.vae import VAEDecoder
    real = VAEDecoder.forward_grad
    monkeypatch.setattr(VAEDecoder, "forward_grad",
                        lambda self, z: 0.8 * real(self, z))


def _no_sharing(monkeypatch):
    """Grouping puts every prompt in a group of its own."""
    from repro_torch.core import grouping
    monkeypatch.setattr(grouping, "greedy_clique_groups",
                        lambda sim, *a, **k: [[i] for i in
                                              range(sim.shape[0])])
    monkeypatch.setattr(grouping, "incremental_assign", lambda *a, **k: -1)


def _half_rows(monkeypatch):
    """The denoiser evaluates the first half of each call's rows and hands
    their results to the other half as well."""
    from repro_torch.models.dit import DiT
    real = DiT.forward

    def half(self, z, t, cond, *a, **k):
        n = (z.shape[0] + 1) // 2
        out = real(self, z[:n], t[:n], cond[:n], *a, **k)
        return torch.cat([out, out])[:z.shape[0]]
    monkeypatch.setattr(DiT, "forward", half)


# an open loop that never groups serves every image right, at a higher
# cost: nfe_per_image.open shows it, the output check does not
@pytest.mark.parametrize("loop, fault", [
    ("offline", _unchanged_step), ("offline", _altered_answer),
    ("offline", _no_sharing), ("offline", _half_rows),
    ("open", _unchanged_step), ("open", _altered_answer),
    ("open", _half_rows)])
def test_a_broken_timed_path_is_not_correct(monkeypatch, loop, fault):
    fault(monkeypatch)
    res = harness.run_cell(smoke.cell(loop), smoke.SEED, 0.5, False, "cpu",
                           0.0)
    assert not res["correct"], res["compared"]


def test_the_control_fails_the_limits():
    """The reference with float8 products and convolutions in the
    program's place, put into a window's requests where the program's
    latents and images were, comes out not correct under the run's own
    output check: under the smoke cell's limits, and under each real
    cell's."""
    from perfbench.control import control_window
    cells = {}
    for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text()
                        )["workloads"]:
        wl = harness.load_json(harness.BENCH / "workloads"
                               / f"{w['name']}.json")
        cells.setdefault(wl["loop"], []).append((w["name"], wl["check"]))
    assert set(cells) == {"offline", "open"}
    for loop, limits in cells.items():
        cell = smoke.cell(loop)
        rng = np.random.default_rng([smoke.SEED, 7])
        system = harness.System(cell.config, smoke.SEED, "cpu")
        w = harness.LOOPS[loop](system, cell.workload, 0.5, rng)
        ctl = control_window(cell.config, cell.workload, w, smoke.SEED,
                             "cpu")
        sound = check.judge(cell.config, cell.workload, w, smoke.SEED, "cpu")
        assert check.passed(sound), sound
        for name, lim in [("smoke", cell.workload["check"])] + limits:
            wl = dict(cell.workload, check=dict(
                cell.workload["check"],
                latent_l1_err=lim["latent_l1_err"],
                decode_rel_err=lim["decode_rel_err"]))
            got = check.judge(cell.config, wl, ctl, smoke.SEED, "cpu")
            assert not check.passed(got), (name, got)


@pytest.mark.cuda
def test_a_sound_run_on_the_card_is_correct():
    """The smoke cell on the card's kernels and CUDA graphs, traced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = harness.run_cell(smoke.cell("offline"), smoke.SEED, 1.0, True,
                           "cuda:0", 0.0)
    assert res["correct"], res["compared"]
    assert res["device"]["busy_s"] > 0


def test_the_reference_cover_is_the_programs():
    """Without ties the reference's greedy clique cover is the program's,
    on similarity matrices with ties, edges at the threshold and missing
    edges."""
    from repro_torch.core.grouping import greedy_clique_groups
    rng = np.random.default_rng(9)
    for _ in range(50):
        n = int(rng.integers(2, 40))
        e = rng.normal(size=(n, 8)) + 2.0 * rng.normal(size=8)
        sim = S.similarity(e)
        sim[0, 1] = sim[1, 0] = 0.6
        for width in (1, 4):
            assert S.clique_groups(sim, 0.6, width) == greedy_clique_groups(
                sim, 0.6, group_max=width)


def test_a_decision_within_rounding_may_go_either_way():
    """Two candidates closer than the tie: the cover that takes either one
    is the reference's; a cover that departs by more is not."""
    sim = np.array([[1.0, 0.90, 0.90 - 4e-6, 0.70],
                    [0.90, 1.0, 0.80, 0.85],
                    [0.90 - 4e-6, 0.80, 1.0, 0.75],
                    [0.70, 0.85, 0.75, 1.0]])
    plain = S.clique_groups(sim, 0.6, 2)
    assert sorted(map(sorted, plain)) == [[0, 1], [2, 3]]
    other = [[0, 2], [1, 3]]
    assert sorted(map(sorted, S.clique_groups(
        sim, 0.6, 2, tie=1e-5, served=other))) == other
    assert sorted(map(sorted, S.clique_groups(
        sim, 0.6, 2, tie=1e-6, served=other))) == [[0, 1], [2, 3]]
    far = [[0, 3], [1, 2]]
    assert sorted(map(sorted, S.clique_groups(
        sim, 0.6, 2, tie=1e-5, served=far))) == [[0, 1], [2, 3]]
