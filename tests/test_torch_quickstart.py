"""The port's quickstart (``repro_torch.examples.quickstart``) held to the
JAX package's ``examples/quickstart.py`` on the CPU: with JAX's draws
handed over (the text tower from ``PRNGKey(0)``, the DiT from
``PRNGKey(1)``, the noise from ``PRNGKey(2)``), the groups equal JAX's,
the NFE is 216 shared against 288 independent, the latents agree within
1e-3 (the end-to-end latent tolerance: the first DDIM step divides by
alpha_T ~ 1e-4) with the DiT in f32 on both sides, and the printed lines
are the JAX example's.  The JAX side repeats the example's calls, once
for the module."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SageConfig as JaxSageConfig
from repro.config import get_config as jax_get_config
from repro.config import replace as jax_replace
from repro.core import grouping as jax_grouping
from repro.core.schedule import make_schedule as jax_make_schedule
from repro.core.shared_sampling import independent_sample as jax_independent
from repro.core.shared_sampling import shared_sample as jax_shared
from repro.data.synthetic import ShapesDataset
from repro.models import dit as jax_dit
from repro.models import text_encoder as jax_te
from repro_torch import weights
from repro_torch.config import get_config, replace
from repro_torch.examples import quickstart
from repro_torch.models import text_encoder as te

LATENT_TOL = 1e-3


@pytest.fixture(scope="module")
def runs():
    """The JAX example's steps with its keys (the DiT in f32), then the
    port's ``run`` on the same draws."""
    jcfg = jax_replace(jax_get_config("sage-dit", smoke=True),
                       dtype="float32")
    sage = JaxSageConfig(total_steps=12, share_ratio=0.33,
                         guidance_scale=4.0, tau_min=0.35)
    sched = jax_make_schedule(1000)
    _, prompts = ShapesDataset(res=16).batch(0, 12)
    tc = jax_te.text_cfg(dim=jcfg.cond_dim, layers=2)
    tp = jax_te.init_text(jax.random.PRNGKey(0), tc)
    cond, pooled = jax_te.encode_text(
        tp, tc, jax_te.tokenize(prompts, max_len=jcfg.cond_len))
    groups = jax_grouping.greedy_clique_groups(
        jax_grouping.similarity_matrix(np.asarray(pooled)), sage.tau_min,
        group_max=4)
    idx, mask = jax_grouping.pad_groups(groups, 4)
    params = jax_dit.init_params(jcfg, jax.random.PRNGKey(1))

    def eps_fn(z, t, c):
        return jax_dit.forward(params, jcfg, z, t, c)

    null = jnp.zeros((jcfg.cond_len, jcfg.cond_dim))
    H, C = jcfg.latent_size, jcfg.latent_channels
    packed = jnp.asarray(cond)[idx.reshape(-1)].reshape(
        idx.shape + cond.shape[1:])
    key = jax.random.PRNGKey(2)
    out = jax_shared(eps_fn, sched, sage, key, packed, jnp.asarray(mask),
                     null, (H, H, C))
    indep = jax_independent(eps_fn, sched, sage, key, jnp.asarray(cond),
                            null, (H, H, C))
    saving = 1 - float(out["nfe"]) / float(indep["nfe"])
    # the JAX example's print statements, on its values
    want_lines = (["== SAGE quickstart =="]
                  + [f"  prompt: {p}" for p in prompts[:4]]
                  + [f"grouped {len(prompts)} prompts into {len(groups)} "
                     f"groups: {[len(g) for g in groups]}",
                     f"shared sampling   NFE = {int(out['nfe'])}",
                     f"independent       NFE = {int(indep['nfe'])}",
                     f"cost saving       = {saving:.1%}",
                     f"latents: {out['latents'].shape} finite: "
                     f"{bool(jnp.all(jnp.isfinite(out['latents'])))}"])
    want = dict(groups=groups, nfe=float(out["nfe"]),
                nfe_independent=float(indep["nfe"]),
                latents=np.asarray(out["latents"]),
                independent=np.asarray(indep["latents"]), lines=want_lines)

    cfg = replace(get_config("sage-dit", smoke=True), dtype="float32")
    text = weights.text_from_jax(
        jax.tree.map(np.asarray, tp),
        te.text_cfg(dim=cfg.cond_dim, layers=2), device="cpu")
    dit = weights.dit_from_jax(jax.tree.map(np.asarray, params), cfg,
                               device="cpu")
    noise = np.array(jax.random.normal(key, (len(idx), H, H, C)))
    indep_noise = np.array(jax.random.normal(key, (12, H, H, C)))
    lines = []
    got = quickstart.run(cfg, text=text, dit=dit,
                         noise=torch.from_numpy(noise),
                         indep_noise=torch.from_numpy(indep_noise),
                         device="cpu", log=lines.append)
    got["lines"] = lines
    return got, want


def test_groups_and_nfe_equal_jax(runs):
    got, want = runs
    assert got["groups"] == want["groups"]
    assert [len(g) for g in got["groups"]] == [4, 4, 4]
    assert (got["nfe"], got["nfe_independent"]) == (216.0, 288.0)
    assert (want["nfe"], want["nfe_independent"]) == (216.0, 288.0)
    assert got["saving"] == pytest.approx(0.25)


@pytest.mark.parametrize("which", ["latents", "independent"])
def test_latents_agree_with_jax(runs, which):
    got, want = runs
    assert tuple(got[which].shape) == want[which].shape
    np.testing.assert_allclose(got[which].numpy(), want[which],
                               atol=LATENT_TOL, rtol=0)


def test_prints_the_jax_examples_lines(runs):
    got, want = runs
    assert got["lines"] == want["lines"]


def test_default_draws_run_on_the_cpu():
    lines = []
    out = quickstart.run(device="cpu", log=lines.append)
    assert len(lines) == 10 and lines[0] == "== SAGE quickstart =="
    assert out["nfe_independent"] == 288.0
    assert bool(torch.isfinite(out["latents"]).all())
