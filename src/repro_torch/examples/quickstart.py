"""Quickstart: the SAGE pipeline end to end at smoke size.  The twin of
the JAX package's ``examples/quickstart.py``, with its printed lines.

1. build a semantically grouped prompt set (procedural corpus),
2. group prompts by text-embedding similarity (paper Alg. 1 line 2),
3. run shared diffusion sampling (shared phase -> branch phase),
4. report the NFE cost saving vs independent sampling.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The text tower (2 layers, untrained) and the ``sage-dit`` smoke DiT get
random weights drawn from ``--seed`` (the tower from ``seed``, the DiT
from ``seed + 1``) and the initial noise from ``seed + 2``, all on the
device; :func:`run` also takes them from outside, as the tests hand in
the JAX example's draws.  The device defaults to CUDA and raises without
a GPU.
"""
from __future__ import annotations

import argparse
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig, SageConfig, get_config, replace
from repro_torch.core import grouping
from repro_torch.core.schedule import make_schedule
from repro_torch.core.shared_sampling import independent_sample, shared_sample
from repro_torch.data.synthetic import ShapesDataset
from repro_torch.models import text_encoder as te
from repro_torch.models.dit import DiT

N_PROMPTS = 12
GROUP_SIZE = 4


def run(cfg: Optional[ModelConfig] = None, *,
        text: Optional[te.TextTower] = None, dit: Optional[DiT] = None,
        noise: Optional[torch.Tensor] = None,
        indep_noise: Optional[torch.Tensor] = None,
        attn_impl: Optional[str] = None, step_impl: str = "reference",
        device="cuda", seed: int = 0,
        log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Group 12 prompts, then sample them shared and independently.

    ``cfg`` is the DiT's config (default ``sage-dit`` smoke); ``text`` /
    ``dit`` are the towers (default: drawn from ``seed``); ``noise`` (K,
    H, W, C) starts the K groups' shared trajectories and ``indep_noise``
    (12, H, W, C) the independent ones (default: drawn from ``seed + 2``,
    the same draw for both, as the JAX example's one key).  ``attn_impl``
    (default the DiT config's) and ``step_impl`` pick the routes.
    Returns the prompts, ``groups``, ``nfe``, ``nfe_independent``,
    ``saving``, and the ``latents`` (K, N, H, W, C) and ``independent``
    (12, H, W, C) latents."""
    dev = resolve_device(device)
    cfg = cfg or get_config("sage-dit", smoke=True)
    sage = SageConfig(total_steps=12, share_ratio=0.33, guidance_scale=4.0,
                      tau_min=0.35, step_impl=step_impl)
    sched = make_schedule(1000)

    log("== SAGE quickstart ==")
    _, prompts = ShapesDataset(res=16).batch(0, N_PROMPTS)
    for p in prompts[:4]:
        log(f"  prompt: {p}")

    gen = torch.Generator(device=dev)
    if text is None:
        text = te.TextTower(te.text_cfg(dim=cfg.cond_dim, layers=2),
                            device=dev, generator=gen.manual_seed(seed))
    cond, pooled = te.encode_text(
        text, te.tokenize(prompts, max_len=cfg.cond_len, device=dev))

    sim = grouping.similarity_matrix(pooled.cpu().numpy())
    groups = grouping.greedy_clique_groups(sim, sage.tau_min,
                                           group_max=GROUP_SIZE)
    log(f"grouped {len(prompts)} prompts into {len(groups)} groups: "
        f"{[len(g) for g in groups]}")
    idx, mask = grouping.pad_groups(groups, GROUP_SIZE)

    if dit is None:
        dit = DiT(cfg, device=dev, generator=gen.manual_seed(seed + 1))
    route = replace(cfg, attn_impl=attn_impl or cfg.attn_impl)

    def eps_fn(z, t, c):
        return dit(z, t, c, cfg=route)

    null = torch.zeros((cfg.cond_len, cfg.cond_dim), device=dev)
    H, C = cfg.latent_size, cfg.latent_channels
    if noise is None or indep_noise is None:
        draw = torch.randn((max(len(idx), N_PROMPTS), H, H, C), device=dev,
                           generator=gen.manual_seed(seed + 2))
        noise = draw[:len(idx)] if noise is None else noise
        indep_noise = draw[:N_PROMPTS] if indep_noise is None else indep_noise
    flat = torch.as_tensor(idx.reshape(-1), dtype=torch.long, device=dev)
    cond_packed = cond[flat].reshape(idx.shape + tuple(cond.shape[1:]))

    out = shared_sample(eps_fn, sched, sage, noise, cond_packed,
                        torch.as_tensor(mask), null, device=dev)
    indep = independent_sample(eps_fn, sched, sage, indep_noise, cond, null,
                               device=dev)
    saving = 1 - float(out["nfe"]) / float(indep["nfe"])
    log(f"shared sampling   NFE = {int(out['nfe'])}")
    log(f"independent       NFE = {int(indep['nfe'])}")
    log(f"cost saving       = {saving:.1%}")
    log(f"latents: {tuple(out['latents'].shape)} finite: "
        f"{bool(torch.isfinite(out['latents']).all())}")
    return {"prompts": prompts, "groups": groups, "nfe": out["nfe"],
            "nfe_independent": indep["nfe"], "saving": saving,
            "latents": out["latents"], "independent": indep["latents"]}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    return run(device=args.device, seed=args.seed)


if __name__ == "__main__":
    main()
