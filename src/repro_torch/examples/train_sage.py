"""Train a ~100M-param DiT with the SAGE objective (Alg. 2 / Eq. 3) on the
grouped procedural corpus, then save a checkpoint.  The twin of the JAX
package's ``examples/train_sage.py``, with its flags and output.

    PYTHONPATH=src python -m repro_torch.examples.train_sage --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_sage --lora 8
    PYTHONPATH=src python -m repro_torch.examples.train_sage --smoke \\
        --steps 2 --device cpu --ckpt /tmp/sage_ckpt

The model is ``sage-dit-100m`` (``--smoke``: its test size) with random
weights drawn from ``--seed``; the "latents" are the corpus images
patchified to the latent grid (first ``latent_channels`` channels).  The
corpus is encoded once by a 2-layer text tower without autograd.  The
device defaults to CUDA and raises without a GPU; ``--device cpu`` trains
on the CPU.  The DiT runs its plain attention route, as training must
(the hand-written kernels have no backward).
"""
import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device, seeded_generator
from repro_torch.checkpoint import save_checkpoint
from repro_torch.config import OptimConfig, SageConfig, get_config
from repro_torch.core import trainer
from repro_torch.core.schedule import make_schedule
from repro_torch.data.grouped import build_grouped_dataset
from repro_torch.models import text_encoder as te


def latents(cfg, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) images -> (B, H/p, W/p, latent_channels) pixel
    "latents" (patchify, then the first channels)."""
    B, H, W, C = images.shape
    p = cfg.patch
    x = images.reshape(B, H // p, p, W // p, p, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // p, W // p, -1)
    return x[..., :cfg.latent_channels]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse ``argv``, train and save; returns the losses and the
    checkpoint's path."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--lora", type=int, default=0)
    ap.add_argument("--k-groups", type=int, default=4)
    ap.add_argument("--group-size", type=int, default=3)
    ap.add_argument("--ckpt", default="experiments/sage_dit_ckpt")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("sage-dit-100m", smoke=args.smoke)
    sage = SageConfig(total_steps=30, share_ratio=0.3, tau_min=0.4)
    sched = make_schedule(1000, device=device)
    opt = OptimConfig(lr=3e-4 if not args.lora else 1e-3)
    res = cfg.latent_size * cfg.patch  # images decode at latent*patch here
    K, N = args.k_groups, args.group_size

    print(f"model={cfg.name} d={cfg.d_model} L={cfg.n_layers} "
          f"lora={args.lora} device={device}")

    tc = te.text_cfg(dim=cfg.cond_dim, layers=2)
    tower = te.TextTower(tc, device=device, generator=torch.Generator(
        device=device).manual_seed(args.seed))

    def encode(prompts):
        return te.encode_text(tower, te.tokenize(prompts, cfg.cond_len,
                                                 device=device))

    gd = build_grouped_dataset(encode, n_items=128, res=res,
                               tau_min=sage.tau_min, tau_max=0.95,
                               group_max=N)
    print(f"dataset: {len(gd.prompts)} pairs, {len(gd.groups)} groups, "
          f"sizes {np.bincount([len(g) for g in gd.groups])[1:]}")

    state = trainer.init_state(cfg, opt, args.seed + 1, lora_rank=args.lora,
                               device=device)
    step_fn = trainer.make_sage_train_step(cfg, sage, sched, opt,
                                           lora_rank=args.lora)
    shape = (cfg.latent_size, cfg.latent_size, cfg.latent_channels)

    it, losses, t0 = None, [], time.time()
    for i in range(args.steps):
        if it is None:
            it = gd.iter_batches(K, N, seed=i)
        try:
            b = next(it)
        except StopIteration:
            it = None
            continue
        images = torch.from_numpy(b["images"].reshape(-1, res, res, 3))
        batch = {"z": latents(cfg, images).reshape(K, N, *shape).to(device),
                 "cond": torch.from_numpy(b["cond"]).to(device),
                 "mask": torch.from_numpy(b["mask"]).to(device)}
        draws = trainer.sage_step_draws(seeded_generator(args.seed, 100 + i),
                                        sage, sched, K, N, shape, device)
        state, m = step_fn(state, batch, draws)
        losses.append(float(m["loss"]))
        if i % 20 == 0:
            print(f"step {i:4d} loss={losses[-1]:.4f} "
                  f"shared={float(m['shared']):.4f} "
                  f"soft={float(m['soft']):.4f} "
                  f"branch={float(m['branch']):.4f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)")

    print(f"final loss {np.mean(losses[-10:]):.4f} "
          f"(first 10: {np.mean(losses[:10]):.4f})")
    path = save_checkpoint(args.ckpt, args.steps,
                           state["lora"] if args.lora else state["params"])
    print(f"checkpoint -> {args.ckpt}")
    return {"losses": losses, "ckpt": path}


if __name__ == "__main__":
    main()
