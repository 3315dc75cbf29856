"""Training launcher for the LM families: the twin of the JAX package's
``launch/train.py``, with its flags and its printed lines, plus
``--device``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
        --smoke --steps 20 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \\
        --smoke --steps 5 --device cpu --ckpt /tmp/lm_ckpt

A step is the JAX one, in its order: ``lm_loss`` and its gradient, the
global-norm clip at ``OptimConfig.grad_clip``, the AdamW or adafactor
update, ``apply_updates``; nothing is updated in place.  The parameters
live in the JAX layout (``transformer.stacked_params``: stacked
``blocks``), so the optimizers see JAX's leaves and the checkpoint is
one that the JAX package's ``restore_checkpoint`` loads.  Batches come
from ``token_stream``; a VLM gets zero image embeddings and an encdec
model ``max(seq // 4, 16)`` zero frames, as in JAX.  Attention takes the
config's route (``"naive"`` by default), the SSM layers their plain scan
(``forward_train`` under autograd): no hand-written kernel has a
backward.  Weights are drawn from ``seed`` on the device, unless a
JAX-layout tree is handed in.  The device defaults to CUDA and raises
without a GPU; ``--device cpu`` trains on the CPU.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tu
from repro_torch.checkpoint import save_checkpoint
from repro_torch.config import ModelConfig, OptimConfig, get_config
from repro_torch.core.trainer import value_and_grad
from repro_torch.data.synthetic import token_stream
from repro_torch.launch.serve import launcher_extras
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import (apply_updates, clip_by_global_norm,
                                          make_optimizer)


def init_params(cfg: ModelConfig, device, seed: int = 0) -> Dict[str, Any]:
    """A fresh LM's weights, drawn from ``seed`` on ``device``, in the JAX
    layout."""
    model = tfm.LM(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(seed))
    return tfm.stacked_params(model)


def train(cfg: ModelConfig, *, steps: int = 20, batch: int = 8,
          seq: int = 128, lr: float = 3e-4, optim: str = "adamw",
          ckpt: str = "", device="cuda", params: Optional[Any] = None,
          seed: int = 0, log: Callable[[str], None] = print
          ) -> Dict[str, Any]:
    """Train ``cfg`` for ``steps`` steps on ``device``; returns the
    per-step ``losses`` and ``gnorms`` (floats), ``walls`` (seconds of
    each step, ending in the device sync that reads its loss), the final
    ``params`` (JAX layout), ``n_params`` and the checkpoint's ``path``
    (``""`` without ``ckpt``).  ``params``: the initial weights as a
    JAX-layout tree (numpy arrays or tensors), else drawn from ``seed``.
    ``log`` receives the JAX launcher's lines."""
    dev = resolve_device(device)
    oc = OptimConfig(kind=optim, lr=lr)
    opt = make_optimizer(oc)
    if params is None:
        params = init_params(cfg, dev, seed)
    else:
        params = tu.tree_map(lambda x: torch.as_tensor(
            np.array(x) if isinstance(x, np.ndarray) else x, device=dev),
            params)
    model = tfm.meta_lm(cfg)
    opt_state = opt.init(params)
    n_params = sum(x.numel() for x in tu.leaves(params))
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    log(f"arch={cfg.name} params={n_params/1e6:.1f}M devices={n_dev}")
    extras = {k: torch.as_tensor(v, device=dev) for k, v in
              launcher_extras(cfg, batch, max(seq // 4, 16)).items()}

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(
            lambda p: tfm.tree_loss(model, p, batch), params)
        grads, gnorm = clip_by_global_norm(grads, oc.grad_clip)
        updates, opt_state = opt.update(grads, opt_state, params, oc.lr)
        return apply_updates(params, updates), opt_state, loss, gnorm

    stream = token_stream(cfg.vocab, batch, seq)
    losses, gnorms, walls = [], [], []
    t0 = time.time()
    for i in range(steps):
        ts = time.perf_counter()
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in next(stream).items()}
        params, opt_state, loss, gnorm = train_step(params, opt_state,
                                                    {**b, **extras})
        # reading the loss waits for the whole step, the update included
        losses.append(float(loss))
        gnorms.append(float(gnorm))
        walls.append(time.perf_counter() - ts)
        if i % 5 == 0:
            log(f"step {i:4d} loss={losses[-1]:.4f} gnorm={gnorms[-1]:.2f} "
                f"({(time.time()-t0)/(i+1):.2f}s/step)")
    log(f"loss {losses[0]:.4f} -> {np.mean(losses[-3:]):.4f}")
    path = ""
    if ckpt:
        path = save_checkpoint(ckpt, steps, params)
        log(f"checkpoint -> {ckpt}")
    return {"losses": losses, "gnorms": gnorms, "walls": walls,
            "params": params, "n_params": n_params, "path": path}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optim", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return train(get_config(args.arch, smoke=args.smoke), steps=args.steps,
                 batch=args.batch, seq=args.seq, lr=args.lr,
                 optim=args.optim, ckpt=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
