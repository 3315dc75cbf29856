"""PyTorch / CUDA port of the SAGE serving system.

Mirrors the layout of the JAX package ``repro`` (``core/``, ``models/``,
``kernels/``, ``serving/``) so every module has an obvious twin.  The
port imports torch, numpy and the standard library only.

Entry points take ``device="cuda"`` by default and raise when no GPU is
present; pass ``device="cpu"`` to run the plain PyTorch versions of the
kernels on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  Asking for CUDA on a machine
    without a GPU raises: nothing falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch path")
    return dev


def seeded_generator(seed: int, k: int) -> torch.Generator:
    """A CPU generator seeded from the pair ``(seed, k)`` alone.  The
    generator keeps 32 bits of its seed, so the pair is mixed through
    ``numpy.random.SeedSequence`` first."""
    return torch.Generator().manual_seed(int(np.random.SeedSequence(
        [seed & 0xFFFFFFFFFFFFFFFF, k]).generate_state(1)[0]))
