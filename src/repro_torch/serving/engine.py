"""SAGE diffusion serving engine (the paper's deployment surface).

Request lifecycle:
  submit(prompts) -> [queue] -> embed (text tower) -> semantic grouping
  (greedy cliques over the tau threshold graph) -> Alg. 1 shared sampling
  in packed segments -> VAE decode -> responses + NFE accounting.

``step()`` delegates to :meth:`RequestScheduler.run_batch`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.config import SageConfig
from repro_torch.config import replace as config_replace
from repro_torch.core.schedule import Schedule
from repro_torch.models.dit import DiT
from repro_torch.models.text_encoder import TextTower
from repro_torch.models.vae import VAEDecoder
from repro_torch.serving.scheduler import (Completed, NoiseFn,
                                           RequestScheduler)

__all__ = ["Completed", "SageServingEngine"]


class SageServingEngine:
    def __init__(self, sage: SageConfig, dit: DiT, text: TextTower,
                 vae: Optional[VAEDecoder] = None,
                 sched: Optional[Schedule] = None, group_size: int = 4,
                 branch_buckets: Sequence[float] = (0.2, 0.3, 0.4),
                 seed: int = 0, attn_impl: Optional[str] = None,
                 step_impl: Optional[str] = None,
                 noise_fn: Optional[NoiseFn] = None, device="cuda"):
        """``attn_impl`` / ``step_impl`` override the DiT's and the
        sampler's kernel routes (``attn_impl`` is written into the DiT's
        config in place): ``attn_impl="kernel"`` + ``step_impl="fused"``
        runs the sampling hot path on the hand-written CUDA kernels.  The
        text tower keeps its own config's route.  ``device`` defaults to
        CUDA and raises without a GPU; the modules must live there."""
        if attn_impl is not None:
            dit.cfg = config_replace(dit.cfg, attn_impl=attn_impl)
        if step_impl is not None:
            sage = config_replace(sage, step_impl=step_impl)
        self.sage = sage
        self.queue: List[str] = []
        self.scheduler = RequestScheduler(
            sage, dit, text, vae, sched=sched, group_size=group_size,
            branch_buckets=branch_buckets, seed=seed, noise_fn=noise_fn,
            device=device)

    def submit(self, prompts: Sequence[str]) -> None:
        self.queue.extend(prompts)

    def step(self, max_batch: int = 32, adaptive: Optional[bool] = None
             ) -> List[Completed]:
        """Serve one engine iteration over up to max_batch queued prompts."""
        if not self.queue:
            return []
        prompts = self.queue[:max_batch]
        self.queue = self.queue[max_batch:]
        return self.scheduler.run_batch(prompts, adaptive=adaptive)

    @property
    def stats(self):
        return self.scheduler.stats

    @property
    def cost_saving(self) -> float:
        return self.scheduler.cost_saving
