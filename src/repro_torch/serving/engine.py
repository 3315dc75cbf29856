"""SAGE diffusion serving engine (the paper's deployment surface).

Request lifecycle:
  submit(prompts) -> [queue] -> embed (text tower) -> semantic grouping
  (greedy cliques over the tau threshold graph) -> Alg. 1 shared sampling
  in packed segments -> VAE decode -> responses + NFE accounting.

``step()`` delegates to :meth:`RequestScheduler.run_batch`, whose segment
runners (CUDA graphs on a CUDA device) live on the scheduler and go with
the engine.  The text tower and the VAE decoder run eagerly, once per
batch.  For arrival-driven serving (ticks, QoS, admission, faults,
per-request shape / tier / sampler, the cross-batch trunk cache), drive a
scheduler of :meth:`SageServingEngine.streaming_scheduler` directly.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

from repro_torch.config import SageConfig
from repro_torch.config import replace as config_replace
from repro_torch.core.schedule import Schedule
from repro_torch.models.dit import DiT
from repro_torch.models.text_encoder import TextTower
from repro_torch.models.vae import VAEDecoder
from repro_torch.serving.policies import LaunchPolicy
from repro_torch.serving.scheduler import (Completed, NoiseFn,
                                           RequestScheduler)
from repro_torch.serving.telemetry import MetricsRegistry, Tracer
from repro_torch.serving.trunk_cache import TrunkCache

__all__ = ["Completed", "SageServingEngine"]


class SageServingEngine:
    def __init__(self, sage: SageConfig, dit: DiT, text: TextTower,
                 vae: Optional[VAEDecoder] = None,
                 sched: Optional[Schedule] = None, group_size: int = 4,
                 branch_buckets: Sequence[float] = (0.2, 0.3, 0.4),
                 seed: int = 0, attn_impl: Optional[str] = None,
                 step_impl: Optional[str] = None,
                 noise_fn: Optional[NoiseFn] = None,
                 policy: Union[str, LaunchPolicy] = "eager", device="cuda",
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None):
        """``attn_impl`` / ``step_impl`` override the DiT's and the
        sampler's kernel routes (``attn_impl`` in the scheduler's own copy
        of the DiT config: the module is left as it is, so engines sharing
        one DiT keep their own routes): ``attn_impl="kernel"`` +
        ``step_impl="fused"`` runs the sampling hot path on the hand-written
        CUDA kernels.  The text tower keeps its own config's route.
        ``policy`` is the launch policy (``serving.policies``) the
        :meth:`streaming_scheduler` inherits; the synchronous :meth:`step`
        has no arrivals to hold for.  ``device`` defaults to CUDA and
        raises without a GPU; the modules must live there.
        ``tracer`` / ``metrics`` (``serving.telemetry``) go to the
        engine's own scheduler; a streaming scheduler wants its own
        (registry names are claimed once per scheduler): pass them to
        :meth:`streaming_scheduler`."""
        if step_impl is not None:
            sage = config_replace(sage, step_impl=step_impl)
        self.sage = sage
        self.modules = (dit, text, vae)
        self.sched = sched
        self.group_size = group_size
        self.branch_buckets = branch_buckets
        self.seed = seed
        self.attn_impl = attn_impl
        self.noise_fn = noise_fn
        self.policy = policy
        self.queue: List[str] = []
        self.scheduler = RequestScheduler(
            sage, dit, text, vae, sched=sched, group_size=group_size,
            branch_buckets=branch_buckets, policy=policy, seed=seed,
            noise_fn=noise_fn, attn_impl=attn_impl, device=device,
            tracer=tracer, metrics=metrics)

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

    def streaming_scheduler(self, slice_steps: int = 4,
                            max_wait_ticks: int = 2,
                            trunk_cache: Optional[TrunkCache] = None,
                            **kw) -> RequestScheduler:
        """A fresh streaming scheduler on this engine's modules, routes,
        device (unless ``device=`` says otherwise) and ``noise_fn``, with an
        optional cross-batch ``trunk_cache``; the engine's own scheduler
        and stats are untouched.  The streaming knobs of
        :class:`RequestScheduler` (``packed``, ``tiers``, ``mix_samplers``,
        QoS, admission, faults, ``tracer`` / ``metrics``) go through
        ``**kw``; per-request shape / tier / sampler are chosen at
        ``submit()``."""
        kw.setdefault("seed", self.seed)
        kw.setdefault("policy", self.policy)
        kw.setdefault("noise_fn", self.noise_fn)
        kw.setdefault("device", self.scheduler.device)
        return RequestScheduler(
            self.sage, *self.modules, sched=self.sched,
            group_size=self.group_size, branch_buckets=self.branch_buckets,
            slice_steps=slice_steps, max_wait_ticks=max_wait_ticks,
            trunk_cache=trunk_cache, attn_impl=self.attn_impl, **kw)

    @property
    def stats(self):
        return self.scheduler.stats

    @property
    def cost_saving(self) -> float:
        return self.scheduler.cost_saving
