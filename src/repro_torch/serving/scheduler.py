"""Request scheduler: the streaming tick loop and the synchronous batch.

The port of the JAX package's ``serving/scheduler.py`` without its
telemetry.  The serving loop runs as repeated **ticks** over in-flight
groups:

* **admission** — arriving requests (``submit``) pass the admission policy
  (``serving.policies``: shed or degrade past a saturation estimate; a
  deadline that cannot be met is rejected up front), then join an *open*
  group of their own compartment (same qos, tier, shape and sampler) via
  ``grouping.incremental_assign``, or seed one; the launch policy
  (``"eager"`` / ``"pad_aware"`` / ``"adaptive"``) decides when an open
  group launches;
* **advance** — every selected in-flight group moves ``slice_steps``
  sampler steps a tick through the resumable segments.  With ``packed=True``
  (the default) groups of one pack signature (``serving.packing``: phase,
  sampler or the mixed wildcard, shape, segment length) ride ONE call of
  their runner over a stacked carry; ``packed=False`` launches each group
  alone (the oracle: same results, more launches).  Under a
  ``max_groups_per_tick`` cap the slots go to starving groups, then
  deadline-at-risk ones (preemption: displaced groups simply do not
  advance), then by weighted-fair round-robin over the QoS classes;
* **trunk cache** — with a :class:`~repro_torch.serving.trunk_cache.
  TrunkCache`, a newly launched group whose centroid hits the cache skips
  its shared phase and forks straight into branching from the cached
  branch-point latent (its saved NFE in ``nfe_saved_cache``); a group that
  computes its shared phase stores the trunk at its fork;
* **faults** — an optional ``serving.faults.FaultPlan`` fails launches
  (the carry is untouched; the group retries with exponential backoff,
  and is shed with its NFE moved to ``nfe_wasted`` after ``max_retries``)
  and stalls ticks;
* **completion** — finished groups VAE-decode and emit :class:`Completed`
  records with latency, status and NFE share; ``summary()`` rolls up
  latency percentiles, launches per tick, pad waste and the overload
  ledger.

Heterogeneous requests: ``submit(shape=, tier=, sampler=)`` pick the
latent geometry, the step budget (``tiers``) and the solver per request;
groups never mix them, and with ``mix_samplers=True`` packs mix solvers
row by row.

:meth:`run_batch` (what ``SageServingEngine.step()`` calls) is the
synchronous special case: greedy-clique grouping over one prompt list,
phase-aligned packed segments (one stacked launch per phase per drain
tick), no arrivals, no cache, no faults, and the tick counter left alone.

Time is injectable: ``submit`` / ``tick`` take ``now`` (a virtual clock of
one unit a tick, or wall seconds; ``time.monotonic()`` by default).

Each segment goes through the runner of its key (phase, n_steps,
samplers), as in the JAX scheduler (``_shared_runner`` /
``_branch_runner``): on a CUDA device a :class:`~repro_torch.serving.
runners.SegmentRunner`, which captures a CUDA graph per input signature
and replays it, the counterpart of the JAX runners' ``jax.jit``; on the
CPU the segment's body, eagerly.  Packing, the scatter and the ledgers
stay on the host.  The DiT's weights are cast to the activation dtype
once, when the scheduler is built.

Initial noise: the JAX scheduler draws each group's noise from a threefry
key folded with the group id, which torch cannot reproduce.  This
scheduler asks ``noise_fn(gid, shape) -> Tensor`` for it, ``shape`` the
group's own ``(1, H, W, C)``, and asks nothing on a cache hit.  The
default, :func:`default_noise`, is a function of ``(seed, gid)`` alone,
drawn on the CPU (so it does not depend on the device), as the JAX noise
is of its key and the gid: a group's noise does not depend on which
groups drew before it or hit the cache.  Parity tests pass a
``noise_fn`` that returns the JAX-drawn noise.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from dataclasses import replace as dc_replace
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch import resolve_device, seeded_generator
from repro_torch.config import SageConfig
from repro_torch.config import replace as config_replace
from repro_torch.core import grouping
from repro_torch.core.schedule import Schedule, make_schedule
from repro_torch.core.shared_sampling import (SampleCarry,
                                              branch_phase_nfe,
                                              branch_segment, fork_carry,
                                              group_mean, init_carry,
                                              phase_split, segment_solver,
                                              shared_phase_nfe,
                                              shared_segment)
from repro_torch.models.dit import DiT
from repro_torch.models.text_encoder import TextTower, tokenize
from repro_torch.models.vae import VAEDecoder
from repro_torch.serving import packing
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.policies import (DEFAULT_QOS, DEFAULT_TIER,
                                          DEGRADE, QOS_RANK, SHED,
                                          AdmissionContext, AdmissionPolicy,
                                          LaunchContext, LaunchPolicy,
                                          make_admission_policy,
                                          make_launch_order,
                                          make_launch_policy)
from repro_torch.serving.runners import SegmentRunner
from repro_torch.serving.trunk_cache import TrunkCache, TrunkEntry

NoiseFn = Callable[[int, Tuple[int, ...]], torch.Tensor]
# a bucket's solver: one name (uniform pack) or one per row (mixed pack)
Samplers = Union[str, Tuple[str, ...]]


def _ratio(num: float, den: float, default: float = 0.0) -> float:
    """``num / den``, or ``default`` when ``den`` is 0."""
    return num / den if den else default


def default_noise(seed: int, gid: int, shape: Tuple[int, ...]
                  ) -> torch.Tensor:
    """Group ``gid``'s initial noise: standard normal draws from a CPU
    generator seeded from ``(seed, gid)`` alone."""
    return torch.randn(shape, generator=seeded_generator(seed, gid))


@dataclass
class Completed:
    prompt: str
    image: Optional[np.ndarray]   # (H, W, 3) image, the latent without a
    #                               VAE, or None when not served
    group_id: int                 # -1 when refused before grouping
    nfe_share: float
    latency: float = 0.0          # completion time - arrival time
    cache_hit: bool = False       # trunk came from the cross-batch cache
    qos: str = DEFAULT_QOS
    tier: str = DEFAULT_TIER      # quality tier the request ran at
    status: str = "ok"            # ok | degraded | shed | rejected_expired


@dataclass
class Request:
    prompt: str
    cond: torch.Tensor            # (Lc, dc) text features on the device
    pooled: np.ndarray            # (d,) pooled embedding (similarity space)
    rid: int = 0
    t_arrival: float = 0.0
    deadline: Optional[float] = None
    qos: str = DEFAULT_QOS
    degraded: bool = False        # admitted at the degrade tier (overload)
    shape: Tuple[int, ...] = ()   # requested latent (H, W, C)
    tier: str = DEFAULT_TIER      # quality tier (step-budget name)
    sampler: str = ""             # requested solver (ddim | dpmpp)


@dataclass
class _Group:
    """One open or in-flight group — always a (K=1, N) packing."""
    gid: int
    members: List[Request]
    shape: Tuple[int, ...]        # latent (H, W, C): members never mix
    sampler: str                  # solver: members never mix
    total_steps: int              # the tier's step budget (own grid)
    created_tick: int = 0
    state: str = "open"           # open | shared | branch | done
    beta: float = 0.0             # share-ratio bucket
    n_shared: int = 0
    steps_done: int = 0
    t_open: float = 0.0           # clock value when the group was seeded
    carry: Optional[SampleCarry] = None
    cbar: Optional[torch.Tensor] = None       # (1, Lc, dc)
    cond_flat: Optional[torch.Tensor] = None  # (N, Lc, dc)
    mask: Optional[torch.Tensor] = None       # (1, N) on the host
    centroid: Optional[np.ndarray] = None     # mean pooled embedding
    cache_hit: bool = False
    nfe: float = 0.0
    qos: str = DEFAULT_QOS        # members never mix classes
    degraded: bool = False        # any member admitted via tier downgrade
    tier: str = DEFAULT_TIER      # members never mix tiers
    retries: int = 0              # consecutive failed segment launches
    next_try_tick: int = 0        # backoff gate: no advance before this
    starved_ticks: int = 0        # consecutive ticks skipped by selection
    preempted: bool = False       # paused in favour of a higher class

    def earliest_deadline(self) -> float:
        ds = [r.deadline for r in self.members if r.deadline is not None]
        return min(ds) if ds else float("inf")


class RequestScheduler:
    """Embedding, grouping, packed segment execution, VAE decode and the
    NFE / launch / overload ledgers, for the streaming tick loop and the
    synchronous batch.

    ``group_size`` is the packed width N; ``group_max`` caps clique size
    during batch grouping (default N; larger cliques split over several
    rows).  ``attn_impl`` overrides the DiT config's attention route in the
    scheduler's own copy of the config (``self.cfg``), which every forward
    of the scheduler is handed: the DiT module is never written.  The
    modules must live on ``device``.

    Streaming knobs (as in the JAX scheduler): ``slice_steps`` sampler
    steps a group advances per tick; ``max_wait_ticks`` and
    ``deadline_slack`` feed the launch ``policy`` (a name or a
    :class:`~repro_torch.serving.policies.LaunchPolicy`); ``packed``
    stacks pack-compatible groups into one launch per bucket.  Overload:
    ``max_groups_per_tick`` caps the groups advanced per tick;
    ``launch_order`` is the advance priority (``"fifo"`` / ``"edf"`` /
    ``"qos_edf"`` or a key callable); ``qos_weights`` the weighted-fair
    shares per class under the cap (default interactive 2 : batch 1);
    ``preempt`` lets deadline-at-risk groups claim slots, and
    ``starvation_ticks`` bounds how long any group can be skipped;
    ``trunk_cache`` a :class:`~repro_torch.serving.trunk_cache.TrunkCache`
    shared phases are served from and stored into (streaming only);
    ``admission`` is the per-request overload policy (``"shed"`` /
    ``"degrade"`` / an instance); ``faults`` a
    :class:`~repro_torch.serving.faults.FaultPlan`, ``max_retries`` the
    launch retries before a group is shed.  Hetero: ``tiers`` maps tier
    names to step budgets (default draft T//2, standard T, premium
    T + T//2); ``degrade_tier`` is where ``degrade`` admission sends a
    request; ``mix_samplers`` lets packs mix solvers row by row."""

    def __init__(self, sage: SageConfig, dit: DiT, text: TextTower,
                 vae: Optional[VAEDecoder] = None,
                 sched: Optional[Schedule] = None, group_size: int = 4,
                 group_max: Optional[int] = None,
                 branch_buckets: Sequence[float] = (0.2, 0.3, 0.4),
                 slice_steps: int = 4, max_wait_ticks: int = 2,
                 deadline_slack: float = 0.0,
                 trunk_cache: Optional[TrunkCache] = None,
                 max_groups_per_tick: Optional[int] = None,
                 packed: bool = True,
                 policy: Union[str, LaunchPolicy, None] = "eager",
                 launch_order: Any = "qos_edf",
                 qos_weights: Optional[Dict[str, int]] = None,
                 preempt: bool = True,
                 starvation_ticks: int = 4,
                 admission: Union[str, AdmissionPolicy, None] = None,
                 faults: Optional[FaultPlan] = None,
                 max_retries: int = 3,
                 tiers: Optional[Dict[str, int]] = None,
                 degrade_tier: str = "draft",
                 mix_samplers: bool = False,
                 seed: int = 0, noise_fn: Optional[NoiseFn] = None,
                 attn_impl: Optional[str] = None, device="cuda"):
        if group_size < 1:
            raise ValueError(f"group_size must be >= 1, got {group_size}")
        if slice_steps < 1:
            raise ValueError(f"slice_steps must be >= 1, got {slice_steps}")
        self.device = resolve_device(device)
        for name, m in (("dit", dit), ("text", text), ("vae", vae)):
            if m is None:
                continue
            dev = next(m.parameters()).device
            if dev.type != self.device.type:
                raise ValueError(f"{name} lives on {dev}, scheduler device "
                                 f"is {self.device}")
        self.cfg = (dit.cfg if attn_impl is None
                    else config_replace(dit.cfg, attn_impl=attn_impl))
        self.sage = sage
        self.sched = (sched or make_schedule(1000)).to(self.device)
        self.dit = dit
        self.text = text
        self.vae = vae
        self.group_size = group_size
        self.group_max = group_size if group_max is None else group_max
        self.branch_buckets = tuple(branch_buckets)
        self.slice_steps = slice_steps
        self.max_wait_ticks = max_wait_ticks
        self.deadline_slack = deadline_slack
        self.trunk_cache = trunk_cache
        self.max_groups_per_tick = max_groups_per_tick
        self.packed = packed
        self.policy = make_launch_policy(policy)
        self.launch_order = make_launch_order(launch_order)
        self.qos_weights = dict(qos_weights or {"interactive": 2,
                                                "batch": 1})
        for q, w in self.qos_weights.items():
            if w <= 0:
                raise ValueError(
                    f"qos_weights[{q!r}] must be > 0, got {w}")
        self.preempt = preempt
        if starvation_ticks < 1:
            raise ValueError(
                f"starvation_ticks must be >= 1, got {starvation_ticks}")
        self.starvation_ticks = starvation_ticks
        self.admission = make_admission_policy(admission)
        T = sage.total_steps
        self.tiers: Dict[str, int] = (dict(tiers) if tiers is not None
                                      else {"draft": max(1, T // 2),
                                            "standard": T,
                                            "premium": T + max(1, T // 2)})
        self.tiers.setdefault("standard", T)
        for name, steps in self.tiers.items():
            if int(steps) < 1:
                raise ValueError(
                    f"tiers[{name!r}] must be >= 1 steps, got {steps}")
            self.tiers[name] = int(steps)
        if degrade_tier not in self.tiers:
            raise ValueError(f"degrade_tier {degrade_tier!r} not in tiers "
                             f"{sorted(self.tiers)}")
        self.degrade_tier = degrade_tier
        self.mix_samplers = bool(mix_samplers)
        self.faults = faults
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.max_retries = max_retries
        self.noise_fn = noise_fn or (
            lambda gid, shape: default_noise(seed, gid, shape))

        self.arrivals: List[Request] = []      # embedded, awaiting admission
        self.open_groups: List[_Group] = []
        self.inflight: List[_Group] = []
        self.ticks = 0
        self._next_rid = 0
        self._next_gid = 0
        # the DiT's weights in the activation dtype, cast once (bytes; 0 in
        # f32); runners key -> segment runner (a CUDA graph per signature)
        self.cast_bytes = dit.cast_weights_(getattr(torch, self.cfg.dtype))
        self._runners: Dict[Tuple, Callable[..., SampleCarry]] = {}
        self.stats: Dict[str, float] = {
            "nfe": 0.0, "nfe_independent": 0.0, "requests": 0,
            "completed": 0, "nfe_saved_cache": 0.0,
            # segment launches, latent rows they carried, pad rows among them
            "launches": 0, "pack_rows": 0, "pack_pad_rows": 0,
            # overload / fault ledger: requests == completed + shed +
            # shed_faulted + rejected_expired + pending
            "shed": 0, "degraded": 0, "rejected_expired": 0,
            "preemptions": 0, "resumes": 0, "retries": 0,
            "launch_faults": 0, "shed_faulted": 0, "stalled_ticks": 0,
            "deadline_met": 0, "deadline_missed": 0, "nfe_wasted": 0.0}
        # per-class outcome counters and latencies; per-tier NFE / outcome
        # and per-shape launch ledgers
        self.class_stats: Dict[str, Dict[str, float]] = {}
        self.class_latencies: Dict[str, "deque[float]"] = {}
        self.tier_stats: Dict[str, Dict[str, float]] = {}
        self.shape_stats: Dict[str, Dict[str, float]] = {}
        # arrivals-per-tick EWMA (admission's backlog decisions and the
        # adaptive hold budget)
        self._arrival_rate = 0.0
        self._arrivals_since_tick = 0
        # deficit-round-robin credit per class, kept across ticks
        self._wfq_credit: Dict[str, float] = {}
        # bounded windows: summary() percentiles are over the trailing ones
        self._stat_window = 65_536
        self.latencies: "deque[float]" = deque(maxlen=self._stat_window)
        self.occupancy: "deque[float]" = deque(maxlen=self._stat_window)
        self.queue_depth: "deque[int]" = deque(maxlen=self._stat_window)

    # -- embedding ------------------------------------------------------
    def _embed(self, prompts: Sequence[str]
               ) -> Tuple[torch.Tensor, np.ndarray]:
        toks = tokenize(prompts, max_len=self.cfg.cond_len,
                        device=self.device)
        feats, pooled = self.text(toks)
        # tile per-token features to the DiT cond width if needed
        if feats.shape[-1] != self.cfg.cond_dim:
            reps = -(-self.cfg.cond_dim // feats.shape[-1])
            feats = feats.repeat(1, 1, reps)[..., :self.cfg.cond_dim]
        return feats, pooled.float().cpu().numpy()

    @property
    def _latent_shape(self) -> Tuple[int, int, int]:
        """The default latent geometry (the full square trained grid)."""
        H = self.cfg.latent_size
        return (H, H, self.cfg.latent_channels)

    def _null_cond(self) -> torch.Tensor:
        return torch.zeros((self.cfg.cond_len, self.cfg.cond_dim),
                           device=self.device)

    def _cfg_key(self, g: _Group) -> Tuple:
        """Everything but the centroid, beta and shape that must match for
        a cached trunk to be reusable, per group: its own sampler and step
        budget ride the key, so a draft-tier or dpmpp trunk never serves a
        premium or ddim group.  Weights are not hashed: the cache lives
        inside one scheduler, whose weights are fixed."""
        s, c = self.sage, self.cfg
        return (c.name, c.attn_impl, g.sampler, s.step_impl, g.total_steps,
                round(s.guidance_scale, 6), round(s.clip_x0, 6),
                s.shared_uncond_cfg, self.sched.T)

    # -- segment runners (the JAX scheduler's, keyed the same way) ------
    def _runner_cfg(self, samplers: Samplers
                    ) -> Tuple[SageConfig, Optional[Tuple[str, ...]]]:
        """A runner's solver: a NAME (uniform pack, the scalar path) or a
        per-row tuple (mixed pack, ``row_samplers``)."""
        if isinstance(samplers, str):
            return dc_replace(self.sage, sampler=samplers), None
        return self.sage, tuple(samplers)

    def _runner(self, phase: str, n_steps: int, samplers: Samplers
                ) -> Callable[..., SampleCarry]:
        """The runner of key (phase, n_steps, samplers) and the attention
        route every forward of this scheduler takes: the segment's body,
        with the row split of a mixed pack built once here (the scheduler
        hands the grid, the step and fork indices and the mask over on the
        device).  On the CPU the body runs eagerly; on a CUDA device it
        goes through a :class:`SegmentRunner`."""
        key = (phase, n_steps, samplers, self.cfg.attn_impl, self.cfg.dtype)
        if key in self._runners:
            return self._runners[key]
        sage, rs = self._runner_cfg(samplers)
        sage, split = segment_solver(sage, rs, len(rs or ()), self.device)
        dit, cfg, sched = self.dit, self.cfg, self.sched

        def eps_fn(z, t, c):
            return dit(z, t, c, cfg=cfg)

        if phase == "shared":
            def body(carry, cbar, null, grid):
                return shared_segment(eps_fn, sched, sage, carry, cbar, null,
                                      n_steps, grid, split)
        else:
            def body(carry, cond_flat, mask, null, fork_idx, grid):
                return branch_segment(eps_fn, sched, sage, carry, cond_flat,
                                      mask, null, n_steps, fork_idx, grid,
                                      split)
        run = body
        if self.device.type == "cuda":
            dtype = getattr(torch, cfg.dtype)
            run = SegmentRunner(key, body,
                                refresh=lambda: dit.cast_weights_(dtype))
        self._runners[key] = run
        return run

    def _shared_runner(self, n_steps: int, samplers: Samplers
                       ) -> Callable[..., SampleCarry]:
        """``run(carry, cbar, null, grid) -> carry``: a shared segment."""
        return self._runner("shared", n_steps, samplers)

    def _branch_runner(self, n_steps: int, samplers: Samplers
                       ) -> Callable[..., SampleCarry]:
        """``run(carry, cond_flat, mask, null, fork_idx, grid) -> carry``:
        a branch segment."""
        return self._runner("branch", n_steps, samplers)

    # -- submission & admission -----------------------------------------
    @staticmethod
    def _now(now: Optional[float]) -> float:
        return time.monotonic() if now is None else float(now)

    def _check_shape(self, shape) -> Tuple[int, int, int]:
        """Validate a requested latent geometry: 3-tuple, the model's
        channel count, patch-divisible spatial dims within the trained
        positional grid (the DiT windows its table down, never up)."""
        shp = tuple(int(x) for x in shape)
        if len(shp) != 3:
            raise ValueError(f"shape must be (H, W, C), got {shape!r}")
        H, W, C = shp
        if C != self.cfg.latent_channels:
            raise ValueError(f"shape channels {C} != model latent_channels "
                             f"{self.cfg.latent_channels}")
        p, top = self.cfg.patch, self.cfg.latent_size
        if H < 1 or W < 1 or H % p or W % p:
            raise ValueError(f"shape ({H},{W}) must be positive multiples "
                             f"of patch {p}")
        if H > top or W > top:
            raise ValueError(f"shape ({H},{W}) exceeds the trained grid "
                             f"{top}x{top}")
        return shp

    @staticmethod
    def _per_request(val, default, n: int, name: str) -> List:
        """Broadcast a scalar-for-batch submit argument or validate a
        per-prompt sequence of length n."""
        if val is None:
            return [default] * n
        if isinstance(val, str) or (isinstance(val, tuple)
                                    and val and not isinstance(val[0],
                                                               (tuple, list))):
            return [val] * n
        vals = list(val)
        if len(vals) != n:
            raise ValueError(f"{name} sequence length {len(vals)} != "
                             f"{n} prompts")
        return vals

    def submit(self, prompts: Sequence[str], now: Optional[float] = None,
               deadline: Optional[float] = None,
               qos: Union[str, Sequence[str]] = DEFAULT_QOS,
               shape=None, tier=None, sampler=None) -> List[int]:
        """Queue prompts (one text-tower call per submit); they are grouped
        at the next tick.  ``qos``, ``shape``, ``tier`` and ``sampler`` are
        each one value for the whole batch or a per-prompt sequence:
        ``qos`` ``"interactive"`` | ``"batch"``; ``shape`` a
        patch-divisible (H, W, C) up to the trained grid (default the full
        square); ``tier`` a ``tiers`` name (default ``"standard"``);
        ``sampler`` ``"ddim"`` | ``"dpmpp"`` (default ``sage.sampler``).
        Returns request ids."""
        if not prompts:
            return []
        now = self._now(now)
        n = len(prompts)
        qs = self._per_request(qos, DEFAULT_QOS, n, "qos")
        for q in qs:
            if q not in QOS_RANK:
                raise ValueError(f"unknown qos class {q!r}; "
                                 f"have {sorted(QOS_RANK)}")
        shapes = [self._check_shape(s) for s in self._per_request(
            tuple(shape) if isinstance(shape, (tuple, list)) else shape,
            self._latent_shape, n, "shape")]
        tiers = self._per_request(tier, DEFAULT_TIER, n, "tier")
        for t in tiers:
            if t not in self.tiers:
                raise ValueError(f"unknown tier {t!r}; "
                                 f"have {sorted(self.tiers)}")
        samplers = self._per_request(sampler, self.sage.sampler, n,
                                     "sampler")
        for s in samplers:
            if s not in ("ddim", "dpmpp"):
                raise ValueError(f"unknown sampler {s!r}; "
                                 f"have ['ddim', 'dpmpp']")
        conds, pooled = self._embed(prompts)
        rids = []
        for p, c, e, q, shp, t, smp in zip(prompts, conds, pooled, qs,
                                           shapes, tiers, samplers):
            r = Request(p, c, e, rid=self._next_rid, t_arrival=now,
                        deadline=deadline, qos=q, shape=shp, tier=t,
                        sampler=smp)
            self._next_rid += 1
            self.arrivals.append(r)
            rids.append(r.rid)
        self.stats["requests"] += n
        self._arrivals_since_tick += n
        return rids

    # -- overload accounting ---------------------------------------------
    def _cstat(self, qos: str, key: str, inc: float = 1) -> None:
        d = self.class_stats.setdefault(
            qos, {"requests": 0, "completed": 0, "shed": 0, "degraded": 0,
                  "rejected_expired": 0, "preemptions": 0,
                  "deadline_met": 0, "deadline_missed": 0})
        d[key] = d.get(key, 0) + inc

    def _tstat(self, tier: str, key: str, inc: float = 1) -> None:
        d = self.tier_stats.setdefault(
            tier, {"requests": 0, "completed": 0, "nfe": 0.0})
        d[key] = d.get(key, 0) + inc

    def _refuse(self, r: Request, status: str) -> Completed:
        """An accounted non-service outcome (shed / rejected_expired): a
        record with no image."""
        self.stats[status] += 1
        self._cstat(r.qos, "requests")
        self._cstat(r.qos, status)
        self._tstat(r.tier, "requests")
        return Completed(prompt=r.prompt, image=None, group_id=-1,
                         nfe_share=0.0, latency=0.0, qos=r.qos,
                         tier=r.tier, status=status)

    def _remaining_ticks(self, g: _Group) -> int:
        """Conservative advance-ticks left for an in-flight group: one
        segment a tick plus one for the shared->branch boundary."""
        rem = g.total_steps - g.steps_done
        return -(-rem // self.slice_steps) + (1 if g.state == "shared"
                                              else 0)

    def _backlog_ticks(self) -> float:
        """Saturation estimate: ticks to drain the work in the system (the
        sum of per-group ticks over the cap, or the longest group
        uncapped)."""
        loads = [self._remaining_ticks(g) for g in self.inflight]
        loads += [self._ticks_to_finish(g.total_steps)
                  for g in self.open_groups]
        if not loads:
            return 0.0
        if self.max_groups_per_tick is None:
            return float(max(loads))
        return sum(loads) / self.max_groups_per_tick

    def _admit(self, now: float) -> List[Completed]:
        """Expired-deadline rejection and the admission policy, then
        compartmented incremental grouping (a request only joins an open
        group of its own (qos, tier, shape, sampler)); a DEGRADE verdict
        moves the request to ``degrade_tier``.  Returns this tick's
        refusal records."""
        notices: List[Completed] = []
        if not self.arrivals:
            return notices
        backlog = self._backlog_ticks()
        ttf = self._ticks_to_finish()
        per_group = (ttf / self.max_groups_per_tick
                     if self.max_groups_per_tick else 0.0)
        arrivals, self.arrivals = self.arrivals, []
        # member-embedding stacks kept incrementally: only the group an
        # arrival joins changes
        open_embeds = [np.stack([m.pooled for m in g.members])
                       for g in self.open_groups]
        for r in arrivals:
            # a deadline already expired, or expiring within one segment
            if r.deadline is not None and r.deadline <= now + 1.0:
                notices.append(self._refuse(r, "rejected_expired"))
                continue
            verdict = self.admission.decide(AdmissionContext(
                now=now, qos=r.qos, deadline=r.deadline,
                backlog_ticks=backlog, ticks_to_finish=ttf,
                arrival_rate=self._arrival_rate))
            if verdict == SHED:
                notices.append(self._refuse(r, "shed"))
                continue
            if verdict == DEGRADE:
                r.degraded = True
                r.tier = self.degrade_tier
            self._cstat(r.qos, "requests")
            self._tstat(r.tier, "requests")
            cand = [i for i, g in enumerate(self.open_groups)
                    if g.qos == r.qos and g.tier == r.tier
                    and g.shape == r.shape and g.sampler == r.sampler]
            gi = grouping.incremental_assign(
                r.pooled, [open_embeds[i] for i in cand],
                self.sage.tau_min, group_max=self.group_size)
            if gi >= 0:
                g = self.open_groups[cand[gi]]
                g.members.append(r)
                g.degraded = g.degraded or r.degraded
                open_embeds[cand[gi]] = np.concatenate(
                    [open_embeds[cand[gi]], r.pooled[None]], 0)
            else:
                self.open_groups.append(_Group(
                    self._next_gid, [r], shape=r.shape, sampler=r.sampler,
                    total_steps=self.tiers[r.tier],
                    created_tick=self.ticks, t_open=now, qos=r.qos,
                    degraded=r.degraded, tier=r.tier))
                self._next_gid += 1
                open_embeds.append(np.asarray(r.pooled)[None])
                backlog += per_group     # each seeded group deepens the
                #                          queue the next verdict sees
        return notices

    # -- launch ----------------------------------------------------------
    @staticmethod
    def _min_sim(sim_sub: np.ndarray) -> float:
        """Group tightness = min pairwise similarity of a square sim
        submatrix; singletons pin to 1.0."""
        if sim_sub.shape[0] == 1:
            return 1.0
        iu = np.triu_indices(sim_sub.shape[0], k=1)
        return float(sim_sub[iu].min())

    def _beta_bucket(self, min_sim: float, adaptive: bool) -> float:
        """THE share-ratio bucket rule: tighter groups share more,
        min_sim in [0, 1] -> beta_raw in [0, 0.5], snapped to the nearest
        branch bucket."""
        if not adaptive:
            return self.sage.share_ratio
        beta_raw = float(np.clip(min_sim, 0.0, 1.0)) * 0.5
        return min(self.branch_buckets, key=lambda b: abs(b - beta_raw))

    def _group_beta(self, members: List[Request], adaptive: bool) -> float:
        """A group's own share-ratio bucket."""
        e = np.stack([m.pooled for m in members])
        return self._beta_bucket(
            self._min_sim(grouping.similarity_matrix(e)), adaptive)

    def _effective_beta(self, g: _Group, adaptive: bool) -> float:
        """The bucket a group runs at: the similarity rule (degraded groups
        save NFE through their tier's step budget, not through beta)."""
        return self._group_beta(g.members, adaptive)

    def _launch(self, g: _Group, now: float, adaptive: bool,
                beta: Optional[float] = None) -> None:
        """Start open group ``g`` (at ``beta``, or its own bucket): c̄, the
        centroid, the NFE ledger, then either a trunk-cache hit (fork from
        the cached latent, no noise drawn) or initial noise, and the fork
        right away when nothing is shared; ``g`` moves from the open groups
        to the in-flight ones."""
        T = g.total_steps
        g.beta = self._effective_beta(g, adaptive) if beta is None \
            else beta
        g.n_shared, _ = phase_split(T, g.beta)
        N = len(g.members)
        cond = torch.stack([m.cond for m in g.members])       # (N, Lc, dc)
        g.cond_flat = cond
        g.mask = torch.ones((1, N))
        g.cbar = group_mean(cond[None], g.mask)               # (1, Lc, dc)
        g.centroid = np.mean(np.stack([m.pooled for m in g.members]), 0)
        self.occupancy.append(N / self.group_size)
        self.stats["nfe_independent"] += 2.0 * N * T
        entry = None
        if self.trunk_cache is not None and g.n_shared > 0:
            entry = self.trunk_cache.lookup(
                g.centroid, g.beta, self._cfg_key(g), g.shape,
                payload="trunk")
        if entry is not None:
            # cross-batch trunk hit: skip the shared phase, fork straight
            # into branching from the cached branch-point latent (on the
            # device: a victim policy may have spilled it right back)
            z = entry.z.to(self.device)
            step = torch.tensor(entry.step_idx, dtype=torch.long,
                                device=self.device)
            g.carry = fork_carry(SampleCarry(z, torch.zeros_like(z), step),
                                 N)
            g.steps_done = g.n_shared
            g.state = "branch"
            g.cache_hit = True
            self.stats["nfe_saved_cache"] += shared_phase_nfe(1, g.n_shared)
        else:
            shape = (1,) + tuple(g.shape)
            noise = self.noise_fn(g.gid, shape)
            if tuple(noise.shape) != shape:
                raise ValueError(f"noise_fn gave {tuple(noise.shape)} for "
                                 f"group {g.gid}, expected {shape}")
            g.carry = init_carry(noise.to(self.device))
            if g.n_shared == 0:
                g.carry = fork_carry(g.carry, N)
                g.state = "branch"
            else:
                g.state = "shared"
        self.open_groups.remove(g)
        self.inflight.append(g)

    # -- advance ---------------------------------------------------------
    def _store_trunk(self, g: _Group) -> None:
        """Offer a group's trunk to the cache at its fork.  The carry may
        be a row view of a whole pack's output (``packing.unpack_shared``),
        whose storage the byte ledger would not count: the entry holds
        compact copies."""
        if self.trunk_cache is None:
            return
        self.trunk_cache.insert(TrunkEntry(
            z=g.carry.z.clone(), eps_prev=g.carry.eps_prev.clone(),
            step_idx=g.n_shared, beta_bucket=g.beta, rng_fold=g.gid,
            centroid=g.centroid, cfg_key=self._cfg_key(g),
            payload="trunk"), shape=g.shape)

    def _count_launch(self, rows: int, pad_rows: int,
                      shape: Optional[Tuple[int, ...]] = None) -> None:
        """Every segment launch, packed or per-group, lands here once: the
        launch ledger and the per-shape one."""
        self.stats["launches"] += 1
        self.stats["pack_rows"] += rows
        self.stats["pack_pad_rows"] += pad_rows
        if shape:
            d = self.shape_stats.setdefault(
                "x".join(map(str, shape)),
                {"launches": 0, "rows": 0, "pad_rows": 0})
            d["launches"] += 1
            d["rows"] += rows
            d["pad_rows"] += pad_rows

    def _after_segment(self, g: _Group, s: int) -> None:
        """Post-advance NFE accounting + phase transitions (NFE counts the
        logical per-group evals; pad rows ride the pad-waste stat)."""
        g.steps_done += s
        if g.state == "shared":
            g.nfe += shared_phase_nfe(1, s)
            if g.steps_done == g.n_shared:
                self._store_trunk(g)
                g.carry = fork_carry(g.carry, len(g.members))
                g.state = "branch"
        else:
            g.nfe += branch_phase_nfe(g.mask, s,
                                      self.sage.shared_uncond_cfg)
            if g.steps_done == g.total_steps:
                g.state = "done"

    def _advance(self, g: _Group) -> bool:
        """One segment of at most ``slice_steps`` for ONE group, the
        ``packed=False`` oracle.  Returns whether the launch succeeded; an
        injected failure leaves the carry untouched.  The grid position
        goes over per row and the fork index as a tensor, as a packed
        launch hands them over: a Python int would be part of the runner's
        graph key, and a 0-dim index into a 1-D grid is read on the host,
        which a CUDA graph cannot capture."""
        if self.faults is not None and self.faults.launch_fails():
            self.stats["launch_faults"] += 1
            return False
        null = self._null_cond()
        grid = packing.pack_grid([g], self.sched.T).to(self.device)
        rows = 1 if g.state == "shared" else len(g.members)
        carry = g.carry._replace(step_idx=torch.full(
            (rows,), g.steps_done, dtype=torch.long, device=self.device))
        if g.state == "shared":
            s = min(self.slice_steps, g.n_shared - g.steps_done)
            g.carry = self._shared_runner(s, g.sampler)(
                carry, g.cbar, null, grid)
            self._count_launch(1, 0, g.shape)
        else:
            s = min(self.slice_steps, g.total_steps - g.steps_done)
            fork = torch.tensor(g.n_shared, device=self.device)
            g.carry = self._branch_runner(s, g.sampler)(
                carry, g.cond_flat, g.mask.to(self.device), null, fork,
                grid)
            self._count_launch(len(g.members), 0, g.shape)
        self._after_segment(g, s)
        g.retries = 0
        return True

    def _advance_packed(self, todo: List[_Group],
                        slice_steps: Optional[int] = None,
                        align_phases: bool = False) -> List[_Group]:
        """One tick of packed execution: bucket the groups by pack
        signature (rows in ``launch_order``), advance each bucket with ONE
        call of its runner over a stacked carry, scatter back, then apply
        transitions after all buckets, in ``todo`` order (buckets are built
        from pre-tick states, so a group forking this tick joins branch
        packs from the next tick, as on the per-group path).  The grid and
        a branch pack's mask move to the device before the call.

        ``align_phases=True`` (the ``run_batch`` drain) aligns segment
        lengths within each phase: one stacked launch per phase a tick.

        Returns the groups whose bucket the fault plan failed this tick:
        one failed launch takes all its pack-mates down, their carries
        untouched."""
        null = self._null_cond()
        seg_len: Dict[int, int] = {}
        failed: List[_Group] = []
        for key, groups in packing.build_packs(
                todo, self.slice_steps if slice_steps is None else
                slice_steps, mix_samplers=self.mix_samplers,
                align_phases=align_phases, order_key=self.launch_order):
            s = key.n_steps
            if self.faults is not None and self.faults.launch_fails():
                self.stats["launch_faults"] += 1
                failed.extend(groups)
                continue
            if key.phase == "shared":
                carry, cbar = packing.pack_shared(groups)
                run = self._shared_runner(s, self._bucket_samplers(groups))
                out = run(carry, cbar, null,
                          packing.pack_grid(groups, self.sched.T
                                            ).to(self.device))
                packing.unpack_shared(out, groups)
                self._count_launch(len(groups), 0, key.shape)
            else:
                carry, cond, mask, fork = packing.pack_branch(
                    groups, self.group_size)
                run = self._branch_runner(
                    s, self._bucket_samplers(groups, self.group_size))
                out = run(carry, cond, mask.to(self.device), null, fork,
                          packing.pack_grid(groups, self.sched.T,
                                            self.group_size).to(self.device))
                packing.unpack_branch(out, groups, self.group_size)
                self._count_launch(*packing.pad_stats(groups,
                                                      self.group_size),
                                   key.shape)
            for g in groups:
                seg_len[g.gid] = s
        for g in todo:
            if g.gid in seg_len:
                self._after_segment(g, seg_len[g.gid])
                g.retries = 0
        return failed

    @staticmethod
    def _bucket_samplers(groups: Sequence[_Group],
                         width: Optional[int] = None) -> Samplers:
        """A bucket's solver: its groups' common sampler, or per-row names
        for a mixed bucket."""
        return packing.pack_samplers(groups, width) or groups[0].sampler

    def _handle_failures(self, failed: List[_Group],
                         now: float) -> List[Completed]:
        """Retry with backoff, bounded by ``max_retries``: a failed group
        keeps its carry and is re-advanced after ``2^(retries-1)`` ticks
        (capped at 8).  Exhaustion sheds it: members complete with
        ``status='shed'`` and the NFE already spent moves to
        ``nfe_wasted``."""
        out: List[Completed] = []
        for g in failed:
            g.retries += 1
            if g.retries <= self.max_retries:
                self.stats["retries"] += 1
                g.next_try_tick = self.ticks + min(2 ** (g.retries - 1), 8)
                continue
            self.inflight.remove(g)
            self.stats["shed_faulted"] += len(g.members)
            self.stats["nfe_wasted"] += g.nfe
            for r in g.members:
                self._cstat(r.qos, "shed")
                out.append(Completed(
                    prompt=r.prompt, image=None, group_id=g.gid,
                    nfe_share=0.0, latency=now - r.t_arrival, qos=r.qos,
                    tier=r.tier, status="shed"))
        return out

    def _decode(self, latents: torch.Tensor) -> np.ndarray:
        """latents (B, H, W, C) -> images (or raw latents without a VAE)."""
        if self.vae is not None:
            latents = self.vae(latents)
        return latents.float().cpu().numpy()

    def _complete(self, g: _Group, now: float,
                  record_latency: bool = True) -> List[Completed]:
        """Decode a finished group; each member's status (degraded is a
        request's admission outcome), latency and deadline outcome."""
        imgs = self._decode(g.carry.z)
        self.stats["nfe"] += g.nfe
        self.stats["completed"] += len(g.members)
        done = []
        for i, r in enumerate(g.members):
            status = "degraded" if r.degraded else "ok"
            lat = now - r.t_arrival if record_latency else 0.0
            if record_latency:
                self.latencies.append(lat)
                self.class_latencies.setdefault(
                    r.qos, deque(maxlen=self._stat_window)).append(lat)
                self._cstat(r.qos, "completed")
                self._tstat(r.tier, "completed")
                self._tstat(r.tier, "nfe", g.nfe / len(g.members))
                if r.degraded:
                    self.stats["degraded"] += 1
                    self._cstat(r.qos, "degraded")
                met = r.deadline is None or now <= r.deadline
                key = "deadline_met" if met else "deadline_missed"
                self.stats[key] += 1
                self._cstat(r.qos, key)
            done.append(Completed(
                prompt=r.prompt, image=imgs[i], group_id=g.gid,
                nfe_share=g.nfe / len(g.members), latency=lat,
                cache_hit=g.cache_hit, qos=r.qos, tier=r.tier,
                status=status))
        return done

    # -- launch-policy context -------------------------------------------
    def _ticks_to_finish(self, total_steps: Optional[int] = None) -> int:
        """Conservative ticks a freshly launched group needs: one segment
        a tick plus one for the fork boundary (``total_steps`` defaults to
        the standard budget)."""
        t = self.sage.total_steps if total_steps is None else total_steps
        return -(-t // self.slice_steps) + 1

    def _open_signature(self, g: _Group, adaptive: bool) -> packing.PackKey:
        """The pack bucket an open group would occupy if launched now."""
        n_shared, _ = phase_split(g.total_steps,
                                  self._effective_beta(g, adaptive))
        limit = n_shared if n_shared > 0 else g.total_steps
        return packing.PackKey(
            "shared" if n_shared > 0 else "branch",
            packing.MIXED if self.mix_samplers else g.sampler,
            tuple(g.shape), min(self.slice_steps, limit))

    def _launch_context(self, now: float, adaptive: bool) -> LaunchContext:
        ttf = max([self._ticks_to_finish()]
                  + [self._ticks_to_finish(g.total_steps)
                     for g in self.open_groups])
        return LaunchContext(
            now=now, tick=self.ticks, group_size=self.group_size,
            max_wait_ticks=self.max_wait_ticks,
            deadline_slack=self.deadline_slack,
            ticks_to_finish=ttf,
            inflight_signatures=frozenset(
                packing.pack_signature(g, self.slice_steps,
                                       self.mix_samplers)
                for g in self.inflight),
            signature_of=lambda g: self._open_signature(g, adaptive),
            arrival_rate=self._arrival_rate)

    # -- advance-slot selection ------------------------------------------
    def _at_risk(self, g: _Group, now: float) -> bool:
        """Skipping one more tick would push the group's conservative
        finish past its earliest deadline (plus the slack)."""
        dl = g.earliest_deadline()
        if dl == float("inf"):
            return False
        return dl - now <= (self._remaining_ticks(g)
                            + self.deadline_slack + 1.0)

    def _preemptive_select(self, ready: List[_Group], cap: int,
                           now: float) -> List[_Group]:
        """The capped slots in three passes over the ``launch_order``-sorted
        ready list: groups at the ``starvation_ticks`` bound first
        (longest-starved first), then deadline-at-risk groups (the
        preemption), then deficit round-robin over the QoS classes with
        ``qos_weights`` (credit kept across ticks).  A group the plain
        priority prefix would have advanced but the claims displaced
        counts one preemption."""
        slots: List[_Group] = []
        taken = set()

        def take(g: _Group) -> None:
            slots.append(g)
            taken.add(g.gid)

        starving = sorted(
            (g for g in ready
             if g.starved_ticks >= self.starvation_ticks),
            key=lambda g: (-g.starved_ticks,) + tuple(self.launch_order(g)))
        for g in starving:
            if len(slots) >= cap:
                break
            take(g)
        for g in ready:
            if len(slots) >= cap:
                break
            if g.gid not in taken and self._at_risk(g, now):
                take(g)
        if len(slots) < cap:
            queues: Dict[str, "deque[_Group]"] = {}
            for g in ready:
                if g.gid not in taken:
                    queues.setdefault(g.qos, deque()).append(g)
            classes = sorted(queues,
                             key=lambda q: (QOS_RANK.get(q, len(QOS_RANK)),
                                            q))
            while len(slots) < cap and any(queues.values()):
                for q in classes:
                    if not queues[q]:
                        self._wfq_credit[q] = 0.0   # no deficit hoarding
                        continue
                    self._wfq_credit[q] = (self._wfq_credit.get(q, 0.0)
                                           + self.qos_weights.get(q, 1))
                    while (queues[q] and len(slots) < cap
                           and self._wfq_credit[q] >= 1.0):
                        take(queues[q].popleft())
                        self._wfq_credit[q] -= 1.0
        for g in ready[:cap]:
            if g.gid not in taken and not g.preempted:
                g.preempted = True
                self.stats["preemptions"] += 1
                self._cstat(g.qos, "preemptions")
        return slots

    def _select_todo(self, now: float) -> List[_Group]:
        """This tick's advance set: every ready group uncapped (retry
        backoff is the only filter); under a cap the ``launch_order``
        prefix (``preempt=False``) or :meth:`_preemptive_select`.  Skipped
        groups age toward the starvation bound; a preempted group that
        advances again counts one resume."""
        ready = [g for g in self.inflight if g.next_try_tick <= self.ticks]
        ready.sort(key=self.launch_order)
        cap = self.max_groups_per_tick
        if cap is None or len(ready) <= cap:
            selected = ready
        elif not self.preempt:
            selected = ready[:cap]
        else:
            selected = self._preemptive_select(ready, cap, now)
        chosen = {g.gid for g in selected}
        for g in ready:
            if g.gid in chosen:
                if g.preempted:
                    g.preempted = False
                    self.stats["resumes"] += 1
                g.starved_ticks = 0
            else:
                g.starved_ticks += 1
        return selected

    # -- the tick --------------------------------------------------------
    def tick(self, now: Optional[float] = None,
             adaptive: Optional[bool] = None) -> List[Completed]:
        """One engine iteration: admit arrivals (returning shed / rejected
        records beside completions), launch the groups the launch policy
        picks, advance the selected in-flight groups one segment each,
        retry or shed failed launches, emit completions."""
        now = self._now(now)
        adaptive = (self.sage.adaptive_branch if adaptive is None
                    else adaptive)
        self.ticks += 1
        self._arrival_rate = (0.5 * self._arrivals_since_tick
                              + 0.5 * self._arrival_rate)
        self._arrivals_since_tick = 0
        if self.faults is not None and self.faults.tick_stalls():
            # a stalled tick is lost time: no admission, launch or segment
            self.stats["stalled_ticks"] += 1
            return []
        done: List[Completed] = self._admit(now)
        self.queue_depth.append(sum(len(g.members)
                                    for g in self.open_groups))
        ctx = self._launch_context(now, adaptive)
        for g in self.policy.launches(list(self.open_groups), ctx):
            self._launch(g, now, adaptive)
        todo = self._select_todo(now)
        failed: List[_Group] = []
        if self.packed:
            if todo:
                failed = self._advance_packed(todo)
        else:
            for g in todo:
                if not self._advance(g):
                    failed.append(g)
        done.extend(self._handle_failures(failed, now))
        for g in todo:
            if g.state == "done":
                done.extend(self._complete(g, now))
                self.inflight.remove(g)
        return done

    def drain(self, now: Optional[float] = None,
              max_ticks: int = 10_000) -> List[Completed]:
        """Tick until no work remains, ``now`` passed to every tick (under
        a virtual clock it then stands still for the whole drain)."""
        done: List[Completed] = []
        for _ in range(max_ticks):
            if not (self.arrivals or self.open_groups or self.inflight):
                break
            done.extend(self.tick(now))
        return done

    @property
    def pending(self) -> int:
        return (len(self.arrivals)
                + sum(len(g.members) for g in self.open_groups)
                + sum(len(g.members) for g in self.inflight))

    # -- synchronous batch -----------------------------------------------
    def run_batch(self, prompts: Sequence[str],
                  adaptive: Optional[bool] = None) -> List[Completed]:
        """Drain one prompt list synchronously: greedy-clique grouping
        over the whole batch, per-clique beta buckets, phase-aligned
        packed segments, VAE decode.  No trunk cache and no faults (the
        drain has no tick to retry on), and the tick counter does not move (streaming groups'
        waits are counted in ticks).  Completions come back in group
        completion order."""
        if not prompts:
            return []
        now = self._now(None)
        adaptive = (self.sage.adaptive_branch if adaptive is None
                    else adaptive)
        conds, pooled = self._embed(prompts)
        sim = grouping.similarity_matrix(pooled)
        cliques = grouping.greedy_clique_groups(
            sim, self.sage.tau_min, group_max=self.group_max)
        self.stats["requests"] += len(prompts)

        # one _Group per packed row (a clique larger than N occupies
        # multiple rows in flatten_groups order); every row inherits its
        # clique's beta bucket
        cache, self.trunk_cache = self.trunk_cache, None
        faults, self.faults = self.faults, None
        try:
            live: List[_Group] = []
            for clique in cliques:
                beta = self._beta_bucket(
                    self._min_sim(sim[np.ix_(clique, clique)]), adaptive)
                for row in grouping.flatten_groups([clique],
                                                   self.group_size):
                    members = []
                    for m in row:
                        members.append(Request(
                            prompts[m], conds[m], pooled[m],
                            rid=self._next_rid, t_arrival=now,
                            shape=self._latent_shape, tier="standard",
                            sampler=self.sage.sampler))
                        self._next_rid += 1
                    g = _Group(self._next_gid, members,
                               shape=self._latent_shape,
                               sampler=self.sage.sampler,
                               total_steps=self.tiers["standard"],
                               created_tick=self.ticks, tier="standard")
                    self._next_gid += 1
                    self.open_groups.append(g)
                    self._launch(g, now, adaptive, beta=beta)
                    live.append(g)

            done: List[Completed] = []
            while live:
                self._advance_packed(live, slice_steps=self.sage.total_steps,
                                     align_phases=True)
                for g in list(live):
                    if g.state == "done":
                        done.extend(self._complete(g, now,
                                                   record_latency=False))
                        live.remove(g)
                        self.inflight.remove(g)
        finally:
            self.trunk_cache = cache
            self.faults = faults
        return done

    # -- reporting -------------------------------------------------------
    @property
    def cost_saving(self) -> float:
        return 1.0 - _ratio(self.stats["nfe"], self.stats["nfe_independent"],
                            default=1.0)

    def summary(self) -> Dict[str, float]:
        """End-of-run rollup, the JAX scheduler's keys (with a trunk cache,
        its ``cache_*`` keys too); zero-denominator ratios report 0.0."""
        lat = np.asarray(self.latencies, np.float64)
        out = {
            "requests": self.stats["requests"],
            "completed": self.stats["completed"],
            "nfe": self.stats["nfe"],
            "nfe_independent": self.stats["nfe_independent"],
            "nfe_saved_cache": self.stats["nfe_saved_cache"],
            "nfe_per_request": _ratio(self.stats["nfe"],
                                      self.stats["completed"]),
            "cost_saving": self.cost_saving,
            "latency_p50": float(np.percentile(lat, 50)) if lat.size else 0.0,
            "latency_p95": float(np.percentile(lat, 95)) if lat.size else 0.0,
            "occupancy_mean": (float(np.mean(self.occupancy))
                               if self.occupancy else 0.0),
            "queue_depth_mean": (float(np.mean(self.queue_depth))
                                 if self.queue_depth else 0.0),
            "ticks": self.ticks,
            # launches_per_tick is the dispatch pressure packing collapses;
            # pad_waste what it pays (the share of launched rows that pad)
            "launches": self.stats["launches"],
            "launches_per_tick": _ratio(self.stats["launches"], self.ticks),
            "pad_waste": _ratio(self.stats["pack_pad_rows"],
                                self.stats["pack_rows"]),
        }
        for k in ("shed", "shed_faulted", "degraded", "rejected_expired",
                  "preemptions", "resumes", "retries", "launch_faults",
                  "stalled_ticks", "deadline_met", "deadline_missed",
                  "nfe_wasted"):
            out[k] = self.stats[k]
        # goodput: deadline-met completions
        out["goodput"] = self.stats["deadline_met"]
        out["goodput_per_tick"] = _ratio(self.stats["deadline_met"],
                                         self.ticks)
        out["arrival_rate"] = self._arrival_rate
        out["backlog_ticks"] = self._backlog_ticks()
        for q, cs in sorted(self.class_stats.items()):
            for k, v in sorted(cs.items()):
                out[f"{q}_{k}"] = v
        for q, lats in sorted(self.class_latencies.items()):
            a = np.asarray(lats, np.float64)
            out[f"{q}_latency_p50"] = (float(np.percentile(a, 50))
                                       if a.size else 0.0)
            out[f"{q}_latency_p95"] = (float(np.percentile(a, 95))
                                       if a.size else 0.0)
        for t, ts in sorted(self.tier_stats.items()):
            for k, v in sorted(ts.items()):
                out[f"tier_{t}_{k}"] = v
        for s, ss in sorted(self.shape_stats.items()):
            for k, v in sorted(ss.items()):
                out[f"shape_{s}_{k}"] = v
        tc = self.trunk_cache
        if tc is not None:
            out["cache_hits"] = tc.stats["hits"]
            out["cache_exact_hits"] = tc.stats["exact_hits"]
            out["cache_hits_hbm"] = tc.stats["hits_hbm"]
            out["cache_hits_host"] = tc.stats["hits_host"]
            out["cache_admission_rejects"] = tc.stats["admission_rejects"]
            out["cache_hit_rate"] = tc.hit_rate
            out["cache_entries"] = len(tc)
            out["cache_bytes"] = tc.bytes
            out["cache_index"] = tc.index.name
            out["cache_spills"] = tc.stats["spills"]
            out["cache_promotions"] = tc.stats["promotions"]
            out["cache_hbm_bytes"] = tc.tier_bytes["hbm"]
            out["cache_host_bytes"] = tc.tier_bytes["host"]
        return out
