"""Request scheduler — the synchronous ``run_batch`` path.

``SageServingEngine.step()`` delegates to :meth:`RequestScheduler.run_batch`:
embed the prompts with the text tower, group them by greedy cliques over
the cosine-similarity graph, launch one sampling trajectory per group, and
drain all groups through phase-aligned packed segments (ONE stacked
launch per phase per drain tick, across beta buckets), then VAE-decode.

This is the JAX scheduler's ``run_batch`` and what it uses; the streaming
tick loop, QoS, fault injection, the trunk cache and telemetry come with
later slices.

Initial noise: the JAX scheduler draws each group's noise from a threefry
key folded with the group id, which torch cannot reproduce.  This
scheduler asks ``noise_fn(gid, shape) -> Tensor`` for it; the default
draws from the scheduler's own seeded ``torch.Generator`` (on the CPU, so
the noise does not depend on the device), and parity tests pass a
``noise_fn`` that returns the JAX-drawn noise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import SageConfig
from repro_torch.core import grouping
from repro_torch.core.schedule import Schedule, make_schedule
from repro_torch.core.shared_sampling import (SampleCarry, branch_phase,
                                              branch_phase_nfe, fork_carry,
                                              group_mean, init_carry,
                                              phase_split, shared_phase,
                                              shared_phase_nfe)
from repro_torch.models.dit import DiT
from repro_torch.models.text_encoder import TextTower, tokenize
from repro_torch.models.vae import VAEDecoder
from repro_torch.serving import packing

NoiseFn = Callable[[int, Tuple[int, ...]], torch.Tensor]


@dataclass
class Completed:
    prompt: str
    image: np.ndarray             # (H, W, 3) image, or the latent without a VAE
    group_id: int
    nfe_share: float


@dataclass
class Request:
    prompt: str
    cond: torch.Tensor            # (Lc, dc) text features on the device
    pooled: np.ndarray            # (d,) pooled embedding (similarity space)


@dataclass
class _Group:
    """One in-flight group — always a (K=1, N) packing."""
    gid: int
    members: List[Request]
    shape: Tuple[int, ...]        # latent (H, W, C)
    sampler: str
    total_steps: int
    state: str = "open"           # open | shared | branch | done
    n_shared: int = 0
    steps_done: int = 0
    carry: Optional[SampleCarry] = None
    cbar: Optional[torch.Tensor] = None       # (1, Lc, dc)
    cond_flat: Optional[torch.Tensor] = None  # (N, Lc, dc)
    mask: Optional[torch.Tensor] = None       # (1, N) on the host
    nfe: float = 0.0


class RequestScheduler:
    """Embedding, grouping, packed segment execution, VAE decode and the
    NFE / launch ledger of the synchronous serving path.

    ``group_size`` is the packed width N; ``group_max`` caps clique size
    during grouping (default N; larger cliques split over several rows).
    The modules must live on ``device``."""

    def __init__(self, sage: SageConfig, dit: DiT, text: TextTower,
                 vae: Optional[VAEDecoder] = None,
                 sched: Optional[Schedule] = None, group_size: int = 4,
                 group_max: Optional[int] = None,
                 branch_buckets: Sequence[float] = (0.2, 0.3, 0.4),
                 seed: int = 0, noise_fn: Optional[NoiseFn] = None,
                 device="cuda"):
        if group_size < 1:
            raise ValueError(f"group_size must be >= 1, got {group_size}")
        self.device = resolve_device(device)
        for name, m in (("dit", dit), ("text", text), ("vae", vae)):
            if m is None:
                continue
            dev = next(m.parameters()).device
            if dev.type != self.device.type:
                raise ValueError(f"{name} lives on {dev}, scheduler device "
                                 f"is {self.device}")
        self.cfg = dit.cfg
        self.sage = sage
        self.sched = (sched or make_schedule(1000)).to(self.device)
        self.dit = dit
        self.text = text
        self.vae = vae
        self.group_size = group_size
        self.group_max = group_size if group_max is None else group_max
        self.branch_buckets = tuple(branch_buckets)
        self._gen = torch.Generator().manual_seed(seed)
        self.noise_fn = noise_fn or self._default_noise
        self._next_gid = 0
        self.stats: Dict[str, float] = {
            "nfe": 0.0, "nfe_independent": 0.0, "requests": 0,
            "completed": 0,
            # segment launches, latent rows they carried, pad rows among them
            "launches": 0, "pack_rows": 0, "pack_pad_rows": 0}

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
        H = self.cfg.latent_size
        return (H, H, self.cfg.latent_channels)

    def _null_cond(self) -> torch.Tensor:
        return torch.zeros((self.cfg.cond_len, self.cfg.cond_dim),
                           device=self.device)

    def _default_noise(self, gid: int, shape: Tuple[int, ...]
                       ) -> torch.Tensor:
        del gid
        return torch.randn(shape, generator=self._gen)

    def _eps_fn(self, z, t, c):
        return self.dit(z, t, c)

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

    def _launch(self, g: _Group, beta: float) -> None:
        """Start group ``g`` at share-ratio bucket ``beta``: c̄, NFE ledger,
        initial noise, and the fork right away when nothing is shared."""
        T = g.total_steps
        g.n_shared, _ = phase_split(T, beta)
        N = len(g.members)
        cond = torch.stack([m.cond for m in g.members])       # (N, Lc, dc)
        g.cond_flat = cond
        g.mask = torch.ones((1, N))
        g.cbar = group_mean(cond[None], g.mask)               # (1, Lc, dc)
        self.stats["nfe_independent"] += 2.0 * N * T
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

    # -- advance ---------------------------------------------------------
    def _count_launch(self, rows: int, pad_rows: int) -> None:
        self.stats["launches"] += 1
        self.stats["pack_rows"] += rows
        self.stats["pack_pad_rows"] += pad_rows

    def _after_segment(self, g: _Group, s: int) -> None:
        """Post-advance NFE accounting + phase transitions (NFE counts the
        logical per-group evals; pad rows ride the pad-waste stat)."""
        g.steps_done += s
        if g.state == "shared":
            g.nfe += shared_phase_nfe(1, s)
            if g.steps_done == g.n_shared:
                g.carry = fork_carry(g.carry, len(g.members))
                g.state = "branch"
        else:
            g.nfe += branch_phase_nfe(g.mask, s,
                                      self.sage.shared_uncond_cfg)
            if g.steps_done == g.total_steps:
                g.state = "done"

    def _advance_packed(self, todo: List[_Group], slice_steps: int) -> None:
        """One drain tick: bucket the groups by pack signature with
        phase-aligned segment lengths, advance each bucket with ONE phase
        call over a stacked carry, scatter back, then apply transitions in
        ``todo`` order."""
        null = self._null_cond()
        seg_len: Dict[int, int] = {}
        for key, groups in packing.build_packs(todo, slice_steps,
                                               align_phases=True):
            s = key.n_steps
            grid = packing.pack_grid(groups, self.sched.T, self.device)
            if key.phase == "shared":
                carry, cbar = packing.pack_shared(groups)
                out = shared_phase(self._eps_fn, self.sched, self.sage,
                                   carry, cbar, null, s, grid=grid)
                packing.unpack_shared(out, groups)
                self._count_launch(len(groups), 0)
            else:
                carry, cond, mask, fork = packing.pack_branch(
                    groups, self.group_size)
                out = branch_phase(self._eps_fn, self.sched, self.sage,
                                   carry, cond, mask, null, s, fork,
                                   grid=grid)
                packing.unpack_branch(out, groups, self.group_size)
                self._count_launch(*packing.pad_stats(groups,
                                                      self.group_size))
            for g in groups:
                seg_len[g.gid] = s
        for g in todo:
            if g.gid in seg_len:
                self._after_segment(g, seg_len[g.gid])

    def _decode(self, latents: torch.Tensor) -> np.ndarray:
        """latents (B, H, W, C) -> images (or raw latents without a VAE)."""
        if self.vae is not None:
            latents = self.vae(latents)
        return latents.float().cpu().numpy()

    def _complete(self, g: _Group) -> List[Completed]:
        imgs = self._decode(g.carry.z)
        self.stats["nfe"] += g.nfe
        self.stats["completed"] += len(g.members)
        return [Completed(prompt=r.prompt, image=imgs[i], group_id=g.gid,
                          nfe_share=g.nfe / len(g.members))
                for i, r in enumerate(g.members)]

    # -- synchronous batch -----------------------------------------------
    def run_batch(self, prompts: Sequence[str],
                  adaptive: Optional[bool] = None) -> List[Completed]:
        """Drain one prompt list synchronously: greedy-clique grouping
        over the whole batch, per-clique beta buckets, phase-aligned
        packed segments, VAE decode.  Completions come back in group
        completion order."""
        if not prompts:
            return []
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
        live: List[_Group] = []
        for clique in cliques:
            beta = self._beta_bucket(
                self._min_sim(sim[np.ix_(clique, clique)]), adaptive)
            for row in grouping.flatten_groups([clique], self.group_size):
                members = [Request(prompts[m], conds[m], pooled[m])
                           for m in row]
                g = _Group(self._next_gid, members,
                           shape=self._latent_shape,
                           sampler=self.sage.sampler,
                           total_steps=self.sage.total_steps)
                self._next_gid += 1
                self._launch(g, beta)
                live.append(g)

        done: List[Completed] = []
        while live:
            self._advance_packed(live, self.sage.total_steps)
            for g in list(live):
                if g.state == "done":
                    done.extend(self._complete(g))
                    live.remove(g)
        return done

    @property
    def cost_saving(self) -> float:
        indep = self.stats["nfe_independent"]
        return 1.0 - self.stats["nfe"] / indep if indep else 0.0
