"""Packed multi-group execution — gather, advance, scatter.

Each tick, in-flight groups are bucketed by a **pack signature** —
everything that must agree for their rows to ride one phase call:
``phase`` (shared rows run under c̄, branch rows under per-member
conditioning), ``sampler``, latent ``shape`` and ``n_steps``, the segment
length every row advances.  The share-ratio bucket is not part of it: a
group's branch point rides in the per-row ``step_idx`` / ``fork_idx``.

One bucket becomes ONE ``shared_phase`` / ``branch_phase`` call over a
stacked :class:`~repro_torch.core.shared_sampling.SampleCarry`.  Branch
rows are padded to the scheduler's static width N (mask 0, member-0
replicas); :func:`pad_stats` reports that pad waste.  Packing is
invisible to results: the denoiser treats batch rows independently and
the per-row step kernel applies the same per-element arithmetic as the
broadcast launch.

Groups are duck-typed: anything with ``carry`` / ``cbar`` / ``cond_flat``
/ ``members`` / ``steps_done`` / ``n_shared`` / ``state`` / ``shape`` /
``sampler`` / ``total_steps`` packs.  Mixed-sampler packs and per-row
step budgets (2-D grids) come with a later slice.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.schedule import ddim_timesteps
from repro_torch.core.shared_sampling import SampleCarry


class PackKey(NamedTuple):
    """Pack-compatibility signature (see module docstring for the rules)."""
    phase: str                  # "shared" | "branch"
    sampler: str
    shape: Tuple[int, ...]      # the bucket's latent (H, W, C)
    n_steps: int                # segment length this tick


def phase_remaining(g) -> int:
    """Steps left in group ``g``'s current phase."""
    limit = g.n_shared if g.state == "shared" else g.total_steps
    return limit - g.steps_done


def pack_signature(g, slice_steps: int,
                   n_steps: Optional[int] = None) -> PackKey:
    """The signature under which group ``g`` may share a launch this tick;
    ``n_steps`` overrides the per-group ``min(slice_steps, remaining)``."""
    if n_steps is None:
        n_steps = min(slice_steps, phase_remaining(g))
    return PackKey(g.state, g.sampler, tuple(g.shape), n_steps)


def build_packs(groups: Sequence, slice_steps: int,
                align_phases: bool = False) -> List[Tuple[PackKey, List]]:
    """Bucket in-flight groups by pack signature (insertion-ordered).

    ``align_phases=True`` sets every group's segment length to the
    minimum steps remaining among its phase-mates (capped by
    ``slice_steps``), so each phase collapses to ONE bucket — groups stop
    together at the earliest phase boundary."""
    phase_steps: Dict[str, int] = {}
    if align_phases:
        for g in groups:
            r = min(slice_steps, phase_remaining(g))
            phase_steps[g.state] = min(phase_steps.get(g.state, r), r)
    packs: Dict[PackKey, List] = {}
    for g in groups:
        packs.setdefault(
            pack_signature(g, slice_steps,
                           n_steps=phase_steps.get(g.state)),
            []).append(g)
    return list(packs.items())


def _pad_rows(x: torch.Tensor, width: int) -> torch.Tensor:
    """Pad the leading axis to ``width`` with member-0 replicas."""
    n = x.shape[0]
    if n == width:
        return x
    return torch.cat([x, x[:1].expand((width - n,) + tuple(x.shape[1:]))], 0)


def pack_shared(groups: Sequence) -> Tuple[SampleCarry, torch.Tensor]:
    """Stack G shared-phase groups (one trunk row each) into a (G, ...)
    carry with per-row step_idx, plus the stacked (G, Lc, dc) c̄."""
    z = torch.cat([g.carry.z for g in groups], 0)
    ep = torch.cat([g.carry.eps_prev for g in groups], 0)
    step = torch.tensor([g.steps_done for g in groups], dtype=torch.long,
                        device=z.device)
    cbar = torch.cat([g.cbar for g in groups], 0)
    return SampleCarry(z, ep, step), cbar


def unpack_shared(carry: SampleCarry, groups: Sequence) -> None:
    """Scatter a packed shared-phase result back into per-group carries."""
    for j, g in enumerate(groups):
        g.carry = SampleCarry(carry.z[j:j + 1], carry.eps_prev[j:j + 1],
                              carry.step_idx[j])


def pack_branch(groups: Sequence, width: int
                ) -> Tuple[SampleCarry, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Stack G branch-phase groups into a (G*width, ...) carry, each group
    padded to the static member width.  Returns ``(carry, cond_flat, mask,
    fork_idx)``; ``step_idx`` and ``fork_idx`` are per-row (G*width,)."""
    z = torch.cat([_pad_rows(g.carry.z, width) for g in groups], 0)
    ep = torch.cat([_pad_rows(g.carry.eps_prev, width) for g in groups], 0)
    cond = torch.cat([_pad_rows(g.cond_flat, width) for g in groups], 0)
    mask = np.zeros((len(groups), width), np.float32)
    for j, g in enumerate(groups):
        mask[j, :len(g.members)] = 1.0
    step = torch.from_numpy(np.repeat([g.steps_done for g in groups], width)
                            ).to(z.device)
    fork = torch.from_numpy(np.repeat([g.n_shared for g in groups], width)
                            ).to(z.device)
    return SampleCarry(z, ep, step), cond, torch.from_numpy(mask), fork


def unpack_branch(carry: SampleCarry, groups: Sequence, width: int) -> None:
    """Scatter a packed branch-phase result back into per-group carries,
    dropping the pad rows."""
    for j, g in enumerate(groups):
        lo, n = j * width, len(g.members)
        g.carry = SampleCarry(carry.z[lo:lo + n],
                              carry.eps_prev[lo:lo + n],
                              carry.step_idx[lo])


def pack_grid(groups: Sequence, sched_T: int, device="cpu") -> torch.Tensor:
    """The 1-D DDIM grid a bucket's rows gather timesteps from (every
    group of a bucket runs the same step budget in this slice)."""
    ts = {g.total_steps for g in groups}
    if len(ts) != 1:
        raise NotImplementedError("packs mixing step budgets (per-row "
                                  "grids) are not ported yet")
    return torch.from_numpy(ddim_timesteps(sched_T, ts.pop())).to(device)


def pad_stats(groups: Sequence, width: int) -> Tuple[int, int]:
    """(rows launched, pad rows among them) for a branch pack."""
    rows = len(groups) * width
    return rows, rows - sum(len(g.members) for g in groups)
