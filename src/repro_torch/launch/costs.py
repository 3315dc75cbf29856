"""Roofline cost model of the serving telemetry's capacity report, with
the NVIDIA H100's constants.

The port of the JAX package's ``launch/costs.py``: the same closed-form
predictors, which model the scheduler's *tick economics* (segments per
phase, rows per launch, the NFE ledger) and not any kernel's own cost.
Their job in a capacity report (``serving/reports.py``) is to make the gap
between what the tick loop should have cost and what the telemetry says it
cost visible: pad waste, cache savings, retry waste and stalls are that
gap.  ``roofline_seconds`` is the floor of a piece of work on the card:
the largest of its compute, memory and link terms.

The constants are the datasheet's figures for the H100 SXM (H100 80GB
HBM3, 700 W power limit), not measurements; a card set below 700 W runs
slower under load.  ``chip_smoke.py`` takes its bounds from here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# ---------------------------------------------------------------------------
# NVIDIA H100 SXM (H100 80GB HBM3, 700 W power limit): datasheet figures
# ---------------------------------------------------------------------------
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12             # HBM3 bytes/s per card
NVLINK_BW = 450e9            # NVLink bytes/s per direction per card


def denoiser_flops_per_eval(n_params: float, n_tokens: int) -> float:
    """FLOPs of ONE denoiser evaluation of one latent row: 2 FLOPs per
    parameter per token (the forward's matmuls), doubled for CFG's
    unconditional + conditional pair."""
    return 2.0 * n_params * 2 * n_tokens


def roofline_seconds(flops: float, bytes_acc: float = 0.0,
                     coll_bytes: float = 0.0, chips: int = 1) -> float:
    """Lower-bound wall seconds: the largest of the three roofline terms
    (compute and memory split over ``chips`` cards, the link not)."""
    c = max(chips, 1)
    return max(flops / c / PEAK_FLOPS, bytes_acc / c / HBM_BW,
               coll_bytes / NVLINK_BW)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b) if b else 0


@dataclass(frozen=True)
class DrainPrediction:
    """Closed-form tick economics of draining a request set."""
    groups: int
    shared_segments: int      # per group
    branch_segments: int      # per group
    ticks: int                # predicted ticks-to-drain
    nfe: int                  # predicted NFE (no cache, no faults)
    nfe_independent: int      # the per-request baseline of the saving


def predict_drain(requests: int, group_size: int, total_steps: int,
                  n_shared: int, slice_steps: int,
                  max_groups_per_tick: Optional[int] = None,
                  ) -> DrainPrediction:
    """Ticks-to-drain and NFE for ``requests`` similar requests.

    Assumes full groups of ``group_size``, no trunk-cache hits and no
    faults: one segment per group a tick, the shared phase charging one
    NFE-row per step per group and the branch ``group_size`` rows per
    step.  Under a ``max_groups_per_tick`` cap the groups advance in waves
    of ``cap``.  Observed ticks above this are queueing, holds and
    retries; observed NFE below it is cache savings."""
    if requests <= 0 or total_steps <= 0:
        return DrainPrediction(0, 0, 0, 0, 0, 0)
    group_size = max(group_size, 1)
    slice_steps = max(slice_steps, 1)
    n_shared = min(max(n_shared, 0), total_steps)
    groups = _ceil_div(requests, group_size)
    shared_segs = _ceil_div(n_shared, slice_steps)
    branch_segs = _ceil_div(total_steps - n_shared, slice_steps)
    per_group_ticks = shared_segs + branch_segs
    if max_groups_per_tick is None or groups <= max_groups_per_tick:
        ticks = per_group_ticks
    else:
        ticks = per_group_ticks * _ceil_div(groups, max_groups_per_tick)
    nfe = groups * n_shared + requests * (total_steps - n_shared)
    return DrainPrediction(groups, shared_segs, branch_segs, ticks, nfe,
                           requests * total_steps)
