#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--parent DIR]

Run from the root of a checkout.  Seven phases; any failure exits non-zero
without the result line:

1. build — compile the CUDA kernels under ``src/repro_torch/csrc`` with
   nvcc for sm_90a (``repro_torch.kernels._build``) and print ptxas's
   register / spill report; for the tensor-core flash kernel
   (``flash_attention_sm90.cu``), per head-dim width, its registers,
   spills, dynamic shared memory and the count of HGMMA (wgmma)
   instructions in ``cuobjdump -sass`` of the library, which must not be 0;
   for the 3xTF32 kernels (``flash_attention.cu``, ``ssd_scan.cu``), per
   instantiation, registers, spills and the count of HMMA (mma.sync)
   instructions, which must not be 0 either;
2. kernel vs plain — every kernel of the serving paths against its plain
   PyTorch version (``ref.py``) on the card at the main paths' shapes, in
   f32 and bf16, each error beside its tolerance, with the kernel's, the
   plain version's and (for attention) the library's time, its bound and
   its achieved TFLOP/s.  Flash in bf16 runs the sm90 kernel, in f32 the
   3xTF32 one, each also at the shapes its padding and masking can get
   wrong.  The three step kernels, whose bytes bounds lie under a
   launch's own cost, get two yardsticks (``[yardstick]`` lines): the
   empty ``launch_floor_kernel`` at the kernel's grid and block, read
   from a captured launch's graph node (``floor_ms``) and held to the
   wrapper's launch plan, and a copy of half the kernel's bytes
   (``copy_ms``); their time per launch inside a replayed step is on the
   ``[profile:<path>]`` lines.  ``ddim_step`` gathers its own schedule
   values from the tables at the step's timesteps: one fused DDIM update,
   captured alone in a CUDA graph, must be exactly one kernel node
   (``[graph-nodes:ddim]``); a DPM-Solver++ update's nodes are counted;
3. end to end, DiT — for each diffusion serving path (``DIT_PATHS``: 30
   DDIM steps, and 30 DPM-Solver++(2M) steps with the shared-uncond CFG),
   eight ``SageServingEngine.step()`` calls at the full ``sage-dit`` width
   (28 layers, d_model 1152, 16 heads of 72, 1024 tokens, cond 77x768;
   text tower dim 768, 4 layers; VAE to 512x512x3 in bf16; the same
   weights for both) over 8 prompts from 2 themes, group_size 4, on the
   kernel routes (``STEP_ORDER``): the first captures each segment
   runner's CUDA graph (``capture_s``); then, after one eager step to warm
   up, replayed steps (``wall_s``), eager ones with the weights cast once
   and eager ones casting each weight per call, two of each, alternating,
   for a same-run reference.  Every launch count is set to 0 just before
   each step and read just after: the wrappers count the launches they
   make (the warm-up's and the one into a capture among them),
   ``runners.REPLAYED`` those of graph replays, read from each graph's
   kernel nodes; both must be exactly ``_want``'s for
   the mode, from ``EXPECTED`` and every bf16 flash launch (self + cross a
   layer a step) on the sm90 route, the f32 text tower's on the tf32x3
   route.  NFE must be ``EXPECTED``'s, every image finite, no kernel off
   the path launched, and the steps' ledgers and groups all equal.  Then
   each runner (the graphs the steps replayed) against a direct eager
   ``shared_phase`` / ``branch_phase`` call on copies of the same packed
   inputs at full width: bitwise expected, at most 1e-3 (the end-to-end
   latent tolerance), with both host-clock times and peak memories; a
   second replay on other inputs must leave the first result as it was;
   one replay alone is traced.  One more replayed step runs under
   ``torch.profiler`` for device time by kernel and the busy share; each
   trace's launches of the port's kernels are held to the counts
   (``_trace_check``).
   Then one DiT forward on the CFG pair (batch 16) through the kernel,
   through plain attention in bf16 and in f32: the kernel's mean error
   against f32 must stay within 1.25x the plain bf16 route's; and the
   kernel forward with the weights cast once against the same forward
   casting each weight per call, bitwise;
4. stream — the streaming scheduler (``SageServingEngine.
   streaming_scheduler``: submit / tick / drain on a virtual clock) on the
   same full-width modules and routes, over ``STREAM_TRACES``: trace H
   (four classes of latent shape, quality tier and solver, all arriving at
   once, mixed-solver packs) twice on one scheduler, the first pass
   capturing its graphs and the second only replaying them, a third pass
   under ``torch.profiler``, then with ``packed=False`` on a fresh
   scheduler; trace O (QoS classes with deadlines under a 2-group cap with
   preemption, shed admission, the pad-aware launch policy and a seeded
   fault plan) once; trace C (the cross-batch trunk cache: two waves of
   one shape, two step budgets co-packed on 2-D grids, exact-key hits on
   the device and on the host, spills and a promotion) in four passes on
   one scheduler, each with its own cache: scan (capturing), LSH
   (replaying: images bitwise those of scan), every would-be hit corrupted
   (bitwise the pass without a cache, as many integrity drops as
   injections), none (NFE = cached + saved); then ``ddim_step`` and flash
   against their plain versions on every stack the four passes handed
   them (``record_stacks``; each stack's per-row steps from the same
   passes at smoke size on the CPU), in f32 and bf16, and the capture and
   no-cache passes again with the DiT and VAE in f32, whose groups
   computed in both must agree within 1e-3.  Each pass's discrete outcome
   (``stream_outcome``: ticks, launch / NFE / overload ledgers, groups,
   statuses, tier and shape ledgers, the cache's ledger) must equal
   ``STREAM_EXPECTED``, the JAX scheduler's at smoke size, the per-group
   run's but for its launches; each trace must launch exactly its path's
   kernels (``PATH_KERNELS``), every image be finite and of its class's
   shape.  Walls, ticks, launches per tick, pad waste, NFE, latencies, the
   packs with a 2-D grid, the graphs captured by runner key, capture
   seconds and memory are printed;
5. end to end, ``mamba2`` — the AR shared-prefix path at the full
   ``mamba2-780m`` width (48 SSD layers, d_model 1536, 48 heads of 64,
   d_state 128, vocab 50280, bf16 activations): the launcher
   (``repro_torch.launch.serve``) at batch 4, 1024-token prompts, 32
   generated tokens, independent and ``--shared-prefix``; then
   ``shared_prefix_prefill`` on 2 groups of 4 requests (1024-token shared
   prefix, 64-token tails) and 32 greedy decode steps, each decode both
   through the decode graphs (``serving.runners.DecodeRunner``; the
   launcher's own) and, for the groups, through an eager ``decode_step``
   loop from the same cache: greedy tokens equal token for token, last
   logits bitwise or within two bf16 ulps, tokens/s of both.  The weights
   are cast once; a prefill with the copies must equal one without them
   bitwise.  ``ssd_scan`` must
   launch once per layer of every prefill call and no other kernel at all;
   token-step counts must equal ``P + N (S - P)``; each group's logits must
   equal a full independent prefill's, within bf16's own error in bf16 and
   within 1e-3 of their magnitude in f32.  Then ``cached_prefix_prefill``
   over the same groups, g0, g1, g0, g1, through a ``TrunkCache`` of one
   payload on the card and two on the host: two misses (48 ``ssd_scan``
   launches each), then two host hits (none, 256 token steps, logits and
   caches bitwise the miss's), with the CRC, spill and promotion
   milliseconds of a payload.  One trunk prefill and the replayed decode
   loop are then traced, each trace held to the counts;
6. reference — each path at smoke size on the card against the plain CPU
   path: equal groups, NFE, launches and token-step counts, images and
   logits within tolerance; the stream traces the same way (equal
   outcomes and records, images within 1e-3);
7. graph nodes — the kernel nodes of each DiT path's segment graphs
   (``[graph-nodes:<path>]``), and the device time of one segment step
   without the DiT (the solver's part of a step).  With ``--parent DIR``,
   a checkout of the parent commit (``git archive``), a child process
   serves one step of each path from that checkout's package at the same
   width and measures both the same way; parent minus this tree must be
   ``NODES_SAVED_PER_STEP`` x each segment's steps.

The line before the last is ``nvidia-smi``'s name and power limit; the
last line is ``{"ok": true, "device": {...}}``.  The port never calls
``F.scaled_dot_product_attention``: it is timed here only as a yardstick.
"""
from __future__ import annotations

import ast
import contextlib
import gc
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _card_costs():
    """``repro_torch.launch.costs`` of this checkout, loaded from its file
    (it imports the standard library only): the one source of the H100's
    memory rate and dense bf16 peak.  Without it, the script exits."""
    path = ROOT / "src" / "repro_torch" / "launch" / "costs.py"
    if not path.is_file():
        sys.exit(f"chip_smoke: no src/repro_torch/launch/costs.py beside "
                 f"{Path(__file__).name}; run it from the repo's root")
    spec = importlib.util.spec_from_file_location("_chip_smoke_costs", path)
    mod = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_COSTS = _card_costs()
# H100 SXM: device memory, and dense bf16 tensor cores (launch/costs.py);
# f32 outside the tensor cores and dense TF32 tensor cores (datasheet)
HBM_BYTES_PER_S = _COSTS.HBM_BW
PEAK_FLOPS = {"float32": 67e12, "bfloat16": _COSTS.PEAK_FLOPS,
              "tf32": 494.7e12}
# nvidia-smi's name and power limit of the card, set by main(): printed
# beside the numbers of the telemetry and example phases
_SMI = ""
# passes of a TF32 product per f32 product in the 3xTF32 kernels
# (hi*hi + hi*lo + lo*hi); an operand in bf16 needs no split, so a product
# with one bf16 operand takes 2 and one with two bf16 operands 1
TF32_PASSES = 3
# tests/test_kernels.py: step kernels 1e-5 / 3e-2 (f32 / bf16); flash
# attention 2e-4 / 4e-2.  The SSD scan: the kernel's tiles (y_diag and the
# chunk states) are f32 on both sides, computed in f32 from the same inputs
# in bf16 as in f32, so both are held at f32's 1e-4 (tests/test_kernel_ssd.
# py); the whole wrapper's y is rounded once to x's dtype, which in bf16
# may flip that rounding by one ulp: two bf16 ulps, 2^-6 of (1 + |y|).
# Both flash paths accumulate in f32.  The f32 route's and the SSD tiles'
# 3xTF32 products miss an f32 product by ~2^-22 of it (the dropped lo*lo
# term), plain TF32 by ~2^-11, which these tolerances fail
# (tests/test_torch_tf32_split.py emulates both).  bf16 flash is held at
# 1e-2, not the JAX tests' 4e-2: a self-attention output over ~1024 keys
# is ~0.04 in size, so 4e-2 of (1 + |o|) would pass a kernel with a wrong
# scale or a dropped key tile; 1e-2 is a quarter of that size.  The sm90 kernel rounds P to bf16 before
# P V (2^-9 relative, averaged over the keys) and the output once to 8 bits
# of mantissa (one ulp of |o| < 2 is 7.8e-3, inside 1e-2 * (1 + |o|)).
# group mean: f32 sums of 4 products in another order than torch's
# reduction differ by a few ulp (~1e-6 here); in bf16 such a last-bit
# difference can flip the one rounding of the output by one bf16 ulp, at
# most 2^-7 of |out|.
TOL = {("ddim_step", "float32"): 1e-5, ("ddim_step", "bfloat16"): 3e-2,
       ("dpmpp_step", "float32"): 1e-5, ("dpmpp_step", "bfloat16"): 3e-2,
       ("group_mean", "float32"): 1e-5, ("group_mean", "bfloat16"): 1e-2,
       ("flash_attention", "float32"): 2e-4,
       ("flash_attention", "bfloat16"): 1e-2,
       ("ssd_scan", "float32"): 1e-4, ("ssd_scan", "bfloat16"): 1e-4,
       ("ssd_scan y", "float32"): 1e-4, ("ssd_scan y", "bfloat16"): 2.0 ** -6}

THEMES = (
    ["a red circle on a white background",
     "a small red circle on a white background",
     "a red circle on a pale white background",
     "a bright red circle on a white background"],
    ["a tall green tree in a field at dawn",
     "a tall green tree in a field at dusk",
     "a green tree in a wide field at dawn",
     "a tall green tree in a grassy field at dawn"],
)


# -- the stream phase's arrival traces --------------------------------------
#
# Both run on a virtual clock (now += 1.0 a tick) through the streaming
# scheduler (``SageServingEngine.streaming_scheduler``), standard tier 30
# steps, tiers as the scheduler's defaults (draft 15, premium 45).  Prompts
# are identical within a class and the classes are kept apart by their
# compartment (shape, tier, sampler, qos), and deadlines are in ticks: so
# groups, ticks, launches and statuses do not depend on the weights or on
# the model's size, and ``STREAM_EXPECTED`` (the JAX scheduler's outcome at
# smoke size) holds at full width too.  Shapes are fractions of the
# trained latent grid (64 at sage-dit: 32x32 -> 256 tokens, 64x64 -> 1024,
# 32x64 -> 512).
STREAM_PROMPTS = ("a red circle on a white background",
                  "a tall green tree in a field at dawn",
                  "a blue square over a calm grey sea",
                  "a yellow house under a starry night sky")
STREAM_TRACES = {
    # "hetero": benchmarks/serving_bench.py's mix4t4s2hT6 (BENCH_7) and one
    # more class, all arriving at t = 0 with mixed-sampler packs:
    # (class, requests, prompt, (H, W) as fractions of the grid, tier,
    # sampler)
    "H": dict(
        sage=dict(total_steps=30),
        scheduler=dict(slice_steps=4, max_wait_ticks=0, policy="eager",
                       mix_samplers=True),
        classes=(("thumb", 4, 0, (1, 2), (1, 2), "draft", "ddim"),
                 ("set", 4, 1, (1, 1), (1, 1), "standard", "ddim"),
                 ("hires", 2, 2, (1, 1), (1, 1), "standard", "dpmpp"),
                 ("wide", 2, 3, (1, 2), (1, 1), "premium", "dpmpp"))),
    # "overload": one prompt, DPM-Solver++ with the shared-uncond CFG; each
    # of the first `ticks` ticks brings `batch` batch requests (deadline now
    # + `batch_deadline`) and every `every`-th tick `interactive`
    # interactive ones (now + `interactive_deadline`), under a 2-group cap,
    # shed admission, the pad-aware policy and seeded faults; then drain
    "O": dict(
        sage=dict(total_steps=30, sampler="dpmpp", shared_uncond_cfg=True),
        scheduler=dict(slice_steps=4, max_groups_per_tick=2,
                       starvation_ticks=8, admission="shed",
                       policy="pad_aware"),
        faults=dict(seed=7, p_launch_fail=0.1, p_tick_stall=0.05,
                    max_faults=6),
        arrivals=dict(ticks=16, batch=3, batch_deadline=24.0,
                      interactive=2, every=4, interactive_deadline=12.0)),
    # "cache": the cross-batch trunk cache (TrunkCache(tau_trunk=0.9),
    # budgets in entries of the trace's own latent, see trunk_entry_bytes:
    # 1.5 on the device, 4 on the host).  Wave A at t = 0 co-packs two step
    # budgets of one shape (2-D grids); wave B, a tick after both A groups
    # forked, repeats both classes (exact-key hits: one found on the
    # device, one on the host and promoted) and adds a premium class of
    # prompt 0, which misses because the step budget rides the cfg_key.
    # waves: (ticks before the wave, its classes)
    "C": dict(
        sage=dict(total_steps=30),
        scheduler=dict(slice_steps=4, max_wait_ticks=0, policy="eager"),
        cache=dict(tau_trunk=0.9, max_entries=1.5, host_entries=4),
        waves=((0, (("set", 4, 0, (1, 1), (1, 1), "standard", "ddim"),
                    ("draft", 4, 1, (1, 1), (1, 1), "draft", "ddim"))),
               (3, (("set", 4, 0, (1, 1), (1, 1), "standard", "ddim"),
                    ("draft", 4, 1, (1, 1), (1, 1), "draft", "ddim"),
                    ("premium", 2, 0, (1, 1), (1, 1), "premium",
                     "ddim"))))),
}


# the JAX scheduler's discrete outcome of each trace (``stream_outcome``),
# served at smoke size on the CPU (tests/test_torch_streaming.py and
# tests/test_torch_policies.py hold it to the JAX scheduler, and the port
# to it); the stream phase holds the card's full-width run to it exactly
STREAM_EXPECTED = {'H': {'ticks': 12,
                         'launches': 26.0,
                         'pack_rows': 104.0,
                         'pack_pad_rows': 28.0,
                         'nfe': 530.0,
                         'nfe_independent': 660.0,
                         'requests': 12.0,
                         'completed': 12.0,
                         'shed': 0.0,
                         'shed_faulted': 0.0,
                         'rejected_expired': 0.0,
                         'degraded': 0.0,
                         'preemptions': 0.0,
                         'resumes': 0.0,
                         'retries': 0.0,
                         'launch_faults': 0.0,
                         'stalled_ticks': 0.0,
                         'deadline_met': 12.0,
                         'deadline_missed': 0.0,
                         'nfe_wasted': 0.0,
                         'groups': [(0, 0, 'interactive', 'draft', 'ok', 4),
                                    (1, 1, 'interactive', 'standard', 'ok', 4),
                                    (2, 2, 'interactive', 'standard', 'ok', 2),
                                    (3, 3, 'interactive', 'premium', 'ok', 2)],
                         'by_status': {'ok': 12},
                         'by_qos': {'interactive/ok': 12},
                         'tiers': {'draft': {'completed': 4.0, 'nfe': 90.0, 'requests': 4.0},
                                   'premium': {'completed': 2.0,
                                               'nfe': 152.0,
                                               'requests': 2.0},
                                   'standard': {'completed': 6.0,
                                                'nfe': 288.0,
                                                'requests': 6.0}},
                         'shapes': {'0.5x0.5': {'launches': 5.0,
                                                'pad_rows': 0.0,
                                                'rows': 14.0},
                                    '0.5x1': {'launches': 12.0,
                                              'pad_rows': 16.0,
                                              'rows': 36.0},
                                    '1x1': {'launches': 9.0,
                                            'pad_rows': 12.0,
                                            'rows': 54.0}}},
                   'O': {'ticks': 32,
                         'launches': 37.0,
                         'pack_rows': 135.0,
                         'pack_pad_rows': 54.0,
                         'nfe': 426.0,
                         'nfe_independent': 660.0,
                         'requests': 56.0,
                         'completed': 11.0,
                         'shed': 45.0,
                         'shed_faulted': 0.0,
                         'rejected_expired': 0.0,
                         'degraded': 0.0,
                         'preemptions': 2.0,
                         'resumes': 2.0,
                         'retries': 6.0,
                         'launch_faults': 5.0,
                         'stalled_ticks': 1.0,
                         'deadline_met': 2.0,
                         'deadline_missed': 9.0,
                         'nfe_wasted': 0.0,
                         'groups': [(-1, 0, 'batch', 'standard', 'shed', 45),
                                    (0, 0, 'batch', 'standard', 'ok', 3),
                                    (1, 0, 'interactive', 'standard', 'ok', 2),
                                    (2, 0, 'interactive', 'standard', 'ok', 2),
                                    (3, 0, 'interactive', 'standard', 'ok', 2),
                                    (4, 0, 'interactive', 'standard', 'ok', 2)],
                         'by_status': {'ok': 11, 'shed': 45},
                         'by_qos': {'batch/ok': 3, 'batch/shed': 45, 'interactive/ok': 8},
                         'tiers': {'standard': {'completed': 11.0,
                                                'nfe': 426.0,
                                                'requests': 56.0}},
                         'shapes': {'1x1': {'launches': 37.0,
                                            'pad_rows': 54.0,
                                            'rows': 135.0}}}}


# trace C's passes on one scheduler (``phase_stream``): "C" is the cached
# pass (scan, then lsh, whose outcome is the same but for the tier and shape
# ledgers, which accumulate), "C:corrupt" the pass whose every would-be hit
# is corrupted and dropped, "C:nocache" the pass without a cache; each the
# JAX scheduler's at smoke size (tests/test_torch_cache_serving.py)
STREAM_EXPECTED['C'] = {'by_qos': {'interactive/ok': 18},
                        'by_status': {'ok': 18},
                        'cache': {'admission_rejects': 0.0,
                                  'entries': 3,
                                  'evictions': 0.0,
                                  'exact_hits': 2.0,
                                  'fault_forced_misses': 0.0,
                                  'hit_groups': [2, 3],
                                  'hits': 2.0,
                                  'hits_hbm': 1.0,
                                  'hits_host': 1.0,
                                  'inserts': 3.0,
                                  'integrity_drops': 0.0,
                                  'misses': 3.0,
                                  'nfe_saved': 28.0,
                                  'overwrites': 0.0,
                                  'promotions': 1.0,
                                  'spills': 3.0},
                        'completed': 18.0,
                        'deadline_met': 18.0,
                        'deadline_missed': 0.0,
                        'degraded': 0.0,
                        'groups': [(0, 0, 'interactive', 'standard', 'ok', 4),
                                   (1, 1, 'interactive', 'draft', 'ok', 4),
                                   (2, 0, 'interactive', 'standard', 'ok', 4),
                                   (3, 1, 'interactive', 'draft', 'ok', 4),
                                   (4, 0, 'interactive', 'premium', 'ok', 2)],
                        'launch_faults': 0.0,
                        'launches': 24.0,
                        'nfe': 676.0,
                        'nfe_independent': 900.0,
                        'nfe_wasted': 0.0,
                        'pack_pad_rows': 16.0,
                        'pack_rows': 113.0,
                        'preemptions': 0.0,
                        'rejected_expired': 0.0,
                        'requests': 18.0,
                        'resumes': 0.0,
                        'retries': 0.0,
                        'shapes': {'1x1': {'launches': 24.0,
                                           'pad_rows': 16.0,
                                           'rows': 113.0}},
                        'shed': 0.0,
                        'shed_faulted': 0.0,
                        'stalled_ticks': 0.0,
                        'ticks': 15,
                        'tiers': {'draft': {'completed': 8.0,
                                            'nfe': 170.0,
                                            'requests': 8.0},
                                  'premium': {'completed': 2.0,
                                              'nfe': 152.0,
                                              'requests': 2.0},
                                  'standard': {'completed': 8.0,
                                               'nfe': 354.0,
                                               'requests': 8.0}}}
STREAM_EXPECTED['C:corrupt'] = {'by_qos': {'interactive/ok': 18},
                                'by_status': {'ok': 18},
                                'cache': {'admission_rejects': 0.0,
                                          'entries': 3,
                                          'evictions': 0.0,
                                          'exact_hits': 0.0,
                                          'fault_forced_misses': 0.0,
                                          'hit_groups': [],
                                          'hits': 0.0,
                                          'hits_hbm': 0.0,
                                          'hits_host': 0.0,
                                          'inserts': 5.0,
                                          'integrity_drops': 2.0,
                                          'misses': 5.0,
                                          'nfe_saved': 0.0,
                                          'overwrites': 0.0,
                                          'promotions': 0.0,
                                          'spills': 3.0},
                                'completed': 18.0,
                                'deadline_met': 18.0,
                                'deadline_missed': 0.0,
                                'degraded': 0.0,
                                'groups': [(0,
                                            0,
                                            'interactive',
                                            'standard',
                                            'ok',
                                            4),
                                           (1,
                                            1,
                                            'interactive',
                                            'draft',
                                            'ok',
                                            4),
                                           (2,
                                            0,
                                            'interactive',
                                            'standard',
                                            'ok',
                                            4),
                                           (3,
                                            1,
                                            'interactive',
                                            'draft',
                                            'ok',
                                            4),
                                           (4,
                                            0,
                                            'interactive',
                                            'premium',
                                            'ok',
                                            2)],
                                'launch_faults': 0.0,
                                'launches': 27.0,
                                'nfe': 704.0,
                                'nfe_independent': 900.0,
                                'nfe_wasted': 0.0,
                                'pack_pad_rows': 16.0,
                                'pack_rows': 118.0,
                                'preemptions': 0.0,
                                'rejected_expired': 0.0,
                                'requests': 18.0,
                                'resumes': 0.0,
                                'retries': 0.0,
                                'shed': 0.0,
                                'shed_faulted': 0.0,
                                'stalled_ticks': 0.0,
                                'ticks': 15}
STREAM_EXPECTED['C:nocache'] = {'by_qos': {'interactive/ok': 18},
                                'by_status': {'ok': 18},
                                'completed': 18.0,
                                'deadline_met': 18.0,
                                'deadline_missed': 0.0,
                                'degraded': 0.0,
                                'groups': [(0,
                                            0,
                                            'interactive',
                                            'standard',
                                            'ok',
                                            4),
                                           (1,
                                            1,
                                            'interactive',
                                            'draft',
                                            'ok',
                                            4),
                                           (2,
                                            0,
                                            'interactive',
                                            'standard',
                                            'ok',
                                            4),
                                           (3,
                                            1,
                                            'interactive',
                                            'draft',
                                            'ok',
                                            4),
                                           (4,
                                            0,
                                            'interactive',
                                            'premium',
                                            'ok',
                                            2)],
                                'launch_faults': 0.0,
                                'launches': 27.0,
                                'nfe': 704.0,
                                'nfe_independent': 900.0,
                                'nfe_wasted': 0.0,
                                'pack_pad_rows': 16.0,
                                'pack_rows': 118.0,
                                'preemptions': 0.0,
                                'rejected_expired': 0.0,
                                'requests': 18.0,
                                'resumes': 0.0,
                                'retries': 0.0,
                                'shed': 0.0,
                                'shed_faulted': 0.0,
                                'stalled_ticks': 0.0,
                                'ticks': 15}


# the JAX tracer's event counts (``Tracer.counts()``) of each stream trace,
# served at smoke size on the CPU: traces H and O over their one pass,
# trace C over its LSH pass (tests/test_torch_streaming.py,
# test_torch_policies.py and test_torch_cache_serving.py pin them against
# the JAX scheduler, whose traces the port's equal event for event); like
# STREAM_EXPECTED they do not depend on the weights or the width, and the
# stream phase's traced passes must give them exactly
STREAM_TRACE_COUNTS = {
    "H": {"group.fork": 4, "group.hold": 4, "group.launch": 4,
          "phase.branch": 17, "phase.shared": 9, "request.admit": 12,
          "request.complete": 12, "request.group": 12,
          "request.submit": 12, "tick": 12, "tick.admit": 12,
          "tick.advance": 12, "tick.complete": 12, "tick.launch": 12},
    "O": {"group.fork": 5, "group.hold": 5, "group.launch": 5,
          "group.preempt": 2, "group.resume": 2, "group.retry": 6,
          "launch.fault": 5, "phase.branch": 23, "phase.shared": 14,
          "request.admit": 11, "request.complete": 11, "request.group": 11,
          "request.shed": 45, "request.submit": 56, "tick": 32,
          "tick.admit": 31, "tick.advance": 31, "tick.complete": 31,
          "tick.launch": 31, "tick.stall": 1},
    "C": {"cache.exact": 2, "cache.miss": 3, "cache.store": 3,
          "group.fork": 3, "group.hold": 5, "group.launch": 5,
          "phase.branch": 16, "phase.shared": 8, "request.admit": 18,
          "request.complete": 18, "request.group": 18,
          "request.submit": 18, "tick": 15, "tick.admit": 15,
          "tick.advance": 15, "tick.complete": 15, "tick.launch": 15},
}

# each op of ``kernels.dispatch.DISPATCH_LOG`` and the wrapper whose
# launches its kernel-route rows count (``runners.launch_counts`` keys):
# the log records every Python-level dispatch and a replay none, so over a
# pass the two are equal, the replays left out
DISPATCH_OPS = {"attention": "flash_attention", "cfg_ddim_step": "ddim_step",
                "cfg_dpmpp_step": "dpmpp_step", "group_mean": "group_mean"}


def dispatch_counts(routes):
    """{op: dispatches that took its kernel route} of a ``DispatchLog``'s
    ``routes``."""
    out = {}
    for (op, _, chosen, _, _), n in routes.items():
        if chosen in ("kernel", "fused"):
            out[op] = out.get(op, 0) + n
    return out


def reconcile(counts, ledger, events):
    """A tracer's counts (and its cache events' tiers) against a run's
    ledger of ``summary()``'s keys, as tests/test_telemetry.py reconciles
    them: launches, completions, sheds, preemptions, resumes, retries,
    faults, stalls, ticks and, with a cache, hits by kind and tier.
    Returns the mismatches."""
    c = counts
    pairs = {
        "launches": (c.get("phase.shared", 0) + c.get("phase.branch", 0),
                     ledger["launches"]),
        "completed": (c.get("request.complete", 0), ledger["completed"]),
        "shed": (c.get("request.shed", 0), ledger["shed"]),
        "shed_faulted": (c.get("request.shed_faulted", 0),
                         ledger["shed_faulted"]),
        "preemptions": (c.get("group.preempt", 0), ledger["preemptions"]),
        "resumes": (c.get("group.resume", 0), ledger["resumes"]),
        "retries": (c.get("group.retry", 0), ledger["retries"]),
        "launch_faults": (c.get("launch.fault", 0),
                          ledger["launch_faults"]),
        "stalled_ticks": (c.get("tick.stall", 0), ledger["stalled_ticks"]),
        "ticks": (c.get("tick", 0), ledger["ticks"])}
    if "cache_hits" in ledger:
        tiers = {"hbm": 0, "host": 0}
        for e in events:
            if e.name in ("cache.exact", "cache.ann"):
                tiers[e.args["tier"]] += 1
        pairs.update({
            "cache_hits": (c.get("cache.exact", 0) + c.get("cache.ann", 0),
                           ledger["cache_hits"]),
            "cache_exact_hits": (c.get("cache.exact", 0),
                                 ledger["cache_exact_hits"]),
            "cache_hits_hbm": (tiers["hbm"], ledger["cache_hits_hbm"]),
            "cache_hits_host": (tiers["host"], ledger["cache_hits_host"])})
    return [f"{k}: trace {a} != ledger {b}" for k, (a, b) in pairs.items()
            if a != b]


def stream_shape(frac_h, frac_w, latent_size, channels):
    """A class's latent (H, W, C) at a config's grid."""
    return (latent_size * frac_h[0] // frac_h[1],
            latent_size * frac_w[0] // frac_w[1], channels)


def trunk_entry_bytes(shape):
    """Bytes of one diffusion trunk entry of latent ``shape`` (H, W, C): z
    and the solver history, both f32 (1, H, W, C)."""
    return 2 * 4 * math.prod(shape)


def _trace_spec(trace):
    """A trace's spec, by name or given as a spec dict."""
    return STREAM_TRACES[trace] if isinstance(trace, str) else trace


def cache_kwargs(trace, latent_size, channels):
    """``TrunkCache`` arguments of a trace (a name or a spec), its budgets
    in bytes."""
    c = dict(_trace_spec(trace)["cache"])
    entry = trunk_entry_bytes((latent_size, latent_size, channels))
    c["max_bytes"] = int(c.pop("max_entries") * entry)
    c["host_bytes"] = int(c.pop("host_entries") * entry)
    return c


def drive_stream(sched, trace, latent_size, channels, now=0.0):
    """Serve ``STREAM_TRACES[trace]`` (or a spec of that form) through a
    streaming scheduler (the port's or the JAX package's: only ``submit``,
    ``tick`` and ``pending`` are used) until it drains.  Returns
    (completion records, the clock)."""
    spec = _trace_spec(trace)
    done = []

    def submit(classes):
        for _, n, p, fh, fw, tier, sampler in classes:
            sched.submit([STREAM_PROMPTS[p]] * n, now=now,
                         shape=stream_shape(fh, fw, latent_size, channels),
                         tier=tier, sampler=sampler)
    if "classes" in spec:
        submit(spec["classes"])
    elif "waves" in spec:
        waves = dict(spec["waves"])
        for k in range(max(waves) + 1):
            submit(waves.get(k, ()))
            if k < max(waves):
                now += 1.0
                done.extend(sched.tick(now=now))
    else:
        a = spec["arrivals"]
        for k in range(a["ticks"]):
            now += 1.0
            sched.submit([STREAM_PROMPTS[0]] * a["batch"], now=now,
                         deadline=now + a["batch_deadline"], qos="batch")
            if k % a["every"] == 0:
                sched.submit([STREAM_PROMPTS[0]] * a["interactive"],
                             now=now, deadline=now + a["interactive_deadline"],
                             qos="interactive")
            done.extend(sched.tick(now=now))
    while sched.pending:
        now += 1.0
        done.extend(sched.tick(now=now))
    return done, now


def stream_outcome(sched, done, latent_size, ticks0=0, stats0=None):
    """The discrete outcome of a served trace: ticks, the launch and NFE
    ledgers, the overload counters, the groups (gid, prompt, qos, tier,
    status, members) and the counts by status and by qos, and the tier and
    shape ledgers (shapes as fractions of the grid, so the outcome does not
    depend on the model's size).  ``ticks0`` / ``stats0`` subtract an
    earlier pass on the same scheduler (its groups then count from that
    pass's first gid on)."""
    stats0 = stats0 or {}
    keys = ("launches", "pack_rows", "pack_pad_rows", "nfe",
            "nfe_independent", "requests", "completed", "shed",
            "shed_faulted", "rejected_expired", "degraded", "preemptions",
            "resumes", "retries", "launch_faults", "stalled_ticks",
            "deadline_met", "deadline_missed", "nfe_wasted")
    out = {"ticks": sched.ticks - ticks0}
    out.update({k: float(sched.stats[k] - stats0.get(k, 0)) for k in keys})
    gid0 = min((c.group_id for c in done if c.group_id >= 0), default=0)
    groups, status, qos = {}, {}, {}
    for c in done:
        key = (c.group_id - gid0 if c.group_id >= 0 else -1,
               STREAM_PROMPTS.index(c.prompt), c.qos, c.tier, c.status)
        groups[key] = groups.get(key, 0) + 1
        status[c.status] = status.get(c.status, 0) + 1
        qos[f"{c.qos}/{c.status}"] = qos.get(f"{c.qos}/{c.status}", 0) + 1
    out["groups"] = sorted(k + (n,) for k, n in groups.items())
    out["by_status"] = dict(sorted(status.items()))
    out["by_qos"] = dict(sorted(qos.items()))
    tc = sched.trunk_cache
    if tc is not None:
        # the cache's own ledger (a pass brings its own cache) and the
        # groups that forked from a cached trunk
        out["cache"] = dict(
            {k: float(v) for k, v in sorted(tc.stats.items())},
            nfe_saved=float(sched.stats["nfe_saved_cache"]
                            - stats0.get("nfe_saved_cache", 0)),
            entries=len(tc), hit_groups=sorted({
                c.group_id - gid0 for c in done if c.cache_hit}))
    if not stats0:
        out["tiers"] = {t: {k: float(v) for k, v in sorted(d.items())}
                        for t, d in sorted(sched.tier_stats.items())}
        shapes = {}
        for s, d in sorted(sched.shape_stats.items()):
            h, w, _ = (int(x) for x in s.split("x"))
            shapes[f"{h / latent_size:g}x{w / latent_size:g}"] = {
                k: float(v) for k, v in sorted(d.items())}
        out["shapes"] = shapes
    return out


@contextlib.contextmanager
def count_2d_grids(packing):
    """Count the packs a scheduler launches with a 2-D grid (groups of
    several step budgets in one pack): the rank-2 results of
    ``packing.pack_grid`` (the port's module, or the JAX package's), which
    every segment launch calls once."""
    seen = [0]
    orig = packing.pack_grid

    def spy(*args, **kw):
        grid = orig(*args, **kw)
        seen[0] += len(grid.shape) == 2
        return grid
    packing.pack_grid = spy
    try:
        yield seen
    finally:
        packing.pack_grid = orig


@contextlib.contextmanager
def record_stacks():
    """Record the stacks the port's serving path hands ``ddim_step`` and
    flash attention through ``kernels.dispatch`` (a graph replay calls no
    wrapper, so each captured stack is seen at its warm-up and capture).
    Yields {"ddim": {(z shape, z dtype, eps dtype, t, t_next)}, "flash":
    {(q shape, k shape, dtype, causal, window)}}; t and t_next are the
    per-row timesteps (a tuple) on a CPU tensor and None on the card,
    where reading them would sync inside a capture.  Host-only
    bookkeeping: nothing is launched."""
    from repro_torch.kernels import dispatch
    seen = {"ddim": set(), "flash": set()}
    ddim, flash = dispatch.fused_cfg_ddim_step, dispatch.flash_attention

    def steps(t):
        return tuple(t.reshape(-1).tolist()) if t.device.type == "cpu" \
            else None

    def ddim_spy(z, eu, ec, g, alphas, sigmas, t, t_next, **kw):
        seen["ddim"].add((tuple(z.shape), str(z.dtype), str(eu.dtype),
                          steps(t), steps(t_next)))
        return ddim(z, eu, ec, g, alphas, sigmas, t, t_next, **kw)

    def flash_spy(q, k, v, **kw):
        seen["flash"].add((tuple(q.shape), tuple(k.shape), str(q.dtype),
                           kw.get("causal"), kw.get("window", 0)))
        return flash(q, k, v, **kw)
    dispatch.fused_cfg_ddim_step, dispatch.flash_attention = \
        ddim_spy, flash_spy
    try:
        yield seen
    finally:
        dispatch.fused_cfg_ddim_step, dispatch.flash_attention = ddim, flash


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, reps: int = 3) -> float:
    """Device time per call of ``fn()``: ``iters`` calls captured in one
    CUDA graph and replayed ``reps`` times between two CUDA events, so the
    host's per-launch overhead is not in the number.  Inputs stay resident
    in the 50 MB L2 where they fit, as they are on the serving path (the
    step's inputs were just written by the DiT)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * iters)
    del graph
    return ms


def phase_build(failures):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.last_build_seconds:.2f} s, sources "
        f"{', '.join(_build.SOURCES)})")
    for name in _build.SOURCES:
        report = _build.BUILD_DIR / (name + ".ptxas.log")
        if report.exists():
            text = report.read_text()
            regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
            spills = [int(w) for w in
                      re.findall(r"(\d+) bytes spill stores", text)]
            log(f"[build]   {name}: {len(regs)} kernels, registers "
                f"{min(regs, default=0)}..{max(regs, default=0)}, spill "
                f"stores up to {max(spills, default=0)} bytes")
    lib_c = _build.load_library()
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout
    _sm90_report(_build, sass, lib_c, failures)
    for source, kernel in TF32X3_KERNELS:
        _tf32x3_report(_build, sass, source, kernel, failures)
    _load_order_report(sass, "ddim_step_kernel")


# the float arithmetic of the step kernels' SASS (a correctly rounded
# division is FCHK, MUFU.RCP and FFMAs; MUFU is left out, as an integer
# division by a value known at run time starts with one too)
FLOAT_OPS = ("FADD", "FMUL", "FFMA", "FMNMX", "FCHK", "FSETP", "FSEL")


def _load_order_report(sass, kernel):
    """Per instantiation of ``kernel``: its global loads in SASS order (bits
    a load) and how many are issued before the first float operation; a
    load placed after a division's slow-path branch would wait for it."""
    name, ops = None, {}
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            if name:
                ops[name] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                      line)
        if name and m:
            ops[name].append(m.group(1))
    for name, seq in sorted(ops.items()):
        loads = [i for i, op in enumerate(seq) if op.startswith("LDG")]
        first = next((i for i, op in enumerate(seq)
                      if op.split(".")[0] in FLOAT_OPS), len(seq))
        bits = [re.search(r"\.(\d+)", seq[i]) for i in loads]
        log(f"[build]   {_instantiation(name, kernel)}: {len(seq)} SASS "
            f"instructions; global loads "
            f"{[int(b.group(1)) if b else 32 for b in bits]} (bits); "
            f"{sum(i < first for i in loads)} of {len(loads)} issued before "
            f"the first float operation ({seq[first] if first < len(seq) else '-'}"
            f" at {first})")


SM90_KERNEL = "flash_sm90_kernel"
# the 3xTF32 kernels: (source, kernel name)
TF32X3_KERNELS = (("flash_attention.cu", "flash_tf32x3_kernel"),
                  ("ssd_scan.cu", "ssd_tc_kernel"))


def _ptxas_by_kernel(_build, source, kernel):
    """{mangled name: (registers, spill stores, spill loads)} of each
    instantiation of ``kernel`` in ``source``'s ptxas log."""
    text = (_build.BUILD_DIR / (source + ".ptxas.log")).read_text()
    out = {}
    for block in text.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        if kernel not in name:
            continue

        def num(pattern):
            m = re.search(pattern, block)
            return int(m.group(1)) if m else 0
        out[name] = (num(r"Used (\d+) registers"),
                     num(r"(\d+) bytes spill stores"),
                     num(r"(\d+) bytes spill loads"))
    return out


def _sass_count(sass, kernel, opcode):
    """{mangled name: count of ``opcode`` instructions} of each
    instantiation of ``kernel`` in the library's SASS."""
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            if name:
                counts.setdefault(name, 0)
        elif name and opcode in line:
            counts[name] += 1
    return counts


def _tf32x3_report(_build, sass, source, kernel, failures):
    """A 3xTF32 kernel, per instantiation: registers and spills from
    ptxas's log and the count of HMMA (mma.sync) instructions in its SASS.
    An instantiation with no HMMA fails the build phase."""
    ptxas = _ptxas_by_kernel(_build, source, kernel)
    hmma = _sass_count(sass, kernel, "HMMA")
    for name in sorted(set(ptxas) | set(hmma)):
        regs, st, ld = ptxas.get(name, (0, 0, 0))
        n = hmma.get(name, 0)
        short = _instantiation(name, kernel)
        log(f"[build]   {source} {short}: registers {regs}, spill stores "
            f"{st} B, spill loads {ld} B, HMMA instructions {n}")
        if n == 0:
            failures.append(f"build: {source} {short} has no HMMA "
                            f"instruction in its SASS")


def _instantiation(mangled, kernel):
    """``kernel<args>`` from a mangled instantiation name (f32 / bf16 for
    a type, numbers for the rest)."""
    m = re.search(kernel + r"I(.+?)EE", mangled)
    if not m:
        return kernel
    args = m.group(1).replace("13__nv_bfloat16", "bf16 ")
    if args.startswith("f"):
        args = "f32 " + args[1:]
    args = args.replace("Li", " ").replace("E", " ")
    return f"{kernel}<{','.join(args.split())}>"


def _sm90_report(_build, sass, lib_c, failures):
    """The tensor-core flash kernel, per head-dim width: registers and
    spills from ptxas's log, its dynamic shared memory, and the count of
    HGMMA (wgmma) instructions in its SASS (``cuobjdump -sass`` of the
    built library).  A width with no HGMMA fails the build phase."""
    ptxas = {_width(k): v for k, v in _ptxas_by_kernel(
        _build, "flash_attention_sm90.cu", SM90_KERNEL).items()}
    hgmma = {_width(k): v for k, v in _sass_count(
        sass, SM90_KERNEL, "HGMMA").items()}
    from repro_torch.kernels.flash_attention.ops import SM90_WIDTHS
    for w in SM90_WIDTHS:
        regs, st, ld = ptxas.get(w, (0, 0, 0))
        smem = lib_c.sage_flash_attention_sm90_smem(w)
        n = hgmma.get(w, 0)
        log(f"[build]   {SM90_KERNEL}<{w}>: registers {regs}, spill stores "
            f"{st} B, spill loads {ld} B, dynamic shared memory {smem} B, "
            f"HGMMA instructions {n}")
        if n == 0:
            failures.append(f"build: {SM90_KERNEL}<{w}> has no HGMMA "
                            f"instruction in its SASS")


def _width(mangled):
    """The head-dim width of a mangled ``flash_sm90_kernel<W>``."""
    m = re.search(SM90_KERNEL + r"ILi(\d+)E", mangled)
    return int(m.group(1)) if m else -1


def _err_worst(key, dtype, got, want):
    """The largest |got - want| and the largest ratio of it to
    ``TOL[(key, dtype)] * (1 + |want|)``."""
    tol = TOL[(key, dtype)]
    diff = (got.float() - want.float()).abs()
    return (diff.max().item(),
            (diff / (tol * (1 + want.float().abs()))).max().item())


def _check(failures, kernel, case, dtype, got, want, extra, tol_key=None):
    """allclose(rtol=tol, atol=tol): |kernel - plain| <= tol * (1 + |plain|)
    everywhere; ``worst`` is the largest ratio of the two sides (<= 1).
    ``tol_key`` names a TOL entry other than the kernel's own."""
    tol = TOL[(tol_key or kernel, dtype)]
    err, worst = _err_worst(tol_key or kernel, dtype, got, want)
    ok = worst <= 1.0
    log(f"[check] {kernel:15s} {case:34s} {dtype:8s} max_abs_err={err:.3e} "
        f"tol={tol:g} worst={worst:.3f} {'ok' if ok else 'FAIL'} {extra}")
    if not ok:
        failures.append(f"{kernel} {case} {dtype}: worst {worst:.3f} > 1")
    return err


def _kernel_row(name, shape, err, ms, plain, bound, bound_by, library_ms,
                source=None):
    file = {"ddim_step": "ddim_step/ddim_step.py:39",
            "dpmpp_step": "dpmpp_step/dpmpp_step.py:53",
            "group_mean": "group_mean/group_mean.py:21",
            "flash_attention": "flash_attention/flash_attention.py:53",
            "ssd_scan": "ssd_scan/ssd_scan.py:31"}[name]
    return dict(name=name, route="cuda",
                source=f"src/repro_torch/csrc/{source or name}.cu",
                replaces=f"src/repro/kernels/{file}", shape=shape,
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=bound_by, library_ms=library_ms)


def _yardsticks(failures, name, case, ms, bound, fn, nbytes, plan=None):
    """Two yardsticks of a step kernel whose bytes bound lies under a
    launch's own cost: ``floor_ms``, the empty ``launch_floor_kernel``
    launched with the grid and block of ``fn()``'s kernel (read from the
    kernel node of a graph that captured ``fn()``), timed as the kernel is
    (``time_ms``); ``copy_ms``, ``dst.copy_(src)`` of ``nbytes / 2`` bytes
    (the kernel's bytes read plus written, each counted once, as a copy
    reads and writes its bytes).  ``plan``, (blocks, 1, threads) of the
    wrapper's launch plan, must be the node's grid and block."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.serving import runners
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    nodes = [n for n in runners.kernel_nodes(graph)
             if runners.KERNEL_SYMBOLS[name] in n.symbol]
    del graph
    if len(nodes) != 1 or nodes[0].grid[2] != 1 or nodes[0].block[1:] != (
            1, 1):
        failures.append(f"yardstick {name}: kernel nodes {nodes}, want one "
                        f"of a 2-D grid of 1-D blocks")
        return {}
    (bx, by, _), (threads, _, _) = nodes[0].grid, nodes[0].block
    if plan is not None and (bx, by, threads) != plan:
        failures.append(f"yardstick {name}: the captured launch has grid "
                        f"{bx}x{by} x {threads} threads, the plan "
                        f"{plan[0]}x{plan[1]} x {plan[2]}")
    lib = _build.load_library()

    def floor():
        _build.check(lib.sage_launch_floor(
            bx, by, threads, torch.cuda.current_stream().cuda_stream),
            "launch_floor")
    floor_ms = time_ms(floor, 200)
    src = torch.zeros(nbytes // 2 // 4, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src), 200)
    log(f"[yardstick] {name:12s} {case:34s} ms={ms:.6g} floor_ms="
        f"{floor_ms:.6g} copy_ms={copy_ms:.6g} bound_ms={bound:.6g} "
        f"grid={bx}x{by}x{threads} ms/floor={ms / floor_ms:.3f} "
        f"ms<=2*bound_ms: {'yes' if ms <= 2 * bound else 'no'}")
    return dict(floor_ms=floor_ms, copy_ms=copy_ms)


def _update_nodes(failures, dev, gen, sched):
    """One fused solver update as a segment makes it
    (``shared_sampling._step_update``), captured alone in a CUDA graph, its
    kernel nodes read back (``[graph-nodes:ddim]``): a DDIM update must be
    exactly one ``ddim_step_kernel`` node, no schedule gather, with per-row
    timesteps (the serving path), one timestep for the stack, and per-row
    timesteps of a 2-D grid.  A DPM-Solver++(2M) update's nodes are
    counted, not checked: its kernel's scalar prologue (``samplers.
    dpmpp_scalars``) is still PyTorch's."""
    import torch
    from repro_torch.config import SageConfig
    from repro_torch.core import shared_sampling as ss
    from repro_torch.core.schedule import ddim_timesteps
    from repro_torch.serving.runners import KERNEL_SYMBOLS, kernel_nodes
    z, eu, ec, ep = (torch.randn((8, 64, 64, 4), device=dev, generator=gen)
                     for _ in range(4))
    grid = torch.as_tensor(ddim_timesteps(1000, 30), device=dev)
    idx = torch.tensor([9, 12], device=dev).repeat_interleave(4)
    g2 = torch.zeros((8, 31), dtype=torch.long, device=dev)
    g2[:4] = grid
    g2[4:, :21] = torch.as_tensor(ddim_timesteps(1000, 20), device=dev)
    steps = {"per-row t": (grid[idx], grid[idx + 1]),
             "one t": (grid[idx[:1]][0], grid[idx[:1] + 1][0]),
             "2-D grid t": (g2.gather(1, idx[:, None])[:, 0],
                            g2.gather(1, idx[:, None] + 1)[:, 0])}

    def nodes_of(fn):
        fn()                                    # loads, first-call set-up
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            fn()
        names = [n.symbol for n in kernel_nodes(graph)]
        del graph
        return names

    sage = SageConfig(**PATHS["ddim"], step_impl="fused")
    for label, (t, tn) in steps.items():
        names = nodes_of(lambda: ss._step_update(sched, sage, z, t, tn, eu,
                                                  ec, ep, None, None))
        ok = (len(names) == 1
              and KERNEL_SYMBOLS["ddim_step"] in names[0])
        log(f"[graph-nodes:ddim] one fused DDIM update captured alone, "
            f"{label}: {len(names)} kernel node(s) "
            f"{[_instantiation(n, KERNEL_SYMBOLS['ddim_step']) for n in names]}"
            f" {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"graph nodes: a fused DDIM update ({label}) "
                            f"is the kernels {names}, not one ddim_step")
    sage = SageConfig(**PATHS["dpmpp"], step_impl="fused")
    t, tn = steps["per-row t"]
    tp, first = grid[torch.clamp_min(idx - 1, 0)], idx == 9
    names = nodes_of(lambda: ss._step_update(sched, sage, z, t, tn, eu, ec,
                                              ep, tp, first))
    mine = sum(KERNEL_SYMBOLS["dpmpp_step"] in n for n in names)
    prologue = {}
    for n in names:
        if KERNEL_SYMBOLS["dpmpp_step"] not in n:
            prologue[n[:72]] = prologue.get(n[:72], 0) + 1
    log(f"[graph-nodes:dpmpp] one fused DPM-Solver++(2M) update captured "
        f"alone, per-row t: {len(names)} kernel nodes, {mine} of them "
        f"dpmpp_step_kernel; the rest its scalar prologue, by kernel: "
        f"{prologue}")


def _step_cases(dev, gen, dtype, cases):
    """Latent stacks with per-row (``rows``) or broadcast (``2d``) grid
    positions on the real 30-step grid: two groups at steps 9 (the 0.3
    share ratio's fork) and 12, one per half of the rows."""
    import torch
    from repro_torch.core.schedule import ddim_timesteps
    grid = torch.as_tensor(ddim_timesteps(1000, 30), device=dev)
    for launch, shape in cases:
        idx = torch.tensor([9, 12], device=dev).repeat_interleave(
            shape[0] // 2)
        i = idx if launch == "rows" else idx[-1]
        yield launch, shape, [torch.randn(shape, device=dev, generator=gen,
                                          dtype=dtype) for _ in range(4)], \
            grid[i], grid[i + 1], grid[torch.clamp_min(i - 1, 0)], i == 9


def _stream_step_cases(failures, dev, gen, sched):
    """The step kernels on the stacks that only the stream phase gives them,
    each against its plain version (f32 DDIM bitwise, the rest at TOL):
    ddim_step on trace H's draft thumb stack (4 rows of 32x32x4) and on the
    4-row DDIM subset the mixed-solver split cuts from an (8, 64, 64, 4)
    pack, its rows at positions of the standard and premium grids (a 2-D
    tier grid); dpmpp_step on the premium wide stack (4 rows of 32x64x4,
    two of them member-0 pad replicas) and on the pack's DPM subset, warm-up
    rows at their fork beside mid-branch rows; group_mean on trace O's one
    group (1, 4, 64, 64, 4) under its pad masks."""
    import torch
    from repro_torch.core import samplers
    from repro_torch.core.schedule import ddim_timesteps
    from repro_torch.kernels.ddim_step.ops import fused_cfg_ddim_step
    from repro_torch.kernels.ddim_step.ref import fused_cfg_ddim_step_ref
    from repro_torch.kernels.dpmpp_step.ops import fused_cfg_dpmpp_step
    from repro_torch.kernels.dpmpp_step.ref import fused_cfg_dpmpp_step_ref
    from repro_torch.kernels.group_mean.ops import masked_group_mean
    from repro_torch.kernels.group_mean.ref import masked_group_mean_ref

    def grid(steps, idx):
        g = torch.as_tensor(ddim_timesteps(1000, steps), device=dev)
        i = torch.tensor(idx, device=dev)
        return g[i], g[i + 1], g[torch.clamp_min(i - 1, 0)]

    def subset(t):                 # the split's DDIM or DPM rows of a pack
        return t[torch.tensor([0, 2, 5, 7], device=dev)]

    def padded(t):                 # 2 members + 2 member-0 replicas
        return torch.cat([t[:2], t[:1].expand((2,) + t.shape[1:])], 0)

    # (case, shape, make the 4 inputs of a stack, (t, t_next, t_prev),
    #  first flags)
    ddim = [("thumb draft", (4, 32, 32, 4), lambda x: x,
             grid(15, [3, 3, 7, 7])),
            ("mixed-pack subset std/prem", (8, 64, 64, 4), subset,
             tuple(torch.cat([a, b]) for a, b in zip(
                 grid(30, [9, 12]), grid(45, [13, 40]))))]
    dpm = [("wide prem padded", (4, 32, 64, 4), padded,
            grid(45, [0, 17, 0, 0]), [True, False, True, True]),
           ("mixed-pack subset std", (8, 64, 64, 4), subset,
            grid(30, [9, 9, 14, 22]), [True, True, False, False])]
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for case, shape, cut, (t, tn, _) in ddim:
            z, eu, ec = (cut(torch.randn(shape, device=dev, generator=gen,
                                         dtype=dtype)) for _ in range(3))
            for clip in (3.0, 0.0):
                args = (z, eu, ec, 7.5, sched.alphas, sched.sigmas, t, tn)
                err = _check(failures, "ddim_step",
                             f"stream {case} {tuple(z.shape)} clip={clip:g}",
                             dn, fused_cfg_ddim_step(*args, clip_x0=clip),
                             fused_cfg_ddim_step_ref(*args, clip_x0=clip),
                             "")
                if dtype == torch.float32 and err != 0.0:
                    failures.append(f"ddim_step stream {case} f32: error "
                                    f"{err:.3e}, not bitwise the plain "
                                    f"version's")
        for case, shape, cut, (t, tn, tp), first in dpm:
            z, eu, ec, ep = (cut(torch.randn(shape, device=dev,
                                             generator=gen, dtype=dtype))
                             for _ in range(4))
            sc = samplers.dpmpp_scalars(sched, t, tn, tp)
            first = torch.tensor(first, device=dev)
            for clip in (3.0, 0.0):
                args = (z, eu, ec, ep, 7.5, *sc, first)
                for out, g, w in zip(
                        ("z'", "eps"),
                        fused_cfg_dpmpp_step(*args, clip_x0=clip),
                        fused_cfg_dpmpp_step_ref(*args, clip_x0=clip)):
                    _check(failures, "dpmpp_step", f"stream {case} "
                           f"{tuple(z.shape)} clip={clip:g} {out}", dn, g,
                           w, "")
        x = torch.randn((1, 4, 64, 64, 4), device=dev, generator=gen,
                        dtype=dtype)
        for mvals in ([[1, 1, 1, 0]], [[1, 1, 0, 0]]):
            mask = torch.tensor(mvals, dtype=torch.float32, device=dev)
            _check(failures, "group_mean",
                   f"stream one group {tuple(x.shape)} mask={mvals[0]}", dn,
                   masked_group_mean(x, mask),
                   masked_group_mean_ref(x, mask), "")


def phase_kernels(failures):
    """Each kernel against its plain version at the main path's shapes.
    Returns the headline row per kernel for the result JSON."""
    import torch
    from repro_torch.core import samplers
    from repro_torch.core.schedule import make_schedule
    from repro_torch.kernels.ddim_step.ops import fused_cfg_ddim_step
    from repro_torch.kernels.ddim_step.ref import fused_cfg_ddim_step_ref
    from repro_torch.kernels.dpmpp_step.ops import fused_cfg_dpmpp_step
    from repro_torch.kernels.dpmpp_step.ref import fused_cfg_dpmpp_step_ref
    from repro_torch.kernels._tiles import launch_plan
    from repro_torch.kernels.group_mean.ops import masked_group_mean
    from repro_torch.kernels.group_mean.ref import masked_group_mean_ref

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    sched = make_schedule(1000, device=dev)
    rows = {}

    # ddim_step: branch-phase stack of run_batch (2 groups x width 4 rows of
    # 64x64x4 latents) and its shared-phase stack (2 trunks), per-row
    # timesteps from the real 30-step grid; and the broadcast launch of
    # shared_sample.  The kernel gathers its own schedule values from the
    # tables at t and t_next, as the plain version does
    cases = [("rows", (8, 64, 64, 4)), ("2d", (8, 64, 64, 4)),
             ("rows", (2, 64, 64, 4))]      # the shared phase's 2 trunks
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for launch, shape, (z, eu, ec, _), t, tn, _, _ in _step_cases(
                dev, gen, dtype, cases):
            for clip in (3.0, 0.0):
                args = (z, eu, ec, 7.5, sched.alphas, sched.sigmas, t, tn)
                got = fused_cfg_ddim_step(*args, clip_x0=clip)
                want = fused_cfg_ddim_step_ref(*args, clip_x0=clip)
                ms = time_ms(lambda: fused_cfg_ddim_step(*args,
                                                         clip_x0=clip), 200)
                plain = time_ms(lambda: fused_cfg_ddim_step_ref(
                    *args, clip_x0=clip), 50)
                # the tiles, and each row's two timesteps and four gathered
                # schedule values (one set for a broadcast launch)
                nbytes = (4 * z.numel() * z.element_size()
                          + (t.numel() + tn.numel()) * 8 + 4 * 4 * t.numel())
                bound = max(nbytes / HBM_BYTES_PER_S,
                            10 * z.numel() / PEAK_FLOPS["float32"]) * 1e3
                case = f"{launch} {tuple(shape)} clip={clip:g}"
                err = _check(failures, "ddim_step", case, dn, got, want,
                             f"ms={ms:.6g} plain_ms={plain:.6g} "
                             f"bound_ms={bound:.6g}")
                if dtype == torch.float32 and err != 0.0:
                    failures.append(f"ddim_step {case} f32: error {err:.3e}"
                                    f", not bitwise the plain version's")
                if ((launch, shape, clip, dtype)
                        == ("rows", (8, 64, 64, 4), 3.0, torch.float32)):
                    plan = launch_plan(z.numel(), z[0].numel(),
                                       z.element_size(), True)
                    rows["ddim_step"] = _kernel_row(
                        "ddim_step", f"{case} f32", err, ms, plain, bound,
                        "bytes", None)
                    rows["ddim_step"].update(_yardsticks(
                        failures, "ddim_step", f"{case} f32", ms, bound,
                        lambda: fused_cfg_ddim_step(*args, clip_x0=clip),
                        nbytes, plan=(plan.blocks_per_row, plan.rows,
                                      plan.threads)))
    _update_nodes(failures, dev, gen, sched)

    # dpmpp_step: the same stacks on the DPM-Solver++ path; in the per-row
    # stacks the first group sits at its fork (history warm-up) and the
    # second mid-branch; both outputs (z' and the combined eps) checked
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for launch, shape, (z, eu, ec, ep), t, tn, tp, first in _step_cases(
                dev, gen, dtype, cases):
            sc = samplers.dpmpp_scalars(sched, t, tn, tp)
            for clip in (3.0, 0.0):
                args = (z, eu, ec, ep, 7.5, *sc, first)
                got = fused_cfg_dpmpp_step(*args, clip_x0=clip)
                want = fused_cfg_dpmpp_step_ref(*args, clip_x0=clip)
                ms = time_ms(lambda: fused_cfg_dpmpp_step(*args,
                                                          clip_x0=clip), 200)
                plain = time_ms(lambda: fused_cfg_dpmpp_step_ref(
                    *args, clip_x0=clip), 50)
                nbytes = 6 * z.numel() * z.element_size()
                bound = max(nbytes / HBM_BYTES_PER_S,
                            25 * z.numel() / PEAK_FLOPS["float32"]) * 1e3
                case = f"{launch} {tuple(shape)} clip={clip:g}"
                errs = [_check(failures, "dpmpp_step", f"{case} {out}", dn,
                               g, w, f"ms={ms:.6g} plain_ms={plain:.6g} "
                               f"bound_ms={bound:.6g}")
                        for out, g, w in zip(("z'", "eps"), got, want)]
                if ((launch, shape, clip, dtype)
                        == ("rows", (8, 64, 64, 4), 3.0, torch.float32)):
                    rows["dpmpp_step"] = _kernel_row(
                        "dpmpp_step", f"{case} f32", max(errs), ms, plain,
                        bound, "bytes", None)
                    plan = launch_plan(z.numel(), z[0].numel(),
                                       z.element_size(), True)
                    rows["dpmpp_step"].update(_yardsticks(
                        failures, "dpmpp_step", f"{case} f32", ms, bound,
                        lambda: fused_cfg_dpmpp_step(*args, clip_x0=clip),
                        nbytes, plan=(plan.blocks, 1, plan.threads)))

    # group_mean: the shared-uncond group-mean latent of the branch stack
    # (2 groups x 4 members of 64x64x4), full groups as on the path, and
    # one masked member beside an all-masked group
    masks = {"full": [[1, 1, 1, 1], [1, 1, 1, 1]],
             "masked": [[1, 1, 1, 0], [0, 0, 0, 0]]}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        x = torch.randn((2, 4, 64, 64, 4), device=dev, generator=gen,
                        dtype=dtype)
        for mname, mvals in masks.items():
            mask = torch.tensor(mvals, dtype=torch.float32, device=dev)
            got = masked_group_mean(x, mask)
            want = masked_group_mean_ref(x, mask)
            ms = time_ms(lambda: masked_group_mean(x, mask), 200)
            plain = time_ms(lambda: masked_group_mean_ref(x, mask), 50)
            nbytes = ((x.numel() + got.numel()) * x.element_size()
                      + 4 * mask.numel())
            bound = max(nbytes / HBM_BYTES_PER_S,
                        2 * x.numel() / PEAK_FLOPS["float32"]) * 1e3
            case = f"{tuple(x.shape)} mask={mname}"
            err = _check(failures, "group_mean", case, dn, got, want,
                         f"ms={ms:.6g} plain_ms={plain:.6g} "
                         f"bound_ms={bound:.6g}")
            if mname == "full" and dtype == torch.float32:
                rows["group_mean"] = _kernel_row(
                    "group_mean", f"{case} f32", err, ms, plain, bound,
                    "bytes", None)
                rows["group_mean"].update(_yardsticks(
                    failures, "group_mean", f"{case} f32", ms, bound,
                    lambda: masked_group_mean(x, mask), nbytes))

    _stream_step_cases(failures, dev, gen, sched)
    _flash_cases(failures, rows, dev, gen, FLASH_CASES)
    _flash_scale_signs(failures, dev, gen)
    _ssd_cases(failures, rows, dev, gen)
    torch.cuda.empty_cache()
    return rows


# flash_attention: (case, B, Sq, Sk, H, Hkv, D, causal, window, dtypes).
# The DiT branch phase runs the CFG pair of 8 member rows (batch 16) through
# self-attention (1024 tokens, 16 heads of 72) and cross-attention (77 cond
# tokens); the text tower runs 8 prompts causally (77 tokens, 4 heads of
# 192, f32 on the path).  bf16 takes the sm90 tensor-core kernel, f32 the
# 3xTF32 one.  The other cases are the shapes a kernel's padding and
# masking can get wrong: each padded width of the sm90 kernel, D not a
# width, Sq and Sk ragged against the tiles (16-row and 32-key for the
# f32 kernel, 64/128 for sm90), a single key; in f32 also D off the 16-byte
# loads (4-byte copies) and off the product's K step of 8.
BOTH, BF16, F32 = ("float32", "bfloat16"), ("bfloat16",), ("float32",)
FLASH_CASES = [
    ("dit_self 16x1024x1024 h16 d72", 16, 1024, 1024, 16, 16, 72, False, 0,
     BOTH),
    ("dit_cross 16x1024x77 h16 d72", 16, 1024, 77, 16, 16, 72, False, 0,
     BOTH),
    # the DPM path's branch phase with the shared-uncond CFG: 2 group rows
    # + 8 member rows
    ("dit_self 10x1024x1024 h16 d72", 10, 1024, 1024, 16, 16, 72, False, 0,
     BOTH),
    ("dit_cross 10x1024x77 h16 d72", 10, 1024, 77, 16, 16, 72, False, 0,
     BOTH),
    # the shared phase: the CFG pair of 2 group trunks
    ("dit_self 4x1024x1024 h16 d72", 4, 1024, 1024, 16, 16, 72, False, 0,
     BOTH),
    ("dit_cross 4x1024x77 h16 d72", 4, 1024, 77, 16, 16, 72, False, 0, BOTH),
    # the stream phase's trace H: its quarter-res class (32x32 latents, 256
    # tokens) and its 32x64 aspect bucket (512 tokens), each at the rows of
    # a shared segment (the CFG pair of one group) and of a branch segment
    # (4 member rows, padded, x2 for the CFG pair)
    ("stream_self 2x256x256 h16 d72", 2, 256, 256, 16, 16, 72, False, 0,
     BOTH),
    ("stream_self 8x256x256 h16 d72", 8, 256, 256, 16, 16, 72, False, 0,
     BOTH),
    ("stream_cross 2x256x77 h16 d72", 2, 256, 77, 16, 16, 72, False, 0,
     BOTH),
    ("stream_cross 8x256x77 h16 d72", 8, 256, 77, 16, 16, 72, False, 0,
     BOTH),
    ("stream_self 2x512x512 h16 d72", 2, 512, 512, 16, 16, 72, False, 0,
     BOTH),
    ("stream_self 8x512x512 h16 d72", 8, 512, 512, 16, 16, 72, False, 0,
     BOTH),
    ("stream_cross 2x512x77 h16 d72", 2, 512, 77, 16, 16, 72, False, 0,
     BOTH),
    ("stream_cross 8x512x77 h16 d72", 8, 512, 77, 16, 16, 72, False, 0,
     BOTH),
    # trace O's one-group (K = 1) segments: the CFG pair of its trunk, and
    # the shared-uncond branch's group row + 4 member rows
    ("stream_self 2x1024x1024 h16 d72", 2, 1024, 1024, 16, 16, 72, False,
     0, BOTH),
    ("stream_self 5x1024x1024 h16 d72", 5, 1024, 1024, 16, 16, 72, False,
     0, BOTH),
    ("stream_cross 2x1024x77 h16 d72", 2, 1024, 77, 16, 16, 72, False, 0,
     BOTH),
    ("stream_cross 5x1024x77 h16 d72", 5, 1024, 77, 16, 16, 72, False, 0,
     BOTH),
    ("text_causal 8x77x77 h4 d192", 8, 77, 77, 4, 4, 192, True, 0, BOTH),
    ("gqa_window 2x1024 h16/4 d72 w256", 2, 1024, 1024, 16, 4, 72, True,
     256, BOTH),
    # sage-dit smoke (16 tokens, 4 heads of 32, cond 48) and sage-dit-100m
    # (256 tokens, 12 heads of 64, cond 64), CFG pair of 8
    ("smoke_self 16x16x16 h4 d32", 16, 16, 16, 4, 4, 32, False, 0, BF16),
    ("smoke_cross 16x16x48 h4 d32", 16, 16, 48, 4, 4, 32, False, 0, BF16),
    ("100m_self 16x256x256 h12 d64", 16, 256, 256, 12, 12, 64, False, 0,
     BF16),
    ("100m_cross 16x256x64 h12 d64", 16, 256, 64, 12, 12, 64, False, 0,
     BF16),
    ("d128 4x1024x1024 h8 d128", 4, 1024, 1024, 8, 8, 128, False, 0, BF16),
    ("d192 causal 2x515x515 h4 d192", 2, 515, 515, 4, 4, 192, True, 0,
     BF16),
    ("d256 2x512x512 h4/2 d256", 2, 512, 512, 4, 2, 256, False, 0, BF16),
    ("d256 causal 2x130x130 h4 d256", 2, 130, 130, 4, 4, 256, True, 0,
     BOTH),
    ("ragged 3x130x200 h4/2 d72", 3, 130, 200, 4, 2, 72, False, 0, BOTH),
    ("ragged causal 2x200x200 h6 d40", 2, 200, 200, 6, 6, 40, True, 0,
     BOTH),
    ("sk1 4x100x1 h4 d72", 4, 100, 1, 4, 4, 72, False, 0, BOTH),
    ("sk1 2x70x1 h2 d80", 2, 70, 1, 2, 2, 80, False, 0, BF16),
    ("d8 window 2x300x300 h2 d8 w40", 2, 300, 300, 2, 2, 8, True, 40, BOTH),
    ("d30 ragged 2x70x90 h2 d30", 2, 70, 90, 2, 2, 30, False, 0, F32),
    ("d100 window 2x300x300 h4/2 d100 w64", 2, 300, 300, 4, 2, 100, True,
     64, F32),
    ("d5 causal 3x33x33 h3/1 d5", 3, 33, 33, 3, 1, 5, True, 0, F32),
]


def _flash_cases(failures, rows, dev, gen, cases):
    """Each case against ``attention_ref``, with the kernel's, the plain
    version's and SDPA's times, the bound and the achieved TFLOP/s on the
    function's own operations (4 B H pairs D at the true D).  The bound
    prices those operations on the units that run them: bf16 tensor cores
    for the sm90 kernel, three TF32 passes for the f32 one (beside the
    f32 CUDA-core figure of earlier runs)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    for (case, B, Sq, Sk, H, Hkv, D, causal, window, dtypes) in cases:
        scale = 1.0 / math.sqrt(D)
        qi = torch.arange(Sq, device=dev)[:, None]
        ki = torch.arange(Sk, device=dev)[None, :]
        visible = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
        if causal:
            visible &= ki <= qi
        if window:
            visible &= ki > qi - window
        pairs = int(visible.sum())
        for dn in dtypes:
            dtype = getattr(torch, dn)
            q = torch.randn((B, Sq, H, D), device=dev, generator=gen,
                            dtype=dtype)
            k, v = (torch.randn((B, Sk, Hkv, D), device=dev, generator=gen,
                                dtype=dtype) for _ in range(2))
            kw = dict(causal=causal, window=window, scale=scale)
            got = flash_attention(q, k, v, **kw)
            want = attention_ref(q, k, v, **kw)
            ms = time_ms(lambda: flash_attention(q, k, v, **kw), 10)
            plain = time_ms(lambda: attention_ref(q, k, v, **kw), 5)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            mask = None if (not causal or not window) else visible

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask,
                    is_causal=causal and mask is None, scale=scale,
                    enable_gqa=Hkv != H)
            lib_ms = time_ms(sdpa, 10)
            flops = 4.0 * B * H * pairs * D
            nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
            t_bytes = nbytes / HBM_BYTES_PER_S
            extra = ""
            if dtype == torch.bfloat16:
                t_ops = flops / PEAK_FLOPS["bfloat16"]
            else:
                t_ops = TF32_PASSES * flops / PEAK_FLOPS["tf32"]
                cc = max(flops / PEAK_FLOPS["float32"], t_bytes) * 1e3
                extra = f"bound_cuda_core_ms={cc:.6g} "
            bound = max(t_ops, t_bytes) * 1e3
            bound_by = "operations" if t_ops >= t_bytes else "bytes"
            err = _check(failures, "flash_attention", case, dn, got, want,
                         f"ms={ms:.6g} plain_ms={plain:.6g} "
                         f"library_ms={lib_ms:.6g} bound_ms={bound:.6g} "
                         f"({bound_by}) {extra}"
                         f"tflops={flops / ms / 1e9:.4g}")
            if case.startswith("dit_self 16x") and dtype == torch.bfloat16:
                rows["flash_attention"] = _kernel_row(
                    "flash_attention", f"{case} bf16", err, ms, plain, bound,
                    bound_by, lib_ms, source="flash_attention_sm90")
            if case.startswith("text_causal") and dtype == torch.float32:
                f32_row = _kernel_row(
                    "flash_attention", f"{case} f32", err, ms, plain, bound,
                    bound_by, lib_ms)
                f32_row["flash_route"] = "tf32x3"
            del q, k, v, got, want
    rows["flash_attention"]["flash_route"] = "sm90"
    rows["flash_attention"]["f32_text_causal"] = f32_row
    torch.cuda.empty_cache()


def _flash_scale_signs(failures, dev, gen):
    """A negative and a zero scale.  The sm90 kernel folds a positive
    scale into its exponents, and the wrapper maps a negative scale (-q)
    and a zero one (q * 0) onto it; the f32 kernel scales its scores."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    for dn in BOTH:
        dtype = getattr(torch, dn)
        q = torch.randn((2, 130, 4, 72), device=dev, generator=gen,
                        dtype=dtype)
        k, v = (torch.randn((2, 200, 2, 72), device=dev, generator=gen,
                            dtype=dtype) for _ in range(2))
        for scale, causal in ((-0.3, False), (-0.3, True), (0.0, True)):
            kw = dict(causal=causal, scale=scale)
            _check(failures, "flash_attention",
                   f"scale={scale:g} causal={int(causal)} 2x130x200 h4/2",
                   dn, flash_attention(q, k, v, **kw),
                   attention_ref(q, k, v, **kw), "")


# ssd_scan on the mamba2 path (48 heads of 64, d_state 128, chunk 128):
# (case, batch, length, dtype, init_state)
SSD_CASES = [
    ("shared prefill 1x1024", 1, 1024, "float32", False),
    ("launcher prefill 4x1024", 4, 1024, "float32", False),
    ("independent prefill 4x1088", 4, 1088, "float32", False),
    ("init_state 1x1024", 1, 1024, "float32", True),
    ("shared prefill 1x1024", 1, 1024, "bfloat16", False),
    ("launcher prefill 4x1024", 4, 1024, "bfloat16", False),
    ("independent prefill 4x1088", 4, 1088, "bfloat16", False),
]


def _ssd_inputs(dev, gen, b, l, dtype, h=48, p=64, n=128):
    """What ``ssm_full`` feeds the scan at mamba2-780m width: x * dt, dA =
    dt * A with dt = softplus(noise) and A = -(1..h) (``A_log`` = log(1..h)
    at init), B and C; x, B, C in the activations' dtype."""
    import torch
    import torch.nn.functional as F
    dt = F.softplus(torch.randn((b, l, h), device=dev, generator=gen))
    A = -torch.arange(1, h + 1, device=dev, dtype=torch.float32)
    x = (torch.randn((b, l, h, p), device=dev, generator=gen)
         * dt[..., None]).to(dtype)
    B, C = (torch.randn((b, l, n), device=dev, generator=gen).to(dtype)
            for _ in range(2))
    return x, dt * A, B, C


def _ssd_cases(failures, rows, dev, gen):
    """The SSD kernel (one launch over every (b, c, h) tile) against its
    plain tiles, and the whole wrapper (padding, init_state, recurrence)
    against ``ssd_chunked_ref``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan.ops import (ssd_chunked_kernel,
                                                  ssd_intra_chunk)
    from repro_torch.kernels.ssd_scan.ref import (ssd_chunked_ref,
                                                  ssd_tiles_ref)
    Q = 128
    for case, b, l, dn, init in SSD_CASES:
        dtype = getattr(torch, dn)
        x, dA, B, C = _ssd_inputs(dev, gen, b, l, dtype)
        s0 = (0.1 * torch.randn((b, 48, 64, 128), device=dev, generator=gen)
              if init else None)
        pad = -l % Q
        xp = F.pad(x, (0, 0, 0, 0, 0, pad))
        dAp = F.pad(dA, (0, 0, 0, pad))
        Bp, Cp = (F.pad(t, (0, 0, 0, pad)) for t in (B, C))
        G = b * (l + pad) // Q * 48
        # the causal pairs j <= i only: Q(Q+1)/2 of them, each an N-long dot
        # for C Bᵀ, once per (b, c) since B and C are shared by the heads,
        # and per head a P-long update of y, plus the chunk state's 2QPN
        cb_ops = b * (l + pad) // Q * Q * (Q + 1) * 128
        head_ops = G * (Q * (Q + 1) * 64 + 2 * Q * 64 * 128)
        # on the tensor cores: 3 TF32 passes each for f32 inputs; for bf16
        # ones 1 for C Bᵀ (both operands bf16) and 2 for the others
        passes = (TF32_PASSES, TF32_PASSES) if dn == "float32" else (1, 2)
        t_ops = ((passes[0] * cb_ops + passes[1] * head_ops)
                 / PEAK_FLOPS["tf32"])
        nbytes = ((xp.numel() + Bp.numel() + Cp.numel()) * xp.element_size()
                  + 4 * dAp.numel() + 4 * (xp.numel() + G * 64 * 128))
        t_bytes = nbytes / HBM_BYTES_PER_S
        bound = max(t_ops, t_bytes) * 1e3
        # PR 13's figure: per-head C Bᵀ, f32 on CUDA cores
        cc = max(G * (Q * (Q + 1) * (128 + 64) + 2 * Q * 64 * 128)
                 / PEAK_FLOPS["float32"], t_bytes) * 1e3
        if not init:
            got = ssd_intra_chunk(xp, dAp, Bp, Cp, Q)
            want = ssd_tiles_ref(xp, dAp, Bp, Cp, Q)
            ms = time_ms(lambda: ssd_intra_chunk(xp, dAp, Bp, Cp, Q), 20)
            plain = time_ms(lambda: ssd_tiles_ref(xp, dAp, Bp, Cp, Q), 3)
            tcase = f"tiles {case} G={G}"
            extra = (f"ms={ms:.6g} plain_ms={plain:.6g} "
                     f"bound_ms={bound:.6g} "
                     f"({'operations' if t_ops >= t_bytes else 'bytes'}; "
                     f"ops {t_ops * 1e3:.6g}, bytes {t_bytes * 1e3:.6g}) "
                     f"bound_cuda_core_ms={cc:.6g} library_ms=none")
            errs = [_check(failures, "ssd_scan", f"{tcase} {out}", dn, g, w,
                           extra) for out, g, w in zip(("y", "st"), got, want)]
            if case.startswith("shared") and dn == "float32":
                rows["ssd_scan"] = _kernel_row(
                    "ssd_scan", f"{tcase} f32", max(errs), ms, plain, bound,
                    "operations" if t_ops >= t_bytes else "bytes", None)
            if case.startswith("shared") and dn == "bfloat16":
                rows["ssd_scan"]["bf16"] = dict(
                    shape=f"{tcase} bf16", max_abs_err=max(errs), ms=ms,
                    plain_ms=plain, bound_ms=bound,
                    bound_by="operations" if t_ops >= t_bytes else "bytes")
            del got, want
        got = ssd_chunked_kernel(x, dA, B, C, Q, s0)
        want = ssd_chunked_ref(x, dA, B, C, Q, s0)
        wms = time_ms(lambda: ssd_chunked_kernel(x, dA, B, C, Q, s0), 5)
        for out, g, w in zip(("y", "state"), got, want):
            _check(failures, "ssd_scan", f"wrapper {case} {out}", dn, g, w,
                   f"wrapper_ms={wms:.6g}",
                   tol_key="ssd_scan y" if out == "y" else None)
        del got, want, xp, Bp, Cp


def _randomize_zero_init(module, gen):
    """adaLN-zero gates, lnx and the q/k/rms norms start at zero, which
    would switch whole branches of the DiT off: give them seeded values."""
    import torch
    with torch.no_grad():
        for p in module.parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=gen)


# the serving paths: slice 1's DDIM path and DPM-Solver++(2M) with the
# shared-uncond CFG (one uncond row per group in the branch phase), both
# through SageServingEngine.step(); and the AR shared-prefix path on
# mamba2-780m (launcher at batch 4, then 2 groups of 4 with a 1024-token
# shared prefix and 64-token tails)
PATHS = {"ddim": dict(total_steps=30),
         "dpmpp": dict(total_steps=30, sampler="dpmpp",
                       shared_uncond_cfg=True),
         "mamba2": dict(arch="mamba2-780m", batch=4, prompt_len=1024,
                        gen=32, groups=2, members=4, tail=64)}
DIT_PATHS = ("ddim", "dpmpp")
# kernels each path must launch; "never" must stay at 0 launches
PATH_KERNELS = {"ddim": dict(needs=("flash_attention", "ddim_step"),
                             never=("dpmpp_step", "group_mean", "ssd_scan")),
                "dpmpp": dict(needs=("flash_attention", "dpmpp_step",
                                     "group_mean"),
                              never=("ddim_step", "ssd_scan")),
                "mamba2": dict(needs=("ssd_scan",),
                               never=("flash_attention", "ddim_step",
                                      "dpmpp_step", "group_mean")),
                # the stream phase's traces: H's DiT on sm90 and its f32 text
                # tower on tf32x3, both solvers; O's DPM-Solver++ with the
                # shared-uncond CFG
                "stream:H": dict(needs=("flash_attention/sm90",
                                        "flash_attention/tf32x3",
                                        "ddim_step", "dpmpp_step"),
                                 never=("group_mean", "ssd_scan")),
                "stream:O": dict(needs=("flash_attention", "dpmpp_step",
                                        "group_mean"),
                                 never=("ddim_step", "ssd_scan")),
                # C's four passes (DDIM, trunk-cache hits branching from the
                # cached latent, 2-D grids), and the cached prefix prefill
                "stream:C": dict(needs=("flash_attention/sm90",
                                        "flash_attention/tf32x3",
                                        "ddim_step"),
                                 never=("dpmpp_step", "group_mean",
                                        "ssd_scan")),
                "mamba2:cache": dict(needs=("ssd_scan",),
                                     never=("flash_attention", "ddim_step",
                                            "dpmpp_step", "group_mean"))}
KERNELS = ("flash_attention", "ddim_step", "dpmpp_step", "group_mean",
           "ssd_scan")
# the sampler-step kernels, whose bytes bound lies under a launch's cost
STEP_KERNELS = ("ddim_step", "dpmpp_step", "group_mean")
# each DiT path's step, as the reference engine counts it: NFE (2 groups of 4,
# 9 shared and 21 branch steps; the shared-uncond CFG runs N + 1 rows a
# branch step) and the step kernels' launches (one a step; the group mean
# one a branch step); flash's are checked by route
EXPECTED = {"ddim": dict(nfe=372, launches=dict(ddim_step=30)),
            "dpmpp": dict(nfe=246, launches=dict(dpmpp_step=30,
                                                 group_mean=21))}


def _counters():
    """Each kernel wrapper, whose ``launches`` counts the launches it
    makes (a graph replay runs no wrapper: ``runners.REPLAYED``)."""
    from repro_torch.serving.runners import WRAPPERS
    return WRAPPERS


def _reset_counts(counters):
    """Every launch count to 0, flash's per-route counts and the graph
    replays' too."""
    from repro_torch.serving.runners import REPLAYED
    for fn in counters.values():
        fn.launches = 0
    routes = counters["flash_attention"].launches_by_route
    for r in routes:
        routes[r] = 0
    for key in REPLAYED:
        REPLAYED[key] = 0


def _ran():
    """The launches counted since ``_reset_counts``, keyed as
    ``runners.launch_counts``: (by the wrappers, by graph replays)."""
    from repro_torch.serving.runners import REPLAYED, launch_counts
    return launch_counts(), dict(REPLAYED)


def _summed(*counts):
    return {k: sum(c[k] for c in counts) for k in counts[0]}


# a served step's launches of the segments' kernels (the step kernels and
# the DiT's flash on sm90), by the wrappers and by graph replays, in units
# of one pass over the segments: a capturing step warms each segment up and
# launches it into its capture (2) and replays it once (1); a replayed step
# only replays; an eager step only runs the wrappers.  The text tower's f32
# flash runs eagerly, once a step, in every mode.  The first eager step
# warms the allocator up for eager activations; the second is the eager
# reference, the third casts each weight per call as before the copies
STEP_MODES = {"capture": (2, 1), "replay": (0, 1), "eager, first": (1, 0),
              "eager": (1, 0), "eager, per-call casts": (1, 0)}
# a DiT path's counted steps: the capture and a first eager step, then
# the replayed, eager and per-call-cast steps twice, alternating, so that
# host-clock noise shows between two steps of one mode
STEP_ORDER = ("capture", "eager, first", "replay", "eager",
              "eager, per-call casts", "replay", "eager",
              "eager, per-call casts")


def _want(path, routes, segments, text):
    """Launch counts keyed as ``runners.launch_counts``: ``segments`` x the
    path's segment kernels plus ``text`` x the text tower's flash."""
    from repro_torch.serving.runners import launch_counts
    want = dict.fromkeys(launch_counts(), 0)
    want.update({k: segments * n
                 for k, n in EXPECTED[path]["launches"].items()})
    want["flash_attention/sm90"] = segments * routes["sm90"]
    want["flash_attention/tf32x3"] = text * routes["tf32x3"]
    want["flash_attention"] = (want["flash_attention/sm90"]
                               + want["flash_attention/tf32x3"])
    return want


def _build_modules(cfg, tc, device, vae_dtype, seed=0):
    """DiT, text tower and VAE decoder with weights drawn from ``seed``."""
    import torch
    from repro_torch.models.dit import DiT
    from repro_torch.models.text_encoder import TextTower
    from repro_torch.models.vae import VAEDecoder

    gen = torch.Generator(device=device).manual_seed(seed)
    dit = DiT(cfg, device=device, generator=gen)
    text = TextTower(tc, device=device, generator=gen)
    vae = VAEDecoder(device=device, generator=gen, dtype=vae_dtype)
    for m in (dit, text):
        _randomize_zero_init(m, gen)
    return dit, text, vae


def _engine(modules, path, device, seed=0):
    from repro_torch.config import SageConfig
    from repro_torch.serving.engine import SageServingEngine
    return SageServingEngine(SageConfig(**PATHS[path]), *modules,
                             group_size=4, attn_impl="kernel",
                             step_impl="fused", seed=seed, device=device)


def _capture_s(engine):
    """Host seconds the engine's segment runners spent capturing."""
    return sum(getattr(r, "capture_s", 0.0)
               for r in engine.scheduler._runners.values())


def _serve(engine, prompts, path, failures, routes, label):
    """One counted ``step()`` of ``path`` in mode ``label``
    (``STEP_MODES``): every launch count set to 0 just before, read just
    after.  The wrappers' and the graph replays' counts must be exactly
    ``_want``'s for the mode (flash's per route too), NFE ``EXPECTED``'s.
    Returns (the launches the wrappers counted, those graph replays
    counted, the step's own ledger (the engine's stats accumulate over
    steps), the groups, the host-clock wall)."""
    import numpy as np
    import torch

    dev = torch.device("cuda:0")
    engine.submit(prompts)
    before = dict(engine.stats)
    capture0 = _capture_s(engine)
    _reset_counts(_counters())
    torch.cuda.synchronize()
    held0 = torch.cuda.memory_allocated(dev)
    reserved0 = torch.cuda.memory_reserved(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    done = engine.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wrappers, replayed = _ran()
    peak = torch.cuda.max_memory_allocated(dev)
    held = torch.cuda.memory_allocated(dev) - held0
    # a graph's private pool stays reserved, its blocks free between replays
    reserved = torch.cuda.memory_reserved(dev) - reserved0
    cap = _capture_s(engine) - capture0

    st = {k: engine.stats[k] - before[k] for k in engine.stats}
    groups = {}
    for c in done:
        groups.setdefault(c.group_id, []).append(prompts.index(c.prompt))
    log(f"[e2e:{path}:{label}] {PATHS[path]} requests={st['requests']} "
        f"completed={len(done)} groups={sorted(groups.values())}")
    log(f"[e2e:{path}:{label}] nfe={st['nfe']:g} nfe_independent="
        f"{st['nfe_independent']:g} cost_saving="
        f"{1 - st['nfe'] / st['nfe_independent']:.4f} "
        f"segment_launches={st['launches']} pack_rows={st['pack_rows']} "
        f"pack_pad_rows={st['pack_pad_rows']}")
    w, r = STEP_MODES[label]
    want_w, want_r = (_want(path, routes, w, 1), _want(path, routes, r, 0))
    graphs = sum(len(getattr(r, "graphs", ()))
                 for r in engine.scheduler._runners.values())
    log(f"[e2e:{path}:{label}] wall_s={wall:.3f} capture_s={cap:.3f} "
        f"peak_mem_gib={peak / 2 ** 30:.3f} held_after_gib="
        f"{held / 2 ** 30:.3f} reserved_after_gib={reserved / 2 ** 30:.3f} "
        f"graphs={graphs}")
    log(f"[e2e:{path}:{label}] launches by the wrappers {wrappers} "
        f"(expected {want_w}); by graph replays, read from the graphs' "
        f"kernel nodes {replayed} (expected {want_r})")
    if wrappers != want_w or replayed != want_r:
        failures.append(f"e2e {path} {label}: launches {wrappers} by the "
                        f"wrappers and {replayed} by graph replays, not "
                        f"{want_w} and {want_r}")
    want = EXPECTED[path]
    if st["nfe"] != want["nfe"]:
        failures.append(f"e2e {path} {label}: nfe {st['nfe']:g}, not "
                        f"{want['nfe']}")
    if len(done) != len(prompts):
        failures.append(f"e2e {path}: {len(done)} completions for "
                        f"{len(prompts)} prompts")
    for c in done:
        if c.image.shape != (512, 512, 3) or not np.isfinite(c.image).all():
            failures.append(f"e2e {path}: image of {c.prompt!r} has shape "
                            f"{c.image.shape} or non-finite values")
    _check_path_kernels(path, _summed(wrappers, replayed), failures)
    return wrappers, replayed, st, sorted(groups.values()), wall


@contextlib.contextmanager
def _eager_segments(engine, per_call_casts):
    """The scheduler's segments eager for a same-run reference: each
    runner's body called directly, as on the CPU; with ``per_call_casts``
    the DiT's cast-once copies hidden too, each weight then cast per call,
    as before the copies existed."""
    s = engine.scheduler
    graphs = s._runners
    s._runners = {k: r.fn for k, r in graphs.items()}
    hidden = [(p, p.__dict__.pop("_casts", None))
              for p in (s.dit._cast if per_call_casts else ())]
    try:
        yield
    finally:
        s._runners = graphs
        for p, casts in hidden:
            if casts is not None:
                p.__dict__["_casts"] = casts


def _check_path_kernels(path, launches, failures):
    for name in PATH_KERNELS[path]["needs"]:
        if launches[name] <= 0:
            failures.append(f"e2e {path}: kernel {name} never launched")
    for name in PATH_KERNELS[path]["never"]:
        if launches[name]:
            failures.append(f"e2e {path}: kernel {name} launched "
                            f"{launches[name]} times off its path")


def _dit_setup(dev):
    """The DiT paths' configurations and modules at full ``sage-dit`` width,
    weights from seed 0: ``(cfg, text cfg, modules, set-up seconds)``."""
    import torch
    from repro_torch.config import get_config, replace
    from repro_torch.models.text_encoder import text_cfg
    cfg = get_config("sage-dit")
    tc = replace(text_cfg(dim=768, layers=4), attn_impl="kernel")
    t0 = time.perf_counter()
    modules = _build_modules(cfg, tc, dev, torch.bfloat16)
    torch.cuda.synchronize()
    return cfg, tc, modules, time.perf_counter() - t0


def _segment_nodes(engine):
    """The kernel nodes of each segment runner's graph, read through the
    CUDA driver: {runner key (phase, n_steps, samplers): nodes}."""
    from repro_torch.serving.runners import kernel_nodes
    out = {}
    for key, run in engine.scheduler._runners.items():
        (_, graph, _, _), = run.graphs.values()
        out[str(key[:3])] = len(kernel_nodes(graph))
    return out


def phase_end_to_end(failures):
    """One engine step per serving path at full sage-dit width on the kernel
    routes, the same weights for both.  Returns each path's launch counts
    and the kernel nodes of its segment graphs."""
    import torch

    dev = torch.device("cuda:0")
    cfg, tc, modules, setup_s = _dit_setup(dev)
    n_params = sum(p.numel() for p in modules[0].parameters())
    log(f"[e2e] {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model} "
        f"{cfg.n_heads} heads x {cfg.hd}, latent {cfg.latent_size}^2x"
        f"{cfg.latent_channels} -> {(cfg.latent_size // cfg.patch) ** 2} "
        f"tokens, cond {cfg.cond_len}x{cfg.cond_dim}, dtype {cfg.dtype}; "
        f"DiT {n_params / 1e6:.1f} M params; text tower dim {tc.d_model} x "
        f"{tc.n_layers}; set-up {setup_s:.2f} s")
    prompts = [p for pair in zip(*THEMES) for p in pair]
    launches, nodes = {}, {}
    for path in DIT_PATHS:
        engine = _engine(modules, path, dev)
        log(f"[e2e:{path}] DiT weights cast once to {cfg.dtype}: "
            f"{engine.scheduler.cast_bytes / 2 ** 20:.1f} MiB")
        # bf16 DiT: self + cross a layer a step, on sm90; the f32 text
        # tower: one causal launch a layer, on tf32x3
        routes = {"sm90": 2 * cfg.n_layers * PATHS[path]["total_steps"],
                  "tf32x3": tc.n_layers}
        steps = []
        for mode in STEP_ORDER:
            with (_eager_segments(engine, mode.endswith("casts"))
                  if mode.startswith("eager") else contextlib.nullcontext()):
                steps.append((mode, _serve(engine, prompts, path, failures,
                                           routes, mode)))
        if any(out[2:4] != steps[0][1][2:4] for _, out in steps):
            failures.append(f"e2e {path}: the steps' ledgers and groups "
                            f"differ: {[out[2:4] for _, out in steps]}")
        walls = {}
        for mode, out in steps:
            walls.setdefault(mode, []).append(out[4])
        mean = {mode: sum(w) / len(w) for mode, w in walls.items()}
        log(f"[e2e:{path}] step walls, same run: " + "; ".join(
            f"{mode} " + " / ".join(f"{x:.3f}" for x in w) + " s"
            for mode, w in walls.items())
            + f"; mean replayed / eager {mean['replay'] / mean['eager']:.3f}"
            f", replayed / eager with per-call casts "
            f"{mean['replay'] / mean['eager, per-call casts']:.3f}")
        launches[path] = dict(steps)["replay"][:2]
        nodes[path] = _segment_nodes(engine)
        _runner_check(engine, path, failures)
        _profile_step(engine, prompts, path, failures)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    _bf16_forward_check(modules[0], failures)
    return launches, nodes, (cfg, modules)


def _stream_scheduler(modules, trace, device, **over):
    """A streaming scheduler for ``STREAM_TRACES[trace]`` from a
    ``SageServingEngine`` on ``modules`` (the kernel routes, noise from seed
    0), with the trace's fault plan drawn afresh and its trunk cache (scan
    index, budgets at the DiT's latent) made anew."""
    from repro_torch.config import SageConfig
    from repro_torch.serving.engine import SageServingEngine
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.trunk_cache import TrunkCache
    spec = STREAM_TRACES[trace]
    kw = dict(spec["scheduler"], **over)
    if "faults" in spec:
        kw["faults"] = FaultPlan(**spec["faults"])
    if "cache" in spec and "trunk_cache" not in kw:
        cfg = modules[0].cfg
        kw["trunk_cache"] = TrunkCache(**cache_kwargs(
            trace, cfg.latent_size, cfg.latent_channels))
    engine = SageServingEngine(SageConfig(**spec["sage"]), *modules,
                               group_size=4, attn_impl="kernel",
                               step_impl="fused", device=device)
    return engine.streaming_scheduler(**kw)


def _stream_latent_shapes(trace, latent_size):
    """Each prompt's latent (H, W): its class's fraction of the grid."""
    spec = STREAM_TRACES[trace]
    classes = (spec.get("classes")
               or tuple(c for _, wave in spec.get("waves", ()) for c in wave)
               or (("all", 0, 0, (1, 1), (1, 1)),))
    return {STREAM_PROMPTS[c[2]]: stream_shape(c[3], c[4], latent_size, 1)[:2]
            for c in classes}


def _stream_image_shapes(trace, latent_size):
    """Each prompt's image (H, W, 3): the VAE's 8x of its class's latent."""
    return {p: (8 * h, 8 * w, 3) for p, (h, w) in _stream_latent_shapes(
        trace, latent_size).items()}


def _graphs(sched):
    """{runner key (phase, n_steps, samplers): graphs captured}, and the
    capture seconds of all of them."""
    return ({str(k[:3]): len(r.graphs) for k, r in sched._runners.items()},
            sum(r.capture_s for r in sched._runners.values()))


def _serve_stream(sched, trace, label, cfg, failures, now=0.0,
                  expected=True, expect=None, telemetry=None):
    """One counted pass of ``trace`` through ``sched`` (every launch count
    set to 0 just before, read just after): with ``expected``, the
    discrete outcome against ``STREAM_EXPECTED[expect or trace]`` (a later
    pass on the same scheduler without the tier and shape ledgers, which
    accumulate); the kernels of the trace's path, every image finite and
    of its class's shape; the pass's walls, ledgers, latencies, graphs,
    capture seconds, memory and packs with a 2-D grid printed.  Given a
    ``telemetry`` dict, the pass is traced: a ``Tracer`` on the scheduler
    and ``DISPATCH_LOG`` on for this pass only, checked by ``_telemetry``,
    and the dict receives the pass's wall, tracer and routes.  Returns
    (records, launches by the wrappers, by graph replays, the clock, the
    outcome, the packs with a 2-D grid)."""
    import numpy as np
    import torch
    from repro_torch.kernels.dispatch import DISPATCH_LOG
    from repro_torch.serving import packing
    from repro_torch.serving.telemetry import Tracer

    dev = torch.device("cuda:0")
    if telemetry is not None:
        sched.tracer = Tracer()
        DISPATCH_LOG.reset()
        DISPATCH_LOG.enabled = True
    ticks0, stats0 = sched.ticks, dict(sched.stats)
    graphs0, cap0 = _graphs(sched)
    _reset_counts(_counters())
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with count_2d_grids(packing) as grids:
        done, now = drive_stream(sched, trace, cfg.latent_size,
                                 cfg.latent_channels, now)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wrappers, replayed = _ran()
    if telemetry is not None:
        DISPATCH_LOG.enabled = False
        telemetry.update(wall=wall, tracer=sched.tracer,
                         routes=dict(DISPATCH_LOG.routes))
        DISPATCH_LOG.reset()
        sched.tracer = None
    graphs, cap = _graphs(sched)
    st = {k: sched.stats[k] - stats0[k] for k in sched.stats}
    ticks = sched.ticks - ticks0
    lat = np.asarray([c.latency for c in done if c.image is not None])
    new = {k: n - graphs0.get(k, 0) for k, n in graphs.items()
           if n - graphs0.get(k, 0)}
    tag = f"[stream:{trace}:{label}]"
    log(f"{tag} ticks={ticks} wall_s={wall:.3f} wall_per_tick_s="
        f"{wall / ticks:.4f} requests={st['requests']:g} served="
        f"{lat.size} launches={st['launches']:g} launches_per_tick="
        f"{st['launches'] / ticks:.4f} pad_waste="
        f"{st['pack_pad_rows'] / max(st['pack_rows'], 1):.4f} nfe="
        f"{st['nfe']:g} nfe_independent={st['nfe_independent']:g} "
        f"cost_saving={1 - st['nfe'] / max(st['nfe_independent'], 1):.4f} "
        f"latency_p50={np.percentile(lat, 50):g} latency_p95="
        f"{np.percentile(lat, 95):g} ticks packs_with_2d_grid={grids[0]}")
    log(f"{tag} graphs captured by runner key {new or 'none'} "
        f"({sum(new.values())} graphs, {sum(graphs.values())} on the "
        f"scheduler) capture_s={cap - cap0:.3f}; memory reserved "
        f"{torch.cuda.memory_reserved(dev) / 2 ** 30:.3f} GiB ("
        f"{(torch.cuda.memory_reserved(dev) - reserved0) / 2 ** 30:+.3f} in "
        f"the pass: the new graphs' pools), peak allocated "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} GiB")
    log(f"{tag} launches by the wrappers {wrappers}; by graph replays "
        f"{replayed}")
    want = _expected_outcome(expect or trace, ticks0)
    got = stream_outcome(sched, done, cfg.latent_size, ticks0,
                         stats0 if ticks0 else None)
    if not expected:
        want = got
    if got != want:
        diff = sorted(k for k in want if got.get(k) != want[k])
        failures.append(f"stream {trace} {label}: outcome differs from "
                        f"STREAM_EXPECTED in {diff}: "
                        f"{ {k: got.get(k) for k in diff} }")
    verdict = ("equal to STREAM_EXPECTED" if got == want
               else "DIFFERS from STREAM_EXPECTED") if expected else ""
    log(f"{tag} outcome {verdict}: groups {got['groups']} by status "
        f"{got['by_status']} by qos {got['by_qos']} preemptions="
        f"{got['preemptions']:g} resumes={got['resumes']:g} retries="
        f"{got['retries']:g} stalled_ticks={got['stalled_ticks']:g} "
        f"deadline_met={got['deadline_met']:g} deadline_missed="
        f"{got['deadline_missed']:g}")
    _check_path_kernels(f"stream:{trace}", _summed(wrappers, replayed),
                        failures)
    if telemetry is not None:
        _telemetry(sched, trace, label, telemetry, dict(st, ticks=ticks),
                   wrappers, failures)
    shapes = _stream_image_shapes(trace, cfg.latent_size)
    for c in done:
        if c.image is not None and (c.image.shape != shapes[c.prompt]
                                    or not np.isfinite(c.image).all()):
            failures.append(f"stream {trace} {label}: image of {c.prompt!r}"
                            f" has shape {c.image.shape} (want "
                            f"{shapes[c.prompt]}) or non-finite values")
    return done, wrappers, replayed, now, got, grids[0]


def _telemetry(sched, trace, label, telemetry, ledger, wrappers, failures):
    """A traced pass's checks, printed on ``[telemetry:<trace>]`` lines:
    the tracer's counts reconcile with the pass's ledger (``reconcile``;
    with a cache, its hits by kind and tier from the pass's own cache) and
    equal ``STREAM_TRACE_COUNTS[trace]``; the tracer's own emit time is
    under 5% of the pass wall (the JAX package's bar); each kernel op's
    dispatches in the log equal its wrapper's launches outside the graph
    replays.  The registry's Prometheus line count and the routes are
    printed."""
    tracer, wall, routes = (telemetry[k] for k in ("tracer", "wall",
                                                   "routes"))
    counts = tracer.counts()
    tc = sched.trunk_cache
    if tc is not None:
        ledger.update(cache_hits=tc.stats["hits"],
                      cache_exact_hits=tc.stats["exact_hits"],
                      cache_hits_hbm=tc.stats["hits_hbm"],
                      cache_hits_host=tc.stats["hits_host"])
    bad = reconcile(counts, ledger, tracer.events)
    want = STREAM_TRACE_COUNTS[trace]
    logged = dispatch_counts(routes)
    logged = {op: logged.get(op, 0) for op in DISPATCH_OPS}
    launched = {op: wrappers[w] for op, w in DISPATCH_OPS.items()}
    share = tracer.self_seconds / wall
    prom_lines = sched.metrics.to_prometheus().count("\n")
    tag = f"[telemetry:{trace}]"
    log(f"{tag} {label}: counts {dict(sorted(counts.items()))}; tracer "
        f"self_seconds={tracer.self_seconds:.6f} of the pass wall_s="
        f"{wall:.3f} ({100 * share:.4f}%, the bar 5%); {len(tracer.events)}"
        f" events, {tracer.dropped} dropped; Prometheus lines "
        f"{prom_lines}; {_SMI}")
    rows = [f"{op} {req}->{ch} [{shape}] {reason} x{n}"
            for (op, req, ch, reason, shape), n in sorted(routes.items())]
    log(f"{tag} dispatch routes ({len(rows)}): {rows}")
    log(f"{tag} kernel-route dispatches {logged}, the wrappers' launches "
        f"outside the replays {launched}: "
        f"{'equal' if logged == launched else 'DIFFER'}; counts "
        f"{'equal to' if counts == want else 'DIFFER from'} "
        f"STREAM_TRACE_COUNTS[{trace!r}]; reconciled with the pass's "
        f"ledger: {'yes' if not bad else bad}")
    if bad or counts != want or share >= 0.05 or logged != launched:
        differ = sorted(k for k in set(want) | set(counts)
                        if counts.get(k) != want.get(k))
        failures.append(
            f"telemetry {trace} {label}: reconcile {bad}; counts differ "
            f"from STREAM_TRACE_COUNTS in {differ}; self_seconds share "
            f"{share:.4f}; dispatches {logged} vs launches {launched}")


def _row_flops(dit, cfg, hw):
    """FLOPs of one denoiser evaluation, one NFE (one latent row, one half
    of a CFG pair), of an (H, W) latent on ``dit`` with its text context:
    ``torch.utils.flop_counter``'s count of the forward's products run
    once with the plain attention route (the elementwise work left out,
    which only lowers the floor)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.config import replace
    dev = next(dit.parameters()).device
    with FlopCounterMode(display=False) as fc:
        dit(torch.zeros(1, *hw, cfg.latent_channels, device=dev),
            torch.full((1,), 500.0, device=dev),
            torch.zeros(1, cfg.cond_len, cfg.cond_dim, device=dev),
            cfg=replace(cfg, attn_impl="naive"))
    return fc.get_total_flops()


def _traced_h(failures, cfg, modules, sched, replay, outcome, ledger, now,
              base):
    """Trace H a third time on ``sched``, traced (a ``Tracer`` and the
    dispatch log on beside the scheduler's registry): the twin of its
    untraced replay pass (``replay`` records, ``outcome``, ``ledger`` its
    stats), each pass drawing its groups' noise by their gid within the
    pass (``base``).  Its images must be bitwise those, its outcome and
    stats equal, no graph captured and no wrapper launch made but the text
    tower's.  Then the roofline floor of the pass's work on the card
    (``launch/costs.py``'s bf16 peak over each served request's NFE, one
    row's forward at its class's latent an NFE, ``_row_flops``) beside its
    wall, and the capacity report's own floor, which counts a CFG pair at
    the full latent an NFE (the JAX package's formula).  Returns the
    clock."""
    from repro_torch.serving import reports

    base[0] = sched._next_gid
    graphs = _graphs(sched)[0]
    stats0 = dict(sched.stats)
    tel = {}
    done, w, _, now, got, _ = _serve_stream(
        sched, "H", "replay, traced", cfg, failures, now=now, telemetry=tel)
    stats = {k: sched.stats[k] - stats0[k] for k in sched.stats}
    eager = {k: n for k, n in w.items() if n and k not in (
        "flash_attention", "flash_attention/tf32x3")}
    same, err = _same_images(done, replay)
    differ = sorted(k for k in set(got) | set(outcome)
                    if got.get(k) != outcome.get(k))
    differ += sorted(k for k in ledger if stats.get(k) != ledger[k])
    log(f"[telemetry:H] the traced replay against the untraced replay: "
        f"images {'bitwise equal' if same else 'DIFFER'} (max {err:.3e}); "
        f"outcome and stats {'equal' if not differ else differ}")
    if _graphs(sched)[0] != graphs or eager or not same or differ:
        failures.append(f"telemetry H: the traced replay captured new "
                        f"graphs or launched {eager} outside them, images "
                        f"bitwise {same}, outcome or stats differ in "
                        f"{differ}")
    dit = modules[0]
    hw = _stream_latent_shapes("H", cfg.latent_size)
    flops = {s: _row_flops(dit, cfg, s) for s in set(hw.values())}
    nfe = sum(c.nfe_share for c in done)
    floor = sum(c.nfe_share * flops[hw[c.prompt]] for c in done
                ) / _COSTS.PEAK_FLOPS
    wall, served = tel["wall"], len(done)
    n_params = sum(p.numel() for p in dit.parameters())
    cap = reports.capacity_report(
        dict(stats, ticks=got["ticks"]),
        total_steps=STREAM_TRACES["H"]["sage"]["total_steps"],
        share_ratio=sched.sage.share_ratio, group_size=4,
        slice_steps=STREAM_TRACES["H"]["scheduler"]["slice_steps"],
        n_params=n_params, n_tokens=(cfg.latent_size // cfg.patch) ** 2)
    log(f"[telemetry:H] roofline floor of the traced replay ("
        f"launch/costs.py: {_COSTS.PEAK_FLOPS:.4g} FLOP/s dense bf16; "
        f"FLOPs of one row's forward, an NFE, by latent (H, W): "
        f"{ {s: f'{f:.6e}' for s, f in sorted(flops.items())} }): "
        f"{floor * 1e3:.3f} ms for its {nfe:g} NFE ({stats['nfe']:g} in "
        f"the ledger), {floor / nfe * 1e3:.4f} ms an NFE, "
        f"{floor / served * 1e3:.3f} ms a request; measured wall_s="
        f"{wall:.3f}: {wall / nfe * 1e3:.3f} ms an NFE, "
        f"{wall / served * 1e3:.3f} ms a request, {wall / floor:.2f}x the "
        f"floor; {_SMI}")
    roof = cap["roofline"]
    log(f"[telemetry:H] capacity_report's own floor (n_params={n_params}, "
        f"2 n_params 2 tokens = {roof['flops_per_eval']:.6e} FLOPs an NFE: "
        f"a CFG pair at the full latent, so above the work): "
        f"{roof['seconds_per_request_floor'] * 1e3:.3f} ms a request; "
        f"ticks predicted {cap['predicted']['ticks_to_drain']} observed "
        f"{cap['observed']['ticks']}")
    if not 0 < floor < wall or abs(nfe - stats["nfe"]) > 1e-6 * nfe:
        failures.append(f"telemetry H: roofline floor {floor:.6f} s not "
                        f"under the wall {wall:.6f} s, or the records' NFE "
                        f"{nfe} differ from the ledger's {stats['nfe']}")
    return now


def phase_stream(failures, cfg, modules):
    """The streaming scheduler at full sage-dit width on the DiT paths'
    modules: trace H twice on one scheduler (the first pass captures, the
    second must only replay: no new graph, no wrapper launch but the text
    tower's), a third time traced (``_traced_h``), once more under
    torch.profiler, then with ``packed=False`` on a fresh scheduler (the
    same outcome but for the launch ledger; the
    largest image difference from the packed run is printed beside the
    1e-3 end-to-end tolerance, a report: cuBLAS picks its algorithms by
    batch); trace O once; trace C in its four passes (``_stream_cache``)
    and its f32 witness (``_stream_cache_f32``).  Returns each trace's
    replayed pass's launches (trace C's: its four passes'), by the
    wrappers and by graph replays."""
    import numpy as np
    import torch

    from repro_torch.serving.scheduler import default_noise

    dev = torch.device("cuda:0")
    out = {}
    base = [0]
    sched = _stream_scheduler(modules, "H", dev, noise_fn=lambda gid, s:
                              default_noise(0, gid - base[0], s))
    first, *_ = _serve_stream(sched, "H", "capture", cfg, failures)
    graphs = _graphs(sched)[0]
    base[0] = sched._next_gid
    stats0 = dict(sched.stats)
    replay, w, r, now, got, _ = _serve_stream(sched, "H", "replay", cfg,
                                              failures, now=100.0)
    ledger = {k: sched.stats[k] - stats0[k] for k in sched.stats}
    out["stream:H"] = (w, r)
    eager = {k: n for k, n in w.items() if n and k not in (
        "flash_attention", "flash_attention/tf32x3")}
    if _graphs(sched)[0] != graphs or eager:
        failures.append(f"stream H replay: the second pass captured "
                        f"{_graphs(sched)[0]} (first {graphs}) or launched "
                        f"{eager} outside the graphs")
    now = _traced_h(failures, cfg, modules, sched, replay, got, ledger,
                    now + 100.0, base)
    _reset_counts(_counters())
    rows = _profile("stream:H", lambda: drive_stream(
        sched, "H", cfg.latent_size, cfg.latent_channels, now + 100.0),
        ("ddim_step_kernel", "dpmpp_step_kernel", "flash_sm90_kernel",
         "flash_tf32x3_kernel"))
    _trace_check("stream:H", rows, _summed(*_ran()), failures)
    del sched
    gc.collect()
    torch.cuda.empty_cache()

    oracle = _stream_scheduler(modules, "H", dev, packed=False)
    done, *_, got, _ = _serve_stream(oracle, "H", "per-group", cfg,
                                     failures, expected=False)
    want = dict(STREAM_EXPECTED["H"])
    differ = sorted(k for k in want if got[k] != want[k])
    if not set(differ) <= {"launches", "pack_rows", "pack_pad_rows",
                           "shapes"}:
        failures.append(f"stream H per-group: outcome differs from the "
                        f"packed one in {differ}")
    by = {}
    for c in first:
        by.setdefault(c.group_id, []).append(c)
    err = max(float(np.abs(c.image - by[c.group_id].pop(0).image).max())
              for c in done)
    log(f"[stream:H:per-group] outcome equal to the packed run's but for "
        f"{differ} (launches {got['launches']:g} against "
        f"{want['launches']:g}); largest image difference from the packed "
        f"run {err:.3e} (the end-to-end tolerance 1e-3; a report, not a "
        f"check)")
    del oracle
    gc.collect()
    torch.cuda.empty_cache()

    from repro_torch.serving.telemetry import MetricsRegistry
    sched = _stream_scheduler(modules, "O", dev, metrics=MetricsRegistry())
    _, w, r, _, _, _ = _serve_stream(sched, "O", "capture", cfg, failures,
                                     telemetry={})
    out["stream:O"] = (w, r)
    log(f"[stream:O] faults injected {sched.faults.injected} over "
        f"{sched.faults.queries} queries")
    del sched
    gc.collect()
    torch.cuda.empty_cache()
    out["stream:C"], cap, plain = _stream_cache(failures, cfg, modules,
                                                dev)
    _stream_cache_f32(failures, cfg, modules, dev, cap, plain)
    return out


# the example's chaos drill at its smoke size (its docstring's flags with
# the trunk cache, 4 themes and the telemetry outputs), on the kernel routes
EXAMPLE_ARGS = ("--streaming", "--trunk-cache", "--themes", "4",
                "--requests", "48", "--arrival-rate", "4.0", "--qos-mix",
                "0.25", "--overload", "shed", "--max-groups-per-tick", "2",
                "--fault-plan", "launch=0.1,stall=0.05,seed=7", "--report",
                "--backend", "kernel", "--fused-step")


def phase_example(failures):
    """``python -m repro_torch.examples.serve_shared`` in a child process
    on the card with ``EXAMPLE_ARGS``, its trace and metrics written to a
    temporary directory: it must exit 0, print its joined report with a
    conservation residual of 0 and write a trace and an exposition.  Its
    output is printed (``[example]`` lines)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        trace, prom = Path(tmp) / "trace.json", Path(tmp) / "metrics.prom"
        cmd = [sys.executable, "-m", "repro_torch.examples.serve_shared",
               *EXAMPLE_ARGS, "--trace", str(trace), "--metrics", str(prom)]
        t0 = time.perf_counter()
        try:
            run = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                 text=True, timeout=300, env=dict(
                                     os.environ,
                                     PYTHONPATH=str(ROOT / "src")))
        except subprocess.TimeoutExpired:
            failures.append("example: no exit within 300 s")
            return
        wall = time.perf_counter() - t0
        for line in run.stdout.splitlines():
            log(f"[example] {line}")
        events = (len(json.loads(trace.read_text())["traceEvents"])
                  if trace.is_file() else 0)
        lines = prom.read_text().count("\n") if prom.is_file() else 0
    residual = re.search(r"^\s+residual\s+(-?\d+)$", run.stdout, re.M)
    log(f"[example] exit {run.returncode} in {wall:.1f} s (a child "
        f"process: start, kernels loaded, graphs captured); trace events "
        f"{events}, Prometheus lines {lines}; {_SMI}")
    if (run.returncode != 0 or "== SLO report ==" not in run.stdout
            or residual is None or residual.group(1) != "0" or not events
            or not lines):
        failures.append(f"example: exit {run.returncode}, report printed "
                        f"{'== SLO report ==' in run.stdout}, residual "
                        f"{residual and residual.group(1)}, {events} trace "
                        f"events, {lines} Prometheus lines; stderr "
                        f"{run.stderr[-2000:]}")


def _same_images(a, b):
    """Whether two passes' records carry bitwise equal images, record for
    record, and the largest difference."""
    import numpy as np
    same = len(a) == len(b) and all(
        x.prompt == y.prompt and np.array_equal(x.image, y.image)
        for x, y in zip(a, b))
    err = max(float(np.abs(x.image - y.image).max()) for x, y in zip(a, b))
    return same, err


def _groups_err(a, b, skip=()):
    """{group within the pass: largest image difference} of two passes of
    trace C with the same groups (records, each pass from its first gid
    on), the groups in ``skip`` left out."""
    import numpy as np
    g0 = min(c.group_id for c in a)
    p0 = min(c.group_id for c in b)
    mine, other = {}, {}
    for c in a:
        if c.group_id - g0 not in skip:
            mine.setdefault(c.group_id - g0, []).append(c.image)
    for c in b:
        other.setdefault(c.group_id - p0, []).append(c.image)
    return {g: max(float(np.abs(x - y).max())
                   for x, y in zip(imgs, other[g]))
            for g, imgs in sorted(mine.items())}


def _kept_groups_err(cached, plain):
    """The groups that computed their own shared phase in a cached pass
    and in a pass without a cache (records of two passes of trace C, each
    from its first gid on): {group within the pass: largest image
    difference}.  With a group's noise a function of its gid, only the
    packs around them differ."""
    g0 = min(c.group_id for c in cached)
    return _groups_err(cached, plain,
                       {c.group_id - g0 for c in cached if c.cache_hit})


def _cache_scheduler(modules, dev):
    """Trace C's scheduler and its passes: (scheduler, passes, pass_start),
    where ``passes`` is (label, ``STREAM_EXPECTED`` key, make the pass's
    trunk cache) for the four passes: scan (the capture pass), LSH, every
    would-be hit corrupted, none; ``pass_start()`` is called as a pass
    starts, so that its groups draw the default noise of their gid within
    the pass and the passes start alike."""
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.scheduler import default_noise
    from repro_torch.serving.trunk_cache import TrunkCache

    cfg = modules[0].cfg
    kw = cache_kwargs("C", cfg.latent_size, cfg.latent_channels)
    base = [0]
    sched = _stream_scheduler(modules, "C", dev, noise_fn=lambda gid, s:
                              default_noise(0, gid - base[0], s))
    passes = (("capture", "C", lambda: TrunkCache(**kw)),
              ("replay, lsh", "C", lambda: TrunkCache(index="lsh", **kw)),
              ("corrupt", "C:corrupt", lambda: TrunkCache(
                  faults=FaultPlan(seed=0, p_cache_corrupt=1.0), **kw)),
              ("no cache", "C:nocache", lambda: None))

    def pass_start():
        base[0] = sched._next_gid
    return sched, passes, pass_start


def _expected_outcome(expect, ticks0):
    """``STREAM_EXPECTED[expect]``, for a later pass on a scheduler (one
    starting at tick ``ticks0`` > 0) without the tier and shape ledgers,
    which accumulate."""
    want = dict(STREAM_EXPECTED[expect])
    if ticks0:
        want.pop("tiers", None)
        want.pop("shapes", None)
    return want


def _outcome_failures(sched, done, cfg, ticks0, stats0, expect, label):
    """A pass's outcome against ``_expected_outcome``: [failure] or []."""
    got = stream_outcome(sched, done, cfg.latent_size, ticks0,
                         stats0 if ticks0 else None)
    want = _expected_outcome(expect, ticks0)
    diff = sorted(k for k in want if got.get(k) != want[k])
    return [f"{label}: outcome differs from STREAM_EXPECTED[{expect!r}] "
            f"in {diff}"] if diff else []


def _drive_cache_passes(modules, dev, failures, tag, labels=None):
    """Trace C's passes (``_cache_scheduler``; those in ``labels``, or all)
    on one scheduler, without the stream phase's measurements, each
    outcome held to its ``STREAM_EXPECTED`` entry: {label: records}."""
    sched, passes, pass_start = _cache_scheduler(modules, dev)
    cfg = modules[0].cfg
    out, now = {}, 0.0
    for label, expect, make in passes:
        if labels is not None and label not in labels:
            continue
        sched.trunk_cache = make()
        pass_start()
        ticks0, stats0 = sched.ticks, dict(sched.stats)
        out[label], now = drive_stream(sched, "C", cfg.latent_size,
                                       cfg.latent_channels, now)
        now += 100.0
        failures.extend(_outcome_failures(
            sched, out[label], cfg, ticks0, stats0, expect,
            f"stream C {label} ({tag})"))
    return out


def trace_c_stacks(failures):
    """Trace C's four passes at ``sage-dit`` smoke size on the CPU (f32,
    the plain versions), recorded (``record_stacks``): every
    (rows, per-row t, per-row t_next) stack the passes hand ``ddim_step``.
    The packs, and so each row's steps, do not depend on the width (each
    outcome must equal its ``STREAM_EXPECTED`` entry, as at full width), so
    these are the steps of the full-width stacks, which the card cannot
    read inside a graph capture."""
    import torch
    from repro_torch.config import get_config, replace
    from repro_torch.models.text_encoder import text_cfg
    cfg = replace(get_config("sage-dit", smoke=True), dtype="float32")
    tc = replace(text_cfg(dim=cfg.cond_dim, layers=2), attn_impl="kernel")
    mods = _build_modules(cfg, tc, torch.device("cpu"), torch.float32)
    with record_stacks() as seen:
        _drive_cache_passes(mods, torch.device("cpu"), failures,
                            "smoke, cpu")
    return {(shape[0], t, tn) for shape, _, _, t, tn in seen["ddim"]}


def _trace_c_stack_checks(failures, card, steps, dev,
                          ddim_dtypes=("float32", "bfloat16")):
    """``ddim_step`` and flash attention against their plain versions on
    every stack trace C handed them at full width (``card``: the
    ``record_stacks`` sets of the four passes on the card), in f32 and
    bf16; the row counts must agree between the card's record and
    ``steps``.  ``ddim_step``: each row count's stacks at the rows'
    recorded steps (``steps``: ``trace_c_stacks``), clip 3 and 0,
    bitwise against the plain version at the kernel's rounding points:
    ``ref.py`` itself in f32; in bf16 ``ref.py`` on the f32 values of the
    same inputs, rounded once to bf16, since the kernel, like the TPU
    kernel (``src/repro/kernels/ddim_step/ddim_step.py:44-48``), combines
    eps in f32, where ``ref.py`` rounds it to bf16 before the division by
    a_t.  The distance from ``ref.py`` in bf16 is printed beside its TOL,
    a report: at t = 1000 the cosine schedule's a_t is 1e-4, which
    multiplies that one rounding 1e4 times.  Flash: each recorded (q, k)
    shape at TOL.  On the CPU, where the wrapper is ``ref.py`` itself,
    only f32 holds the bitwise check: pass ``ddim_dtypes=("float32",)``."""
    import torch
    from repro_torch.core.schedule import make_schedule
    from repro_torch.kernels.ddim_step.ops import fused_cfg_ddim_step
    from repro_torch.kernels.ddim_step.ref import fused_cfg_ddim_step_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device=dev).manual_seed(20)
    sched = make_schedule(1000, device=dev)
    shapes, by_rows = {}, {}
    for shape, zdt, edt, _, _ in card["ddim"]:
        shapes.setdefault(shape[0], set()).add((shape, f"{zdt}/{edt}"))
    for rows, t, tn in steps:
        by_rows.setdefault(rows, []).append((t, tn))
    if set(shapes) != set(by_rows):
        failures.append(f"stream C: ddim_step row counts on the card "
                        f"{sorted(shapes)} but {sorted(by_rows)} at smoke "
                        f"size")
    for rows in sorted(set(shapes) & set(by_rows)):
        for shape, path_dtypes in sorted(shapes[rows]):
            for dn in ddim_dtypes:
                dtype = getattr(torch, dn)
                z, eu, ec = (torch.randn(shape, device=dev, generator=gen,
                                         dtype=dtype) for _ in range(3))
                err = ref_err = ref_worst = 0.0
                for t, tn in sorted(by_rows[rows]):
                    t, tn = (torch.tensor(x, device=dev) for x in (t, tn))
                    for clip in (3.0, 0.0):
                        tail = (7.5, sched.alphas, sched.sigmas, t, tn)
                        got = fused_cfg_ddim_step(z, eu, ec, *tail,
                                                  clip_x0=clip)
                        want = fused_cfg_ddim_step_ref(
                            z.float(), eu.float(), ec.float(), *tail,
                            clip_x0=clip).to(dtype)
                        err = max(err, (got.float() - want.float()).abs()
                                  .max().item())
                        e, w = _err_worst("ddim_step", dn, got,
                                          fused_cfg_ddim_step_ref(
                                              z, eu, ec, *tail,
                                              clip_x0=clip))
                        ref_err, ref_worst = max(ref_err, e), max(ref_worst,
                                                                  w)
                ok = err == 0.0
                report = "" if dtype == torch.float32 else (
                    f"; against ref.py in bf16 max_abs_err={ref_err:.3e} "
                    f"tol={TOL[('ddim_step', dn)]:g} worst={ref_worst:.3f} "
                    f"(a report)")
                log(f"[check] ddim_step       stream C {shape} x "
                    f"{len(by_rows[rows])} stacks of per-row steps, clip 3 "
                    f"and 0 (path {path_dtypes}) {dn:8s} max_abs_err="
                    f"{err:.3e} bitwise {'ok' if ok else 'FAIL'}{report}")
                if not ok:
                    failures.append(f"ddim_step stream C {shape} {dn}: "
                                    f"error {err:.3e}, not bitwise the "
                                    f"plain version's")
    for qs, ks, path_dtype, causal, window in sorted(card["flash"]):
        for dn in ("float32", "bfloat16"):
            dtype = getattr(torch, dn)
            q = torch.randn(qs, device=dev, generator=gen, dtype=dtype)
            k, v = (torch.randn(ks, device=dev, generator=gen, dtype=dtype)
                    for _ in range(2))
            kw = dict(causal=causal, window=window,
                      scale=1.0 / math.sqrt(qs[-1]))
            _check(failures, "flash_attention",
                   f"stream C {qs[0]}x{qs[1]}x{ks[1]} h{qs[2]} d{qs[3]}"
                   f"{' causal' if causal else ''}", dn,
                   flash_attention(q, k, v, **kw),
                   attention_ref(q, k, v, **kw), f"(path {path_dtype})")
    torch.cuda.empty_cache()


def _stream_cache(failures, cfg, modules, dev):
    """Trace C on one scheduler in four passes (``_cache_scheduler``), each
    with its own trunk cache: scan (the capture pass), LSH (replayed: no
    new graph), every would-be hit corrupted, none.  Checks: each outcome
    its ``STREAM_EXPECTED`` entry; LSH images bitwise those of scan; the
    corrupt pass's bitwise those of the pass without a cache, with as many
    integrity drops as injections; NFE conserved (no cache = cached +
    saved); a 2-D grid in at least one served pack; every stored entry
    ``trunk_entry_bytes`` of the latent and on the card; then
    ``ddim_step`` and flash on every stack the passes handed them
    (``_trace_c_stack_checks``).  Returns the four passes' launches (by the
    wrappers, by graph replays), and the capture and no-cache passes'
    records."""
    import torch

    shape = (cfg.latent_size, cfg.latent_size, cfg.latent_channels)
    sched, passes, pass_start = _cache_scheduler(modules, dev)
    res, launches, now = {}, [], 0.0
    with record_stacks() as card:
        for label, expect, make in passes:
            sched.trunk_cache = make()
            pass_start()
            graphs = _graphs(sched)[0]
            done, w, r, now, got, grids = _serve_stream(
                sched, "C", label, cfg, failures, now=now, expect=expect,
                telemetry={} if label == "replay, lsh" else None)
            now += 100.0
            launches.append((w, r))
            res[label] = (done, got, grids, sched.trunk_cache)
            tc = sched.trunk_cache
            if tc is not None:
                log(f"[stream:C:{label}] cache {tc.index.name}: "
                    f"{got['cache']}; bytes {tc.bytes} (device "
                    f"{tc.tier_bytes['hbm']}, host {tc.tier_bytes['host']})"
                    f" budgets {tc.max_bytes} / {tc.host_bytes}; entry "
                    f"bytes {sorted({e.nbytes for e in tc._entries.values()})}"
                    f" (trunk_entry_bytes {trunk_entry_bytes(shape)}) on "
                    f"{sorted({str(e.device) for e in tc._entries.values()})}")
                if any(e.nbytes != trunk_entry_bytes(shape)
                       or e.device.type != "cuda"
                       for e in tc._entries.values()):
                    failures.append(f"stream C {label}: an entry is not "
                                    f"{trunk_entry_bytes(shape)} bytes on "
                                    f"the card")
            if label == "replay, lsh":
                eager = {k: n for k, n in w.items() if n and k not in (
                    "flash_attention", "flash_attention/tf32x3")}
                if _graphs(sched)[0] != graphs or eager:
                    failures.append(f"stream C replay: the pass captured "
                                    f"new graphs or launched {eager} "
                                    f"outside them")
    cap, cached, cap_grids, _ = res["capture"]
    lsh = res["replay, lsh"][0]
    bad, _, _, bad_cache = res["corrupt"]
    plain, nocache, plain_grids, _ = res["no cache"]
    same_lsh, err_lsh = _same_images(lsh, cap)
    same_bad, err_bad = _same_images(bad, plain)
    err_kept = _kept_groups_err(cap, plain)
    injected = bad_cache.faults.injected["cache_corrupt"]
    drops = bad_cache.stats["integrity_drops"]
    saved = cached["cache"]["nfe_saved"]
    log(f"[stream:C] lsh images {'bitwise equal' if same_lsh else 'DIFFER'}"
        f" to scan's (max {err_lsh:.3e}); corrupt pass "
        f"{'bitwise equal' if same_bad else 'DIFFERS'} to the pass without "
        f"a cache (max {err_bad:.3e}), integrity_drops={drops} injected="
        f"{injected}; nfe {cached['nfe']:g} cached + {saved:g} saved = "
        f"{nocache['nfe']:g} without; packs with a 2-D grid {cap_grids} "
        f"cached, {plain_grids} without; the groups computed in both "
        f"passes differ by {err_kept} (a report: their packs differ; the "
        f"f32 passes below and the reference phase check them)")
    if not (same_lsh and same_bad and drops == injected > 0
            and cached["nfe"] + saved == nocache["nfe"] and cap_grids >= 1):
        failures.append(f"stream C: lsh bitwise {same_lsh}, corrupt "
                        f"bitwise {same_bad}, drops {drops} / injected "
                        f"{injected}, nfe {cached['nfe']} + {saved} vs "
                        f"{nocache['nfe']}, 2-D packs {cap_grids}")
    log(f"[stream:C] stacks handed to the kernels in the four passes: "
        f"ddim_step {sorted(card['ddim'])}; flash "
        f"{sorted(card['flash'])}")
    del sched, res
    gc.collect()
    torch.cuda.empty_cache()
    _trace_c_stack_checks(failures, card, trace_c_stacks(failures), dev)
    return ((_summed(*(w for w, _ in launches)),
             _summed(*(r for _, r in launches))), cap, plain)


def _stream_cache_f32(failures, cfg, modules, dev, cap, plain):
    """Trace C's capture (scan) and no-cache passes again at full width
    with the DiT and the VAE in f32: the same weights, noise and packs as
    the bf16 passes (``cap``, ``plain``: their records).  The groups that
    computed their own shared phase in both f32 passes must agree within
    1e-3, the end-to-end tolerance: at full width, on the kernels, a
    group's image does not depend on the packs it rides but for rounding.
    Printed beside it: each group's distance between its bf16 and its f32
    image in the same pass, the size of bf16's rounding after the steps."""
    import torch
    from repro_torch.config import replace
    from repro_torch.models.dit import DiT
    from repro_torch.models.vae import VAEDecoder

    cfg32 = replace(cfg, dtype="float32")
    dit = DiT(cfg32, device=dev)
    dit.load_state_dict(modules[0].state_dict())
    vae = VAEDecoder(device=dev, dtype=torch.float32)
    vae.load_state_dict(modules[2].state_dict())
    t0 = time.perf_counter()
    out = _drive_cache_passes((dit, modules[1], vae), dev, failures, "f32",
                              ("capture", "no cache"))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    kept = _kept_groups_err(out["capture"], out["no cache"])
    bf16_cap = _groups_err(cap, out["capture"])
    bf16_plain = _groups_err(plain, out["no cache"])
    ok = max(kept.values()) <= 1e-3
    log(f"[stream:C:f32] the capture and no-cache passes with the DiT and "
        f"VAE in f32 ({wall:.3f} s, graphs captured included): the groups "
        f"computed in both passes differ by {kept} tol=1e-3 "
        f"{'ok' if ok else 'FAIL'}; bf16 against f32 by group, capture "
        f"pass {bf16_cap}, no-cache pass {bf16_plain}")
    if not ok:
        failures.append(f"stream C f32: a group's image moved with its "
                        f"packs: {kept}")
    del out, dit, vae
    gc.collect()
    torch.cuda.empty_cache()


# kernel nodes a step of each path's segments saves against the parent
# commit's: none, the streaming slice leaves the run_batch segments' graphs
# as they were (118230 ddim, 118912 dpmpp; the DDIM kernel's own gathers
# took 8 a step out against the commit before, 240 over the 30 steps)
NODES_SAVED_PER_STEP = {"ddim": 0, "dpmpp": 0}


def _solver_step_us():
    """Device microseconds of one ``shared_segment`` step without the DiT
    (its eps function hands back a fixed tensor), in a CUDA graph
    (``time_ms``), for each DiT path's solver on the kernel route: the
    branch stack of 8 rows of 64x64x4 f32 at per-row steps 9 and 12 of
    the 30-step grid, as the serving path packs it.  What is left of a
    step is the solver's part: the timestep gathers, the CFG pair's
    ``cat``s, the update and the history indices."""
    import torch
    from repro_torch.config import SageConfig
    from repro_torch.core import shared_sampling as ss
    from repro_torch.core.schedule import ddim_timesteps, make_schedule
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(5)
    sched = make_schedule(1000, device=dev)
    grid = torch.as_tensor(ddim_timesteps(1000, 30), device=dev)
    z = torch.randn((8, 64, 64, 4), device=dev, generator=gen)
    eps = torch.randn((16, 64, 64, 4), device=dev, generator=gen)
    cond = torch.randn((8, 77, 768), device=dev, generator=gen)
    null = torch.zeros((77, 768), device=dev)
    step = torch.tensor([9, 12], device=dev).repeat_interleave(4)
    carry = ss.SampleCarry(z, torch.zeros_like(z), step)
    out = {}
    for path in DIT_PATHS:
        sage = SageConfig(**dict(PATHS[path], shared_uncond_cfg=False),
                          step_impl="fused")
        out[path] = 1e3 * time_ms(lambda: ss.shared_segment(
            lambda zz, tt, cc: eps, sched, sage, carry, cond, null, 1,
            grid), 200)
    return out


def phase_graph_nodes(failures, nodes, parent):
    """Each DiT path's segment graphs: their kernel nodes (``[graph-nodes:
    <path>]``), beside the same count from ``parent``, a checkout of the
    parent commit whose own package this script drives in a child process
    (``--segment-nodes``), when one is given.  There, parent - this must
    be ``NODES_SAVED_PER_STEP`` x the segment's steps, key by key."""
    step_us = _solver_step_us()
    theirs = _parent_segment_nodes(failures, parent) if parent else None
    their_us = theirs.pop("solver_step_us") if theirs else None
    log(f"[graph-nodes] one segment step without the DiT, device us: "
        f"{step_us}" + (f"; parent, same card: {their_us}" if their_us
                        else ""))
    for path in DIT_PATHS:
        mine = nodes[path]
        line = (f"[graph-nodes:{path}] kernel nodes of each replayed segment "
                f"graph {mine}, total {sum(mine.values())}")
        if theirs is None:
            log(line + "; parent: not measured (--parent DIR, a checkout "
                "of the parent commit)")
            continue
        k = NODES_SAVED_PER_STEP[path]
        steps = {key: ast.literal_eval(key)[1] for key in mine}
        want = {key: theirs[path].get(key, -1) - k * steps[key]
                for key in mine}
        ok = mine == want and set(theirs[path]) == set(mine)
        saved = sum(theirs[path].values()) - sum(mine.values())
        steps = sum(steps.values())
        log(line + f"; parent {theirs[path]}, total "
            f"{sum(theirs[path].values())}; parent - this = {saved}, "
            f"expected k x steps = {k} x {steps} = {k * steps} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"graph nodes {path}: {mine}, parent "
                            f"{theirs[path]}, want parent - {k} a step")


def _parent_segment_nodes(failures, parent):
    """``_segment_nodes`` of each DiT path served from ``parent``'s
    ``src/repro_torch`` (a child process, which builds that checkout's
    kernels there), or None after a failure."""
    import os
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--segment-nodes", str(parent)], env=env,
                       capture_output=True, text=True, timeout=900)
    log(f"[graph-nodes] parent {parent}: child exit {r.returncode} in "
        f"{time.perf_counter() - t0:.1f} s")
    if r.returncode:
        failures.append(f"graph nodes: the parent's child process exited "
                        f"{r.returncode}: {r.stderr[-2000:]}")
        return None
    return json.loads(r.stdout.strip().splitlines()[-1])


def segment_nodes_main(root: Path) -> int:
    """Child mode: serve one step of each DiT path at full width from
    ``root``'s package (set-up and routes as ``phase_end_to_end``) and print
    ``_segment_nodes`` of each, and ``_solver_step_us``, as JSON."""
    import torch
    sys.path.insert(0, str(root / "src"))
    import repro_torch
    if root.resolve() not in Path(repro_torch.__file__).resolve().parents:
        print(f"imported {repro_torch.__file__}, not {root}'s package",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    modules = _dit_setup(dev)[2]
    prompts = [p for pair in zip(*THEMES) for p in pair]
    out = {}
    for path in DIT_PATHS:
        engine = _engine(modules, path, dev)
        engine.submit(prompts)
        engine.step()
        out[path] = _segment_nodes(engine)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    out["solver_step_us"] = _solver_step_us()
    print(json.dumps(out))
    return 0


def _float_like(x, gen):
    """New values for a latent or a text-feature stack (ndim >= 3); index
    tensors, the mask, the null cond and the grid as they are."""
    import torch
    if x.is_floating_point() and x.ndim >= 3:
        return torch.randn(x.shape, device=x.device, generator=gen,
                           dtype=x.dtype)
    return x.clone()


def _runner_check(engine, path, failures):
    """Each segment runner of the served steps (its one graph, not a new
    capture) against a direct eager ``shared_phase`` / ``branch_phase``
    call on a copy of the same packed inputs: the served shapes and
    indices, new latents and text features.  The same kernels run on the
    same inputs, so the two should agree bitwise; the bar is 1e-3, the
    port's end-to-end latent tolerance.  A second replay on other inputs
    must leave the first result as it was.  Host-clock seconds (after a
    sync) and peak memory of the eager call and of a replay."""
    import torch
    from repro_torch.core import shared_sampling as ss
    from repro_torch.serving.kvcache import _map

    s = engine.scheduler
    dev = s.device
    gen = torch.Generator(device=dev).manual_seed(3)

    def eps_fn(z, t, c):
        return s.dit(z, t, c, cfg=s.cfg)

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, \
            torch.cuda.max_memory_allocated(dev)

    for key, run in list(s._runners.items()):
        phase, n, samplers = key[:3]
        sage, rs = s._runner_cfg(samplers)
        (static, *_), = run.graphs.values()
        a1, a2 = (_map(lambda x: _float_like(x, gen), static)
                  for _ in range(2))
        if phase == "shared":
            def eager(a):
                carry, cbar, null, grid = a
                return ss.shared_phase(eps_fn, s.sched, sage, carry, cbar,
                                       null, n, grid=grid, row_samplers=rs)
        else:
            def eager(a):
                carry, cond, mask, null, fork, grid = a
                return ss.branch_phase(eps_fn, s.sched, sage, carry, cond,
                                       mask, null, n, fork, grid=grid,
                                       row_samplers=rs)
        want, eager_s, eager_peak = timed(
            lambda: eager(_map(lambda x: x.clone(), a1)))
        got, replay_s, replay_peak = timed(lambda: run(*a1))
        kept = [x.clone() for x in got]
        run(*a2)
        intact = all(torch.equal(k, g) for k, g in zip(kept, got))
        bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
        ok = (err <= 1e-3 and intact and len(run.graphs) == 1
              and torch.equal(got.step_idx, want.step_idx))
        log(f"[runner:{path}] {key[:3]} rows={got.z.shape[0]} "
            f"{'bitwise equal' if bitwise else 'not bitwise'} to the eager "
            f"phase, max_abs_err={err:.3e} tol=1e-3; first result intact "
            f"after a second replay: {intact}; eager_s={eager_s:.4f} "
            f"replay_s={replay_s:.4f} eager_peak_gib="
            f"{eager_peak / 2 ** 30:.3f} replay_peak_gib="
            f"{replay_peak / 2 ** 30:.3f} graphs={len(run.graphs)} "
            f"capture_s={run.capture_s:.3f} replays={run.replays} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"runner {path} {key[:3]}: err {err:.3e}, "
                            f"intact {intact}, graphs {len(run.graphs)}")
        (_, graph, _, launches), = run.graphs.values()
        label = f"{path} {key[:3]} one replay"
        _trace_check(label, _profile(label, graph.replay, top=0), launches,
                     failures)


def _bf16_forward_check(dit, failures):
    """One full-width DiT forward on the CFG pair (batch 16) three ways: the
    bf16 model through the kernel (sm90 rounds P to bf16 before P V), the
    same bf16 model with plain attention, and plain attention in f32.  The
    kernel's mean error against f32 must be within 1.25x the plain bf16
    route's own, the bar tests/test_torch_models.py holds bf16 to."""
    import torch
    from repro_torch.config import replace
    cfg = dit.cfg
    dev = dit.pos.device
    gen = torch.Generator(device=dev).manual_seed(1)
    z = torch.randn((16, cfg.latent_size, cfg.latent_size,
                     cfg.latent_channels), device=dev, generator=gen)
    t = torch.randint(0, 1000, (16,), device=dev, generator=gen)
    cond = torch.randn((16, cfg.cond_len, cfg.cond_dim), device=dev,
                       generator=gen)
    eps = {}
    for impl, dtype in (("kernel", "bfloat16"), ("naive", "bfloat16"),
                        ("naive", "float32")):
        eps[impl, dtype] = dit(z, t, cond, cfg=replace(cfg, attn_impl=impl,
                                                       dtype=dtype))
    want = eps["naive", "float32"]
    err = {}
    for key in (("kernel", "bfloat16"), ("naive", "bfloat16")):
        diff = (eps[key] - want).abs()
        err[key] = (diff.mean().item(), diff.max().item())
    finite = all(bool(torch.isfinite(e).all()) for e in eps.values())
    kcfg = replace(cfg, attn_impl="kernel")
    _cast_check("sage-dit forward, CFG pair of 8, kernel route",
                dit._cast, lambda: dit(z, t, cond, cfg=kcfg), failures)
    ok = finite and (err["kernel", "bfloat16"][0]
                     <= 1.25 * err["naive", "bfloat16"][0])
    log(f"[check] sage-dit bf16 forward, CFG pair of 8, against f32: "
        f"kernel mean_abs_err={err['kernel', 'bfloat16'][0]:.4e} "
        f"max_abs_err={err['kernel', 'bfloat16'][1]:.4e}; naive bf16 "
        f"mean_abs_err={err['naive', 'bfloat16'][0]:.4e} max_abs_err="
        f"{err['naive', 'bfloat16'][1]:.4e} (|eps| mean "
        f"{want.abs().mean().item():.4f}); tol 1.25x naive "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"sage-dit bf16 forward: kernel mean error "
                        f"{err['kernel', 'bfloat16'][0]:.4e} > 1.25 x naive "
                        f"{err['naive', 'bfloat16'][0]:.4e} (finite="
                        f"{finite})")
    del eps, want
    torch.cuda.empty_cache()


def _cast_check(label, params, forward, failures):
    """``forward()`` with the weights cast once against the same forward
    with the copies hidden, each weight then cast per call: bitwise
    equal (the copy is ``w.to(dtype)``'s own bits)."""
    import torch
    with_copies = forward()
    hidden = [(p, p.__dict__.pop("_casts", None)) for p in params]
    try:
        without = forward()
    finally:
        for p, casts in hidden:
            if casts is not None:
                p.__dict__["_casts"] = casts
    same = torch.equal(with_copies, without)
    err = (with_copies.float() - without.float()).abs().max().item()
    log(f"[check] {label}: weights cast once vs cast per call "
        f"{'bitwise equal' if same else 'DIFFER'} max_abs_err={err:.3e} "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        failures.append(f"{label}: weights cast once differ from a cast per "
                        f"call by {err:.3e}")


def _profile_step(engine, prompts, path, failures):
    """The same step once more, its segments replayed, under
    torch.profiler (the counted runs above are untraced), the trace's
    launches of the port's kernels held to those the wrappers and the
    graph replays counted in that step (``_trace_check``)."""
    engine.submit(prompts)
    _reset_counts(_counters())
    rows = _profile(path, engine.step, ("ddim_step_kernel",
                                        "dpmpp_step_kernel",
                                        "group_mean_kernel"))
    counted = _summed(*_ran())
    _trace_check(path, rows, counted, failures)
    from repro_torch.serving.runners import KERNEL_SYMBOLS
    per = []
    for key in STEP_KERNELS:
        mine = [(u, n) for u, n, name in rows if KERNEL_SYMBOLS[key] in name]
        if counted[key] and mine:
            us, n = map(sum, zip(*mine))
            per.append(f"{key} {us / counted[key]:.4f} us a counted launch "
                       f"(x{counted[key]}; {us / n:.4f} us a traced one, "
                       f"x{n})")
    log(f"[profile:{path}] step kernels in the step, device time per "
        f"launch (traced total over the graphs' and wrappers' count): "
        f"{'; '.join(per)}")


def _trace_check(label, rows, counted, failures):
    """The profiler's launches of the port's kernels (by
    ``runners.KERNEL_SYMBOLS``) against ``counted`` (keyed as
    ``runners.launch_counts``): none beyond the count, and none missing
    from the trace where the count has some.  The profiler can lose a few
    records of a graph launch of tens of thousands of kernels, so the exact
    counts are the wrappers' and the graphs' kernel nodes; the trace's
    shortfall is printed."""
    from repro_torch.serving.runners import KERNEL_SYMBOLS
    traced = {key: sum(n for _, n, name in rows if sym in name)
              for key, sym in KERNEL_SYMBOLS.items()}
    want = {key: counted[key] for key in KERNEL_SYMBOLS}
    short = {k: want[k] - traced[k] for k in want if traced[k] != want[k]}
    ok = all(0 < traced[k] <= want[k] or traced[k] == want[k] == 0
             for k in want)
    log(f"[profile:{label}] the port's kernels in the trace {traced}, "
        f"counted {want}: "
        f"{'exact' if not short else f'short by {short}'} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"profile {label}: the trace launched {traced}, "
                        f"the counts say {want}")


def _profile(label, fn, highlight=(), top=10):
    """``fn()`` once under torch.profiler: device time by kernel, the
    ``top`` kernels and any ``highlight`` kernel wherever it ranks, and the
    device's busy share of the traced wall time.  Returns every kernel's
    (device microseconds, launches, name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))
    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"[profile:{label}] traced wall_s={wall:.3f} device_busy_s="
        f"{busy:.3f} busy_share={busy / wall:.3f} kernels={len(rows)}")
    for i, (us, n, key) in enumerate(rows):
        if i < top or any(k in key for k in highlight):
            log(f"[profile:{label}]   {us / 1e3:11.4f} ms "
                f"{us / 1e4 / busy:5.1f}% x{n:<6d} {key[:90]}")
    return rows


def _group_tokens(rng, vocab, groups, members, prefix, tail):
    """Each group's requests as examples/shared_prefill_llm.py builds them:
    one shared prefix repeated per member, then each member's own tail."""
    import numpy as np
    for _ in range(groups):
        shared = rng.randint(0, vocab, (1, prefix))
        yield np.concatenate([shared.repeat(members, 0),
                              rng.randint(0, vocab, (members, tail))], 1)


def _expected_steps(tokens):
    """P + N (S - P) against N S, with P the rows' common prefix found
    here with numpy alone (clamped to leave a token to catch up), as
    ``serving/shared_prefill.py:shared_prefix_prefill`` of the JAX package
    counts them."""
    import numpy as np
    N, S = tokens.shape
    differ = np.nonzero((tokens != tokens[:1]).any(axis=0))[0]
    P = max(1, min(int(differ[0]) if len(differ) else S, S - 1))
    ours = P + N * (S - P)
    return {"prefix_len": P, "token_steps": ours,
            "token_steps_naive": N * S, "saving": 1.0 - ours / (N * S)}


def _as_dtype(model, dtype):
    """The same weights run with other activations (``cfg.dtype``)."""
    from repro_torch.config import replace
    model.cfg = replace(model.cfg, dtype=dtype)
    return model


def phase_mamba2(failures):
    """The AR shared-prefix path at full mamba2-780m width (random weights
    from seed 0).  Launch counts are set to 0 just before the path's runs
    and read just after; the comparisons with independent prefills come
    after that.  Returns the path's launch counts."""
    import numpy as np
    import torch
    from repro_torch.config import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.kvcache import fork_model_cache
    from repro_torch.serving.runners import DecodeRunner
    from repro_torch.serving.shared_prefill import shared_prefix_prefill

    dev = torch.device("cuda:0")
    spec = PATHS["mamba2"]
    cfg = get_config(spec["arch"])
    gc.collect()                  # the DiT phases' modules, held in cycles
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    model = tfm.LM(cfg, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    s = cfg.ssm
    log(f"[e2e:mamba2] {cfg.name}: {cfg.n_layers} ssm layers d_model "
        f"{cfg.d_model} d_inner {s.expand * cfg.d_model} heads "
        f"{s.expand * cfg.d_model // s.head_dim} x {s.head_dim} d_state "
        f"{s.d_state} chunk {s.chunk} vocab {cfg.vocab} dtype {cfg.dtype}; "
        f"{n_params / 1e6:.1f} M params; set-up "
        f"{time.perf_counter() - t0:.2f} s; allocated before it "
        f"{held / 2 ** 30:.3f} GiB; weights cast once to {cfg.dtype}: "
        f"{model.cast_weights_() / 2 ** 20:.1f} MiB")
    _cast_check("mamba2-780m prefill 1 x 256", model._cast,
                lambda: tfm.prefill(model, np.arange(256)[None])[0],
                failures)
    per_prefill = cfg.n_layers            # one ssd_scan launch per layer
    counters = _counters()
    _reset_counts(counters)
    ssd = counters["ssd_scan"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    for shared in (False, True):
        before = ssd.launches
        r = serve(spec["arch"], batch=spec["batch"],
                  prompt_len=spec["prompt_len"], gen=spec["gen"],
                  shared_prefix=shared, device=dev, model=model)
        n = ssd.launches - before
        log(f"[e2e:mamba2] launcher shared_prefix={shared}: prefill_s="
            f"{r['prefill_s']:.4f} capture_s={r['capture_s']:.4f} (decode "
            f"graphs) decode_s={r['decode_s']:.4f} "
            f"decode_tok_s={r['decode_tok_s']:.1f} cache_mib="
            f"{r['cache_bytes'] / 2 ** 20:.2f} token_steps="
            f"{r['token_steps']} ssd_launches={n}")
        if n != per_prefill:
            failures.append(f"e2e mamba2 launcher: {n} ssd_scan launches "
                            f"for one prefill, not {per_prefill}")
        if (r["tokens"].shape != (spec["batch"], spec["gen"])
                or not torch.isfinite(r["logits"]).all()):
            failures.append("e2e mamba2 launcher: tokens of the wrong shape "
                            "or non-finite logits")

    rng = np.random.RandomState(0)
    prefix, tail = spec["prompt_len"], spec["tail"]
    groups = list(_group_tokens(rng, cfg.vocab, spec["groups"],
                                spec["members"], prefix, tail))
    max_len = prefix + tail + spec["gen"] + 8
    timing = {"prefill_s": 0.0, "catch_up_s": 0.0, "decode_s": 0.0,
              "eager_decode_s": 0.0}
    decode = DecodeRunner(model)

    def prefill_fn(t, m):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = tfm.prefill(model, t, max_len=m)
        torch.cuda.synchronize()
        timing["prefill_s"] += time.perf_counter() - t1
        return out

    def decode_fn(c, t, p):
        return tfm.decode_step(model, c, t, p)

    caught_up = []
    for g, tokens in enumerate(groups):
        before = ssd.launches
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, caches, pos, stats = shared_prefix_prefill(
            prefill_fn, decode_fn, tokens, max_len)
        torch.cuda.synchronize()
        timing["catch_up_s"] += time.perf_counter() - t1
        n = ssd.launches - before
        caught_up.append(logits.float())
        tok = logits.argmax(dim=-1)
        eager, eager_s = _decode_loop(
            lambda c, t, p: tfm.decode_step(model, c, t, p), caches, tok,
            pos, spec["gen"])
        decode.capture(caches, tok)
        (toks, logits), decode_s = _decode_loop(decode, caches, tok, pos,
                                                spec["gen"])
        timing["decode_s"] += decode_s
        timing["eager_decode_s"] += eager_s
        _decode_check(f"group {g}", (toks, logits), eager, failures)
        want = _expected_steps(tokens)
        log(f"[e2e:mamba2] group {g}: {tokens.shape[0]} x {tokens.shape[1]} "
            f"tokens, prefix_len={stats['prefix_len']} token_steps="
            f"{stats['token_steps']} naive={stats['token_steps_naive']} "
            f"saving={stats['saving']:.4f} (expected {want}) "
            f"ssd_launches={n} logits_finite="
            f"{bool(torch.isfinite(logits).all())}")
        if stats != want:
            failures.append(f"e2e mamba2 group {g}: counts {stats} != "
                            f"{want}")
        if n != per_prefill:
            failures.append(f"e2e mamba2 group {g}: {n} ssd_scan launches "
                            f"for one trunk prefill, not {per_prefill}")
        if not torch.isfinite(logits).all():
            failures.append(f"e2e mamba2 group {g}: non-finite logits")
    torch.cuda.synchronize()
    wrappers, replayed = _ran()
    launches = _summed(wrappers, replayed)
    peak = torch.cuda.max_memory_allocated(dev)
    n_groups, members = spec["groups"], spec["members"]
    dec_tok = n_groups * members * spec["gen"]
    log(f"[e2e:mamba2] shared_prefix_prefill over {n_groups} groups: trunk "
        f"prefill_s={timing['prefill_s']:.4f} (2 x 1 x {prefix}) "
        f"prefill+catch_up_s={timing['catch_up_s']:.4f} decode "
        f"{dec_tok} tokens replayed in {timing['decode_s']:.4f} s = "
        f"{dec_tok / timing['decode_s']:.1f} tok/s (decode graphs "
        f"capture_s={decode.capture_s:.4f}); eager "
        f"{timing['eager_decode_s']:.4f} s = "
        f"{dec_tok / timing['eager_decode_s']:.1f} tok/s")
    log(f"[e2e:mamba2] peak_mem_gib={peak / 2 ** 30:.3f} (of which held "
        f"before the path {held / 2 ** 30:.3f}) launches by the wrappers "
        f"{wrappers}; by graph replays (the decode graphs' kernel nodes) "
        f"{replayed}")
    _check_path_kernels("mamba2", launches, failures)
    if wrappers["ssd_scan"] != per_prefill * (2 + n_groups):
        failures.append(f"e2e mamba2: {wrappers['ssd_scan']} ssd_scan "
                        f"launches, not {per_prefill} x {2 + n_groups} "
                        f"prefill calls")
    if any(replayed.values()):
        failures.append(f"e2e mamba2: the decode graphs hold kernels of "
                        f"the port's: {replayed}")

    # lossless sharing: each group's forked-and-caught-up logits against
    # an independent prefill of the same tokens.  In bf16 the bound is
    # bf16's own error there: twice the independent prefill's largest
    # difference from the same prefill in f32 (dt and the projections are
    # rounded to 8 bits, and 48 random layers carry that far).  In f32 the
    # two must agree within 1e-3 of the logits' largest magnitude.
    for g, tokens in enumerate(groups):
        ind, _ = tfm.prefill(model, tokens)
        m32 = _as_dtype(model, "float32")
        ind32, _ = tfm.prefill(m32, tokens)
        sh32 = shared_prefix_prefill(
            lambda t, m: tfm.prefill(m32, t, max_len=m),
            lambda c, t, p: tfm.decode_step(m32, c, t, p), tokens,
            max_len)[0].float()
        _as_dtype(model, cfg.dtype)
        ind, ind32 = ind.float(), ind32.float()
        err = (caught_up[g] - ind).abs().max().item()
        noise = (ind - ind32).abs().max().item()
        err32 = (sh32 - ind32).abs().max().item()
        top = ind32.abs().max().item()
        ok = err <= 2 * noise and err32 <= 1e-3 * top
        log(f"[check] mamba2 shared vs independent logits, group {g}: bf16 "
            f"max_abs_err={err:.4e} (bf16 vs f32 {noise:.4e}, tol 2x); f32 "
            f"max_abs_err={err32:.4e} (tol 1e-3 x |logits| max {top:.3f}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"mamba2 group {g}: shared vs independent logits "
                            f"differ: bf16 {err:.3e} (2 x {noise:.3e}), f32 "
                            f"{err32:.3e} ({1e-3 * top:.3e})")
        del ind, ind32, sh32

    cached = _mamba2_cached_prefix(failures, model, groups, max_len)

    prompt = groups[0][:1, :prefix]
    _reset_counts(counters)
    rows = _profile("mamba2 trunk prefill 1x1024",
                    lambda: tfm.prefill(model, prompt), ("ssd_tc_kernel",))
    _trace_check("mamba2 trunk prefill", rows, _summed(*_ran()), failures)
    _, trunk = tfm.prefill(model, prompt)
    cache0 = fork_model_cache(trunk, members)
    tok0 = torch.zeros((members, 1), dtype=torch.long, device=dev)
    decode.capture(cache0, tok0)
    _reset_counts(counters)
    label = f"mamba2 decode {spec['gen']} steps x {members}, replayed"
    rows = _profile(label, lambda: _decode_loop(decode, cache0, tok0, prefix,
                                                spec["gen"]))
    _trace_check(label, rows, _summed(*_ran()), failures)
    del model, trunk, cache0, decode
    gc.collect()
    torch.cuda.empty_cache()
    return {"mamba2": (wrappers, replayed), "mamba2:cache": cached}


def _host_ms(fn, reps=3):
    """Host milliseconds of ``fn()`` between device syncs, the least of
    ``reps`` runs (for copies and CRCs on the host, which no graph can
    hold)."""
    import torch
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def _mamba2_cached_prefix(failures, model, groups, max_len):
    """``cached_prefix_prefill`` over the shared-prefix groups in the order
    g0, g1, g0, g1 through one ``TrunkCache`` whose budgets are one payload
    on the device and two on the host (a payload: the trunk prefill's
    logits and state cache, by ``cache_bytes``): miss, miss with a spill,
    then a host hit with its promotion (and a spill) twice.  A hit must
    launch no ``ssd_scan``, count only the tails' token steps, and give
    logits and caches bitwise those of the group's miss.  Printed: each
    call's wall with its prefill, lookup and insert milliseconds (each
    between device syncs), and the CRC, spill and promotion milliseconds
    of one payload.  Returns the run's launches (by the wrappers, by graph
    replays)."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.faults import _sorted_leaves, array_crc
    from repro_torch.serving.kvcache import cache_bytes
    from repro_torch.serving.shared_prefill import cached_prefix_prefill
    from repro_torch.serving.trunk_cache import (TrunkCache, _to_device,
                                                 _to_host)

    dev = model.device
    prefix = PATHS["mamba2"]["prompt_len"]
    payload = tfm.prefill(model, groups[0][:1, :prefix], max_len=max_len)
    one = cache_bytes(payload)
    cache = TrunkCache(tau_trunk=0.9, max_bytes=one, host_bytes=2 * one)
    cents = np.random.RandomState(3).randn(len(groups), 64)
    spent = {"prefill": 0.0, "lookup": 0.0, "insert": 0.0}

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return call
    cache.lookup = timed("lookup", cache.lookup)
    cache.insert = timed("insert", cache.insert)
    prefill = timed("prefill", lambda t, m: tfm.prefill(model, t, max_len=m))
    counters = _counters()
    ssd = counters["ssd_scan"]
    first, calls = {}, []
    _reset_counts(counters)
    for g in (0, 1, 0, 1):
        before, stats0 = ssd.launches, dict(cache.stats)
        spent0 = dict(spent)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches, _, st = cached_prefix_prefill(
            prefill, lambda c, t, p: tfm.decode_step(model, c, t, p),
            groups[g], max_len, cache=cache, centroid=cents[g])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = ssd.launches - before
        moved = {k: cache.stats[k] - stats0[k] for k in cache.stats
                 if cache.stats[k] != stats0[k]}
        hit = st["trunk_cache_hit"]
        same = ""
        if hit:
            f_logits, f_caches = first[g]
            same = torch.equal(logits, f_logits) and all(
                torch.equal(a, b) for a, b in zip(_sorted_leaves(caches),
                                                  _sorted_leaves(f_caches)))
            if not same:
                failures.append(f"mamba2 cached prefix group {g}: the hit's "
                                f"logits or caches differ from the miss's")
        else:
            first[g] = (logits, caches)
        want = (0 if hit else model.cfg.n_layers,
                _expected_steps(groups[g])["token_steps"]
                - (prefix if hit else 0))
        calls.append((hit, wall))
        ms = {k: round((spent[k] - spent0[k]) * 1e3, 3) for k in spent}
        log(f"[e2e:mamba2:cache] group {g}: hit={hit} wall_s={wall:.4f} "
            f"(of which ms {ms}; the rest the fork and the eager catch-up) "
            f"ssd_launches={n} token_steps={st['token_steps']} (expected "
            f"{want[1]}) cache {moved}"
            + (f"; logits and caches {'bitwise equal' if same else 'DIFFER'}"
               f" to the miss's" if hit else ""))
        if (n, st["token_steps"]) != want:
            failures.append(f"mamba2 cached prefix group {g}: {n} ssd_scan "
                            f"launches, {st['token_steps']} token steps; "
                            f"want {want}")
    wrappers, replayed = _ran()
    got = (cache.stats["misses"], cache.stats["hits_host"],
           cache.stats["spills"], cache.stats["promotions"])
    if got != (2, 2, 3, 2) or [h for h, _ in calls] != [False, False, True,
                                                        True]:
        failures.append(f"mamba2 cached prefix: misses / host hits / spills "
                        f"/ promotions {got}, want (2, 2, 3, 2)")
    _check_path_kernels("mamba2:cache", _summed(wrappers, replayed),
                        failures)
    crc_ms = _host_ms(lambda: array_crc(payload))
    host = _to_host(payload)
    spill_ms = _host_ms(lambda: _to_host(payload))
    promote_ms = _host_ms(lambda: _to_device(host, dev))
    miss = np.mean([w for h, w in calls if not h])
    hit = np.mean([w for h, w in calls if h])
    log(f"[e2e:mamba2:cache] payload {one / 2 ** 20:.2f} MiB ("
        f"{len(list(_sorted_leaves(payload)))} tensors); crc_ms="
        f"{crc_ms:.3f} spill_ms={spill_ms:.3f} promote_ms={promote_ms:.3f} "
        f"(host clock, least of 3); a call's wall: miss {miss:.4f} s, hit "
        f"{hit:.4f} s (hit/miss {hit / miss:.3f}: a hit skips the 1 x "
        f"{prefix} prefill and pays a CRC, a promotion and a spill)")
    del payload, host, cache, first
    return wrappers, replayed


def _decode_loop(step, cache, tok, pos, n):
    """``n`` greedy steps of ``step(cache, token, pos) -> (logits,
    cache)``: ((tokens (B, n), last logits), host seconds after a sync).
    Each step's token is a new tensor (argmax of the logits the step
    returned), so no entry aliases another."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = []
    for i in range(n):
        logits, cache = step(cache, tok, pos + i)
        tok = logits.argmax(dim=-1)
        out.append(tok)
    torch.cuda.synchronize()
    return (torch.cat(out, 1), logits), time.perf_counter() - t0


def _decode_check(label, got, want, failures):
    """The decode graphs' greedy tokens against the eager loop's, token for
    token; the last logits bitwise, or within two bf16 ulps (2^-6 of
    1 + |logits|, chip_smoke's bound for a flipped bf16 rounding)."""
    import torch
    (toks, logits), (etoks, elogits) = got, want
    same_toks = torch.equal(toks, etoks)
    bitwise = torch.equal(logits, elogits)
    diff = (logits.float() - elogits.float()).abs()
    err = diff.max().item()
    worst = (diff / (2.0 ** -6 * (1 + elogits.float().abs()))).max().item()
    ok = same_toks and worst <= 1.0
    log(f"[check] mamba2 decode graphs vs eager loop, {label}: tokens "
        f"{'equal' if same_toks else 'DIFFER'} ({toks.shape[0]} x "
        f"{toks.shape[1]}), last logits "
        f"{'bitwise equal' if bitwise else 'not bitwise'} "
        f"max_abs_err={err:.3e} worst={worst:.3f} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"mamba2 decode graphs {label}: tokens equal "
                        f"{same_toks}, logits worst {worst:.3f}")


def phase_reference(failures):
    """Each DiT path's engine at smoke size on the card (kernels) and on the
    CPU (plain versions), same weights and noise: equal groups, NFE and
    launch ledger, images within 1e-3 (f32; the first step divides by
    alpha_T ~ 1e-4, which magnifies last-bit differences on elements inside
    the x0 clip).  Then the mamba2 path the same way."""
    import numpy as np
    import torch
    from repro_torch.config import get_config, replace
    from repro_torch.models.text_encoder import text_cfg

    cfg = replace(get_config("sage-dit", smoke=True), dtype="float32")
    tc = replace(text_cfg(dim=cfg.cond_dim, layers=2), attn_impl="kernel")
    prompts = [p for pair in zip(*THEMES) for p in pair][:6]
    gpu_mods = _build_modules(cfg, tc, torch.device("cuda:0"),
                              torch.float32)
    cpu_mods = _build_modules(cfg, tc, torch.device("cpu"), torch.float32)
    for g, c in zip(gpu_mods, cpu_mods):
        c.load_state_dict(g.state_dict())
    for path in DIT_PATHS:
        gpu = _engine(gpu_mods, path, torch.device("cuda:0"))
        cpu = _engine(cpu_mods, path, torch.device("cpu"))
        out = []
        for eng in (gpu, cpu):
            eng.submit(prompts)
            out.append(eng.step())
        same = ([(c.prompt, c.group_id, c.nfe_share) for c in out[0]]
                == [(c.prompt, c.group_id, c.nfe_share) for c in out[1]]
                and gpu.stats == cpu.stats)
        err = max(float(np.abs(a.image - b.image).max())
                  for a, b in zip(*out))
        ok = same and all(np.allclose(a.image, b.image, rtol=1e-3,
                                      atol=1e-3) for a, b in zip(*out))
        log(f"[reference:{path}] smoke engine card vs cpu: groups/nfe/"
            f"launches {'equal' if same else 'DIFFER'} (nfe "
            f"{gpu.stats['nfe']:g}), image max_abs_err={err:.3e} tol=1e-3 "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"reference {path}: card vs cpu differ "
                            f"(same={same}, err={err:.3e})")
    for trace in STREAM_TRACES:
        out = []
        for mods, dev in ((gpu_mods, torch.device("cuda:0")),
                          (cpu_mods, torch.device("cpu"))):
            s = _stream_scheduler(mods, trace, dev)
            done, _ = drive_stream(s, trace, cfg.latent_size,
                                   cfg.latent_channels)
            out.append((stream_outcome(s, done, cfg.latent_size), done))
        (gpu, gdone), (cpu, cdone) = out
        fields = ("prompt", "group_id", "nfe_share", "latency", "status",
                  "cache_hit")
        same = (gpu == cpu == STREAM_EXPECTED[trace]
                and [[getattr(c, f) for f in fields] for c in gdone]
                == [[getattr(c, f) for f in fields] for c in cdone])
        pairs = [(a.image, b.image) for a, b in zip(gdone, cdone)
                 if a.image is not None and b.image is not None]
        err = max(float(np.abs(a - b).max()) for a, b in pairs)
        ok = same and all(np.allclose(a, b, rtol=1e-3, atol=1e-3)
                          for a, b in pairs)
        log(f"[reference:stream:{trace}] smoke streaming scheduler card vs "
            f"cpu: outcome and records {'equal' if same else 'DIFFER'} "
            f"(ticks {gpu['ticks']}, launches {gpu['launches']:g}, nfe "
            f"{gpu['nfe']:g}), image max_abs_err={err:.3e} tol=1e-3 "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"reference stream {trace}: card vs cpu differ "
                            f"(same={same}, err={err:.3e})")
        if "cache" in STREAM_TRACES[trace]:
            s = _stream_scheduler(gpu_mods, trace, torch.device("cuda:0"),
                                  trunk_cache=None)
            plain, _ = drive_stream(s, trace, cfg.latent_size,
                                    cfg.latent_channels)
            errs = _kept_groups_err(gdone, plain)
            ok = max(errs.values()) <= 1e-3
            log(f"[reference:stream:{trace}] the groups that computed "
                f"their own shared phase, cached pass vs a pass without a "
                f"cache on the card: max_abs_err by group {errs} tol=1e-3 "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"reference stream {trace}: a group's image "
                                f"moved with the cache elsewhere: {errs}")
    _reference_mamba2(failures)


def _reference_mamba2(failures):
    """The LM at mamba2-smoke in f32 on the card (kernel) and on the CPU
    (plain tiles), same weights: ``shared_prefix_prefill`` over one group
    (a 40-token prefix, ragged against the 32-token chunk, and 9-token
    tails) and the launcher's shared-prefix mode.  Counts and greedy tokens
    equal, logits within 1e-4 (the f32 tolerance of the JAX kernel sweep:
    the kernel sums in another order than the plain tiles)."""
    import numpy as np
    import torch
    from repro_torch.config import get_config, replace
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.shared_prefill import shared_prefix_prefill

    cfg = replace(get_config("mamba2-780m", smoke=True), dtype="float32")
    gpu = tfm.LM(cfg, device="cuda:0",
                 generator=torch.Generator(device="cuda:0").manual_seed(1))
    cpu = tfm.LM(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    tokens = next(_group_tokens(np.random.RandomState(1), cfg.vocab, 1, 3,
                                40, 9))
    out = []
    for model in (gpu, cpu):
        logits, _, _, stats = shared_prefix_prefill(
            lambda t, m: tfm.prefill(model, t, max_len=m),
            lambda c, t, p: tfm.decode_step(model, c, t, p), tokens, 64)
        r = serve("mamba2-780m", smoke=True, batch=3, prompt_len=40, gen=8,
                  shared_prefix=True, device=model.device, model=model)
        out.append((logits.cpu(), stats, r["logits"].cpu(), r["tokens"],
                    r["token_steps"]))
    (lg, st, rl, rt, rs), (lc, sc, rlc, rtc, rsc) = out
    same = st == sc and rs == rsc and np.array_equal(rt, rtc)
    err = max((lg - lc).abs().max().item(), (rl - rlc).abs().max().item())
    ok = same and err <= 1e-4 * (1 + max(lc.abs().max().item(),
                                         rlc.abs().max().item()))
    log(f"[reference:mamba2] smoke LM card vs cpu: counts/tokens "
        f"{'equal' if same else 'DIFFER'} ({st}), logits max_abs_err="
        f"{err:.3e} tol=1e-4 {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"reference mamba2: card vs cpu differ (same={same},"
                        f" err={err:.3e})")


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the parent commit: count its DiT "
                    "segment graphs' kernel nodes beside this tree's")
    ap.add_argument("--segment-nodes", type=Path, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name};"
              f" run it from a checkout of the repository", file=sys.stderr)
        return 2
    if args.segment_nodes is not None:
        return segment_nodes_main(args.segment_nodes)
    parent = args.parent.resolve() if args.parent else None
    if parent is not None and not (parent / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: --parent {parent} holds no src/repro_torch",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    global _SMI
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    _SMI = smi
    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {smi}")

    failures = []
    t0 = time.perf_counter()
    phase_build(failures)
    t1 = time.perf_counter()
    rows = phase_kernels(failures)
    t2 = time.perf_counter()
    launches, nodes, dit = phase_end_to_end(failures)
    t3 = time.perf_counter()
    launches.update(phase_stream(failures, *dit))
    del dit
    gc.collect()
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    phase_example(failures)
    t4e = time.perf_counter()
    launches.update(phase_mamba2(failures))
    t5 = time.perf_counter()
    phase_reference(failures)
    t6 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    phase_graph_nodes(failures, nodes, parent)
    t7 = time.perf_counter()
    log(f"[time] build {t1 - t0:.1f} s, kernels {t2 - t1:.1f} s, "
        f"e2e DiT {t3 - t2:.1f} s, stream {t4 - t3:.1f} s, example "
        f"{t4e - t4:.1f} s, e2e mamba2 {t5 - t4e:.1f} s, reference "
        f"{t6 - t5:.1f} s, graph nodes {t7 - t6:.1f} s")
    if failures:
        for f in failures:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    kernels = []
    for name in KERNELS:
        row = rows[name]
        row["launches"] = sum(w[name] + r[name] for w, r in launches.values())
        row["launches_by_path"] = {path: w[name] + r[name]
                                   for path, (w, r) in launches.items()}
        row["graph_replay_launches_by_path"] = {
            path: r[name] for path, (w, r) in launches.items()}
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
