#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout.  Four phases; any failure exits non-zero
without the result line:

1. build — compile the CUDA kernels under ``src/repro_torch/csrc`` with
   nvcc for sm_90a (``repro_torch.kernels._build``) and print ptxas's
   register / spill report;
2. kernel vs plain — every kernel of the serving path against its plain
   PyTorch version (``ref.py``) on the card at the main path's shapes, in
   f32 and bf16, each error beside its tolerance, with the kernel's, the
   plain version's and (for attention) the library's time;
3. end to end — for each serving path (``PATHS``: 30 DDIM steps, and 30
   DPM-Solver++(2M) steps with the shared-uncond CFG), one
   ``SageServingEngine.step()`` at the full ``sage-dit`` width (28
   layers, d_model 1152, 16 heads of 72, 1024 tokens, cond 77x768; text
   tower dim 768, 4 layers; VAE to 512x512x3 in bf16; the same weights
   for both) over 8 prompts from 2 themes, group_size 4, on the kernel
   routes, with every launch count set to 0 just before and read just
   after; every image must be finite, every kernel of the path launched
   and no kernel off it.  Each step then runs once more under
   ``torch.profiler`` for device time by kernel and the busy share;
4. reference — each path's engine at smoke size on the card against the
   plain CPU path: equal groups, NFE and launches, images within
   tolerance.

The line before the last is ``nvidia-smi``'s name and power limit; the
last line is ``{"ok": true, "device": {...}}``.  The port never calls
``F.scaled_dot_product_attention``: it is timed here only as a yardstick.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12,    # f32 outside the tensor cores
              "bfloat16": 989e12}  # dense bf16 tensor cores
# tests/test_kernels.py: step kernels 1e-5 / 3e-2 (f32 / bf16); flash
# attention 2e-4 / 4e-2.  Both flash paths accumulate in f32, so f32 differs
# by summation order only; in bf16 the output is rounded once to 8 bits of
# mantissa (one ulp of |o| <= 4 is 1.6e-2).
# group mean: f32 sums of 4 products in another order than torch's
# reduction differ by a few ulp (~1e-6 here); in bf16 such a last-bit
# difference can flip the one rounding of the output by one bf16 ulp, at
# most 2^-7 of |out|.
TOL = {("ddim_step", "float32"): 1e-5, ("ddim_step", "bfloat16"): 3e-2,
       ("dpmpp_step", "float32"): 1e-5, ("dpmpp_step", "bfloat16"): 3e-2,
       ("group_mean", "float32"): 1e-5, ("group_mean", "bfloat16"): 1e-2,
       ("flash_attention", "float32"): 2e-4,
       ("flash_attention", "bfloat16"): 4e-2}

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


def phase_build():
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
    _build.load_library()


def _check(failures, kernel, case, dtype, got, want, extra):
    """allclose(rtol=tol, atol=tol): |kernel - plain| <= tol * (1 + |plain|)
    everywhere; ``worst`` is the largest ratio of the two sides (<= 1)."""
    tol = TOL[(kernel, dtype)]
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    worst = (diff / (tol * (1 + want.float().abs()))).max().item()
    ok = worst <= 1.0
    log(f"[check] {kernel:15s} {case:34s} {dtype:8s} max_abs_err={err:.3e} "
        f"tol={tol:g} worst={worst:.3f} {'ok' if ok else 'FAIL'} {extra}")
    if not ok:
        failures.append(f"{kernel} {case} {dtype}: worst {worst:.3f} > 1")
    return err


def _kernel_row(name, shape, err, ms, plain, bound, bound_by, library_ms):
    file = {"ddim_step": "ddim_step/ddim_step.py:39",
            "dpmpp_step": "dpmpp_step/dpmpp_step.py:53",
            "group_mean": "group_mean/group_mean.py:21",
            "flash_attention": "flash_attention/flash_attention.py:53"}[name]
    return dict(name=name, route="cuda",
                source=f"src/repro_torch/csrc/{name}.cu",
                replaces=f"src/repro/kernels/{file}", shape=shape,
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=bound_by, library_ms=library_ms)


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


def phase_kernels(failures):
    """Each kernel against its plain version at the main path's shapes.
    Returns the headline row per kernel for the result JSON."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import samplers
    from repro_torch.core.schedule import make_schedule
    from repro_torch.kernels.ddim_step.ops import fused_cfg_ddim_step
    from repro_torch.kernels.ddim_step.ref import fused_cfg_ddim_step_ref
    from repro_torch.kernels.dpmpp_step.ops import fused_cfg_dpmpp_step
    from repro_torch.kernels.dpmpp_step.ref import fused_cfg_dpmpp_step_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.group_mean.ops import masked_group_mean
    from repro_torch.kernels.group_mean.ref import masked_group_mean_ref

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    sched = make_schedule(1000, device=dev)
    rows = {}

    # ddim_step: branch-phase stack of run_batch (2 groups x width 4 rows of
    # 64x64x4 latents) and its shared-phase stack (2 trunks), per-row
    # scalars from the real 30-step grid; and the broadcast launch of
    # shared_sample
    cases = [("rows", (8, 64, 64, 4)), ("2d", (8, 64, 64, 4)),
             ("rows", (2, 64, 64, 4))]      # the shared phase's 2 trunks
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for launch, shape, (z, eu, ec, _), t, tn, _, _ in _step_cases(
                dev, gen, dtype, cases):
            sc = samplers.ddim_scalars(sched, t, tn)
            for clip in (3.0, 0.0):
                args = (z, eu, ec, 7.5, *sc)
                got = fused_cfg_ddim_step(*args, clip_x0=clip)
                want = fused_cfg_ddim_step_ref(*args, clip_x0=clip)
                ms = time_ms(lambda: fused_cfg_ddim_step(*args,
                                                         clip_x0=clip), 200)
                plain = time_ms(lambda: fused_cfg_ddim_step_ref(
                    *args, clip_x0=clip), 50)
                nbytes = 4 * z.numel() * z.element_size()
                bound = max(nbytes / HBM_BYTES_PER_S,
                            10 * z.numel() / PEAK_FLOPS["float32"]) * 1e3
                case = f"{launch} {tuple(shape)} clip={clip:g}"
                err = _check(failures, "ddim_step", case, dn, got, want,
                             f"ms={ms:.6g} plain_ms={plain:.6g} "
                             f"bound_ms={bound:.6g}")
                if ((launch, shape, clip, dtype)
                        == ("rows", (8, 64, 64, 4), 3.0, torch.float32)):
                    rows["ddim_step"] = _kernel_row(
                        "ddim_step", f"{case} f32", err, ms, plain, bound,
                        "bytes", None)

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

    # flash_attention: the DiT branch phase runs the CFG pair of 8 member
    # rows (batch 16) through self-attention (1024 tokens, 16 heads of 72)
    # and cross-attention (77 cond tokens); the text tower runs 8 prompts
    # causally (77 tokens, 4 heads of 192); plus a GQA + sliding-window case
    cases = [
        ("dit_self 16x1024x1024 h16 d72", 16, 1024, 1024, 16, 16, 72,
         False, 0),
        ("dit_cross 16x1024x77 h16 d72", 16, 1024, 77, 16, 16, 72, False, 0),
        # the DPM path's branch phase with the shared-uncond CFG: 2 group
        # rows + 8 member rows
        ("dit_self 10x1024x1024 h16 d72", 10, 1024, 1024, 16, 16, 72, False,
         0),
        ("dit_cross 10x1024x77 h16 d72", 10, 1024, 77, 16, 16, 72, False, 0),
        # the shared phase: the CFG pair of 2 group trunks
        ("dit_self 4x1024x1024 h16 d72", 4, 1024, 1024, 16, 16, 72, False, 0),
        ("dit_cross 4x1024x77 h16 d72", 4, 1024, 77, 16, 16, 72, False, 0),
        ("text_causal 8x77x77 h4 d192", 8, 77, 77, 4, 4, 192, True, 0),
        ("gqa_window 2x1024 h16/4 d72 w256", 2, 1024, 1024, 16, 4, 72,
         True, 256),
    ]
    for (case, B, Sq, Sk, H, Hkv, D, causal, window) in cases:
        scale = 1.0 / math.sqrt(D)
        qi = torch.arange(Sq, device=dev)[:, None]
        ki = torch.arange(Sk, device=dev)[None, :]
        visible = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
        if causal:
            visible &= ki <= qi
        if window:
            visible &= ki > qi - window
        pairs = int(visible.sum())
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
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
            t_ops = flops / PEAK_FLOPS[dn]
            t_bytes = nbytes / HBM_BYTES_PER_S
            bound = max(t_ops, t_bytes) * 1e3
            err = _check(failures, "flash_attention", case, dn, got, want,
                         f"ms={ms:.6g} plain_ms={plain:.6g} "
                         f"library_ms={lib_ms:.6g} bound_ms={bound:.6g}")
            if case.startswith("dit_self 16x") and dtype == torch.bfloat16:
                rows["flash_attention"] = _kernel_row(
                    "flash_attention", f"{case} bf16", err, ms, plain, bound,
                    "operations" if t_ops >= t_bytes else "bytes", lib_ms)
            del q, k, v, got, want
    torch.cuda.empty_cache()
    return rows


def _randomize_zero_init(module, gen):
    """adaLN-zero gates, lnx and the q/k/rms norms start at zero, which
    would switch whole branches of the DiT off: give them seeded values."""
    import torch
    with torch.no_grad():
        for p in module.parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=gen)


# the two serving paths: slice 1's DDIM path and DPM-Solver++(2M) with the
# shared-uncond CFG (one uncond row per group in the branch phase)
PATHS = {"ddim": dict(total_steps=30),
         "dpmpp": dict(total_steps=30, sampler="dpmpp",
                       shared_uncond_cfg=True)}
# kernels each path must launch; "never" must stay at 0 launches
PATH_KERNELS = {"ddim": dict(needs=("flash_attention", "ddim_step"),
                             never=("dpmpp_step", "group_mean")),
                "dpmpp": dict(needs=("flash_attention", "dpmpp_step",
                                     "group_mean"), never=("ddim_step",))}


def _counters():
    """Each kernel wrapper, whose ``launches`` counts its kernel launches."""
    from repro_torch.kernels.ddim_step.ops import fused_cfg_ddim_step
    from repro_torch.kernels.dpmpp_step.ops import fused_cfg_dpmpp_step
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.group_mean.ops import masked_group_mean
    return {"flash_attention": flash_attention,
            "ddim_step": fused_cfg_ddim_step,
            "dpmpp_step": fused_cfg_dpmpp_step,
            "group_mean": masked_group_mean}


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


def _serve(engine, prompts, path, failures):
    """One counted ``step()`` of ``path``: every launch count set to 0
    just before, read just after.  Returns the counts."""
    import numpy as np
    import torch

    dev = torch.device("cuda:0")
    engine.submit(prompts)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    done = engine.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)

    st = engine.stats
    groups = {}
    for c in done:
        groups.setdefault(c.group_id, []).append(prompts.index(c.prompt))
    log(f"[e2e:{path}] {PATHS[path]} requests={st['requests']} "
        f"completed={len(done)} groups={sorted(groups.values())}")
    log(f"[e2e:{path}] nfe={st['nfe']:g} nfe_independent="
        f"{st['nfe_independent']:g} cost_saving={engine.cost_saving:.4f} "
        f"segment_launches={st['launches']} pack_rows={st['pack_rows']} "
        f"pack_pad_rows={st['pack_pad_rows']}")
    log(f"[e2e:{path}] wall_s={wall:.3f} peak_mem_gib={peak / 2 ** 30:.3f} "
        f"kernel_launches={launches}")
    if len(done) != len(prompts):
        failures.append(f"e2e {path}: {len(done)} completions for "
                        f"{len(prompts)} prompts")
    for c in done:
        if c.image.shape != (512, 512, 3) or not np.isfinite(c.image).all():
            failures.append(f"e2e {path}: image of {c.prompt!r} has shape "
                            f"{c.image.shape} or non-finite values")
    for name in PATH_KERNELS[path]["needs"]:
        if launches[name] <= 0:
            failures.append(f"e2e {path}: kernel {name} never launched")
    for name in PATH_KERNELS[path]["never"]:
        if launches[name]:
            failures.append(f"e2e {path}: kernel {name} launched "
                            f"{launches[name]} times off its path")
    return launches


def phase_end_to_end(failures):
    """One engine step per serving path at full sage-dit width on the kernel
    routes, the same weights for both.  Returns each path's launch counts."""
    import torch
    from repro_torch.config import get_config, replace
    from repro_torch.models.text_encoder import text_cfg

    dev = torch.device("cuda:0")
    cfg = get_config("sage-dit")
    tc = replace(text_cfg(dim=768, layers=4), attn_impl="kernel")
    t0 = time.perf_counter()
    modules = _build_modules(cfg, tc, dev, torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in modules[0].parameters())
    log(f"[e2e] {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model} "
        f"{cfg.n_heads} heads x {cfg.hd}, latent {cfg.latent_size}^2x"
        f"{cfg.latent_channels} -> {(cfg.latent_size // cfg.patch) ** 2} "
        f"tokens, cond {cfg.cond_len}x{cfg.cond_dim}, dtype {cfg.dtype}; "
        f"DiT {n_params / 1e6:.1f} M params; text tower dim {tc.d_model} x "
        f"{tc.n_layers}; set-up {time.perf_counter() - t0:.2f} s")
    prompts = [p for pair in zip(*THEMES) for p in pair]
    launches = {}
    for path in PATHS:
        engine = _engine(modules, path, dev)
        launches[path] = _serve(engine, prompts, path, failures)
        _profile_step(engine, prompts, path)
    return launches


def _profile_step(engine, prompts, path):
    """The same step once more under torch.profiler: device time by kernel
    and the device's busy share of the step (the counted run above is
    untraced)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.submit(prompts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))
    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"[profile:{path}] traced step wall_s={wall:.3f} device_busy_s="
        f"{busy:.3f} busy_share={busy / wall:.3f} kernels={len(rows)}")
    for us, n, key in rows[:10]:
        log(f"[profile:{path}]   {us / 1e3:10.2f} ms {us / 1e4 / busy:5.1f}% "
            f"x{n:<6d} {key[:90]}")
    for us, n, key in rows[10:]:      # the step kernels, wherever they rank
        if any(k in key for k in ("ddim_step_kernel", "dpmpp_step_kernel",
                                  "group_mean_kernel")):
            log(f"[profile:{path}]   {us / 1e3:10.2f} ms "
                f"{us / 1e4 / busy:5.1f}% x{n:<6d} {key[:90]}")


def phase_reference(failures):
    """Each path's engine at smoke size on the card (kernels) and on the CPU
    (plain versions), same weights and noise: equal groups, NFE and launch
    ledger, images within 1e-3 (f32; the first step divides by alpha_T ~
    1e-4, which magnifies last-bit differences on elements inside the x0
    clip)."""
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
    for path in PATHS:
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name};"
              f" run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {smi}")

    failures = []
    t0 = time.perf_counter()
    phase_build()
    t1 = time.perf_counter()
    rows = phase_kernels(failures)
    t2 = time.perf_counter()
    launches = phase_end_to_end(failures)
    t3 = time.perf_counter()
    phase_reference(failures)
    t4 = time.perf_counter()
    log(f"[time] build {t1 - t0:.1f} s, kernels {t2 - t1:.1f} s, "
        f"e2e {t3 - t2:.1f} s, reference {t4 - t3:.1f} s")
    if failures:
        for f in failures:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    kernels = []
    for name in ("flash_attention", "ddim_step", "dpmpp_step", "group_mean"):
        row = rows[name]
        row["launches"] = sum(n[name] for n in launches.values())
        row["launches_by_path"] = {path: n[name]
                                   for path, n in launches.items()}
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
