"""Kernel backend dispatch — one switch between the plain PyTorch math,
the chunked online-softmax loop and the hand-written CUDA kernels
(attention, the fused CFG+DDIM and CFG+DPM-Solver++(2M) steps, the masked
group mean, the Mamba2 SSD scan).

Routing follows the TENSOR's device, never what is installed: on a CUDA
tensor the ``kernel`` / ``fused`` routes launch the kernel or raise; on a
CPU tensor they run the kernel's plain version (``ref.py``).  The only
shapes the flash kernel does not take — ``head_dim > 256`` and
non-causal sliding windows — go to the chunked loop, as in the JAX
package.

Dispatch attribution: every route decision of ``attention``,
``cfg_ddim_step``, ``cfg_dpmpp_step`` and ``group_mean`` can be recorded in
the module-level :data:`DISPATCH_LOG` — (op, impl requested, impl chosen,
fallback reason, shape bucket) -> count — under the JAX package's op
names, reasons and shape buckets (its ``"pallas"`` is the port's
``"kernel"``).  Off by default: one ``if`` a dispatch.  The JAX log records
once per trace; this one at every Python-level dispatch, so an eager call,
a CUDA graph's warm-up and its capture each record once and a replay,
which runs no Python, records nothing: a kernel op's count over a pass is
its wrapper's launches outside the replays.  ``ssd`` records nothing (the
JAX log has no such op).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.kernels.ddim_step.ops import fused_cfg_ddim_step
from repro_torch.kernels.ddim_step.ref import fused_cfg_ddim_step_ref
from repro_torch.kernels.dpmpp_step.ops import fused_cfg_dpmpp_step
from repro_torch.kernels.dpmpp_step.ref import fused_cfg_dpmpp_step_ref
from repro_torch.kernels.flash_attention.ops import (MAX_HEAD_DIM,
                                                     flash_attention)
from repro_torch.kernels.group_mean.ops import masked_group_mean
from repro_torch.kernels.group_mean.ref import masked_group_mean_ref
from repro_torch.kernels.ssd_scan.ops import ssd_chunked_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref
from repro_torch.models.layers import attend, attend_chunked, causal_mask

ATTN_IMPLS = ("naive", "chunked", "kernel")
STEP_IMPLS = ("reference", "fused")
GROUP_MEAN_IMPLS = ("reference", "kernel")
SSD_IMPLS = ("kernel", "reference")


class DispatchLog:
    """Route-decision counter for kernel dispatch attribution.

    Keyed by ``(op, requested, chosen, reason, shape)``; ``reason`` is
    ``"requested"`` when the chosen impl is what the caller asked for,
    else the fallback's cause (``"head_dim>256"``,
    ``"noncausal_window"``).  Disabled by default, so the hot path pays
    one ``if`` a dispatch."""

    __slots__ = ("enabled", "routes")

    def __init__(self) -> None:
        self.enabled = False
        self.routes: Dict[Tuple[str, str, str, str, str], int] = {}

    def record(self, op: str, requested: str, chosen: str, reason: str,
               shape: str) -> None:
        key = (op, requested, chosen, reason, shape)
        self.routes[key] = self.routes.get(key, 0) + 1

    def reset(self) -> None:
        self.routes.clear()

    def snapshot(self) -> List[Dict[str, object]]:
        """Rows sorted for stable output: one dict per distinct route."""
        return [
            {"op": op, "requested": req, "chosen": chosen,
             "reason": reason, "shape": shape, "count": n}
            for (op, req, chosen, reason, shape), n
            in sorted(self.routes.items())]

    def fallbacks(self) -> List[Dict[str, object]]:
        """Only the routes where chosen != requested: the live fallback
        matrix."""
        return [r for r in self.snapshot() if r["reason"] != "requested"]

    def prometheus_samples(self) -> Iterable[
            Tuple[str, Dict[str, str], float, str]]:
        """(name, labels, value, kind) tuples for
        ``MetricsRegistry.collector``."""
        for (op, req, chosen, reason, shape), n in sorted(
                self.routes.items()):
            yield ("kernel_dispatch",
                   {"op": op, "requested": req, "chosen": chosen,
                    "reason": reason, "shape": shape}, float(n), "counter")


#: process-wide log; enable with ``DISPATCH_LOG.enabled = True``
DISPATCH_LOG = DispatchLog()


def _attn_shape_bucket(q: torch.Tensor, k: torch.Tensor) -> str:
    B, Sq, H, hd = q.shape
    return f"b{B}s{Sq}x{k.shape[1]}h{H}d{hd}"


def _shape(x: torch.Tensor) -> str:
    return "x".join(str(d) for d in x.shape)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              impl: str = "naive", causal: bool = False, window: int = 0,
              block: int = 1024,
              scale: Optional[float] = None) -> torch.Tensor:
    """Backend-dispatched attention.  q (B,Sq,H,hd), k/v (B,Sk,Hkv,hd)."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn impl {impl!r}; one of {ATTN_IMPLS}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    log = DISPATCH_LOG
    if (impl == "kernel" and q.shape[-1] <= MAX_HEAD_DIM
            and (window == 0 or causal)):
        if log.enabled:
            log.record("attention", impl, "kernel", "requested",
                       _attn_shape_bucket(q, k))
        return flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)
    if impl in ("chunked", "kernel"):
        # kernel lands here only for head_dim > 256 / non-causal window
        if log.enabled:
            reason = "requested"
            if impl == "kernel":
                reason = ("head_dim>256" if q.shape[-1] > MAX_HEAD_DIM
                          else "noncausal_window")
            log.record("attention", impl, "chunked", reason,
                       _attn_shape_bucket(q, k))
        return attend_chunked(q, k, v, causal=causal, window=window,
                              scale=scale, block=block)
    if log.enabled:
        log.record("attention", impl, "naive", "requested",
                   _attn_shape_bucket(q, k))
    if causal:
        mask = causal_mask(q.shape[1], k.shape[1], window=window,
                           device=q.device)
    elif window:
        qi = torch.arange(q.shape[1], device=q.device)[:, None]
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = (ki > qi - window)[None, None, None]
    else:
        mask = None
    return attend(q, k, v, mask, scale)


def cfg_ddim_step(z: torch.Tensor, eps_u: torch.Tensor, eps_c: torch.Tensor,
                  *, guidance, alphas, sigmas, t, t_next,
                  clip_x0: float = 0.0,
                  impl: str = "reference") -> torch.Tensor:
    """CFG combine + DDIM update at timesteps ``t`` -> ``t_next`` of the
    schedule's ``alphas`` / ``sigmas`` tables: the fused kernel (one pass:
    3 reads, 1 write, its own schedule gathers) or the reference math."""
    if impl not in STEP_IMPLS:
        raise ValueError(f"unknown step impl {impl!r}; one of {STEP_IMPLS}")
    if DISPATCH_LOG.enabled:
        DISPATCH_LOG.record("cfg_ddim_step", impl, impl, "requested",
                            _shape(z))
    step = fused_cfg_ddim_step if impl == "fused" \
        else fused_cfg_ddim_step_ref
    return step(z, eps_u, eps_c, guidance, alphas, sigmas, t, t_next,
                clip_x0=clip_x0)


def cfg_dpmpp_step(z: torch.Tensor, eps_u: torch.Tensor,
                   eps_c: torch.Tensor, eps_prev: torch.Tensor, *, guidance,
                   a_t, s_t, a_n, s_n, lam, lam_p, lam_n, is_first,
                   clip_x0: float = 0.0, impl: str = "reference"):
    """CFG combine + DPM-Solver++(2M) update -> ``(z_next, eps_combined)``:
    the fused kernel (one pass: 4 reads, 2 writes) or the reference math.
    Scalars come from ``samplers.dpmpp_scalars``; ``is_first`` flags the
    history warm-up step (the first step and the branch fork)."""
    if impl not in STEP_IMPLS:
        raise ValueError(f"unknown step impl {impl!r}; one of {STEP_IMPLS}")
    if DISPATCH_LOG.enabled:
        DISPATCH_LOG.record("cfg_dpmpp_step", impl, impl, "requested",
                            _shape(z))
    step = fused_cfg_dpmpp_step if impl == "fused" \
        else fused_cfg_dpmpp_step_ref
    return step(z, eps_u, eps_c, eps_prev, guidance, a_t, s_t, a_n, s_n,
                lam, lam_p, lam_n, is_first, clip_x0=clip_x0)


def group_mean(x: torch.Tensor, mask: torch.Tensor, *,
               impl: str = "reference") -> torch.Tensor:
    """Masked mean over the member axis: x (K, N, ...), mask (K, N).
    ``"kernel"`` is the JAX package's ``"pallas"`` route."""
    if impl not in GROUP_MEAN_IMPLS:
        raise ValueError(f"unknown group_mean impl {impl!r}; one of "
                         f"{GROUP_MEAN_IMPLS}")
    if DISPATCH_LOG.enabled:
        DISPATCH_LOG.record("group_mean", impl, impl, "requested",
                            _shape(x))
    if impl == "kernel":
        return masked_group_mean(x, mask)
    return masked_group_mean_ref(x, mask)


def ssd(x: torch.Tensor, dA: torch.Tensor, B_: torch.Tensor,
        C_: torch.Tensor, chunk: int,
        init_state: Optional[torch.Tensor] = None, *, impl: str = "kernel"):
    """The Mamba2 SSD scan (``models.ssm.ssd_chunked``'s contract).
    ``"kernel"``: on a CUDA tensor the intra-chunk kernel, launched or
    raising; on a CPU tensor its plain tile.  ``"reference"``: the plain
    scan (``ssd_chunked_ref``) on any device, the differentiable route:
    the kernel has no backward, and the JAX model differentiates its jnp
    scan, never the Pallas tile.  The JAX config has no switch for it:
    the caller picks the route, ``forward_train`` when autograd records."""
    if impl not in SSD_IMPLS:
        raise ValueError(f"unknown ssd impl {impl!r}; one of {SSD_IMPLS}")
    scan = ssd_chunked_kernel if impl == "kernel" else ssd_chunked_ref
    return scan(x, dA, B_, C_, chunk, init_state)
