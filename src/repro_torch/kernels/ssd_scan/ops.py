"""Public wrapper of the SSD intra-chunk kernel (``csrc/ssd_scan.cu``):
the full Mamba2 SSD scan assembled around it.

The kernel computes each chunk's diagonal block of y and its state on
the tensor cores, f32-accurate (3xTF32 on f32 inputs; one and two passes
on bf16 ones), forming C·Bᵀ once per (batch, chunk) for a block of heads,
since B and C are shared by the heads; the cheap, sequential inter-chunk
recurrence and the off-diagonal term stay in plain torch, as the JAX
wrapper keeps them in jnp.  Unlike the JAX wrapper this one keeps the
whole contract of ``models.ssm.ssd_chunked``, which the model calls
through it: a ragged tail is padded (zero inputs, dA = 0) and an initial
state enters the recurrence.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
tiles (``ssd_tiles_ref``) in the kernel's place, with the rest of the
wrapper unchanged.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ddim_step.ops import DTYPES
from repro_torch.kernels.ssd_scan.ref import cumsum_f32, ssd_tiles_ref

MAX_CHUNK = MAX_HEAD_DIM = MAX_STATE = 128   # the kernel's tile limits


def ssd_intra_chunk(x: torch.Tensor, dA: torch.Tensor, B_: torch.Tensor,
                    C_: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on every (b, c, h) tile of a sequence whose length is a
    multiple of ``chunk`` (one launch): x (b,l,h,p), dA (b,l,h), B_/C_
    (b,l,n) -> y_diag (b,l,h,p) f32 and chunk states (b,c,h,p,n) f32.  On a
    CPU tensor: ``ssd_tiles_ref``."""
    b, l, h, p = x.shape
    n = B_.shape[-1]
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the "
                         f"chunk {chunk}: pad it (ssd_chunked_kernel does)")
    if (tuple(dA.shape) != (b, l, h) or tuple(B_.shape) != (b, l, n)
            or tuple(C_.shape) != (b, l, n)):
        raise ValueError(f"ssd shapes disagree: x {tuple(x.shape)}, dA "
                         f"{tuple(dA.shape)}, B {tuple(B_.shape)}, C "
                         f"{tuple(C_.shape)}")
    if any(t.device != x.device for t in (dA, B_, C_)):
        raise ValueError("x, dA, B and C must lie on one device")
    c, Q = l // chunk, chunk
    _build.forbid_grad("ssd_intra_chunk", x, dA, B_, C_)
    if x.device.type == "cpu":
        return ssd_tiles_ref(x, dA, B_, C_, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no ssd_scan kernel for device {x.device}")
    if x.dtype not in DTYPES or B_.dtype != x.dtype or C_.dtype != x.dtype:
        raise TypeError(f"ssd_scan kernel takes x, B, C all float32 or all "
                        f"bfloat16, got {x.dtype}, {B_.dtype}, {C_.dtype}")
    if Q > MAX_CHUNK or p > MAX_HEAD_DIM or n > MAX_STATE or n % 4:
        raise ValueError(f"ssd_scan kernel takes chunk, head_dim and d_state "
                         f"up to 128, d_state a multiple of 4; got {Q}, {p}, "
                         f"{n}")
    x, B_, C_ = (t.contiguous() for t in (x, B_, C_))
    dA = dA.to(torch.float32).contiguous()
    y = torch.empty((b, l, h, p), dtype=torch.float32, device=x.device)
    states = torch.empty((b, c, h, p, n), dtype=torch.float32,
                         device=x.device)
    lib = _build.load_library()
    rc = lib.sage_ssd_intra_chunk(
        x.data_ptr(), dA.data_ptr(), B_.data_ptr(), C_.data_ptr(),
        y.data_ptr(), states.data_ptr(), b, c, h, Q, p, n, DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "ssd_scan")
    ssd_chunked_kernel.launches += 1
    return y, states


def ssd_chunked_kernel(x: torch.Tensor, dA: torch.Tensor, B_: torch.Tensor,
                       C_: torch.Tensor, chunk: int,
                       init_state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``ssd_chunked_ref`` (``models.ssm.ssd_chunked``,
    one B/C group): x (b,l,h,p) already multiplied by dt; dA (b,l,h);
    B_/C_ (b,l,n); optional init_state (b,h,p,n).  Returns y (b,l,h,p) in
    x's dtype and the final state (b,h,p,n) f32."""
    _build.forbid_grad("ssd_chunked_kernel", x, dA, B_, C_, init_state)
    b, l, h, p = x.shape
    n = B_.shape[-1]
    l0 = l
    if l % chunk:
        pad = chunk - l % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
        l += pad
    c, Q = l // chunk, chunk
    y_diag, states = ssd_intra_chunk(x, dA, B_, C_, chunk)

    # inter-chunk recurrence: O(c) sequential steps of (b, h, p, n)
    cum = cumsum_f32(dA.float().reshape(b, c, Q, h), dim=2)      # (b,c,Q,h)
    chunk_decay = torch.exp(cum[:, :, -1])                       # (b,c,h)
    s = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    prev = []
    for z in range(c):                  # the state entering each chunk
        prev.append(s)
        s = s * chunk_decay[:, z, :, None, None] + states[:, z]
    prev_states = torch.stack(prev, dim=1)                       # (b,c,h,p,n)

    Cf = C_.float().reshape(b, c, Q, n)
    y_off = torch.einsum("bzqn,bzhpn,bzqh->bzqhp", Cf, prev_states,
                         torch.exp(cum))
    y = (y_diag.reshape(b, c, Q, h, p) + y_off).reshape(b, l, h, p)[:, :l0]
    return y.to(x.dtype), s


ssd_chunked_kernel.launches = 0
