"""Plain PyTorch versions of the Mamba2 SSD scan (``csrc/ssd_scan.cu``'s
twins).

* :func:`ssd_intra_chunk_ref` is the twin of the TPU kernel's body
  (``repro/kernels/ssd_scan/ssd_scan.py:_kernel``): one (batch, chunk,
  head) tile per leading index.
* :func:`ssd_tiles_ref` runs it on every tile of a sequence, in the
  kernel's input and output layouts;
* :func:`ssd_chunked_ref` is the twin of ``repro/models/ssm.py:
  ssd_chunked``, the whole scan with its tail padding and initial state.

All compute in f32, with the cumulative sum of dA taken in f64 and
rounded once (:func:`cumsum_f32`; the JAX package sums in f32, in an order
of XLA's choosing), and mask the causal decay as the JAX package does
(:func:`_decay`): for i < j the segment sum is positive and ``exp`` of it
overflows, so it is replaced by -inf before ``exp``, never multiplied by
the mask, and its gradient is 0, not ``0 * inf``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def cumsum_f32(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive cumsum of f32 values, summed in f64 and rounded once: the
    same f32 in any order of additions, so the kernel and every plain
    version get equal decay exponents."""
    return torch.cumsum(a.double(), dim=dim).float()


def _decay(seg: torch.Tensor) -> torch.Tensor:
    """exp of the segment sums (..., Q, Q) below and on the diagonal, 0
    above it."""
    Q = seg.shape[-1]
    tril = torch.ones((Q, Q), dtype=torch.bool, device=seg.device).tril()
    return torch.exp(torch.where(tril, seg, -torch.inf))


def ssd_intra_chunk_ref(dA: torch.Tensor, x: torch.Tensor, B: torch.Tensor,
                        C: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dA (G, Q); x (G, Q, P); B, C (G, Q, N) -> (y_diag (G, Q, P) f32,
    chunk states (G, P, N) f32)."""
    dA, x, B, C = (t.float() for t in (dA, x, B, C))
    cum = cumsum_f32(dA)                                      # (G, Q)
    seg = cum[:, :, None] - cum[:, None, :]                   # (G, Q, Q)
    L = _decay(seg)
    S = (C @ B.transpose(1, 2)) * L
    y = S @ x
    decay = torch.exp(cum[:, -1:] - cum)                      # (G, Q)
    states = (x * decay[:, :, None]).transpose(1, 2) @ B      # (G, P, N)
    return y, states


def ssd_tiles_ref(x: torch.Tensor, dA: torch.Tensor, B_: torch.Tensor,
                  C_: torch.Tensor, chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_intra_chunk_ref` on every (b, c, h) tile of a sequence
    whose length is a multiple of ``chunk``, in the kernel's layouts: x
    (b,l,h,p), dA (b,l,h), B_/C_ (b,l,n) -> y_diag (b,l,h,p) f32 and chunk
    states (b,c,h,p,n) f32.  B and C are broadcast over the heads here; the
    kernel reads them in place."""
    b, l, h, p = x.shape
    n = B_.shape[-1]
    c, Q = l // chunk, chunk
    xg = x.reshape(b, c, Q, h, p).permute(0, 1, 3, 2, 4).reshape(-1, Q, p)
    dg = dA.reshape(b, c, Q, h).permute(0, 1, 3, 2).reshape(-1, Q)
    Bg, Cg = (t.reshape(b, c, 1, Q, n).expand(b, c, h, Q, n)
              .reshape(-1, Q, n) for t in (B_, C_))
    y, states = ssd_intra_chunk_ref(dg, xg, Bg, Cg)
    y = y.reshape(b, c, h, Q, p).permute(0, 1, 3, 2, 4).reshape(b, l, h, p)
    return y, states.reshape(b, c, h, p, n)


def ssd_chunked_ref(x: torch.Tensor, dA: torch.Tensor, B_: torch.Tensor,
                    C_: torch.Tensor, chunk: int,
                    init_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan.  x (b,l,h,p) already multiplied by dt; dA (b,l,h) = dt*A
    (negative); B_/C_ (b,l,n).  Returns y (b,l,h,p) in x's dtype and the
    final state (b,h,p,n) f32."""
    b, l, h, p = x.shape
    n = B_.shape[-1]
    l0 = l
    if l % chunk:
        # zero inputs with dA = 0 (decay 1) leave y[:l] and the state as is
        pad = chunk - l % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
        l += pad
    c, Q = l // chunk, chunk
    xf = x.float().reshape(b, c, Q, h, p)
    Bf = B_.float().reshape(b, c, Q, n)
    Cf = C_.float().reshape(b, c, Q, n)
    A = dA.float().reshape(b, c, Q, h).permute(0, 3, 1, 2)    # (b,h,c,Q)
    A_cum = cumsum_f32(A)

    seg = A_cum[..., :, None] - A_cum[..., None, :]
    L = _decay(seg)                                            # (b,h,c,Q,Q)
    Y_diag = torch.einsum("bzqn,bzsn,bhzqs,bzshp->bzqhp", Cf, Bf, L, xf)

    decay_states = torch.exp(A_cum[..., -1:] - A_cum)         # (b,h,c,Q)
    states = torch.einsum("bzqn,bhzq,bzqhp->bzhpn", Bf, decay_states, xf)

    chunk_decay = torch.exp(A_cum[..., -1])                   # (b,h,c)
    s = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    prev = []
    for z in range(c):                  # the state entering each chunk
        prev.append(s)
        s = s * chunk_decay[:, :, z, None, None] + states[:, z]
    prev_states = torch.stack(prev, dim=1)                    # (b,c,h,p,n)

    Y_off = torch.einsum("bzqn,bzhpn,bhzq->bzqhp", Cf, prev_states,
                         torch.exp(A_cum))
    y = (Y_diag + Y_off).reshape(b, l, h, p)[:, :l0]
    return y.to(x.dtype), s
