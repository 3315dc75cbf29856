"""Public wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (``ref.py``).  The kernel reads the (B, S, H, D) layout in place
with GQA by head index (query head h reads K/V head h // (H // Hkv)), so
nothing is transposed, repeated or padded on the way in.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Sq, H, D); k/v (B, Sk, Hkv, D), H % Hkv == 0 -> (B, Sq, H, D).

    Keys past Sk and the ragged final query/key tiles are masked inside
    the kernel; ``window > 0`` (causal only) keeps keys in
    (row - window, row]."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on batch or head_dim")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention supports head_dim <= "
                         f"{MAX_HEAD_DIM}, got {D}")
    if window and not causal:
        raise ValueError("sliding window requires causal attention")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"n_heads {H} not divisible by n_kv_heads {Hkv}")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, q is "
                             f"{q.dtype} on {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention kernel takes float32/bfloat16, "
                        f"got {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous "
                         "(B, S, H, D) tensors")
    out = torch.empty_like(q)
    if out.numel() == 0 or Sk == 0:
        return out.zero_()
    lib = _build.load_library()
    rc = lib.sage_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, Hkv, D, float(scale), int(causal), int(window),
        DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
