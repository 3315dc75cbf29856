"""Public wrapper of the flash-attention kernels.

A CUDA tensor launches a kernel or raises; a CPU tensor takes the plain
version (``ref.py``).  The route follows the dtype; both kernels run their
products on Hopper's tensor cores.  bf16 goes to
``csrc/flash_attention_sm90.cu`` (``"sm90"``: wgmma, TMA-fed K/V ring),
f32 to ``csrc/flash_attention.cu`` (``"tf32x3"``: mma.sync with each f32
operand split into two TF32 values, three products summed in f32, which
keeps f32's accuracy).  Both read the (B, S, H, D) layout in place with
GQA by head index (query head h reads K/V head h // (H // Hkv)), so
nothing is transposed or repeated on the way in.  The sm90 kernel's TMA
moves rows in 16-byte chunks: a bf16 head_dim off 8 is zero-padded to the
next multiple of 8 in a fresh buffer (:func:`pad_head_dim`), as the JAX
wrapper pads D to its 128 lanes, and the output sliced back; zero columns
add nothing to a score, and the padded V columns fill only output columns
that are dropped.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
#: head-dim widths the sm90 kernel is built for; D is zero-padded in shared
#: memory to the first that holds it, and the launcher is handed that width
SM90_WIDTHS = (32, 64, 80, 128, 192, 256)
ROUTES = ("sm90", "tf32x3")


def route(dtype: torch.dtype, head_dim: int) -> tuple[str, int]:
    """The kernel a CUDA tensor of ``dtype`` launches and the head-dim width
    it computes at: ``("sm90", padded width)`` for bf16, ``("tf32x3",
    head_dim)`` for f32.  Raises for what neither kernel takes."""
    if head_dim > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention supports head_dim <= "
                         f"{MAX_HEAD_DIM}, got {head_dim}")
    if dtype == torch.bfloat16:
        return "sm90", next(w for w in SM90_WIDTHS if w >= head_dim)
    if dtype == torch.float32:
        return "tf32x3", head_dim
    raise TypeError(f"flash_attention kernel takes float32/bfloat16, "
                    f"got {dtype}")


def pad_head_dim(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., D) zero-padded on its last dim to the next multiple of
    8, in a fresh contiguous tensor (the allocator's blocks are 512-byte
    aligned, so its rows start on 16 bytes)."""
    D = x.shape[-1]
    out = x.new_zeros(*x.shape[:-1], -(-D // 8) * 8)
    out[..., :D] = x
    return out


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
    _build.forbid_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, q is "
                             f"{q.dtype} on {q.device}")
    kernel, width = route(q.dtype, D)
    if kernel == "sm90" and D % 8:
        out = flash_attention(*map(pad_head_dim, (q, k, v)), causal=causal,
                              window=window, scale=scale)
        return out[..., :D].contiguous()
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous "
                         "(B, S, H, D) tensors")
    out = torch.empty_like(q)
    if out.numel() == 0 or Sk == 0:
        return out.zero_()
    if kernel == "sm90" and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the bf16 kernel's tensor maps need 16-byte "
                         "aligned q, k, v")
    if kernel == "sm90" and scale <= 0:
        # the sm90 kernel folds a positive scale into each exponent's FMA;
        # -q at -scale gives the same scores exactly, and q * 0 at scale 1
        # the zero scale's (NaN where q is not finite, as in attention_ref)
        q, scale = (q.neg(), -scale) if scale < 0 else (q * 0, 1.0)
    lib = _build.load_library()
    if kernel == "sm90":
        launcher, sizes = lib.sage_flash_attention_sm90, (D, width)
    else:
        launcher, sizes = lib.sage_flash_attention, (D,)
    rc = launcher(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, Hkv, *sizes, float(scale), int(causal), int(window),
        DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, f"flash_attention ({kernel})")
    flash_attention.launches += 1
    flash_attention.launches_by_route[kernel] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
