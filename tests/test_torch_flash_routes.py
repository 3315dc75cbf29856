"""The flash-attention wrapper's two CUDA routes, as far as the CPU shows
them: which kernel a dtype takes and the head-dim width it pads to, that
the sm90 launcher is handed that width, that the zero columns the bf16
route pads a head_dim off 8 with leave attention unchanged, and that
CPU tensors of either dtype take the plain version without counting a
launch.  The kernels themselves are held against ``attention_ref`` on
the card by ``chip_smoke.py``."""
import ctypes
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref


@pytest.mark.parametrize("head_dim,width", [
    (72, 80), (32, 32), (64, 64), (192, 192), (256, 256),
    (8, 32), (40, 64), (80, 80), (96, 128), (128, 128), (136, 192),
    (1, 32), (36, 64), (100, 128), (250, 256)])
def test_bf16_routes_to_sm90_at_the_padded_width(head_dim, width):
    assert flash_ops.route(torch.bfloat16, head_dim) == ("sm90", width)


def test_bf16_route_takes_every_head_dim_to_256():
    """A head_dim off 8 is padded to the next multiple of 8 by the wrapper,
    which the same width holds, so every D in 1..256 takes the sm90
    kernel, as the TPU kernel takes every D <= 256."""
    for head_dim in range(1, flash_ops.MAX_HEAD_DIM + 1):
        kernel, width = flash_ops.route(torch.bfloat16, head_dim)
        assert kernel == "sm90" and head_dim <= width
        assert width == flash_ops.route(torch.bfloat16,
                                        -(-head_dim // 8) * 8)[1]


@pytest.mark.parametrize("head_dim", [72, 192, 20, 256])
def test_f32_routes_to_the_tf32x3_kernel(head_dim):
    assert flash_ops.route(torch.float32, head_dim) == ("tf32x3", head_dim)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_rejects_head_dim_past_256(dtype):
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.route(dtype, 264)


def test_route_rejects_other_dtypes():
    with pytest.raises(TypeError, match="float32/bfloat16"):
        flash_ops.route(torch.float16, 64)


def test_build_lists_the_sm90_source_and_launcher():
    """The sm90 launcher takes the f32 one's arguments with the padded
    width (an int) after D, the tenth argument."""
    assert "flash_attention_sm90.cu" in _build.SOURCES
    tf32x3 = _build.SIGNATURES["sage_flash_attention"]
    assert (_build.SIGNATURES["sage_flash_attention_sm90"]
            == tf32x3[:10] + (ctypes.c_int,) + tf32x3[10:])


# (B, Sq, Sk, H, Hkv, D, causal, window): the DiT's cross-attention at
# head_dim 72, the text tower's causal 192, GQA with a window, a ragged Sq
# at the widest head, a single key
CPU_CASES = {
    "cross_sk77_hd72": (2, 33, 77, 2, 2, 72, False, 0),
    "causal_hd192": (1, 20, 20, 2, 2, 192, True, 0),
    "gqa_window_hd64": (1, 70, 70, 4, 2, 64, True, 16),
    "ragged_hd256": (1, 130, 50, 2, 1, 256, False, 0),
    "sk1_hd80": (2, 9, 1, 2, 2, 80, False, 0),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_cpu_tensors_take_the_plain_version_without_a_launch(case, dtype):
    B, Sq, Sk, H, Hkv, D, causal, window = CPU_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype) for shape in
        ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    scale = 1.0 / math.sqrt(D)
    want = attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    before = flash_ops.flash_attention.launches
    by_route = dict(flash_ops.flash_attention.launches_by_route)
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                    scale=scale)
    routed = dispatch.attention(q, k, v, impl="kernel", causal=causal,
                                window=window, scale=scale)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, want) and torch.equal(routed, want)
    assert flash_ops.flash_attention.launches == before
    assert flash_ops.flash_attention.launches_by_route == by_route
    assert set(by_route) == set(flash_ops.ROUTES)


# (B, Sq, Sk, H, Hkv, D, causal, window) at head_dims off 8: causal GQA
# with a window, non-causal cross with a ragged Sk, the widest head
PAD_CASES = {
    "gqa_window_hd36": (2, 96, 96, 4, 2, 36, True, 24),
    "cross_sk77_hd100": (2, 40, 77, 4, 4, 100, False, 0),
    "causal_hd250": (1, 70, 70, 2, 1, 250, True, 0),
    "hd1": (1, 20, 30, 2, 2, 1, False, 0),
}
PAD_TOL = {torch.float32: 1e-6, torch.bfloat16: 4e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PAD_CASES))
def test_head_dim_padding_leaves_attention_unchanged(case, dtype):
    """What the bf16 route does with a head_dim off 8: q, k and v padded
    with zero columns to the next multiple of 8 (a fresh contiguous
    buffer), attention at the true D's scale, the output sliced back to D
    equal to attention on the originals."""
    B, Sq, Sk, H, Hkv, D, causal, window = PAD_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype) for shape in
        ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    # a transposed view too: the pad's buffer is contiguous whatever it is
    # given
    k = k.transpose(1, 2).contiguous().transpose(1, 2)
    padded = [flash_ops.pad_head_dim(x) for x in (q, k, v)]
    D8 = -(-D // 8) * 8
    for x, p in zip((q, k, v), padded):
        assert p.shape == x.shape[:-1] + (D8,) and p.is_contiguous()
        assert torch.equal(p[..., :D], x) and not p[..., D:].any()
    scale = 1.0 / math.sqrt(D)
    kw = dict(causal=causal, window=window, scale=scale)
    got = attention_ref(*padded, **kw)[..., :D]
    want = attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=PAD_TOL[dtype])


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports only the standard library
    at the top)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path,full,want", [
    ("vlm", True, 48), ("vlm", False, 12),
    ("encdec", True, 72), ("encdec", False, 18)])
def test_chip_smoke_flash_launches_a_prefill_follow_the_depth(path, full,
                                                              want):
    """``chip_smoke.py`` holds a cross-attention LM's prefill to one sm90
    launch a self-attention, a cross-attention and an encoder layer,
    counted from the model it built: at full depth the 48 (VLM: 40 self,
    8 cross) and 72 (seamless: 24 encoder, 24 self, 24 cross) it was held
    to before, at the path's cut depth what those layers give."""
    from repro_torch.config import get_config, replace
    from repro_torch.models import transformer as tfm
    smoke = _chip_smoke()
    spec = smoke.PATHS[path]
    cfg = get_config(spec["arch"])
    if not full:
        cfg = replace(cfg, **smoke._depth(spec))
    assert smoke._flash_per_prefill(tfm.meta_lm(cfg)) == want


def _p_in_bf16(q, k, v, scale):
    """Attention as the sm90 kernel rounds it: f32 scores and statistics,
    P rounded to bf16 before P V, the output rounded once to bf16."""
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    s = (qf @ kf.transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = (p.bfloat16().float() @ vf) / p.sum(-1, keepdim=True)
    return o.permute(0, 2, 1, 3).bfloat16()


# how a bf16 flash kernel can go subtly wrong at the DiT's self-attention
# shape (1024 keys, D = 72): (scale factor, keys kept)
FLAWS = {"right": (1.0, 1024), "scale_3pct_high": (1.03, 1024),
         "key_tile_dropped": (1.0, 960), "last_key_dropped": (1.0, 1023)}


@pytest.mark.parametrize("flaw", sorted(FLAWS))
def test_chip_smoke_bf16_flash_tolerance_fails_a_wrong_kernel(flaw):
    """``chip_smoke.py`` holds the bf16 kernel to ``attention_ref`` at
    TOL's bf16 flash entry: a kernel with the sm90 kernel's own roundings
    passes it, one with a scale a few percent off or keys dropped fails."""
    smoke = _chip_smoke()
    gen = torch.Generator().manual_seed(14)
    q, k, v = (torch.randn((1, 1024, 4, 72), generator=gen).bfloat16()
               for _ in range(3))
    scale = 1.0 / math.sqrt(72)
    factor, keys = FLAWS[flaw]
    got = _p_in_bf16(q, k[:, :keys], v[:, :keys], scale * factor)
    want = attention_ref(q, k, v, causal=False, scale=scale)
    failures = []
    smoke._check(failures, "flash_attention", flaw, "bfloat16", got, want,
                 "")
    assert (failures == []) == (flaw == "right")
