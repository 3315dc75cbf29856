"""The ``ddim_step``, ``dpmpp_step`` and ``group_mean`` kernels against
their plain versions on the card, at the serving path's shapes and on the
one-element path (ragged rows, and pointers one element off 16 bytes),
within ``chip_smoke.py``'s tolerances.

Every test here is marked ``cuda`` and skips itself without a card (a CUDA
kernel has no CPU mode; the CPU tests of the plans are
``tests/test_torch_step_plan.py``, of the plain versions against the JAX
package ``tests/test_torch_solvers.py``).  The machine with the card has no
JAX, and nothing here imports it:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_step_kernels.py
"""
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch.core import samplers
from repro_torch.core.schedule import ddim_timesteps, make_schedule
from repro_torch.kernels.ddim_step import ops as ddim_ops
from repro_torch.kernels.ddim_step.ref import fused_cfg_ddim_step_ref
from repro_torch.kernels.dpmpp_step import ops as dpmpp_ops
from repro_torch.kernels.dpmpp_step.ref import fused_cfg_dpmpp_step_ref
from repro_torch.kernels.group_mean import ops as gmean_ops
from repro_torch.kernels.group_mean.ref import masked_group_mean_ref


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports only the standard library
    at the top)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOL = _chip_smoke().TOL


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels run only "
                    "there")
    return torch.device("cuda")


def _randn(shape, dtype, dev, gen, offset):
    """A contiguous tensor whose data starts ``offset`` elements into its
    storage (offset 1: off the 16-byte boundary)."""
    buf = torch.randn(math.prod(shape) + offset, device=dev, generator=gen)
    return buf.to(dtype)[offset:].view(shape)


def _assert_close(kernel, got, want):
    tol = TOL[(kernel, str(want.dtype).split(".")[1])]
    diff = (got.float() - want.float()).abs()
    assert (diff <= tol * (1 + want.float().abs())).all(), diff.max().item()


# (shape, offset, timesteps): the branch stack (2 groups x 4 members of
# sage-dit's 64x64x4 latent) and the shared phase's 2 trunks with per-row
# timesteps, the broadcast launch (0-dim), a row of 16386 elements (not a
# multiple of the vector), the branch stack one element off 16 bytes, t
# expanded from one value (a row stride of 0) beside a per-row t_next,
# per-row timesteps gathered from a 2-D grid of two step budgets, and more
# rows than one launch's grid takes (two launches)
DDIM_CASES = {"branch8": ((8, 64, 64, 4), 0, "rows"),
              "shared2": ((2, 64, 64, 4), 0, "rows"),
              "broadcast8": ((8, 64, 64, 4), 0, "one"),
              "ragged16386": ((2, 16386), 0, "rows"),
              "offset1": ((8, 64, 64, 4), 1, "rows"),
              "expanded": ((8, 64, 64, 4), 0, "expanded"),
              "grid2d": ((8, 64, 64, 4), 0, "grid2d"),
              "rows65538": ((65538, 8), 0, "rows")}


def _ddim_timesteps(kind, rows, dev):
    """(t, t_next) on the real 30-step grid: two groups at steps 9 and 12
    (one per half of the rows), one step for all, or a 2-D grid of 30- and
    20-step budgets."""
    grid = torch.as_tensor(ddim_timesteps(1000, 30), device=dev)
    idx = torch.tensor([9, 12], device=dev).repeat_interleave(rows // 2)
    if kind == "one":
        return grid[idx[-1]], grid[idx[-1] + 1]
    if kind == "expanded":
        return grid[idx[-1]].expand(rows), grid[idx + 1]
    if kind == "grid2d":
        g2 = torch.zeros((rows, 31), dtype=torch.long, device=dev)
        g2[: rows // 2] = grid
        g2[rows // 2:, :21] = torch.as_tensor(ddim_timesteps(1000, 20),
                                              device=dev)
        i = idx[:, None]
        return g2.gather(1, i)[:, 0], g2.gather(1, i + 1)[:, 0]
    return grid[idx], grid[idx + 1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(DDIM_CASES))
def test_ddim_step_kernel(case, dtype):
    """The kernel, gathering its own schedule values, against the plain
    version on the same tables and timesteps: in f32 op for op, so
    bitwise; clip on and off."""
    dev = _device()
    shape, offset, kind = DDIM_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(9)
    z, eu, ec = (_randn(shape, dtype, dev, gen, offset) for _ in range(3))
    sched = make_schedule(1000, device=dev)
    t, tn = _ddim_timesteps(kind, shape[0], dev)
    for clip in (3.0, 0.0):
        args = (z, eu, ec, 7.5, sched.alphas, sched.sigmas, t, tn)
        before = ddim_ops.fused_cfg_ddim_step.launches
        got = ddim_ops.fused_cfg_ddim_step(*args, clip_x0=clip)
        torch.cuda.synchronize()
        per_row = kind != "one"
        assert ddim_ops.fused_cfg_ddim_step.launches == before + (
            -(-shape[0] // ddim_ops.MAX_ROWS) if per_row else 1)
        want = fused_cfg_ddim_step_ref(*args, clip_x0=clip)
        assert got.dtype == dtype and got.shape == want.shape
        _assert_close("ddim_step", got, want)
        if dtype == torch.float32:
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_ddim_step_kernel_indexes_as_pytorch():
    """A negative timestep counts from the end of the table, as PyTorch's
    indexing does; one past the table gives NaN rows (PyTorch raises)."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(10)
    z, eu, ec = (_randn((4, 8, 8, 4), torch.float32, dev, gen, 0)
                 for _ in range(3))
    sched = make_schedule(1000, device=dev)
    t = torch.tensor([-1, -1001, 500, 1001], device=dev)
    tn = torch.tensor([900, 10, 1001, 400], device=dev)
    got = ddim_ops.fused_cfg_ddim_step(z, eu, ec, 2.0, sched.alphas,
                                       sched.sigmas, t, tn, clip_x0=3.0)
    want = fused_cfg_ddim_step_ref(z[:2], eu[:2], ec[:2], 2.0, sched.alphas,
                                   sched.sigmas, t[:2], tn[:2], clip_x0=3.0)
    assert torch.equal(got[:2], want)
    assert torch.isnan(got[2:]).all()


# (shape, offset, per_row): the branch stack (2 groups x 4 members of
# sage-dit's 64x64x4 latent), the shared phase's 2 trunks, the broadcast
# launch, a row of 16386 elements (not a multiple of the vector), and the
# branch stack one element off 16 bytes
DPMPP_CASES = {"branch8": ((8, 64, 64, 4), 0, True),
               "shared2": ((2, 64, 64, 4), 0, True),
               "broadcast8": ((8, 64, 64, 4), 0, False),
               "ragged16386": ((2, 16386), 0, True),
               "offset1": ((8, 64, 64, 4), 1, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(DPMPP_CASES))
def test_dpmpp_step_kernel(case, dtype):
    """Both outputs; in f32 op for op the plain version's, so bitwise.  The
    first half of a per-row stack sits at its fork (history warm-up), the
    second mid-branch."""
    dev = _device()
    shape, offset, per_row = DPMPP_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(7)
    z, eu, ec, ep = (_randn(shape, dtype, dev, gen, offset) for _ in range(4))
    sched = make_schedule(1000, device=dev)
    grid = torch.as_tensor(ddim_timesteps(1000, 30), device=dev)
    idx = torch.tensor([9, 12], device=dev).repeat_interleave(shape[0] // 2)
    i = idx if per_row else idx[-1]
    sc = samplers.dpmpp_scalars(sched, grid[i], grid[i + 1],
                                grid[torch.clamp_min(i - 1, 0)])
    for clip in (3.0, 0.0):
        args = (z, eu, ec, ep, 7.5, *sc, i == 9)
        before = dpmpp_ops.fused_cfg_dpmpp_step.launches
        got = dpmpp_ops.fused_cfg_dpmpp_step(*args, clip_x0=clip)
        torch.cuda.synchronize()
        assert dpmpp_ops.fused_cfg_dpmpp_step.launches == before + 1
        want = fused_cfg_dpmpp_step_ref(*args, clip_x0=clip)
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape
            _assert_close("dpmpp_step", g, w)
            if dtype == torch.float32:
                assert torch.equal(g, w)


# (shape, offset, mask): the branch stack's group mean (full groups, as on
# the path; a masked member beside an all-masked group), N of 1, 3, 8 and
# 64, a ragged feature length (77 x 5) and x one element off 16 bytes
GMEAN_CASES = {"path-full": ((2, 4, 64, 64, 4), 0, "full"),
               "path-masked": ((2, 4, 64, 64, 4), 0, "masked"),
               "n1": ((3, 1, 64, 64, 4), 0, "masked"),
               "n3": ((2, 3, 64, 64, 4), 0, "masked"),
               "n8": ((2, 8, 64, 64, 4), 0, "masked"),
               "n64": ((2, 64, 16, 16, 4), 0, "masked"),
               "ragged385": ((2, 4, 77, 5), 0, "masked"),
               "offset1": ((2, 4, 64, 64, 4), 1, "full")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(GMEAN_CASES))
def test_group_mean_kernel(case, dtype):
    dev = _device()
    shape, offset, mask_kind = GMEAN_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(8)
    x = _randn(shape, dtype, dev, gen, offset)
    mask = torch.ones(shape[:2], device=dev)
    if mask_kind == "masked":
        mask[0, -1] = 0.0
        mask[1] = 0.0
    before = gmean_ops.masked_group_mean.launches
    got = gmean_ops.masked_group_mean(x, mask)
    torch.cuda.synchronize()
    assert gmean_ops.masked_group_mean.launches == before + 1
    want = masked_group_mean_ref(x, mask)
    assert got.dtype == dtype and got.shape == want.shape
    _assert_close("group_mean", got, want)
    if mask_kind == "masked":
        assert not got[1].any()
