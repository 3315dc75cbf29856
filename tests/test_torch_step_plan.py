"""Launch plans of the port's step kernels (``ddim_step``, ``dpmpp_step``,
``group_mean``), on the CPU.

The kernels read their slice from ``blockIdx`` as the plans'
``slice_of`` says; here every plan is held to what the kernels need: each
element covered exactly once, no ``ddim_step`` / ``dpmpp_step`` slice
across a row (a block reads one row's schedule values or step scalars),
every slice of the vector path (16-byte loads) 16-byte aligned in bytes,
one vector a thread, and a grid that covers the card at the serving path's
stacks.  The kernels themselves run on the card:
``tests/test_torch_step_kernels.py``.
"""
import numpy as np
import pytest

from repro_torch.kernels import _tiles
from repro_torch.kernels._tiles import MAX_THREADS
from repro_torch.kernels.ddim_step import ops as ddim_ops
from repro_torch.kernels.dpmpp_step import ops as dpmpp_ops
from repro_torch.kernels.group_mean import ops as gmean_ops

# sage-dit's latent (64x64x4) and the path's stacks: the branch phase's
# 2 groups x 4 members, the shared phase's 2 trunks
LATENT = 64 * 64 * 4
F32, BF16 = 4, 2


def _bytes_aligned(elements, itemsize):
    return elements * itemsize % 16 == 0


# (rows, n_per_row, itemsize, aligned, broadcast); broadcast plans the
# whole stack as one row, as the wrapper does for 0-dim step scalars
DPMPP_CASES = {
    "branch8-f32": (8, LATENT, F32, True, False),
    "shared2-f32": (2, LATENT, F32, True, False),
    "branch8-bf16": (8, LATENT, BF16, True, False),
    "shared2-bf16": (2, LATENT, BF16, True, False),
    "branch16-f32": (16, LATENT, F32, True, False),
    "broadcast2-f32": (2, LATENT, F32, True, True),
    "broadcast8-f32": (8, LATENT, F32, True, True),
    "broadcast8-bf16": (8, LATENT, BF16, True, True),
    "ragged16386-f32": (2, 16386, F32, True, False),
    "ragged16386-bf16": (2, 16386, BF16, True, False),
    "ragged385-f32": (6, 77 * 5, F32, True, False),
    "misaligned-f32": (8, LATENT, F32, False, False),
    "tiny-rows-bf16": (3, 8, BF16, True, False),
    "large-f32": (64, LATENT, F32, True, False),
}


@pytest.mark.parametrize("case", list(DPMPP_CASES))
def test_dpmpp_plan(case):
    rows, n_per_row, itemsize, aligned, broadcast = DPMPP_CASES[case]
    n = rows * n_per_row
    plan = dpmpp_ops.launch_plan(n, n if broadcast else n_per_row, itemsize,
                                 aligned)
    full = 16 // itemsize
    vector = aligned and plan.n_per_row % full == 0
    assert plan.vec == (full if vector else 1)
    # one element or vector a thread
    assert 32 <= plan.threads <= MAX_THREADS and plan.threads % 32 == 0
    assert plan.slice == _tiles.SLICE == plan.threads * plan.vec
    seen = np.zeros(n, np.int32)
    for b in range(plan.blocks):
        start, length = plan.slice_of(b)
        assert 0 < length <= plan.slice
        seen[start:start + length] += 1
        # one row's step scalars a block
        assert start // plan.n_per_row == (start + length - 1) // plan.n_per_row
        if plan.vec > 1:
            assert _bytes_aligned(start, itemsize)
            assert _bytes_aligned(length, itemsize)
    assert (seen == 1).all()
    if n_per_row == LATENT and rows in (2, 8):
        assert plan.blocks >= 128          # about one per SM of the H100
    if broadcast:
        # the same plan as per-row scalars would get, cut from one row
        per_row = dpmpp_ops.launch_plan(n, n_per_row, itemsize, aligned)
        assert (plan.slice, plan.blocks, plan.threads) == (
            per_row.slice, per_row.blocks, per_row.threads)


# (rows, n_per_row, itemsize, aligned, broadcast): the DDIM path's stacks
# (the branch phase's 2 groups x 4 members, the shared phase's 2 trunks,
# per-row timesteps), the broadcast launch of one timestep, and the
# one-element path (ragged rows, a misaligned pointer)
DDIM_CASES = {
    "branch8-f32": (8, LATENT, F32, True, False),
    "shared2-f32": (2, LATENT, F32, True, False),
    "branch8-bf16": (8, LATENT, BF16, True, False),
    "shared2-bf16": (2, LATENT, BF16, True, False),
    "broadcast8-f32": (8, LATENT, F32, True, True),
    "broadcast2-bf16": (2, LATENT, BF16, True, True),
    "ragged16386-f32": (2, 16386, F32, True, False),
    "ragged16386-bf16": (2, 16386, BF16, True, False),
    "ragged385-f32": (6, 77 * 5, F32, True, False),
    "misaligned-f32": (8, LATENT, F32, False, False),
    "misaligned-bf16": (2, LATENT, BF16, False, False),
    "tiny-rows-f32": (3, 4, F32, True, False),
    "one-row-f32": (1, 1000, F32, True, False),
}


@pytest.mark.parametrize("case", list(DDIM_CASES))
def test_ddim_plan(case):
    rows, n_per_row, itemsize, aligned, broadcast = DDIM_CASES[case]
    n = rows * n_per_row
    plan = ddim_ops.launch_plan(n, n if broadcast else n_per_row, itemsize,
                                aligned)
    full = 16 // itemsize
    vector = aligned and plan.n_per_row % full == 0
    assert plan.vec == (full if vector else 1)
    # one vector a thread: 64-thread blocks in f32, 32 in bf16; one element
    # a thread in 256-thread blocks
    assert plan.threads == _tiles.SLICE // plan.vec
    assert plan.threads == (256 if plan.vec == 1 else
                            {F32: 64, BF16: 32}[itemsize])
    seen = np.zeros(n, np.int32)
    for b in range(plan.blocks):
        start, length = plan.slice_of(b)
        assert 0 < length <= plan.slice
        seen[start:start + length] += 1
        # one row's schedule values a block
        assert start // plan.n_per_row == (start + length - 1) // plan.n_per_row
        if plan.vec > 1:
            assert _bytes_aligned(start, itemsize)
            assert _bytes_aligned(length, itemsize)
    assert (seen == 1).all()
    if n_per_row == LATENT and rows in (2, 8) and aligned:
        # the path's stacks: 512 and 128 blocks, about one per SM and more
        assert plan.blocks == {8: 512, 2: 128}[rows]
    # the kernel's grid, (slices a row, rows), in one launch
    assert plan.blocks == plan.blocks_per_row * plan.rows
    assert ddim_ops.launches(plan) == 1


def test_ddim_plan_launches_per_65535_rows():
    """Rows beyond the grid's y limit take more launches, each counted."""
    for rows, want in ((65535, 1), (65536, 2), (3 * 65535 + 1, 4)):
        plan = ddim_ops.launch_plan(rows * 4, 4, F32, True)
        assert plan.rows == rows and ddim_ops.launches(plan) == want


def test_dpmpp_plan_rejects():
    with pytest.raises(ValueError, match="rows of"):
        dpmpp_ops.launch_plan(10, 3, F32, True)
    with pytest.raises(ValueError, match="rows of"):
        dpmpp_ops.launch_plan(0, 0, F32, True)


# (K, N, F, itemsize, aligned)
GMEAN_CASES = {
    "path-f32": (2, 4, LATENT, F32, True),
    "path-bf16": (2, 4, LATENT, BF16, True),
    "n1-f32": (3, 1, LATENT, F32, True),
    "n2-f32": (2, 2, LATENT, F32, True),
    "n3-f32": (2, 3, LATENT, F32, True),
    "n8-bf16": (2, 8, LATENT, BF16, True),
    "n64-f32": (2, 64, LATENT, F32, True),
    "ragged385-f32": (2, 4, 77 * 5, F32, True),
    "ragged16386-bf16": (2, 4, 16386, BF16, True),
    "misaligned-f32": (2, 4, LATENT, F32, False),
    "misaligned-bf16": (2, 8, LATENT, BF16, False),
    "one-group-f32": (1, 4, 100, F32, True),
}


@pytest.mark.parametrize("case", list(GMEAN_CASES))
def test_group_mean_plan(case):
    K, N, F, itemsize, aligned = GMEAN_CASES[case]
    plan = gmean_ops.launch_plan(K, N, F, itemsize, aligned)
    full = 16 // itemsize
    vector = aligned and F % full == 0
    assert plan.vec == (full if vector else 1)
    assert plan.unrolled == (vector and N in gmean_ops.UNROLLED)
    assert 32 <= plan.threads <= MAX_THREADS and plan.threads % 32 == 0
    seen = np.zeros(K * F, np.int32)
    for k in range(K):
        for bx in range(plan.blocks_x):
            f0, length = plan.slice_of(bx)
            assert 0 < length <= plan.threads * plan.vec
            seen[k * F + f0:k * F + f0 + length] += 1
            if plan.vec > 1:
                # each member's slice of x: a 16-byte load a thread
                for n in range(N):
                    assert _bytes_aligned((k * N + n) * F + f0, itemsize)
                assert _bytes_aligned(length, itemsize)
    assert (seen == 1).all()
    if (K, N, F) == (2, 4, LATENT):
        assert plan.blocks >= gmean_ops.TARGET_BLOCKS == 128


def test_group_mean_plan_rejects():
    with pytest.raises(ValueError, match="empty"):
        gmean_ops.launch_plan(2, 0, 16, F32, True)
    with pytest.raises(ValueError, match="empty"):
        gmean_ops.launch_plan(2, 4, 0, F32, True)
