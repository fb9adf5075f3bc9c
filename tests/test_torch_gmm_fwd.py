"""The grouped matmul's forward schedule on the CPU: the bf16 kernel's work
items (``ops/gmm.py fwd_schedule``) and the product they drive
(``gmm_tiled``: the kernel's walk in plain PyTorch, 64-wide k steps with
zero-filled edges, the roles swapped at decode) against megablox ``gmm``
run as the JAX package runs it off a TPU (interpret mode, the helper of
``tests/test_torch_moe.py``), in each of the kernel's three regimes, in f32
and bf16. Inputs come from numpy with a seed; the weights are scaled by
1 / sqrt(k), so outputs are of unit size, as a layer's init keeps them."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu_torch.ops import gmm as gm

from test_torch_moe import F32_TOL, _jax_gmm
from test_torch_qwen import to_torch

CASES = {
    # M, k, n, group sizes (None: 32 tokens routed top-8 over 128 experts)
    "straddle": (520, 64, 136, [63, 65, 127, 129, 1, 135]),  # across 64- and 128-row tile edges
    "empty-and-one-row": (40, 72, 72, [0, 1, 0, 1, 30, 0, 8]),
    "one-group": (300, 64, 72, [0, 300, 0]),
    "rows-past": (203, 200, 72, [0, 1, 57, 0, 100, 3, 0, 30]),  # 12 rows past the groups
    "k200-n136": (150, 200, 136, [70, 0, 72]),  # 8 rows past the groups
    "routed-256": (256, 64, 72, None),
}


def _sizes(case) -> list[int]:
    M, _, _, sizes = CASES[case]
    if sizes is not None:
        return sizes
    logits = np.random.default_rng(7).standard_normal((M // 8, 128))
    top = np.argsort(-logits, axis=1)[:, :8].reshape(-1)  # top-8 of a softmax: the largest logits
    return np.bincount(top, minlength=128).tolist()


@functools.lru_cache(maxsize=None)
def _case(case, dtype):
    """(lhs, rhs, sizes, megablox's output) of a case, made once."""
    M, k, n, _ = CASES[case]
    sizes = _sizes(case)
    rng = np.random.default_rng(0)
    lhs = jnp.asarray(rng.standard_normal((M, k)), dtype)
    rhs = jnp.asarray(rng.standard_normal((len(sizes), k, n)) / np.sqrt(k), dtype)
    return to_torch(lhs), to_torch(rhs), torch.tensor(sizes, dtype=torch.int32), _jax_gmm(lhs, rhs, sizes)


@pytest.mark.parametrize("tile", gm.BF16_TILES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_tiled_twin_matches_megablox(case, dtype, tile):
    """The kernel's walk gives megablox's product on the groups' rows (the
    same f32 products, bf16 inputs exact in f32, summed in other orders)
    and exact zeros past them (megablox leaves those rows uninitialized)."""
    lhs, rhs, sizes, want = _case(case, dtype)
    got = gm.gmm_tiled(lhs, rhs, sizes, tile)
    used = int(sizes.sum())
    np.testing.assert_allclose(got.numpy()[:used], want[:used], **F32_TOL)
    assert torch.equal(got[used:], torch.zeros_like(got[used:]))


@pytest.mark.parametrize("tile", gm.BF16_TILES)
@pytest.mark.parametrize("case", list(CASES))
def test_schedule_fits_its_grid(case, tile):
    """The work items fit the grid sized from M and E alone; each lies in
    one group, tiled from the group's first row, every row is written once
    in every column tile, and rows past the groups only by zeroing items."""
    M, k, n, _ = CASES[case]
    sizes = _sizes(case)
    items, grid = gm.fwd_schedule(torch.tensor(sizes, dtype=torch.int32), M, n, tile)
    assert grid == (-(-n // gm.FWD_BN), M // tile + len(sizes) + 1)
    work = sorted({(g, r0, rows) for g, r0, rows, _ in items}, key=lambda x: x[1])
    assert len(work) <= grid[1] and len(items) == len(work) * grid[0]
    off = np.concatenate([[0], np.cumsum(sizes)])
    row = 0
    for g, r0, rows in work:
        assert r0 == row and 0 < rows <= tile  # in order, no gap, no overlap
        if g >= 0:
            assert off[g] <= r0 and r0 + rows <= off[g + 1] and (r0 - off[g]) % tile == 0
        else:
            assert r0 >= off[-1]
        row += rows
    assert row == M


def _move_a_row(items, tile):
    """The planted fault: the first row of a group moved into the group
    before it, in every column tile's items."""
    by_ct = {}
    for g, r0, rows, ct in items:
        by_ct.setdefault(ct, []).append((g, r0, rows))
    bad = []
    for ct, work in by_ct.items():
        for i, ((g, r0, rows), (g2, r2, rows2)) in enumerate(zip(work, work[1:])):
            if g >= 0 and g2 == g + 1 and r0 + rows == r2 and rows < tile and rows2 > 1:
                work = work[:i] + [(g, r0, rows + 1), (g2, r2 + 1, rows2 - 1)] + work[i + 2:]
                break
        else:
            raise AssertionError("no adjacent groups to move a row between")
        bad += [(g, r0, rows, ct) for g, r0, rows in work]
    return bad


@pytest.mark.parametrize("tile", gm.BF16_TILES)
def test_planted_fault_misses_the_tolerance(tile):
    """A walk with one row moved across a group boundary (multiplied by the
    wrong expert's weights) misses the tolerance the twin is held to."""
    lhs, rhs, sizes, want = _case("straddle", "float32")
    M, _, n, _ = CASES["straddle"]
    items, _ = gm.fwd_schedule(sizes, M, n, tile)
    got = gm.gmm_tiled(lhs, rhs, sizes, tile, items=_move_a_row(items, tile))
    assert not np.allclose(got.numpy(), want, **F32_TOL)


def test_pick_bf16_tile():
    """The regime from the groups' average rows: the roles swapped below 16
    (decode: Qwen3-30B-A3B's 32 slots x top-8 over 128 experts), 64-row
    tiles below 64, else 128 (a 1,024-token microbatch, a prefill group,
    train_moe's grid)."""
    E = 128
    assert gm.pick_bf16_tile(256, E) == 16
    assert gm.pick_bf16_tile(16 * E - 1, E) == 16
    assert gm.pick_bf16_tile(16 * E, E) == 64
    assert gm.pick_bf16_tile(64 * E - 1, E) == 64
    assert gm.pick_bf16_tile(8192, E) == 128
    assert gm.pick_bf16_tile(32768, E) == 128 and gm.pick_bf16_tile(49152, E) == 128


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """A CPU tensor takes the plain version whatever regime is asked for,
    and counts no launch."""
    lhs, rhs, sizes, _ = _case("rows-past", "bfloat16")
    before = gm.gmm.launches
    for tile in gm.BF16_TILES:
        assert torch.equal(gm.gmm(lhs, rhs, sizes, bf16_tile=tile), gm.gmm_plain(lhs, rhs, sizes))
    assert gm.gmm.launches == before
