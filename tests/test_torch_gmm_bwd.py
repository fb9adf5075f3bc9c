"""The grouped matmul's backward in the port against megablox's VJP on the
CPU: ``GroupedMatmul`` (dLHS through ``gmm_bwd_lhs``, dRHS through
``tgmm``) against ``jax.vjp`` of the ``gmm`` that ``areal_tpu/models/moe.py``
calls, run as the JAX package runs it off a TPU (megablox in interpret
mode, tiling ``(gcd(M, 16), 128, 128)``). On the CPU the wrappers take their
plain versions, the functions the CUDA kernels are held to on the card.

Inputs come from numpy with a seed; the cotangent is f32, as the forward's
f32 output gives it."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.megablox import gmm as megablox_gmm

from areal_tpu_torch.ops import gmm as gm

from test_torch_qwen import to_torch

# f32 outputs: megablox multiplies the f32 cotangent by the widened operand
# in f32 (common.py:54), as the plain versions do; only the summation order
# differs, which stays inside 1e-5 of the sum of the terms' magnitudes
# (|grad| @ |rhs|^T, |lhs|^T @ |grad|)
REL_OF_MAG = 1e-5
# bf16 outputs: both sides round the same f32 value once, so they agree to
# one bf16 step (2^-7 of the value) where the f32 sums straddle a rounding
# boundary
BF16_STEP = 2**-7

CASES = {
    # M, k, n, group sizes
    "ragged-empty-groups": (40, 32, 24, [7, 0, 13, 1, 0, 15]),  # 36 rows: 4 past the groups
    "one-group-odd-M": (37, 16, 40, [0, 0, 37, 0]),
    "single-rows": (12, 24, 16, [1, 1, 0, 1, 9]),
    "last-group-ragged": (48, 16, 32, [16, 16, 13]),  # 45 rows: the last group ends mid-tile
    # the group sizes at the card kernels' tile edges (empty, one row, a row
    # short of and past the 64- and 128-row tiles, three tiles), 64 past
    "tile-edges": (768, 24, 40, [0, 1, 63, 127, 129, 384]),
}


def _inputs(case, dtype, seed=0):
    M, k, n, sizes = CASES[case]
    rng = np.random.default_rng(seed)
    lhs = rng.standard_normal((M, k)).astype(np.float32)
    rhs = rng.standard_normal((len(sizes), k, n)).astype(np.float32)
    grad = rng.standard_normal((M, n)).astype(np.float32)
    return jnp.asarray(lhs, dtype), jnp.asarray(rhs, dtype), grad, sizes


def _jax_vjp(lhs, rhs, grad, sizes):
    tm = math.gcd(lhs.shape[0], 16)

    def f(a, b):
        return megablox_gmm(a, b, jnp.asarray(sizes, jnp.int32), tiling=(tm, 128, 128), interpret=True)

    out, vjp = jax.vjp(f, lhs, rhs)
    assert out.dtype == jnp.float32
    d_lhs, d_rhs = vjp(jnp.asarray(grad))
    return np.asarray(d_lhs.astype(jnp.float32)), np.asarray(d_rhs.astype(jnp.float32)), d_lhs.dtype, d_rhs.dtype


def _port_vjp(lhs, rhs, grad, sizes):
    a = to_torch(lhs).requires_grad_(True)
    b = to_torch(rhs).requires_grad_(True)
    out = gm.gmm(a, b, torch.tensor(sizes, dtype=torch.int32))
    assert out.dtype == torch.float32 and out.grad_fn is not None
    out.backward(torch.from_numpy(grad))
    return a.grad, b.grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_megablox_vjp(case, dtype):
    lhs, rhs, grad, sizes = _inputs(case, dtype)
    used = sum(sizes)
    want_l, want_r, jdt_l, jdt_r = _jax_vjp(lhs, rhs, grad, sizes)
    got_l, got_r = _port_vjp(lhs, rhs, grad, sizes)
    # the output dtypes are the operands', as _gmm_bwd asks for them
    assert got_l.dtype == to_torch(lhs).dtype and got_r.dtype == to_torch(rhs).dtype
    assert str(jdt_l) == dtype and str(jdt_r) == dtype
    l32, r32 = np.asarray(lhs, np.float32), np.asarray(rhs, np.float32)
    mag_l = gm.gmm_bwd_lhs_plain(*(torch.from_numpy(np.abs(x)) for x in (grad, r32)),
                                 torch.tensor(sizes, dtype=torch.int32), torch.float32).numpy()
    mag_r = gm.tgmm_plain(*(torch.from_numpy(np.abs(x)) for x in (l32, grad)),
                          torch.tensor(sizes, dtype=torch.int32), torch.float32).numpy()
    got_l, got_r = got_l.float().numpy(), got_r.float().numpy()
    step = BF16_STEP if dtype == "bfloat16" else 0.0
    for got, want, mag in ((got_l[:used], want_l[:used], mag_l[:used]), (got_r, want_r, mag_r)):
        assert (np.abs(got - want) <= step * np.abs(want) + REL_OF_MAG * mag).all(), np.abs(got - want).max()
    # rows past sum(group_sizes) get exact zeros; an empty group's dRHS too
    assert not got_l[used:].any()
    for g, s in enumerate(sizes):
        if s == 0:
            assert not got_r[g].any() and not want_r[g].any()


def test_rows_past_the_groups_add_nothing():
    """Changing lhs and the cotangent on the rows past sum(group_sizes)
    leaves dRHS and the other rows of dLHS as they were."""
    lhs, rhs, grad, sizes = _inputs("ragged-empty-groups", "float32", seed=1)
    used = sum(sizes)
    base_l, base_r = _port_vjp(lhs, rhs, grad, sizes)
    lhs2, grad2 = np.array(lhs), grad.copy()
    lhs2[used:] = 1e3
    grad2[used:] = -1e3
    got_l, got_r = _port_vjp(jnp.asarray(lhs2), rhs, grad2, sizes)
    assert torch.equal(got_r, base_r) and torch.equal(got_l, base_l)


@pytest.mark.parametrize("which", ["dlhs", "drhs"])
def test_planted_faults_miss_the_tolerance(which):
    """The check above tells a correct backward from three wrong ones: the
    cotangent rounded to bf16 (the split's lo half dropped), a group
    multiplied by the next group's weights, and the transposed operand
    (rhs[g] read as [n, k], the case k == n)."""
    M, k, n, sizes = 32, 16, 16, [10, 0, 12, 10]
    rng = np.random.default_rng(2)
    lhs = torch.from_numpy(rng.standard_normal((M, k)).astype(np.float32))
    rhs = torch.from_numpy(rng.standard_normal((len(sizes), k, n)).astype(np.float32))
    grad = torch.from_numpy(rng.standard_normal((M, n)).astype(np.float32))
    sz = torch.tensor(sizes, dtype=torch.int32)
    if which == "dlhs":
        ref = gm.gmm_bwd_lhs_plain(grad, rhs, sz, torch.float32)
        mag = gm.gmm_bwd_lhs_plain(grad.abs(), rhs.abs(), sz, torch.float32)
        faults = {
            "no lo": gm.gmm_bwd_lhs_plain(grad.bfloat16().float(), rhs, sz, torch.float32),
            "wrong group": gm.gmm_bwd_lhs_plain(grad, rhs.roll(1, 0), sz, torch.float32),
            "transposed": gm.gmm_bwd_lhs_plain(grad, rhs.transpose(1, 2), sz, torch.float32),
        }
    else:
        ref = gm.tgmm_plain(lhs, grad, sz, torch.float32)
        mag = gm.tgmm_plain(lhs.abs(), grad.abs(), sz, torch.float32)
        faults = {
            "no lo": gm.tgmm_plain(lhs, grad.bfloat16().float(), sz, torch.float32),
            "wrong group": gm.tgmm_plain(lhs, grad, sz.roll(1), torch.float32),
            "transposed": gm.tgmm_plain(lhs, grad, sz, torch.float32).transpose(1, 2),
        }
    for name, bad in faults.items():
        assert ((bad - ref).abs() > REL_OF_MAG * mag).any(), name


def test_gradcheck_grouped_matmul():
    """``torch.autograd.gradcheck`` of the Function on the plain path. The
    plain versions compute in f32, so f32 inputs with eps = 1e-2: gmm is
    linear in each operand, so central differences are exact but for f32
    rounding of outputs of O(1) (~1e-7 / eps = 1e-5), inside atol and rtol
    of 1e-3."""
    rng = np.random.default_rng(3)
    lhs = torch.from_numpy(rng.standard_normal((11, 8)).astype(np.float32)).requires_grad_(True)
    rhs = torch.from_numpy(rng.standard_normal((3, 8, 8)).astype(np.float32)).requires_grad_(True)
    sizes = torch.tensor([4, 0, 5], dtype=torch.int32)  # 2 rows past the groups
    with pytest.warns(UserWarning, match="double precision"):
        assert torch.autograd.gradcheck(
            lambda a, b: gm.GroupedMatmul.apply(a, b, sizes, None), (lhs, rhs), eps=1e-2, atol=1e-3, rtol=1e-3
        )


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """A CPU tensor takes the plain version (no launch counted); any device
    other than the CPU or a card raises."""
    before = (gm.gmm_bwd_lhs.launches, gm.tgmm.launches)
    grad = torch.randn(8, 16)
    rhs = torch.randn(2, 8, 16)
    lhs = torch.randn(8, 8)
    sz = torch.tensor([3, 5], dtype=torch.int32)
    assert gm.gmm_bwd_lhs(grad, rhs, sz, out_dtype=torch.bfloat16).dtype == torch.bfloat16
    assert gm.tgmm(lhs, grad, sz, out_dtype=torch.float32).shape == (2, 8, 16)
    assert (gm.gmm_bwd_lhs.launches, gm.tgmm.launches) == before
    meta = [t.to("meta") for t in (grad, rhs, lhs, sz)]
    with pytest.raises(ValueError, match="unsupported device"):
        gm.gmm_bwd_lhs(meta[0], meta[1], meta[3], out_dtype=torch.float32)
    with pytest.raises(ValueError, match="unsupported device"):
        gm.tgmm(meta[2], meta[0], meta[3], out_dtype=torch.float32)


def _bf16(x: np.ndarray) -> np.ndarray:
    """f32 rounded to the nearest bf16 (ties to even), kept in f32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return (((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("which", ["dlhs", "drhs"])
def test_register_split_model_stays_inside_its_limit(which):
    """A numpy model of the card kernels' split of the f32 cotangent, made in
    registers from the staged f32 values (``csrc/gmm.cu`` split2): hi =
    bf16(grad), lo = bf16(grad - hi), the lo and hi products summed exactly
    (float64) group by group over the tile-edge group sizes. What the split
    drops stays under 2^-16 of the terms' magnitudes (|grad| @ |rhs|^T,
    |lhs|^T @ |grad|) on every element; with lo dropped the worst element
    misses that limit by more than 100x."""
    M, k, n, sizes = CASES["tile-edges"]
    rng = np.random.default_rng(5)
    grad = rng.standard_normal((M, n)).astype(np.float32)
    lhs = _bf16(rng.standard_normal((M, k)))  # bf16 operands, exact in f32
    rhs = _bf16(rng.standard_normal((len(sizes), k, n)))
    hi = _bf16(grad)
    lo = _bf16(grad - hi)  # grad - hi is exact in f32
    assert np.array_equal(hi, torch.from_numpy(grad).bfloat16().float().numpy())
    worst, worst_no_lo, a = 0.0, 0.0, 0
    for g, s in enumerate(sizes):
        rows = slice(a, a + s)
        a += s
        if which == "dlhs":
            def prod(x):
                return x[rows].astype(np.float64) @ rhs[g].T.astype(np.float64)
            mag = np.abs(grad[rows]).astype(np.float64) @ np.abs(rhs[g]).T
        else:
            def prod(x):
                return lhs[rows].T.astype(np.float64) @ x[rows].astype(np.float64)
            mag = np.abs(lhs[rows]).T.astype(np.float64) @ np.abs(grad[rows])
        if s == 0:
            continue
        exact = prod(grad)
        split = prod(lo) + prod(hi)
        worst = max(worst, (np.abs(split - exact) / (2**-16 * mag)).max())
        worst_no_lo = max(worst_no_lo, (np.abs(prod(hi) - exact) / (2**-16 * mag)).max())
    assert worst <= 1.0, worst
    assert worst_no_lo > 100.0, worst_no_lo
