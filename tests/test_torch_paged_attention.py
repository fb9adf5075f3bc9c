"""The port's paged decode attention and KV quantization against the JAX
package, on the same numpy inputs.

The JAX Pallas decode kernel (ops/paged_attention_q8.py) does not import on
this jax, so the reference is its XLA twin ``paged_kv.paged_attention_xla``.
The CUDA kernel itself is held against the plain version on a card by
tests/test_torch_cuda_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.inference import paged_kv as jpk
from areal_tpu_torch.inference import paged_kv as tpk
from areal_tpu_torch.ops.paged_attention import paged_attention_plain, paged_attention_stacked

# (S, H, KH, hd, psz, wp): a tiny shape and the Qwen2.5-1.5B head shape (G=6)
SHAPES = [(5, 4, 2, 16, 8, 4), (6, 12, 2, 128, 16, 3)]
N_LAYERS, LAYER = 3, 2  # stacked cache, read at layer > 0
# f32: the same f32 arithmetic summed in another order -> 1e-5.
# bf16: both sides round logits and probabilities to bf16 at the same points,
# but einsum accumulation order differs; bf16 carries 8 significant bits,
# so one bf16 ulp of an O(1) output (2^-7) bounds the difference.
TOL = {"float32": 1e-5, "bfloat16": 2**-7}


def _t(a, dtype=None):
    """numpy / jax array -> torch tensor with the same bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    t = torch.from_numpy(a.copy())
    return t.to(dtype) if dtype is not None else t


def _inputs(S, H, KH, hd, psz, wp, seed=0):
    """Random stacked pages, ragged lengths (1, psz-1, psz, psz+1, full
    window...), distinct pages per slot, trash page 0 past each slot's need,
    and two slots sharing a page."""
    rng = np.random.default_rng(seed)
    N = S * wp + 1
    W = wp * psz
    lengths = np.array(([1, psz - 1, psz, psz + 1, W] * S)[:S], np.int32)
    perm = rng.permutation(np.arange(1, N)).astype(np.int32)
    pt = np.zeros((S, wp), np.int32)
    for s in range(S):
        need = -(-int(lengths[s]) // psz)
        pt[s, :need] = perm[s * wp : s * wp + need]
    pt[1, 0] = pt[0, 0]  # shared page
    shape = (N_LAYERS, KH, N, psz, hd)
    q = rng.standard_normal((S, H, hd)).astype(np.float32)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return q, k, v, lengths, pt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=["tiny", "qwen2.5-1.5b-heads"])
def test_plain_matches_xla(dtype, shape):
    q, k, v, lengths, pt = _inputs(*shape)
    jd = jnp.dtype(dtype)
    want = jpk.paged_attention_xla(
        jnp.asarray(q, jd), jnp.asarray(k[LAYER], jd), jnp.asarray(v[LAYER], jd),
        jnp.asarray(lengths), jnp.asarray(pt),
    )
    td = getattr(torch, dtype)
    got = paged_attention_plain(
        _t(q, td), _t(k[LAYER], td), _t(v[LAYER], td), _t(lengths), _t(pt)
    )
    assert got.dtype == td
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=TOL[dtype], rtol=0
    )


@pytest.mark.parametrize("quant", ["int8", "fp8"])
@pytest.mark.parametrize("shape", SHAPES, ids=["tiny", "qwen2.5-1.5b-heads"])
def test_plain_matches_xla_quantized(quant, shape):
    """int8 / fp8 pages with narrow scales, quantized by each side's own
    quantize_kv (bit-identical, see below); f32 queries, so both dequantize
    to f32 and the 1e-5 f32 tolerance applies."""
    q, k, v, lengths, pt = _inputs(*shape, seed=1)
    jq = jpk.quant_dtype(quant)
    jk, jks = jpk.quantize_kv(jnp.asarray(k[LAYER]), jq)
    jv, jvs = jpk.quantize_kv(jnp.asarray(v[LAYER]), jq)
    want = jpk.paged_attention_xla(
        jnp.asarray(q), jk, jv, jnp.asarray(lengths), jnp.asarray(pt), k_scales=jks, v_scales=jvs
    )
    tq = tpk.quant_dtype(quant)
    tk, tks = tpk.quantize_kv(_t(k[LAYER]), tq)
    tv, tvs = tpk.quantize_kv(_t(v[LAYER]), tq)
    got = paged_attention_plain(_t(q), tk, tv, _t(lengths), _t(pt), tks, tvs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantize_kv_bit_identical(quant):
    rng = np.random.default_rng(2)
    # enough vectors that exact .5 ties and division rounding both occur
    x = (rng.standard_normal((4, 97, 128)) * rng.uniform(0.01, 10, (4, 97, 1))).astype(np.float32)
    x[0, 0] = 0.0  # all-zero vector: the 1e-12 scale floor
    jq, js = jpk.quantize_kv(jnp.asarray(x), jpk.quant_dtype(quant))
    tq, ts = tpk.quantize_kv(torch.from_numpy(x), tpk.quant_dtype(quant))
    assert tq.dtype == tpk.quant_dtype(quant)
    np.testing.assert_array_equal(
        tq.view(torch.uint8).numpy(), np.asarray(jq).view(np.uint8)
    )
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # and the shared dequant formula
    np.testing.assert_array_equal(
        tpk.dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(jpk.dequantize_kv(jq, js, jnp.float32)),
    )


@pytest.mark.parametrize("quant", [None, "int8"])
def test_stacked_wrapper_takes_plain_path_on_cpu(quant):
    q, k, v, lengths, pt = _inputs(*SHAPES[0])
    kk, vv, sc, scl = _t(k), _t(v), {}, (None, None)
    if quant:
        kk, ks = tpk.quantize_kv(kk, torch.int8)
        vv, vs = tpk.quantize_kv(vv, torch.int8)
        sc, scl = dict(k_scales=ks, v_scales=vs), (ks[LAYER], vs[LAYER])
    before = paged_attention_stacked.launches
    got = paged_attention_stacked(_t(q), kk, vv, LAYER, _t(lengths), _t(pt), **sc)
    want = paged_attention_plain(_t(q), kk[LAYER], vv[LAYER], _t(lengths), _t(pt), *scl)
    assert torch.equal(got, want)
    assert paged_attention_stacked.launches == before  # no kernel on the CPU


def test_page_helpers_match_jax():
    assert tpk.n_pages_for_budget(1 << 30, 28, 2, 128, 128, 2) == jpk.n_pages_for_budget(
        1 << 30, 28, 2, 128, 128, 2
    )
    assert tpk.n_pages_for_budget(
        1 << 30, 28, 2, 128, 128, 2, quant="fp8"
    ) == jpk.n_pages_for_budget(1 << 30, 28, 2, 128, 128, 2, quant="fp8")
    pool = tpk.PagePool(4)
    a = pool.alloc(2)
    assert a == [1, 2] and pool.alloc(2) is None
    pool.ref(a[:1])
    pool.free(a)
    assert pool.available == 2 and pool.used == 1
