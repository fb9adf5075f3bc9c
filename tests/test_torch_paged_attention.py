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
from areal_tpu_torch.ops import _build
from areal_tpu_torch.ops.paged_attention import (
    decode_split_partials_plain,
    paged_attention_plain,
    paged_attention_stacked,
)
from areal_tpu_torch.ops.paged_suffix_attention import TILE, merge_splits_plain, pick_splits, split_tiles

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


# split-KV (the kernel's arithmetic for bf16 q over bf16 / int8 / fp8 pages):
# a 320-token window is 5 tiles of 64, which P = 2 and 3 do not divide and
# P = 7 leaves splits 5 and 6 empty; the lengths are 0, 1, a page, the whole
# window, and ends inside a tile, on a tile's end and in a tile's first row.
SPLIT_PSZ, SPLIT_WP = 16, 20
SPLIT_LENGTHS = [0, 1, SPLIT_PSZ, SPLIT_PSZ * SPLIT_WP, 100, 128, 129, 257]


def _split_inputs(G, kv, seed=3):
    S, KH, hd, psz, wp = len(SPLIT_LENGTHS), 2, 16, SPLIT_PSZ, SPLIT_WP
    rng = np.random.default_rng(seed)
    N = S * wp + 1
    perm = rng.permutation(np.arange(1, N)).astype(np.int32)
    pt = np.zeros((S, wp), np.int32)
    for s in range(S):
        pt[s] = perm[s * wp : (s + 1) * wp]
    pt[2, 0] = pt[3, 0]  # a shared page
    q = torch.from_numpy(rng.standard_normal((S, KH * G, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((KH, N, psz, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((KH, N, psz, hd)).astype(np.float32))
    sc = (None, None)
    if kv == "bf16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    else:
        k, ks = tpk.quantize_kv(k, tpk.quant_dtype(kv))
        v, vs = tpk.quantize_kv(v, tpk.quant_dtype(kv))
        sc = (ks, vs)
    return q, k, v, torch.tensor(SPLIT_LENGTHS, dtype=torch.int32), torch.from_numpy(pt), sc


@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("G", [1, 6, 7, 8])
@pytest.mark.parametrize("n_splits", [1, 2, 3, 5, 7])
def test_split_partials_merge_to_plain(n_splits, G, kv):
    """The kernel's split-KV arithmetic in f32: P splits' partials merged by
    #3's merge at B = 1 are the unsplit plain function to 1e-6 of its
    largest output (the same f32 logits, only the softmax's sums regrouped);
    a zero length gives exact zeros; a split with no token of a slot gives
    lse = -inf and O = 0."""
    q, k, v, lengths, pt, sc = _split_inputs(G, kv)
    S, H, hd = q.shape
    KH = k.shape[0]
    parts = [decode_split_partials_plain(q, k, v, lengths, pt, *sc, n_splits=n_splits, split=p)
             for p in range(n_splits)]
    o_part = torch.stack([o for o, _ in parts])  # [P, S, KH, G, hd]
    lse_part = torch.stack([lse for _, lse in parts])
    assert o_part.shape == (n_splits, S, KH, G, hd) and lse_part.shape == (n_splits, S, KH, G)
    for p in range(n_splits):
        lo, _ = split_tiles(SPLIT_WP, SPLIT_PSZ, n_splits, p)
        empty = lengths <= lo * TILE  # slots whose length ends before this split
        assert torch.isneginf(lse_part[p][empty]).all()
        assert torch.count_nonzero(o_part[p][empty]) == 0
        assert torch.isfinite(lse_part[p][~empty]).all()
    got = merge_splits_plain(o_part, lse_part, 1, G).reshape(S, H, hd)
    # bf16 pages' values in f32 (the plain function would round P to bf16)
    kf, vf = (k.float(), v.float()) if kv == "bf16" else (k, v)
    want = paged_attention_plain(q, kf, vf, lengths, pt, *sc)
    assert want.dtype == torch.float32
    live = lengths > 0
    assert torch.count_nonzero(got[~live]) == 0
    err = (got[live] - want[live]).abs().max().item()
    assert err <= 1e-6 * want[live].abs().max().item(), err


@pytest.mark.parametrize(
    "shape, want",
    [
        ((32, 2, 6, 16, 128), 5),  # chip_smoke.py's kernel phase, Qwen2.5-1.5B heads
        ((32, 4, 8, 16, 128), 3),  # the same for Qwen3-30B-A3B (G = 8)
        ((256, 2, 6, 16, 128), 1),  # 512 blocks already fill two waves
        ((4, 2, 6, 1, 64), 1),  # a one-tile window
        ((2, 2, 6, 64, 16), 16),  # few slots, a long window: MAX_SPLITS
    ],
)
def test_decode_split_count_from_shapes(shape, want):
    """The decode kernel's P, #3's pick_splits at one query row a slot, comes
    from shapes and the SM count alone (never from the lengths, which live
    on the device), and never leaves a split without a tile."""
    S, KH, G, wp, psz = shape
    n = pick_splits(S, KH, 1, G, wp, psz, 132)
    assert n == want
    assert split_tiles(wp, psz, n, n - 1)[0] < -(-wp * psz // TILE)


def test_build_hash_follows_shared_headers(tmp_path, monkeypatch):
    """A library's name hashes its source and every csrc/*.cuh, so an edit
    to a shared header rebuilds the libraries that may include it."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    _, first = _build._target("k")
    assert _build._target("k")[1] == first  # stable
    (tmp_path / "shared.cuh").write_text("// v2\n")
    _, second = _build._target("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new\n")
    assert _build._target("k")[1] not in (first, second)
