"""The hand-written CUDA kernels against their plain PyTorch versions, on a
card. Marked ``cuda``: skipped where there is no GPU, and free of JAX so it
runs where only the port is installed:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py
"""

import math

import pytest
import torch

from areal_tpu_torch.inference import paged_kv
from areal_tpu_torch.ops import paged_attention as pa
from areal_tpu_torch.ops import paged_suffix_attention as psa
from areal_tpu_torch.ops.paged_attention import paged_attention_plain, paged_attention_stacked

# the plain version rounds logits and probabilities to bf16 (as its JAX twin
# does) while the kernel keeps f32: bf16's 2^-8 relative on O(1) outputs,
# with a margin of 5. With f32 queries and pages both sides are f32.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _case(dev, S, H, KH, hd, psz, wp, dtype, quant, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    n_layers, N = 3, S * wp + 1
    lengths = torch.randint(1, wp * psz + 1, (S,), generator=g, dtype=torch.int32)
    lengths[: min(S, 4)] = torch.tensor([1, psz - 1, psz + 1, wp * psz], dtype=torch.int32)[: min(S, 4)]
    perm = torch.randperm(N - 1, generator=g).to(torch.int32) + 1
    pt = torch.zeros((S, wp), dtype=torch.int32)
    for s in range(S):
        need = -(-int(lengths[s]) // psz)
        pt[s, :need] = perm[s * wp : s * wp + need]
    if S > 1:
        pt[1, 0] = pt[0, 0]  # a shared page
    q = torch.randn((S, H, hd), generator=g).to(dtype)
    k = torch.randn((n_layers, KH, N, psz, hd), generator=g).to(dtype)
    v = torch.randn((n_layers, KH, N, psz, hd), generator=g).to(dtype)
    sc = {}
    if quant:
        k, ks = paged_kv.quantize_kv(k, paged_kv.quant_dtype(quant))
        v, vs = paged_kv.quantize_kv(v, paged_kv.quant_dtype(quant))
        sc = dict(k_scales=ks.to(dev), v_scales=vs.to(dev))
    return q.to(dev), k.to(dev), v.to(dev), lengths.to(dev), pt.to(dev), sc


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
@pytest.mark.parametrize(
    "shape",
    [(32, 12, 2, 128, 128, 4), (9, 14, 2, 64, 16, 5), (5, 8, 8, 128, 32, 3), (32, 32, 4, 128, 128, 4)],
    ids=["qwen2.5-1.5b", "qwen2.5-0.5b-heads", "G1", "qwen3-30b-a3b-G8"],
)
def test_kernel_matches_plain(cuda, shape, quant):
    S, H, KH, hd, psz, wp = shape
    q, k, v, lengths, pt, sc = _case(cuda, *shape, torch.bfloat16, quant)
    layer = 2
    before = paged_attention_stacked.launches
    got = paged_attention_stacked(q, k, v, layer, lengths, pt, **sc)
    assert paged_attention_stacked.launches == before + 1
    scl = [sc[n][layer] for n in ("k_scales", "v_scales")] if sc else [None, None]
    want = paged_attention_plain(q, k[layer], v[layer], lengths, pt, *scl)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= TOL[torch.bfloat16]


@pytest.mark.cuda
def test_kernel_f32_and_strided_table(cuda):
    q, k, v, lengths, pt, _ = _case(cuda, 6, 12, 2, 128, 16, 4, torch.float32, None)
    wide = torch.zeros((6, 9), dtype=torch.int32, device=cuda)
    wide[:, :4] = pt  # the engine passes a column slice of a wider table
    got = paged_attention_stacked(q, k, v, 1, lengths, wide[:, :4])
    want = paged_attention_plain(q, k[1], v[1], lengths, pt)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= TOL[torch.float32]


@pytest.mark.cuda
def test_kernel_zero_length_writes_zeros(cuda):
    q, k, v, lengths, pt, _ = _case(cuda, 4, 12, 2, 128, 16, 2, torch.bfloat16, None)
    lengths[2] = 0
    got = paged_attention_stacked(q, k, v, 0, lengths, pt)
    torch.cuda.synchronize()
    assert torch.count_nonzero(got[2]) == 0


@pytest.mark.cuda
def test_kernel_refuses_bad_arguments(cuda):
    q, k, v, lengths, pt, _ = _case(cuda, 4, 12, 2, 128, 16, 2, torch.bfloat16, None)
    with pytest.raises(ValueError):
        paged_attention_stacked(q, k, v, 0, lengths.long(), pt)  # int64 lengths
    with pytest.raises(ValueError):
        paged_attention_stacked(q, k[:, :, :, :, :64], v[:, :, :, :, :64], 0, lengths, pt)
    with pytest.raises(ValueError):
        paged_attention_stacked(q, k.to(torch.int8), v.to(torch.int8), 0, lengths, pt)  # no scales
    q2, k2, v2, l2, pt2, _ = _case(cuda, 4, 12, 2, 128, 10, 2, torch.bfloat16, None)
    with pytest.raises(ValueError, match="multiple of 4"):
        paged_attention_stacked(q2, k2, v2, 0, l2, pt2)


# split-KV of the tensor-core kernel (bf16 q over bf16 / int8 / fp8 pages):
# few slots, so the wrapper splits the 2,048-token window. At S = 6 and G = 6
# that is 16 splits of 2 tiles of 64 tokens; the lengths end in a split's
# first tile (394: split 3 = tokens 384..511), inside its second (484), on a
# split's boundary (512), at 0, 1 and the window's end.
DECODE_SPLIT_CASES = {
    # H, KH, hd, psz, wp, kv, lengths
    "G6-bf16": (12, 2, 128, 128, 16, "bf16", [394, 484, 512, 0, 2048, 1]),
    "G6-int8": (12, 2, 128, 128, 16, "int8", [394, 484, 512, 0, 2048, 1]),
    "G6-fp8": (12, 2, 128, 128, 16, "fp8", [394, 484, 512, 0, 2048, 1]),
    # 11 splits of 3 tiles (192 tokens)
    "G8-bf16": (32, 4, 128, 128, 16, "bf16", [394, 700, 768, 0, 2048, 1]),
    "G8-int8": (32, 4, 128, 128, 16, "int8", [394, 700, 768, 0, 2048, 1]),
    # pages of 16 and 32 tokens: each token row looks its page up
    "G7-hd64-psz16-int8": (14, 2, 64, 16, 128, "int8", [394, 484, 512, 0, 2048, 1]),
    "G7-hd64-psz16-bf16": (14, 2, 64, 16, 128, "bf16", [394, 484, 512, 0, 2048, 1]),
    "G1-psz32-fp8": (8, 8, 128, 32, 64, "fp8", [394, 484, 768, 0, 2048, 1]),
}


def _decode_split_case(dev, H, KH, hd, psz, wp, kv, lens, seed=3):
    """Every slot's whole window on distinct pages (a shared one between
    slots 0 and 1), lengths as given."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    S, n_layers = len(lens), 3
    N = S * wp + 1
    pt = (torch.randperm(N - 1, generator=g).to(torch.int32) + 1)[: S * wp].reshape(S, wp).contiguous()
    pt[1, 0] = pt[0, 0]
    q = torch.randn((S, H, hd), generator=g).to(torch.bfloat16)
    k = torch.randn((n_layers, KH, N, psz, hd), generator=g).to(torch.bfloat16)
    v = torch.randn((n_layers, KH, N, psz, hd), generator=g).to(torch.bfloat16)
    sc = {}
    if kv != "bf16":
        k, ks = paged_kv.quantize_kv(k, paged_kv.quant_dtype(kv))
        v, vs = paged_kv.quantize_kv(v, paged_kv.quant_dtype(kv))
        sc = dict(k_scales=ks.to(dev), v_scales=vs.to(dev))
    lengths = torch.tensor(lens, dtype=torch.int32)
    return q.to(dev), k.to(dev), v.to(dev), lengths.to(dev), pt.to(dev), sc


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DECODE_SPLIT_CASES))
def test_kernel_splits_match_plain(cuda, case):
    H, KH, hd, psz, wp, kv, lens = DECODE_SPLIT_CASES[case]
    q, k, v, lengths, pt, sc = _decode_split_case(cuda, H, KH, hd, psz, wp, kv, lens)
    S = len(lens)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = psa.pick_splits(S, KH, 1, H // KH, wp, psz, n_sm)
    assert n > 1
    spans = [(lo * psa.TILE, hi * psa.TILE) for lo, hi in (psa.split_tiles(wp, psz, n, p) for p in range(n))]
    assert any(x == hi for x in lens for _, hi in spans[:-1])  # on an inner boundary
    assert any(lo < x <= lo + psa.TILE for x in lens for lo, _ in spans[1:])  # in a split's first tile
    assert any(lo + psa.TILE < x < hi for x in lens for lo, hi in spans)  # inside a later tile
    before = paged_attention_stacked.launches
    got = paged_attention_stacked(q, k, v, 1, lengths, pt, **sc)
    again = paged_attention_stacked(q, k, v, 1, lengths, pt, **sc)
    scl = (sc["k_scales"][1], sc["v_scales"][1]) if sc else (None, None)
    kf, vf = (k[1].float(), v[1].float()) if kv == "bf16" else (k[1], v[1])
    want32 = paged_attention_plain(q.float(), kf, vf, lengths, pt, *scl)
    want = paged_attention_plain(q, k[1], v[1], lengths, pt, *scl)
    torch.cuda.synchronize()
    assert paged_attention_stacked.splits == n
    assert paged_attention_stacked.launches == before + 2  # one a call, whatever the splits
    assert torch.equal(got, again)  # a fixed merge order: the same bits
    live = lengths > 0
    assert torch.count_nonzero(got[~live]) == 0  # zero length: exact zeros
    assert (got[live].float() - want[live].float()).abs().max().item() <= TOL[torch.bfloat16]
    _assert_flash_close(got, want32, live)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_kernel_graph_replay_equals_eager(cuda, kv):
    """The split count and scratch come from shapes, so the call captures
    in a CUDA graph; its replay gives the eager call's bits."""
    q, k, v, lengths, pt, sc = _decode_split_case(cuda, 12, 2, 128, 128, 16, kv, [394, 484, 512, 0, 2048, 1])
    eager = paged_attention_stacked(q, k, v, 2, lengths, pt, **sc)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged_attention_stacked(q, k, v, 2, lengths, pt, **sc)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_attention_stacked(q, k, v, 2, lengths, pt, **sc)
    graph.replay()
    torch.cuda.synchronize()
    assert paged_attention_stacked.splits > 1
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_kernel_occupancy(cuda):
    for kv in (torch.bfloat16, torch.int8, torch.float8_e4m3fn):
        for hd in (64, 128):
            occ = pa.occupancy(hd, kv)
            assert 0 < occ["registers"] <= 255 and occ["smem_bytes"] > 0 and occ["blocks_per_sm"] >= 1


# ---------------------------------------------------------------------------
# flash attention: K2 (forward), K3 (dK, dV), K4 (dQ)
# ---------------------------------------------------------------------------

from areal_tpu_torch.ops import attention as fa  # noqa: E402

# bf16 inputs, element by element on valid rows: |kernel - plain| <=
# FLASH_RTOL |plain| + FLASH_ATOL rms(plain). The plain versions keep S, dP
# and every sum in f32 (the backward's rounds P and dS to bf16 where the
# kernels feed the tensor cores), leaving the kernels' bf16 output rounding
# (2^-8 relative) and summation order: two bf16 steps relative, and for
# sums that cancel to near zero 2^-5 of the RMS, which the kernels need
# ~1e-2 of and S or dP rounded to bf16 ~1e-1 of (chip_smoke.py's reading)
FLASH_RTOL = 2**-7
FLASH_ATOL = 2**-5


def _assert_flash_close(got, ref, valid):
    g, r = got.float()[valid], ref.float()[valid]
    limit = FLASH_RTOL * r.abs() + FLASH_ATOL * r.pow(2).mean().sqrt()
    excess = ((g - r).abs() / limit).max().item()
    assert excess <= 1.0, f"worst element at {excess:.3f} x the limit"


def _flash_case(dev, G, L, H, hd, layout, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    seg = torch.zeros((G, L), dtype=torch.int32)
    for r, lens in enumerate(layout):
        c = 0
        for j, n in enumerate(lens):
            seg[r, c : c + n] = j + 1
            c += n
    q, k, v, dout = (torch.randn((G, L, H, hd), generator=g).to(torch.bfloat16) for _ in range(4))
    dout = dout * (seg != 0)[:, :, None, None]
    return [t.to(dev) for t in (q, k, v, dout, seg)]


FLASH_SHAPES = {
    "qwen2.5-1.5b-heads": (2, 1024, 12, 128, [[300, 500, 200], [1000]]),
    "ragged-L-hd64": (3, 200, 4, 64, [[130, 5, 1, 40], [200], [17]]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(FLASH_SHAPES))
def test_flash_kernels_match_plain(cuda, shape):
    G, L, H, hd, layout = FLASH_SHAPES[shape]
    q, k, v, dout, seg = _flash_case(cuda, G, L, H, hd, layout)
    n0 = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dkv.launches, fa.flash_attention_bwd_dq.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, seg, with_lse=True)
    ref_out, ref_lse = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float(), seg)
    valid = seg != 0
    torch.cuda.synchronize()
    _assert_flash_close(out, ref_out, valid)
    assert (lse - ref_lse).abs().max().item() <= 1e-3  # f32 row statistics
    assert torch.count_nonzero(out[~valid]) == 0 and torch.count_nonzero(lse[~valid]) == 0
    di = (dout.float() * out.float()).sum(-1)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, seg, dout, lse, di)
    dq = fa.flash_attention_bwd_dq(q, k, v, seg, dout, lse, di)
    want = fa.flash_attention_bwd_plain(q, k, v, seg, dout, lse, di, out_dtype=torch.float32)
    torch.cuda.synchronize()
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == torch.bfloat16
        _assert_flash_close(got, ref, valid)
    n1 = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dkv.launches, fa.flash_attention_bwd_dq.launches)
    assert [b - a for a, b in zip(n0, n1)] == [1, 1, 1]


@pytest.mark.cuda
def test_flash_train_autograd_and_determinism(cuda):
    G, L, H, hd, layout = FLASH_SHAPES["ragged-L-hd64"]
    q, k, v, dout, seg = _flash_case(cuda, G, L, H, hd, layout, seed=1)
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fa.flash_train(*leaves, seg)
        (out.float() * dout.float()).sum().backward()
        grads.append([out.detach()] + [t.grad for t in leaves])
    torch.cuda.synchronize()
    for a, b in zip(*grads):  # a recompute under checkpointing reproduces it
        assert torch.equal(a, b)
    assert torch.equal(fa.flash_fwd(q, k, v, seg), grads[0][0])


@pytest.mark.cuda
def test_flash_kernels_refuse_bad_arguments(cuda):
    q, k, v, _, seg = _flash_case(cuda, 1, 128, 2, 128, [[128]])
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.float(), k.float(), v.float(), seg, with_lse=False)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k, v, seg.long(), with_lse=False)
    q2, k2, v2, _, seg2 = _flash_case(cuda, 1, 128, 2, 96, [[128]])
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q2, k2, v2, seg2, with_lse=False)


def _flash_seg_case(dev, seg, H, hd, seed=0):
    """bf16 q, k, v, dO [G, L, H, hd] (dO zero on padding rows) for explicit
    segment ids [G, L]."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    seg = torch.as_tensor(seg, dtype=torch.int32)
    G, L = seg.shape
    q, k, v, dout = (torch.randn((G, L, H, hd), generator=g).to(torch.bfloat16) for _ in range(4))
    dout = dout * (seg != 0)[:, :, None, None]
    return [t.to(dev) for t in (q, k, v, dout, seg)]


def _check_fwd_bwd(q, k, v, dout, seg, backward=True):
    """K2 against its plain version (O element by element, lse to 1e-3,
    exact zeros on padding rows), then K3 and K4 against theirs on K2's
    lse."""
    out, lse = fa.flash_attention_fwd(q, k, v, seg, with_lse=True)
    ref_out, ref_lse = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float(), seg)
    valid = seg != 0
    torch.cuda.synchronize()
    _assert_flash_close(out, ref_out, valid)
    assert (lse - ref_lse)[valid].abs().max().item() <= 1e-3
    assert torch.count_nonzero(out[~valid]) == 0 and torch.count_nonzero(lse[~valid]) == 0
    del ref_out, ref_lse
    if backward:
        di = (dout.float() * out.float()).sum(-1)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, seg, dout, lse, di)
        dq = fa.flash_attention_bwd_dq(q, k, v, seg, dout, lse, di)
        want = fa.flash_attention_bwd_plain(q, k, v, seg, dout, lse, di, out_dtype=torch.float32)
        torch.cuda.synchronize()
        for got, ref in zip((dq, dk, dv), want):
            _assert_flash_close(got, ref, valid)
    return out, lse


def _segment_row(L, runs):
    """One grid row of segment ids from (id, length) runs, padded with 0."""
    row = [i for i, n in runs for _ in range(n)]
    return row + [0] * (L - len(row))


@pytest.mark.cuda
def test_flash_fwd_long_row(cuda):
    """K2 over one row of 8,192 tokens (segments of 5,000 and 3,192): 128
    KV tiles for the last query tile, most of them interior."""
    L = 8192
    q, k, v, dout, seg = _flash_seg_case(cuda, [_segment_row(L, [(1, 5000), (2, 3192)])], 2, 128, seed=2)
    _check_fwd_bwd(q, k, v, dout, seg, backward=False)


@pytest.mark.cuda
def test_flash_bwd_long_row(cuda):
    """K3 and K4 over the same row of 8,192 tokens as the forward's test
    (segments of 5,000 and 3,192): 128 query tiles a KV tile for K3, 128 KV
    tiles a query tile for K4, most pairs interior."""
    L = 8192
    q, k, v, dout, seg = _flash_seg_case(cuda, [_segment_row(L, [(1, 5000), (2, 3192)])], 2, 128, seed=2)
    _check_fwd_bwd(q, k, v, dout, seg, backward=True)


def _bwd_kernels(q, k, v, dout, seg, lse, di):
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, seg, dout, lse, di)
    return fa.flash_attention_bwd_dq(q, k, v, seg, dout, lse, di), dk, dv


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_bwd_tile_pair_kinds(cuda, hd):
    """Grids whose tile pairs are of all three kinds (interior, partial,
    skipped: long segments, boundaries inside and between tiles, a padded
    tail, a row of single-token segments), dq, dk, dv against the plain
    backward at both head dims."""
    L = 640
    rows = [
        _segment_row(L, [(1, 300), (2, 256), (3, 40)]),
        _segment_row(L, [(7, 64), (8, 64), (7, 128), (9, 384)]),
        _segment_row(L, [(j + 1, 1) for j in range(100)] + [(200, 400)]),
    ]
    q, k, v, dout, seg = _flash_seg_case(cuda, rows, 3, hd, seed=7)
    kinds = {kind for *_, kind in fa.fwd_tile_pairs(seg)}
    assert kinds == {"interior", "partial", "skipped"}
    _check_fwd_bwd(q, k, v, dout, seg)


@pytest.mark.cuda
def test_flash_bwd_bits_repeat_and_replay(cuda):
    """K3 and K4 give the same bits on a second call and when captured in a
    CUDA graph and replayed (no atomics, no host state read at replay)."""
    G, L, H, hd, layout = FLASH_SHAPES["qwen2.5-1.5b-heads"]
    q, k, v, dout, seg = _flash_case(cuda, G, L, H, hd, layout, seed=8)
    out, lse = fa.flash_attention_fwd(q, k, v, seg, with_lse=True)
    di = (dout.float() * out.float()).sum(-1)
    eager = _bwd_kernels(q, k, v, dout, seg, lse, di)
    again = _bwd_kernels(q, k, v, dout, seg, lse, di)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _bwd_kernels(q, k, v, dout, seg, lse, di)  # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = _bwd_kernels(q, k, v, dout, seg, lse, di)
    for t in replayed:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for a, b, c in zip(eager, again, replayed):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_flash_bwd_occupancy(cuda):
    for hd in (64, 128):
        for L in (1024, 8192):
            occ = fa.bwd_occupancy(hd, L)
            for kernel in ("dkv", "dq"):
                o = occ[kernel]
                assert 0 < o["registers"] <= 255 and o["smem_bytes"] > 0 and o["blocks_per_sm"] >= 2, (hd, L, occ)


@pytest.mark.cuda
def test_flash_noncontiguous_segment_ids(cuda):
    """A segment id that comes back after another segment's run (and ids that
    are large, negative, unsorted), L not a multiple of 64."""
    L = 1000
    rows = [
        _segment_row(L, [(1, 300), (2, 200), (1, 400)]),
        _segment_row(L, [(5, 64), (-2, 64), (5, 700), (2**31 - 1, 1), (5, 100)]),
    ]
    q, k, v, dout, seg = _flash_seg_case(cuda, rows, 4, 128, seed=3)
    _check_fwd_bwd(q, k, v, dout, seg)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_all_padding_row(cuda, hd):
    """A grid row of padding only writes exact zeros (and lse 0) beside rows
    with single-token segments and a padded tail."""
    L = 320
    rows = [[0] * L, _segment_row(L, [(j + 1, 1) for j in range(70)] + [(100, 200)]), _segment_row(L, [(3, L)])]
    q, k, v, dout, seg = _flash_seg_case(cuda, rows, 3, hd, seed=4)
    _check_fwd_bwd(q, k, v, dout, seg)


@pytest.mark.cuda
def test_flash_fwd_bits_do_not_depend_on_lse_or_call(cuda):
    """O is bit-identical with and without the logsumexp, and from call to
    call (no atomics: a checkpointed recompute reproduces the forward)."""
    G, L, H, hd, layout = FLASH_SHAPES["qwen2.5-1.5b-heads"]
    q, k, v, _, seg = _flash_case(cuda, G, L, H, hd, layout, seed=5)
    a, lse_a = fa.flash_attention_fwd(q, k, v, seg, with_lse=True)
    b, lse_b = fa.flash_attention_fwd(q, k, v, seg, with_lse=True)
    c, none = fa.flash_attention_fwd(q, k, v, seg, with_lse=False)
    torch.cuda.synchronize()
    assert none is None
    assert torch.equal(a, b) and torch.equal(lse_a, lse_b) and torch.equal(a, c)


@pytest.mark.cuda
def test_flash_fwd_in_a_cuda_graph(cuda):
    """The same call captured in a CUDA graph and replayed gives the eager
    call's output (the launch reads no host state at replay)."""
    G, L, H, hd, layout = FLASH_SHAPES["ragged-L-hd64"]
    q, k, v, _, seg = _flash_case(cuda, G, L, H, hd, layout, seed=6)
    eager, eager_lse = fa.flash_attention_fwd(q, k, v, seg, with_lse=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fa.flash_attention_fwd(q, k, v, seg, with_lse=True)  # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, lse = fa.flash_attention_fwd(q, k, v, seg, with_lse=True)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager) and torch.equal(lse, eager_lse)


@pytest.mark.cuda
def test_flash_fwd_occupancy(cuda):
    for hd in (64, 128):
        for L in (1024, 8192):
            occ = fa.occupancy(hd, L)
            assert 0 < occ["registers"] <= 255 and occ["smem_bytes"] > 0 and occ["blocks_per_sm"] >= 2


# ---------------------------------------------------------------------------
# kernel #3: paged suffix attention (chain mask = warm prefill, tree mask =
# speculative verify)
# ---------------------------------------------------------------------------


def _suffix_case(dev, S, B, H, KH, hd, psz, wp, kv, kind, seed=0, plens=None):
    """Ragged prefixes (0, a partial page, full windows; or ``plens``),
    shared pages, and a chain mask with padded rows or random draft trees."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n_layers, N = 3, S * wp + 1
    if plens is None:
        plens = torch.randint(0, wp * psz + 1, (S,), generator=g, dtype=torch.int32)
        plens[: min(S, 3)] = torch.tensor([0, psz + 3, wp * psz], dtype=torch.int32)[: min(S, 3)]
    else:
        plens = torch.tensor(plens, dtype=torch.int32)
    perm = torch.randperm(N - 1, generator=g).to(torch.int32) + 1
    pt = torch.zeros((S, wp), dtype=torch.int32)
    for s in range(S):
        need = -(-int(plens[s]) // psz)
        pt[s, :need] = perm[s * wp : s * wp + need]
    if S > 2:
        pt[1, 0] = pt[2, 0]  # a shared page
    if kind == "chain":
        lens = torch.randint(1, B + 1, (S,), generator=g)
        lens[0] = B
        mask = torch.tril(torch.ones((B, B), dtype=torch.bool))[None].repeat(S, 1, 1)
        idx = torch.arange(B)
        mask &= (idx[None, :, None] < lens[:, None, None]) & (idx[None, None, :] < lens[:, None, None])
    else:
        mask = torch.zeros((S, B, B), dtype=torch.bool)
        for s in range(S):
            mask[s, 0, 0] = True
            for j in range(1, B):
                p = int(torch.randint(0, j, (1,), generator=g))
                mask[s, j] = mask[s, p]
                mask[s, j, j] = True
    q = torch.randn((S, B, H, hd), generator=g).to(torch.bfloat16)
    ks, vs = (torch.randn((S, B, KH, hd), generator=g).to(torch.bfloat16) for _ in range(2))
    k = torch.randn((n_layers, KH, N, psz, hd), generator=g).to(torch.bfloat16)
    v = torch.randn((n_layers, KH, N, psz, hd), generator=g).to(torch.bfloat16)
    sc = {}
    if kv != "bf16":
        k, k_s = paged_kv.quantize_kv(k, paged_kv.quant_dtype(kv))
        v, v_s = paged_kv.quantize_kv(v, paged_kv.quant_dtype(kv))
        sc = dict(k_scales=k_s.to(dev), v_scales=v_s.to(dev))
    t = [x.to(dev) for x in (q, ks, vs, k, v, plens, pt, mask)]
    return t, sc


SUFFIX_SHAPES = {
    # S, B, H, KH, hd, psz, wp
    "warm-prefill-qwen2.5-1.5b": (4, 150, 12, 2, 128, 128, 8),
    "verify-chain-B5": (32, 5, 12, 2, 128, 128, 16),
    "verify-tree-B9": (32, 9, 12, 2, 128, 128, 16),
    "small-pages-hd64-G1": (5, 70, 4, 4, 64, 16, 9),
    # Qwen3-30B-A3B's heads: G = 32 / 4 = 8
    "warm-prefill-qwen3-30b-a3b-G8": (4, 150, 32, 4, 128, 128, 8),
    "verify-tree-B9-G8": (32, 9, 32, 4, 128, 128, 16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("shape", list(SUFFIX_SHAPES))
def test_suffix_kernel_matches_plain(cuda, shape, kv):
    S, B, H, KH, hd, psz, wp = SUFFIX_SHAPES[shape]
    kind = "tree" if "tree" in shape else "chain"
    (q, ks, vs, k, v, plens, pt, mask), sc = _suffix_case(cuda, S, B, H, KH, hd, psz, wp, kv, kind)
    layer = 2
    before = dict(psa.paged_suffix_attention.launches)
    got = psa.paged_suffix_attention(q, ks, vs, k, v, layer, plens, pt, mask, kind=kind, **sc)
    want = psa.paged_suffix_attention_plain(
        q, ks, vs, k, v, layer, plens, pt, mask, sc.get("k_scales"), sc.get("v_scales")
    )
    torch.cuda.synchronize()
    assert psa.paged_suffix_attention.launches[kind] == before[kind] + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    live = mask.any(-1)  # [S, B]
    assert torch.count_nonzero(got[~live]) == 0  # rows with no valid bit: exact zeros
    _assert_flash_close(got, want, live)


@pytest.mark.cuda
def test_suffix_kernel_reads_a_column_slice_of_the_page_table(cuda):
    (q, ks, vs, k, v, plens, pt, mask), _ = _suffix_case(cuda, 6, 9, 12, 2, 128, 16, 4, "bf16", "tree")
    wide = torch.zeros((6, 11), dtype=torch.int32, device=cuda)
    wide[:, :4] = pt  # the engine passes a column slice of a wider table
    got = psa.paged_suffix_attention(q, ks, vs, k, v, 0, plens, wide[:, :4], mask, kind="tree")
    want = psa.paged_suffix_attention_plain(q, ks, vs, k, v, 0, plens, pt, mask)
    torch.cuda.synchronize()
    _assert_flash_close(got, want, mask.any(-1))


# split-KV: few blocks, so the wrapper splits the 2,048-token window. At
# S = 6, B * G <= 64 that is 16 splits of 2 tiles of 64 tokens; the prefixes
# end in a split's first tile (394: split 3 = tokens 384..511), inside its
# second (484), on a split's boundary (512), at 0, 1 and the full window.
# At G = 8, B = 9 (two row tiles) it is 6 splits of 6 tiles (384 tokens).
SPLIT_PLENS = [394, 484, 512, 0, 2048, 1]
SPLIT_CASES = {
    # B, H, KH, hd, psz, wp, kv, kind, prefixes
    "tree-B9-bf16": (9, 12, 2, 128, 128, 16, "bf16", "tree", SPLIT_PLENS),
    "chain-B5-rows30-bf16": (5, 12, 2, 128, 128, 16, "bf16", "chain", SPLIT_PLENS),
    "tree-B9-int8": (9, 12, 2, 128, 128, 16, "int8", "tree", SPLIT_PLENS),
    "tree-B9-fp8": (9, 12, 2, 128, 128, 16, "fp8", "tree", SPLIT_PLENS),
    "hd64-psz16-rows18": (9, 4, 2, 64, 16, 128, "bf16", "tree", SPLIT_PLENS),
    "G8-two-row-tiles": (9, 32, 4, 128, 128, 16, "bf16", "chain", [394, 700, 768, 0, 2048, 1]),
    # 150 and 140 rows: the kernel's prefill configuration (cells of >= 128 rows)
    "rows150-prefill-config": (25, 12, 2, 128, 128, 16, "bf16", "chain", [300, 450, 512, 0, 2048, 1]),
    "hd64-rows140-prefill-config": (70, 4, 2, 64, 16, 128, "bf16", "tree", [300, 450, 512, 0, 2048, 1]),
    # B a multiple of 16: the mask read 16 bytes a thread
    "chain-B128-prefill-16B-mask": (128, 12, 2, 128, 128, 16, "bf16", "chain", [1030, 1500, 1024, 0, 2048, 1]),
    "tree-B16-16B-mask": (16, 12, 2, 128, 128, 16, "int8", "tree", [394, 500, 576, 0, 2048, 1]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_suffix_kernel_splits_match_plain(cuda, case):
    B, H, KH, hd, psz, wp, kv, kind, lens = SPLIT_CASES[case]
    S = len(lens)
    (q, ks, vs, k, v, plens, pt, mask), sc = _suffix_case(
        cuda, S, B, H, KH, hd, psz, wp, kv, kind, seed=3, plens=lens)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = psa.pick_splits(S, KH, B, H // KH, wp, psz, n_sm)
    assert n > 1
    spans = [(lo * psa.TILE, hi * psa.TILE) for lo, hi in (psa.split_tiles(wp, psz, n, p) for p in range(n))]
    assert any(x == hi for x in lens for _, hi in spans[:-1])  # on an inner boundary
    assert any(lo < x <= lo + psa.TILE for x in lens for lo, _ in spans[1:])  # in a split's first tile
    assert any(lo + psa.TILE < x < hi for x in lens for lo, hi in spans)  # inside a later tile
    before = dict(psa.paged_suffix_attention.launches)
    got = psa.paged_suffix_attention(q, ks, vs, k, v, 1, plens, pt, mask, kind=kind, **sc)
    again = psa.paged_suffix_attention(q, ks, vs, k, v, 1, plens, pt, mask, kind=kind, **sc)
    want = psa.paged_suffix_attention_plain(q, ks, vs, k, v, 1, plens, pt, mask, sc.get("k_scales"), sc.get("v_scales"))
    torch.cuda.synchronize()
    assert psa.paged_suffix_attention.splits == n
    assert psa.paged_suffix_attention.launches[kind] == before[kind] + 2  # one a call, whatever the splits
    assert torch.equal(got, again)  # a fixed merge order: the same bits
    live = mask.any(-1)
    assert torch.count_nonzero(got[~live]) == 0
    _assert_flash_close(got, want, live)


@pytest.mark.cuda
def test_suffix_kernel_splits_a_column_slice_of_the_page_table(cuda):
    S, B, H, KH, hd, psz, wp = 6, 9, 12, 2, 128, 16, 64
    (q, ks, vs, k, v, plens, pt, mask), _ = _suffix_case(cuda, S, B, H, KH, hd, psz, wp, "bf16", "tree", seed=4)
    wide = torch.zeros((S, wp + 7), dtype=torch.int32, device=cuda)
    wide[:, :wp] = pt
    got = psa.paged_suffix_attention(q, ks, vs, k, v, 0, plens, wide[:, :wp], mask, kind="tree")
    want = psa.paged_suffix_attention_plain(q, ks, vs, k, v, 0, plens, pt, mask)
    torch.cuda.synchronize()
    assert psa.paged_suffix_attention.splits > 1
    _assert_flash_close(got, want, mask.any(-1))


@pytest.mark.cuda
def test_suffix_kernel_refuses_bad_arguments(cuda):
    (q, ks, vs, k, v, plens, pt, mask), _ = _suffix_case(cuda, 4, 5, 12, 2, 128, 16, 2, "bf16", "chain")
    with pytest.raises(TypeError):
        psa.paged_suffix_attention(q.float(), ks.float(), vs.float(), k, v, 0, plens, pt, mask)
    with pytest.raises(ValueError):
        psa.paged_suffix_attention(q, ks, vs, k, v, 0, plens.long(), pt, mask)
    with pytest.raises(ValueError):
        psa.paged_suffix_attention(q, ks, vs, k, v, 0, plens, pt, mask.int())
    with pytest.raises(ValueError):
        psa.paged_suffix_attention(q, ks, vs, k.to(torch.int8), v.to(torch.int8), 0, plens, pt, mask)
    with pytest.raises(ValueError):
        psa.paged_suffix_attention(q, ks, vs, k, v, 3, plens, pt, mask)  # 3 layers: 0..2


# ---------------------------------------------------------------------------
# tree attention: #4 (forward), #5 (dQ), #6 (dK, dV)
# ---------------------------------------------------------------------------

import numpy as np  # noqa: E402

from areal_tpu_torch.models.tree import build_tree  # noqa: E402
from areal_tpu_torch.ops import tree_attention as ta  # noqa: E402


def _tree_case(dev, groups, H, KH, hd, seed=0):
    """A forest of GRPO-like groups (prompt length, samples, branch length)
    with branches forking again at random depths, packed to ancestor bits;
    bf16 q and dO [N, H, hd], K/V repeated from KH heads, dO zero on padded
    rows."""
    rng = np.random.default_rng(seed)
    seqs = []
    for plen, n, blen in groups:
        prompt = rng.integers(0, 1000, plen).tolist()
        for _ in range(n):
            seqs.append(prompt + rng.integers(0, 1000, blen).tolist())
            cut = int(rng.integers(plen, plen + blen))
            seqs.append(seqs[-1][:cut] + rng.integers(0, 1000, 20).tolist())
    return _tree_tensors(dev, seqs, H, KH, hd, seed=seed)


def _tree_tensors(dev, seqs, H, KH, hd, n_pad=None, seed=0):
    """The trie of ``seqs`` packed to ancestor bits over ``n_pad`` rows (the
    next multiple of 128 by default); bf16 q and dO [N, H, hd], K/V repeated
    from KH heads, dO zero on padded rows."""
    pack = build_tree(seqs)
    words, block_any = ta.pack_ancestor_bits(pack.parent, n_pad)
    N = words.shape[0]
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, dout = (torch.randn((N, H, hd), generator=g).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((N, KH, hd), generator=g).to(torch.bfloat16).repeat_interleave(H // KH, dim=1)
            for _ in range(2))
    valid = torch.zeros(N, dtype=torch.bool)
    valid[: pack.n_nodes] = True
    dout = dout * valid[:, None, None]
    t = [x.to(dev) for x in (q, k, v, dout, torch.from_numpy(words.view(np.int32)),
                             torch.from_numpy(block_any), valid)]
    return t


TREE_SHAPES = {
    "qwen2.5-1.5b-heads": (((445, 2, 128), (349, 2, 128)), 12, 2, 128),
    "deep-hd64": (((60, 3, 100), (200, 1, 30)), 4, 4, 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(TREE_SHAPES))
def test_tree_kernels_match_plain(cuda, shape):
    groups, H, KH, hd = TREE_SHAPES[shape]
    q, k, v, dout, words, block_any, valid = _tree_case(cuda, groups, H, KH, hd)
    kernels = (ta.tree_attention_fwd, ta.tree_attention_bwd_dq, ta.tree_attention_bwd_dkv)
    n0 = [f.launches for f in kernels]
    out, lse = ta.tree_attention_fwd(q, k, v, words, block_any, with_lse=True)
    ref_out, ref_lse = ta.tree_attention_fwd_plain(q.float(), k.float(), v.float(), words, block_any)
    torch.cuda.synchronize()
    _assert_flash_close(out, ref_out, valid)
    assert (lse - ref_lse)[valid].abs().max().item() <= 1e-3  # f32 row statistics
    assert torch.count_nonzero(out[~valid]) == 0 and torch.count_nonzero(lse[~valid]) == 0
    delta = (dout.float() * out.float()).sum(-1)
    dq = ta.tree_attention_bwd_dq(q, k, v, words, block_any, dout, lse, delta)
    dk, dv = ta.tree_attention_bwd_dkv(q, k, v, words, block_any, dout, lse, delta)
    want = ta.tree_attention_bwd_plain(q, k, v, words, block_any, dout, lse, delta, out_dtype=torch.float32)
    torch.cuda.synchronize()
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == torch.bfloat16
        _assert_flash_close(got, ref, valid)
    assert [f.launches - a for f, a in zip(kernels, n0)] == [1, 1, 1]


def _tree_bwd_seqs(kind, rng):
    """Tries for the backward kernels' walk. "chain": one sequence, so
    every pair below the diagonal is full. "straddle": GRPO groups whose
    prompts (100, 70 tokens) and branches end off the 64-row tile edges.
    "partial": 20 disjoint chains of 40 nodes, so no 64-row pair is full.
    "grpo": prompts of 500, 400 and 300 tokens with 4, 4 and 3 branches of
    250-token responses."""
    tok = lambda n: rng.integers(0, 1000, n).tolist()  # noqa: E731
    if kind == "chain":
        return [tok(500)]
    if kind == "straddle":
        return [p + tok(b) for plen, n, b in ((100, 4, 90), (70, 3, 50)) for p in [tok(plen)] for _ in range(n)]
    if kind == "partial":
        return [[1000 + i] + tok(39) for i in range(20)]
    return [p + tok(250) for plen, n in ((500, 4), (400, 4), (300, 3)) for p in [tok(plen)] for _ in range(n)]


# (trie, n_pad or None for the next multiple of 128, H, KH, hd)
TREE_BWD_CASES = {
    "chain-full-N512-hd128": ("chain", 512, 4, 2, 128),
    "straddle-hd64": ("straddle", None, 4, 1, 64),
    "straddle-hd128-padded": ("straddle", 1024, 2, 2, 128),
    "all-partial-hd128": ("partial", None, 2, 1, 128),
    "all-partial-hd64": ("partial", None, 3, 3, 64),
    "grpo-N4096-hd128": ("grpo", 4096, 4, 2, 128),
    "grpo-N4096-hd64": ("grpo", 4096, 2, 1, 64),
}


def _tree_bwd(q, k, v, words, block_any, dout, lse, delta):
    dq = ta.tree_attention_bwd_dq(q, k, v, words, block_any, dout, lse, delta)
    return (dq, *ta.tree_attention_bwd_dkv(q, k, v, words, block_any, dout, lse, delta))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TREE_BWD_CASES))
def test_tree_fwd_kernel_walk_matches_plain(cuda, case):
    """#4 against the plain forward, element by element, on the walk cases
    of #5 / #6: O within the limit, lse within 1e-3, padding rows exact
    zeros, one launch."""
    kind, n_pad, H, KH, hd = TREE_BWD_CASES[case]
    seqs = _tree_bwd_seqs(kind, np.random.default_rng(12))
    q, k, v, _, words, block_any, valid = _tree_tensors(cuda, seqs, H, KH, hd, n_pad=n_pad, seed=12)
    n0 = ta.tree_attention_fwd.launches
    out, lse = ta.tree_attention_fwd(q, k, v, words, block_any, with_lse=True)
    assert ta.tree_attention_fwd.launches - n0 == 1
    ref_out, ref_lse = ta.tree_attention_fwd_plain(q.float(), k.float(), v.float(), words, block_any)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape and lse.shape == q.shape[:2]
    _assert_flash_close(out, ref_out, valid)
    assert (lse - ref_lse)[valid].abs().max().item() <= 1e-3  # f32 row statistics
    assert torch.count_nonzero(out[~valid]) == 0 and torch.count_nonzero(lse[~valid]) == 0


@pytest.mark.cuda
def test_tree_fwd_bits_repeat_and_replay(cuda):
    """#4 gives the same bits of O and lse on a second call and when
    captured in a CUDA graph and replayed, and O's bits do not depend on
    whether lse is written."""
    seqs = _tree_bwd_seqs("grpo", np.random.default_rng(13))
    q, k, v, _, words, block_any, _ = _tree_tensors(cuda, seqs, 4, 2, 128, n_pad=4096, seed=13)

    def fwd():
        out, lse = ta.tree_attention_fwd(q, k, v, words, block_any, with_lse=True)
        return out, lse, ta.tree_attention_fwd(q, k, v, words, block_any, with_lse=False)[0]

    eager, again = fwd(), fwd()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fwd()  # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = fwd()
    for t in replayed:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for a, b, c in zip(eager, again, replayed):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(eager[0], eager[2])


@pytest.mark.cuda
def test_tree_fwd_occupancy(cuda):
    for hd in (64, 128):
        for N in (2048, 8192):
            o = ta.fwd_occupancy(hd, N)  # K2's budget: 3 blocks an SM at hd 128, 4 at hd 64
            assert 0 < o["registers"] <= 255 and o["smem_bytes"] > 0, (hd, N, o)
            assert o["blocks_per_sm"] >= (3 if hd == 128 else 4), (hd, N, o)
            assert o["local_bytes"] >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TREE_BWD_CASES))
def test_tree_bwd_kernels_walk_match_plain(cuda, case):
    """#5 and #6 against the plain backward on #4's lse, element by element,
    on tries whose live 64-row tile pairs are full, straddle tile edges or
    are all partial, at N = 512 .. 4,096, hd 64 and 128, with bit 31 set in
    some words and padding rows whose gradients must be exact zeros."""
    kind, n_pad, H, KH, hd = TREE_BWD_CASES[case]
    seqs = _tree_bwd_seqs(kind, np.random.default_rng(12))
    q, k, v, dout, words, block_any, valid = _tree_tensors(cuda, seqs, H, KH, hd, n_pad=n_pad, seed=12)
    classes = ta.tree_tile_classes(words)
    assert ((words >> 31) & 1).any()
    assert (ta.FULL in classes) == (kind != "partial") and ta.PARTIAL in classes
    if n_pad is not None:
        assert not valid.all()
    out, lse = ta.tree_attention_fwd(q, k, v, words, block_any, with_lse=True)
    delta = (dout.float() * out.float()).sum(-1)
    n0 = [f.launches for f in (ta.tree_attention_bwd_dq, ta.tree_attention_bwd_dkv)]
    grads = _tree_bwd(q, k, v, words, block_any, dout, lse, delta)
    assert [f.launches - a for f, a in zip((ta.tree_attention_bwd_dq, ta.tree_attention_bwd_dkv), n0)] == [1, 1]
    want = ta.tree_attention_bwd_plain(q, k, v, words, block_any, dout, lse, delta, out_dtype=torch.float32)
    torch.cuda.synchronize()
    for got, ref in zip(grads, want):
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        _assert_flash_close(got, ref, valid)
        assert torch.count_nonzero(got[~valid]) == 0


@pytest.mark.cuda
def test_tree_bwd_bits_repeat_and_replay(cuda):
    """#5 and #6 give the same bits on a second call and when captured in a
    CUDA graph and replayed (no atomics, no host state read at replay)."""
    seqs = _tree_bwd_seqs("grpo", np.random.default_rng(13))
    q, k, v, dout, words, block_any, _ = _tree_tensors(cuda, seqs, 4, 2, 128, n_pad=4096, seed=13)
    out, lse = ta.tree_attention_fwd(q, k, v, words, block_any, with_lse=True)
    delta = (dout.float() * out.float()).sum(-1)
    args = (q, k, v, words, block_any, dout, lse, delta)
    eager, again = _tree_bwd(*args), _tree_bwd(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _tree_bwd(*args)  # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = _tree_bwd(*args)
    for t in replayed:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for a, b, c in zip(eager, again, replayed):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_tree_bwd_occupancy(cuda):
    for hd in (64, 128):
        for N in (2048, 8192):
            occ = ta.bwd_occupancy(hd, N)
            for kernel in ("dkv", "dq"):
                o = occ[kernel]
                assert 0 < o["registers"] <= 255 and o["smem_bytes"] > 0 and o["blocks_per_sm"] >= 2, (hd, N, occ)
                assert o["local_bytes"] >= 0


@pytest.mark.cuda
def test_tree_attention_autograd_and_determinism(cuda):
    q, k, v, dout, words, block_any, _ = _tree_case(cuda, *TREE_SHAPES["deep-hd64"][:1], 4, 4, 64, seed=1)
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = ta.tree_attention(*leaves, words, block_any)
        (out.float() * dout.float()).sum().backward()
        grads.append([out.detach()] + [t.grad for t in leaves])
    torch.cuda.synchronize()
    for a, b in zip(*grads):  # a recompute under checkpointing reproduces it
        assert torch.equal(a, b)
    assert torch.equal(ta.tree_attention_fwd(q, k, v, words, block_any, with_lse=False)[0], grads[0][0])


@pytest.mark.cuda
def test_tree_kernels_refuse_bad_arguments(cuda):
    q, k, v, dout, words, block_any, _ = _tree_case(cuda, ((100, 1, 10),), 2, 2, 128)
    with pytest.raises(TypeError):
        ta.tree_attention_fwd(q.float(), k.float(), v.float(), words, block_any, with_lse=False)
    with pytest.raises(ValueError, match="words"):
        ta.tree_attention_fwd(q, k, v, words.long(), block_any, with_lse=False)
    with pytest.raises(ValueError, match="block_any"):
        ta.tree_attention_fwd(q, k, v, words, block_any.t().contiguous()[:, :0], with_lse=False)
    with pytest.raises(ValueError, match="multiple"):
        ta.tree_attention_fwd(q[:64], k[:64], v[:64], words[:64, :2], block_any, with_lse=False)
    with pytest.raises(ValueError, match="head_dim"):
        ta.tree_attention_fwd(q[..., :96].contiguous(), k[..., :96].contiguous(), v[..., :96].contiguous(),
                              words, block_any, with_lse=False)
    lse = torch.zeros(q.shape[:2], device=cuda)
    with pytest.raises(ValueError, match="lse"):
        ta.tree_attention_bwd_dq(q, k, v, words, block_any, dout, lse.t(), lse)


# ---------------------------------------------------------------------------
# the grouped matmul (the dropless MoE FFN's GEMM, in place of megablox gmm)
# ---------------------------------------------------------------------------

from areal_tpu_torch.ops import gmm as gm  # noqa: E402

# kernel vs plain: the same f32 products (bf16 inputs are exact in f32)
# summed in other orders; f32 rounding over k terms stays far inside 2^-20
# of the sum of the terms' magnitudes (a bf16-rounded output misses it by
# ~100x at k = 2048)
GMM_REL = 2**-20


def _routed_sizes(T, E, K, g):
    """Group sizes of T tokens routed top-K by a softmax over E experts."""
    top = torch.topk(torch.softmax(torch.randn((T, E), generator=g), -1), K, dim=-1).indices
    return torch.bincount(top.reshape(-1), minlength=E).to(torch.int32)


GMM_CASES = {
    # M, k, n, group sizes (None: 32 tokens routed top-8 over 128 experts)
    "ragged": (203, 200, 72, [0, 1, 57, 0, 100, 3, 0, 30]),  # 12 rows past the groups
    "one-group": (77, 64, 136, [0, 0, 77, 0]),
    "decode-qwen3-30b-a3b": (256, 2048, 768, None),
}


def _gmm_case(dev, M, k, n, sizes, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    sizes = _routed_sizes(M // 8, 128, 8, g) if sizes is None else torch.tensor(sizes, dtype=torch.int32)
    lhs = torch.randn((M, k), generator=g).to(dtype)
    rhs = torch.randn((len(sizes), k, n), generator=g).to(dtype)
    return lhs.to(dev), rhs.to(dev), sizes.to(dev)


# each instantiation of the forward: bf16 through ``bf16_tile`` (16: the
# roles swapped, 64- and 128-row tiles), f32 through ``tm``
GMM_FWD_TILES = [("bf16", 16), ("bf16", 64), ("bf16", 128), ("f32", 16), ("f32", 32), ("f32", 64)]


def _gmm_fwd(lhs, rhs, sizes, kind, tile):
    if kind == "bf16":
        return gm.gmm(lhs, rhs, sizes, bf16_tile=tile)
    return gm.gmm(lhs.float(), rhs.float(), sizes, tm=tile)


def _assert_gmm_close(got, lhs, rhs, sizes):
    """The limit, and exact zeros past the groups."""
    want = gm.gmm_plain(lhs, rhs, sizes)
    mag = gm.gmm_plain(lhs.float().abs(), rhs.float().abs(), sizes)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    used = int(sizes.sum())
    assert torch.count_nonzero(got[used:]) == 0  # rows past the groups: exact zeros
    assert ((got - want).abs() <= GMM_REL * mag).all(), ((got - want).abs() / mag).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,tm", GMM_FWD_TILES)
@pytest.mark.parametrize("case", list(GMM_CASES))
def test_gmm_kernel_matches_plain(cuda, case, kind, tm):
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    lhs, rhs, sizes = _gmm_case(cuda, *GMM_CASES[case], dtype)
    before = gm.gmm.launches
    got = _gmm_fwd(lhs, rhs, sizes, kind, tm)
    torch.cuda.synchronize()
    assert gm.gmm.launches == before + 1
    _assert_gmm_close(got, lhs, rhs, sizes)


# the forward's tile edges: groups of 0, 1, 7, 8, 9 (the swapped regime's
# second 8-row MMA tile), 15, 16, 17 (its 16-row items), 63, 65, 127, 129
# (the 64- and 128-row tiles) and 384 rows; k and n multiples of 8 but not
# of the 64-wide k step or the 128 output columns a block; 64 rows past the
# groups
GMM_FWD_EDGE_SIZES = [0, 1, 7, 8, 9, 15, 16, 17, 63, 65, 127, 129, 384]
GMM_FWD_EDGE_CASES = {
    "k200-n136": (sum(GMM_FWD_EDGE_SIZES) + 64, 200, 136, GMM_FWD_EDGE_SIZES),
    "k136-n200": (sum(GMM_FWD_EDGE_SIZES) + 64, 136, 200, GMM_FWD_EDGE_SIZES[::-1]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind,tile", GMM_FWD_TILES)
@pytest.mark.parametrize("case", list(GMM_FWD_EDGE_CASES))
def test_gmm_kernel_tile_edges(cuda, case, kind, tile):
    lhs, rhs, sizes = _gmm_case(cuda, *GMM_FWD_EDGE_CASES[case], torch.bfloat16, seed=6)
    assert lhs.shape[0] - int(sizes.sum()) == 64
    got = _gmm_fwd(lhs, rhs, sizes, kind, tile)
    if kind == "f32":
        lhs, rhs = lhs.float(), rhs.float()
    _assert_gmm_close(got, lhs, rhs, sizes)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", gm.BF16_TILES)
def test_gmm_kernel_bits_repeat_and_replay(cuda, tile):
    """Each bf16 regime gives the same bits on a second call and when
    captured in a CUDA graph and replayed (no atomics, no host sync)."""
    lhs, rhs, sizes = _gmm_case(cuda, *GMM_FWD_EDGE_CASES["k200-n136"], torch.bfloat16, seed=7)
    eager = gm.gmm(lhs, rhs, sizes, bf16_tile=tile)
    again = gm.gmm(lhs, rhs, sizes, bf16_tile=tile)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gm.gmm(lhs, rhs, sizes, bf16_tile=tile)  # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = gm.gmm(lhs, rhs, sizes, bf16_tile=tile)
    replayed.fill_(1.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(eager, again) and torch.equal(eager, replayed)


@pytest.mark.cuda
def test_gmm_fwd_occupancy(cuda):
    """The bf16 forward kernels fit two blocks an SM (their launch bounds:
    at most 128 registers a thread) with nothing spilled, and their shared
    memory is what the source lays out: a 4-stage ring of 16 KB weight
    stages with the roles swapped, 3 stages of both operands (24 KB and 32
    KB) on 64- and 128-row tiles."""
    occ = gm.fwd_occupancy()
    for name, o in occ.items():
        assert 0 < o["registers"] <= 128 and o["blocks_per_sm"] >= 2 and o["local_bytes"] == 0, (name, o)
    assert occ["gmm/128"]["smem_bytes"] > occ["gmm/64"]["smem_bytes"] > 48 * 1024
    assert occ["gmm/16"]["smem_bytes"] > 4 * 16 * 1024


@pytest.mark.cuda
def test_gmm_check_catches_planted_faults(cuda):
    """The limit tells the kernel from three wrong forwards at the decode
    shape: a group multiplied by the next expert's weights, a row moved
    across a group boundary, the output rounded to bf16."""
    lhs, rhs, sizes = _gmm_case(cuda, *GMM_CASES["decode-qwen3-30b-a3b"], torch.bfloat16)
    used = int(sizes.sum())
    ref = gm.gmm_plain(lhs, rhs, sizes)[:used]
    mag = gm.gmm_plain(lhs.float().abs(), rhs.float().abs(), sizes)[:used]
    first = int(torch.nonzero(sizes[:-1] > 0)[0])
    moved = sizes.clone()
    moved[first] -= 1
    moved[first + 1] += 1
    faults = {
        "wrong group": gm.gmm_plain(lhs, rhs.roll(1, 0), sizes),
        "row moved": gm.gmm_plain(lhs, rhs, moved),
        "bf16 out": gm.gmm_plain(lhs, rhs, sizes).bfloat16().float(),
    }
    assert ((gm.gmm(lhs, rhs, sizes)[:used] - ref).abs() <= GMM_REL * mag).all()
    for name, bad in faults.items():
        assert ((bad[:used] - ref).abs() > 10 * GMM_REL * mag).any(), name


@pytest.mark.cuda
def test_gmm_kernel_refuses_bad_arguments(cuda):
    lhs, rhs, sizes = _gmm_case(cuda, 64, 32, 16, [10, 20, 30], torch.bfloat16)
    with pytest.raises(TypeError):
        gm.gmm(lhs, rhs.float(), sizes)
    with pytest.raises(ValueError, match="multiples of 8"):
        gm.gmm(lhs[:, :30].contiguous(), rhs[:, :30].contiguous(), sizes)
    with pytest.raises(ValueError, match="int32"):
        gm.gmm(lhs, rhs, sizes.long())
    with pytest.raises(ValueError, match="tm"):
        gm.gmm(lhs, rhs, sizes, tm=8)
    with pytest.raises(ValueError, match="tm"):  # tm sets the f32 path's row tile
        gm.gmm(lhs, rhs, sizes, tm=16)
    with pytest.raises(ValueError, match="not in"):
        gm.gmm(lhs, rhs, sizes, bf16_tile=32)
    with pytest.raises(ValueError, match="bf16_tile"):
        gm.gmm(lhs.float(), rhs.float(), sizes, bf16_tile=64)
    with pytest.raises(ValueError, match="aligned"):
        gm.gmm(torch.zeros(64 * 32 + 1, dtype=torch.bfloat16, device=cuda)[1:].view(64, 32), rhs, sizes)
    # the C entry point refuses a row tile its dtype does not have
    out = torch.empty((64, 16), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for dtype, tile in ((1, 32), (0, 128), (2, 16)):
        assert gm._lib().gmm_forward(lhs.data_ptr(), rhs.data_ptr(), sizes.data_ptr(), out.data_ptr(), 64, 32, 16,
                                     3, dtype, tile, stream) == -1
    with pytest.raises(TypeError, match="f32"):
        gm.gmm_bwd_lhs(torch.zeros((64, 16), dtype=torch.bfloat16, device=cuda), rhs, sizes, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="grad"):
        gm.tgmm(lhs, torch.zeros((63, 16), device=cuda), sizes, out_dtype=torch.float32)


# the backward kernels against their plain versions (f32 products of the f32
# cotangent and the widened operand). The kernels split the cotangent into
# bf16 hi + lo halves: what the split drops is at most 2^-16 |grad| an
# element (u = 2^-8, squared), so each element stays inside 2^-14 of the sum
# of the terms' magnitudes, plus f32 rounding of R-term sums in other orders
# (a random walk: sqrt(R) 2^-24 of it).
# bf16 outputs: one bf16 step (2^-7) of the plain value on top.
GMM_BWD_REL = 2**-14

GMM_BWD_CASES = {
    # M, k, n, group sizes (None: M / 8 tokens routed top-8 over 128 experts)
    "ragged": (203, 200, 72, [0, 1, 57, 0, 100, 3, 0, 30]),  # 12 rows past the groups
    "one-group": (77, 64, 136, [0, 0, 77, 0]),
    "train-gate-up": (2048, 2048, 768, None),
    "train-down": (2048, 768, 2048, None),
}


def _gmm_bwd_case(dev, M, k, n, sizes, dtype, seed=0):
    lhs, rhs, sizes = _gmm_case(dev, M, k, n, sizes, dtype, seed)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    grad = torch.randn((M, n), generator=g).to(dev)
    return lhs, rhs, grad, sizes


def _bwd_share(got, ref, mag, reduce_len: int, out_dtype) -> float:
    """Worst element of |got - ref| as a share of its limit."""
    lim = (GMM_BWD_REL + math.sqrt(reduce_len) * 2**-24) * mag
    if out_dtype == torch.bfloat16:
        lim = lim + 2**-7 * ref.abs()
    return ((got.float() - ref).abs() / lim.clamp_min(1e-30)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["out-f32", "out-bf16"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(GMM_BWD_CASES))
def test_gmm_bwd_kernels_match_plain(cuda, case, dtype, out_dtype):
    lhs, rhs, grad, sizes = _gmm_bwd_case(cuda, *GMM_BWD_CASES[case], dtype)
    M, k, n = lhs.shape[0], lhs.shape[1], rhs.shape[2]
    used = int(sizes.sum())
    before = (gm.gmm_bwd_lhs.launches, gm.tgmm.launches)
    for tm in (16, 32, 64):
        d_lhs = gm.gmm_bwd_lhs(grad, rhs, sizes, out_dtype=out_dtype, tm=tm)
        ref = gm.gmm_bwd_lhs_plain(grad, rhs, sizes, torch.float32)
        mag = gm.gmm_bwd_lhs_plain(grad.abs(), rhs.float().abs(), sizes, torch.float32)
        torch.cuda.synchronize()
        assert d_lhs.dtype == out_dtype and d_lhs.shape == (M, k)
        assert torch.count_nonzero(d_lhs[used:]) == 0  # rows past the groups: exact zeros
        assert _bwd_share(d_lhs[:used], ref[:used], mag[:used], n, out_dtype) <= 1.0, tm
    d_rhs = gm.tgmm(lhs, grad, sizes, out_dtype=out_dtype)
    ref = gm.tgmm_plain(lhs, grad, sizes, torch.float32)
    mag = gm.tgmm_plain(lhs.float().abs(), grad.abs(), sizes, torch.float32)
    torch.cuda.synchronize()
    assert (gm.gmm_bwd_lhs.launches, gm.tgmm.launches) == (before[0] + 3, before[1] + 1)
    assert d_rhs.dtype == out_dtype and d_rhs.shape == rhs.shape
    assert _bwd_share(d_rhs, ref, mag, int(sizes.max()), out_dtype) <= 1.0
    assert torch.count_nonzero(d_rhs[sizes == 0]) == 0  # empty groups: zeros


# the bf16 kernels' tile edges: groups of 0, 1, 63, 127, 129 and 384 rows
# (empty, one row, a row short of a 64- and a 128-row tile, a row past one,
# three whole tiles), k and n multiples of 8 but not of 128 (nor of the
# 64-wide reduction step), 64 rows past the groups. 768 rows over 6 groups
# average 128 rows a group: dLHS takes 128-row tiles; 1,472 rows over the
# sizes twice (12 groups) average fewer: 64-row tiles.
GMM_BWD_EDGE_SIZES = [0, 1, 63, 127, 129, 384]
GMM_BWD_EDGE_CASES = {
    "tile-128": (sum(GMM_BWD_EDGE_SIZES) + 64, 200, 136, GMM_BWD_EDGE_SIZES),
    "tile-64": (2 * sum(GMM_BWD_EDGE_SIZES) + 64, 136, 200, GMM_BWD_EDGE_SIZES * 2),
}


def _gmm_bwd_both(lhs, rhs, grad, sizes, out_dtype):
    return (gm.gmm_bwd_lhs(grad, rhs, sizes, out_dtype=out_dtype), gm.tgmm(lhs, grad, sizes, out_dtype=out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["out-f32", "out-bf16"])
@pytest.mark.parametrize("case", list(GMM_BWD_EDGE_CASES))
def test_gmm_bwd_kernels_tile_edges(cuda, case, out_dtype):
    lhs, rhs, grad, sizes = _gmm_bwd_case(cuda, *GMM_BWD_EDGE_CASES[case], torch.bfloat16, seed=4)
    k, n = lhs.shape[1], rhs.shape[2]
    used = int(sizes.sum())
    assert lhs.shape[0] - used == 64
    d_lhs, d_rhs = _gmm_bwd_both(lhs, rhs, grad, sizes, out_dtype)
    ref = gm.gmm_bwd_lhs_plain(grad, rhs, sizes, torch.float32)
    mag = gm.gmm_bwd_lhs_plain(grad.abs(), rhs.float().abs(), sizes, torch.float32)
    torch.cuda.synchronize()
    assert d_lhs.dtype == out_dtype and torch.count_nonzero(d_lhs[used:]) == 0
    assert _bwd_share(d_lhs[:used], ref[:used], mag[:used], n, out_dtype) <= 1.0
    ref = gm.tgmm_plain(lhs, grad, sizes, torch.float32)
    mag = gm.tgmm_plain(lhs.float().abs(), grad.abs(), sizes, torch.float32)
    assert d_rhs.dtype == out_dtype and d_rhs.shape == (sizes.numel(), k, n)
    assert _bwd_share(d_rhs, ref, mag, int(sizes.max()), out_dtype) <= 1.0
    assert torch.count_nonzero(d_rhs[sizes == 0]) == 0  # empty groups: zeros


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GMM_BWD_EDGE_CASES))
def test_gmm_bwd_kernels_bits_repeat_and_replay(cuda, case):
    """Both kernels give the same bits on a second call and when captured in
    a CUDA graph and replayed (no atomics, no host sync)."""
    lhs, rhs, grad, sizes = _gmm_bwd_case(cuda, *GMM_BWD_EDGE_CASES[case], torch.bfloat16, seed=5)
    eager = _gmm_bwd_both(lhs, rhs, grad, sizes, torch.bfloat16)
    again = _gmm_bwd_both(lhs, rhs, grad, sizes, torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _gmm_bwd_both(lhs, rhs, grad, sizes, torch.bfloat16)  # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = _gmm_bwd_both(lhs, rhs, grad, sizes, torch.bfloat16)
    for t in replayed:
        t.fill_(1.0)
    graph.replay()
    torch.cuda.synchronize()
    for a, b, c in zip(eager, again, replayed):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_gmm_bwd_kernels_refuse_bad_arguments(cuda):
    lhs, rhs, grad, sizes = _gmm_bwd_case(cuda, 64, 32, 16, [10, 20, 30], torch.bfloat16)
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="multiples of 8"):
        gm.gmm_bwd_lhs(grad[:, :12].contiguous(), rhs[:, :, :12].contiguous(), sizes, out_dtype=bf)
    with pytest.raises(ValueError, match="multiples of 8"):
        gm.tgmm(lhs[:, :30].contiguous(), grad, sizes, out_dtype=bf)
    with pytest.raises(TypeError, match="not supported"):
        gm.tgmm(lhs, grad, sizes, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="aligned"):
        gm.gmm_bwd_lhs(torch.zeros(64 * 16 + 1, device=cuda)[1:].view(64, 16), rhs, sizes, out_dtype=bf)
    with pytest.raises(ValueError, match="one device"):
        gm.tgmm(lhs, grad, sizes.cpu(), out_dtype=bf)
    with pytest.raises(ValueError, match="tm"):  # tm sets the f32 path's row tile
        gm.gmm_bwd_lhs(grad, rhs.float(), sizes, out_dtype=bf, tm=128)
    many = torch.zeros(513, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="groups"):
        gm.gmm_bwd_lhs(grad, torch.zeros((513, 32, 16), dtype=bf, device=cuda), many, out_dtype=bf)
    # the C entry points refuse what the wrappers would: a row tile the f32
    # path does not have, an unknown dtype code
    out = torch.empty((64, 32), dtype=bf, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    rhs32 = rhs.float()
    assert gm._lib().gmm_bwd_lhs(grad.data_ptr(), rhs32.data_ptr(), sizes.data_ptr(), out.data_ptr(), 64, 32, 16, 3,
                                 0, 1, 8, stream) == -1
    assert gm._lib().tgmm(lhs.data_ptr(), grad.data_ptr(), sizes.data_ptr(), out.data_ptr(), 64, 32, 16, 3, 2, 1,
                          stream) == -1


@pytest.mark.cuda
def test_gmm_bwd_occupancy(cuda):
    """The bf16 kernels fit two blocks an SM (their launch bounds: at most
    128 registers a thread), and their shared memory is what the source lays
    out."""
    occ = gm.bwd_occupancy()
    for name, o in occ.items():
        assert 0 < o["registers"] <= 128 and o["blocks_per_sm"] >= 2, (name, o)
    assert occ["gmm_bwd_lhs/128"]["smem_bytes"] > occ["gmm_bwd_lhs/64"]["smem_bytes"] > 0
    assert occ["tgmm"]["smem_bytes"] > 48 * 1024  # dynamic shared memory past the default limit


@pytest.mark.cuda
def test_gmm_bwd_check_catches_planted_faults(cuda):
    """The limit above tells the kernels from three wrong backwards at a
    training shape: the cotangent's lo half dropped (bf16(grad) only: a
    random walk of 2^-9 errors, several times the limit at its worst
    element), a group multiplied by the next group's weights, and the
    transposed operand (k == n)."""
    lhs, rhs, grad, sizes = _gmm_bwd_case(cuda, 2048, 512, 512, None, torch.bfloat16)
    used = int(sizes.sum())
    ref = gm.gmm_bwd_lhs_plain(grad, rhs, sizes, torch.float32)[:used]
    mag = gm.gmm_bwd_lhs_plain(grad.abs(), rhs.float().abs(), sizes, torch.float32)[:used]
    faults = {
        "no lo": gm.gmm_bwd_lhs_plain(grad.bfloat16().float(), rhs, sizes, torch.float32),
        "wrong group": gm.gmm_bwd_lhs_plain(grad, rhs.roll(1, 0), sizes, torch.float32),
        "transposed": gm.gmm_bwd_lhs_plain(grad, rhs.transpose(1, 2).contiguous(), sizes, torch.float32),
    }
    for name, bad in faults.items():
        assert _bwd_share(bad[:used], ref, mag, 512, torch.float32) > 2.0, name
    ref = gm.tgmm_plain(lhs, grad, sizes, torch.float32)
    mag = gm.tgmm_plain(lhs.float().abs(), grad.abs(), sizes, torch.float32)
    faults = {
        "no lo": gm.tgmm_plain(lhs, grad.bfloat16().float(), sizes, torch.float32),
        "wrong group": gm.tgmm_plain(lhs, grad, sizes.roll(1), torch.float32),
        "transposed": ref.transpose(1, 2),
    }
    for name, bad in faults.items():
        assert _bwd_share(bad, ref, mag, int(sizes.max()), torch.float32) > 2.0, name


@pytest.mark.cuda
def test_grouped_matmul_autograd_and_determinism(cuda):
    """``gmm`` under autograd on the card launches the forward once and each
    backward kernel once, gives the plain backward's gradients, and the same
    bits on a second run (no atomics)."""
    lhs, rhs, grad, sizes = _gmm_bwd_case(cuda, 512, 256, 128, None, torch.bfloat16)
    before = (gm.gmm.launches, gm.gmm_bwd_lhs.launches, gm.tgmm.launches)
    runs = []
    for _ in range(2):
        a, b = lhs.clone().requires_grad_(True), rhs.clone().requires_grad_(True)
        gm.gmm(a, b, sizes).backward(grad)
        runs.append((a.grad, b.grad))
    torch.cuda.synchronize()
    assert (gm.gmm.launches, gm.gmm_bwd_lhs.launches, gm.tgmm.launches) == (
        before[0] + 2, before[1] + 2, before[2] + 2)
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    assert runs[0][0].dtype == torch.bfloat16 and runs[0][1].dtype == torch.bfloat16
    want_l = gm.gmm_bwd_lhs_plain(grad, rhs, sizes, torch.float32)
    mag_l = gm.gmm_bwd_lhs_plain(grad.abs(), rhs.float().abs(), sizes, torch.float32)
    want_r = gm.tgmm_plain(lhs, grad, sizes, torch.float32)
    mag_r = gm.tgmm_plain(lhs.float().abs(), grad.abs(), sizes, torch.float32)
    assert _bwd_share(runs[0][0], want_l, mag_l, 128, torch.bfloat16) <= 1.0
    assert _bwd_share(runs[0][1], want_r, mag_r, int(sizes.max()), torch.bfloat16) <= 1.0


@pytest.mark.cuda
def test_tree_logprobs_are_differentiable_on_the_card(cuda):
    """``tree_forward_logprobs_pallas`` in bf16 on the card carries gradients
    to every parameter, the LM head included (``compute_logits``' f32-output
    product has no derivative, so the gradient path up-casts instead), and
    gives the no-grad logprobs."""
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.models.tree import build_tree

    cfg = qwen.ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=2,
                           num_kv_heads=1, head_dim=128, tie_word_embeddings=False, attention_bias=False)
    model = qwen.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    model.requires_grad_(True)
    g = torch.Generator(device="cpu").manual_seed(1)
    prompt = torch.randint(0, 512, (40,), generator=g).tolist()
    pack = build_tree([prompt + torch.randint(0, 512, (n,), generator=g).tolist() for n in (5, 9, 14)])
    with torch.no_grad():
        ref = ta.tree_forward_logprobs_pallas(model, pack)
    got = ta.tree_forward_logprobs_pallas(model, pack)
    (-got.sum()).backward()
    assert torch.allclose(got.detach(), ref, atol=1e-3)
    assert model.lm_head.grad is not None and model.lm_head.grad.abs().max() > 0
    assert model.layers[0].wq.grad.abs().max() > 0
