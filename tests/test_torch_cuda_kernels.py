"""The hand-written CUDA kernels against their plain PyTorch versions, on a
card. Marked ``cuda``: skipped where there is no GPU, and free of JAX so it
runs where only the port is installed:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from areal_tpu_torch.inference import paged_kv
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
    [(32, 12, 2, 128, 128, 4), (9, 14, 2, 64, 16, 5), (5, 8, 8, 128, 32, 3)],
    ids=["qwen2.5-1.5b", "qwen2.5-0.5b-heads", "G1"],
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
