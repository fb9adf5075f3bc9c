"""Paged decode attention: the hand-written CUDA kernel and its plain twin.

``paged_attention_stacked`` has the contract of the TPU kernel
``areal_tpu/ops/paged_attention_q8.py:paged_attention_stacked``: raw q
(``1/sqrt(hd)`` applied inside), the full stacked cache
``[n_layers, KH, N, psz, hd]`` plus a layer index, optional narrow f32
scales ``[n_layers, KH, N, psz, 1]`` for int8 / fp8 pages. On the TPU the
stacked signature avoided a per-step copy of every layer's pages; here
``k_pages[layer]`` is a view, so the wrapper passes a pointer offset and
copies nothing.

Dispatch is by the device of ``q``: a CPU tensor takes
``paged_attention_plain``; a CUDA tensor launches ``csrc/paged_attention.cu``
or raises. ``paged_attention_stacked.launches`` counts calls that launched
the kernel; ``paged_attention_stacked.splits`` is the last such call's
split count.

For bf16 q over bf16, int8 or fp8 pages the kernel splits the window across
blocks (flash-decoding): #3's ``pick_splits`` at one query row a slot
chooses the count P from shapes alone, split p covers the window tiles of
``split_tiles``, and with P > 1 #3's merge combines the splits'
normalised outputs by their log-sum-exp. ``decode_split_partials_plain``
is one split's arithmetic in plain PyTorch, ``merge_splits_plain`` (at
B = 1) the merge's.
"""

from __future__ import annotations

import ctypes

import torch

from areal_tpu_torch.inference.paged_kv import dequantize_kv
from areal_tpu_torch.ops import _build
from areal_tpu_torch.ops.paged_suffix_attention import TILE, _multiprocessors, pick_splits, split_tiles

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float8_e4m3fn: 3}
_MAX_GROUP = 8  # kMaxG in the kernel
_ROWS = 4  # page_size must be a multiple of 4 (the CUDA-core kernel reads 4 rows a step)
_HEAD_DIMS = (64, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "paged_attention_decode": ([_P] * 8 + [_I] * 11 + [_P] * 3, ctypes.c_int),
    "paged_attention_occupancy": ([_I, _I, _P], ctypes.c_int),
}


def paged_attention_plain(
    q: torch.Tensor,  # [S, H, hd]
    k_pages: torch.Tensor,  # [KH, N, psz, hd] (one layer)
    v_pages: torch.Tensor,
    lengths: torch.Tensor,  # [S] valid rows per slot
    page_table: torch.Tensor,  # [S, wp] page ids covering the window
    k_scales: torch.Tensor | None = None,  # [KH, N, psz, 1] (quantized pages)
    v_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Gather the window's pages, grouped masked einsum — the twin of
    ``areal_tpu/inference/paged_kv.py:paged_attention_xla`` (same -1e30
    mask, fp32 softmax, probabilities cast to the value dtype)."""
    S, H, hd = q.shape
    KH, _, psz, _ = k_pages.shape
    G = H // KH
    wp = page_table.shape[1]
    W = wp * psz
    pt = page_table.long()

    def gather(pages):  # [KH, S, wp, psz, d] -> [S, W, KH, d]
        g = pages[:, pt].permute(1, 2, 3, 0, 4)
        return g.reshape(S, W, KH, pages.shape[-1])

    kk, vv = gather(k_pages), gather(v_pages)
    if k_scales is not None:
        kk = dequantize_kv(kk, gather(k_scales), q.dtype)
        vv = dequantize_kv(vv, gather(v_scales), q.dtype)
    ct = torch.promote_types(q.dtype, kk.dtype)  # jnp.einsum's promotion
    qg = q.reshape(S, KH, G, hd).to(ct)
    logits = torch.einsum("skgd,stkd->skgt", qg, kk.to(ct)).float() * hd**-0.5
    valid = torch.arange(W, device=q.device)[None, :] < lengths[:, None]
    logits = torch.where(valid[:, None, None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(vv.dtype)
    return torch.einsum("skgt,stkd->skgd", probs, vv).reshape(S, H, hd)


def decode_split_partials_plain(
    q: torch.Tensor,  # [S, H, hd]
    k_pages: torch.Tensor,  # [KH, N, psz, hd] (one layer)
    v_pages: torch.Tensor,
    lengths: torch.Tensor,  # [S]
    page_table: torch.Tensor,  # [S, wp]
    k_scales: torch.Tensor | None = None,  # [KH, N, psz, 1]
    v_scales: torch.Tensor | None = None,
    *,
    n_splits: int,
    split: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One split's part of the kernel's work, in f32: the window tokens of
    ``split_tiles(wp, psz, n_splits, split)`` below each slot's length.
    Returns (O [S, KH, G, hd] normalised by the split's own row sums, lse
    [S, KH, G] natural-log log-sum-exp of the scaled logits), rows in the
    kernel's order (slot, KV head, g); a slot with no token here has lse =
    -inf and O = 0. ``merge_splits_plain(o, lse, 1, G)`` over the P splits
    is ``paged_attention_plain`` (exact zeros where the length is 0)."""
    S, H, hd = q.shape
    KH, _, psz, _ = k_pages.shape
    G = H // KH
    wp = page_table.shape[1]
    W = wp * psz
    pt = page_table.long()

    def gather(pages):  # [KH, S, wp, psz, d] -> [S, W, KH, d]
        return pages[:, pt].permute(1, 2, 3, 0, 4).reshape(S, W, KH, pages.shape[-1])

    kk, vv = gather(k_pages).float(), gather(v_pages).float()
    if k_scales is not None:
        kk = dequantize_kv(kk, gather(k_scales), torch.float32)
        vv = dequantize_kv(vv, gather(v_scales), torch.float32)
    lo, hi = split_tiles(wp, psz, n_splits, split)
    t = torch.arange(W, device=q.device)
    valid = (t >= lo * TILE) & (t < hi * TILE) & (t[None, :] < lengths[:, None])  # [S, W]
    logits = torch.einsum("skgd,stkd->skgt", q.float().reshape(S, KH, G, hd), kk) * hd**-0.5
    logits = torch.where(valid[:, None, None, :], logits, -torch.inf)
    lse = torch.logsumexp(logits, dim=-1)  # [S, KH, G]; -inf where nothing is valid
    live = torch.isfinite(lse)
    p = torch.where(live[..., None], torch.exp(logits - torch.where(live, lse, 0.0)[..., None]), 0.0)
    return torch.einsum("skgt,stkd->skgd", p, vv), lse


def paged_attention_stacked(
    q: torch.Tensor,  # [S, H, hd] raw (unscaled)
    k_pages: torch.Tensor,  # [n_layers, KH, N, psz, hd]
    v_pages: torch.Tensor,
    layer: int,
    lengths: torch.Tensor,  # [S] int32
    page_table: torch.Tensor,  # [S, wp] int32 (row stride may exceed wp)
    *,
    k_scales: torch.Tensor | None = None,  # [n_layers, KH, N, psz, 1] f32
    v_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Decode attention of layer ``layer`` of the stacked paged cache.
    Returns [S, H, hd] in q's dtype on CUDA (the plain path returns the
    value dtype, as its twin does)."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales go together")
    if q.device.type == "cpu":
        return paged_attention_plain(
            q,
            k_pages[layer],
            v_pages[layer],
            lengths,
            page_table,
            k_scales[layer] if k_scales is not None else None,
            v_scales[layer] if v_scales is not None else None,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_stacked: unsupported device {q.device}")
    _check_cuda_args(q, k_pages, v_pages, lengths, page_table, k_scales, v_scales)
    S, H, hd = q.shape
    _, KH, N, psz, _ = k_pages.shape
    wp = page_table.shape[1]
    out = torch.empty_like(q)
    n_splits = 1  # f32 q or pages: the CUDA-core kernel, one block a (slot, KV head)
    o_part = lse_part = None
    if q.dtype == torch.bfloat16 and k_pages.dtype != torch.float32:
        n_splits = pick_splits(S, KH, 1, H // KH, wp, psz, _multiprocessors(q.device))  # one row a slot
        if n_splits > 1:  # f32 scratch of the splits, merged by the kernel's second launch
            o_part = torch.empty((n_splits, S, KH, H // KH, hd), dtype=torch.float32, device=q.device)
            lse_part = torch.empty((n_splits, S, KH, H // KH), dtype=torch.float32, device=q.device)
    lib = _build.load("paged_attention", _SIGNATURES)
    scaled = k_scales is not None
    rc = lib.paged_attention_decode(
        q.data_ptr(),
        k_pages[layer].data_ptr(),
        v_pages[layer].data_ptr(),
        k_scales[layer].data_ptr() if scaled else None,
        v_scales[layer].data_ptr() if scaled else None,
        lengths.data_ptr(),
        page_table.data_ptr(),
        out.data_ptr(),
        S,
        H,
        KH,
        N,
        psz,
        hd,
        wp,
        page_table.stride(0),
        _Q_CODES[q.dtype],
        _KV_CODES[k_pages.dtype],
        n_splits,
        o_part.data_ptr() if o_part is not None else None,
        lse_part.data_ptr() if lse_part is not None else None,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed (code {rc})")
    paged_attention_stacked.launches += 1
    paged_attention_stacked.splits = n_splits
    return out


paged_attention_stacked.launches = 0
paged_attention_stacked.splits = 0


def occupancy(hd: int, kv_dtype: torch.dtype) -> dict[str, int]:
    """The tensor-core kernel's registers a thread, dynamic shared memory
    and blocks an SM holds for bf16 q over ``kv_dtype`` pages (bf16, int8,
    fp8), as the CUDA runtime reports them (needs a card)."""
    lib = _build.load("paged_attention", _SIGNATURES)
    info = (ctypes.c_int * 3)()
    rc = lib.paged_attention_occupancy(hd, _KV_CODES[kv_dtype], info)
    if rc != 0:
        raise RuntimeError(f"paged_attention_occupancy failed (code {rc})")
    return {"registers": info[0], "smem_bytes": info[1], "blocks_per_sm": info[2]}


def check_heads(H: int, KH: int, hd: int, psz: int, page_hd: int | None = None) -> None:
    """Refuse the head shapes and page size the kernel does not take; the
    decode engine calls it at start on a card, since the kernel runs at
    every decode step."""
    page_hd = hd if page_hd is None else page_hd
    if page_hd != hd or hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} (pages {page_hd}) not in {_HEAD_DIMS}")
    if H % KH or H // KH > _MAX_GROUP:
        raise ValueError(f"H={H}, KH={KH}: need KH | H and H/KH <= {_MAX_GROUP}")
    if psz % _ROWS:
        raise ValueError(f"page_size {psz} must be a multiple of {_ROWS}")


def _check_cuda_args(q, k_pages, v_pages, lengths, page_table, k_scales, v_scales):
    """Refuse what the kernel does not take (it reads raw pointers)."""
    dev = q.device
    tensors = [q, k_pages, v_pages, lengths, page_table]
    if k_scales is not None:
        tensors += [k_scales, v_scales]
    if any(t.device != dev for t in tensors):
        raise ValueError("paged_attention_stacked: all tensors must be on one device")
    if q.dtype not in _Q_CODES:
        raise TypeError(f"q dtype {q.dtype} not supported (f32 / bf16)")
    if k_pages.dtype not in _KV_CODES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"page dtypes {k_pages.dtype}/{v_pages.dtype} not supported")
    quant = k_pages.dtype in (torch.int8, torch.float8_e4m3fn)
    if quant != (k_scales is not None):
        raise ValueError("scales are required for int8/fp8 pages and only for them")
    S, H, hd = q.shape
    if k_pages.dim() != 5 or k_pages.shape != v_pages.shape:
        raise ValueError(f"pages must be [n_layers, KH, N, psz, hd], got {tuple(k_pages.shape)}")
    _, KH, N, psz, khd = k_pages.shape
    check_heads(H, KH, hd, psz, khd)
    if quant and (
        k_scales.dtype != torch.float32
        or v_scales.dtype != torch.float32
        or k_scales.shape != k_pages.shape[:-1] + (1,)
        or v_scales.shape != k_scales.shape
        or not k_scales.is_contiguous()
        or not v_scales.is_contiguous()
    ):
        raise ValueError("scales must be contiguous f32 [n_layers, KH, N, psz, 1]")
    if lengths.dtype != torch.int32 or lengths.shape != (S,):
        raise ValueError("lengths must be int32 [S]")
    if page_table.dtype != torch.int32 or page_table.dim() != 2 or page_table.shape[0] != S:
        raise ValueError("page_table must be int32 [S, wp]")
    if page_table.stride(1) != 1 or not lengths.is_contiguous():
        raise ValueError("page_table rows and lengths must be contiguous")
    if not (q.is_contiguous() and k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("q and pages must be contiguous")
