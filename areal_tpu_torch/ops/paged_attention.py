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
or raises. ``paged_attention_stacked.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from areal_tpu_torch.inference.paged_kv import dequantize_kv
from areal_tpu_torch.ops import _build

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float8_e4m3fn: 3}
_MAX_GROUP = 8  # kMaxG in the kernel
_ROWS = 4  # kRows in the kernel: rows per step, which page_size must divide into
_HEAD_DIMS = (64, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "paged_attention_decode": (
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        ctypes.c_int,
    )
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
    out = torch.empty_like(q)
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
        page_table.shape[1],
        page_table.stride(0),
        _Q_CODES[q.dtype],
        _KV_CODES[k_pages.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed (code {rc})")
    paged_attention_stacked.launches += 1
    return out


paged_attention_stacked.launches = 0


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
    if khd != hd or hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} (pages {khd}) not in {_HEAD_DIMS}")
    if H % KH or H // KH > _MAX_GROUP:
        raise ValueError(f"H={H}, KH={KH}: need KH | H and H/KH <= {_MAX_GROUP}")
    if psz % _ROWS:
        raise ValueError(f"page_size {psz} must be a multiple of {_ROWS}")
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
