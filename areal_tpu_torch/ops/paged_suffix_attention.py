"""Paged suffix attention: the hand-written CUDA kernel #3 and its plain twin.

``paged_suffix_attention`` has the contract of the TPU kernel
``areal_tpu/ops/paged_suffix_attention.py:paged_suffix_attention``: B suffix
queries per slot (raw q, ``1/sqrt(hd)`` applied inside) attend the slot's
cached prefix through its page table, reading layer ``layer`` of the full
stacked cache ``[n_layers, KH, N, psz, hd]`` (optional narrow f32 scales
``[n_layers, KH, N, psz, 1]`` for int8 / fp8 pages), plus the in-flight
suffix K/V under ``suffix_mask`` [S, B, B]. A row attends the prefix only
when its mask diagonal bit is set; a row with no valid bit outputs exact
zeros. The mask decides the launch: a causal chain is the warm suffix
prefill after a radix hit (``qwen.forward_prefill_paged``), a draft tree's
ancestor mask is speculative verify (``qwen.forward_verify_paged``).

Dispatch is by the device of ``q``: a CPU tensor takes
``paged_suffix_attention_plain``; a CUDA tensor launches
``csrc/paged_suffix_attention.cu`` or raises. ``paged_suffix_attention.
launches`` counts kernel launches per mask kind (``"chain"``, ``"tree"``).
"""

from __future__ import annotations

import ctypes

import torch

from areal_tpu_torch.ops import _build

_MAX_INT8 = 127.5  # the dequant formula of inference/paged_kv.py
_NEG_INF = -1e30
_KV_CODES = {torch.bfloat16: 1, torch.int8: 2, torch.float8_e4m3fn: 3}
_HEAD_DIMS = (64, 128)
KINDS = ("chain", "tree")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"paged_suffix_attention": ([_P] * 11 + [_I] * 11 + [_P], ctypes.c_int)}


def paged_suffix_attention_plain(
    q: torch.Tensor,  # [S, B, H, hd] raw
    k_suffix: torch.Tensor,  # [S, B, KH, hd]
    v_suffix: torch.Tensor,
    k_pages: torch.Tensor,  # [n_layers, KH, N, psz, hd]
    v_pages: torch.Tensor,
    layer: int,
    prefix_lens: torch.Tensor,  # [S]
    page_indices: torch.Tensor,  # [S, wp]
    suffix_mask: torch.Tensor,  # [S, B, B] bool
    k_scales: torch.Tensor | None = None,  # [n_layers, KH, N, psz, 1]
    v_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Gather the window's pages, then a grouped einsum in f32 — the twin of
    ``paged_suffix_attention_xla`` (``paged_suffix_attention.py:395``): the
    prefix gated by the mask diagonal, zero output on rows with no valid
    bit, the result cast to q's dtype."""
    S, B, H, hd = q.shape
    KH, psz = k_pages.shape[1], k_pages.shape[3]
    G = H // KH
    wp = page_indices.shape[1]
    W = wp * psz
    pt = page_indices.long()

    def gather(pages):  # [KH, S, wp, psz, d] -> [S, W, KH, d]
        g = pages[layer][:, pt].permute(1, 2, 3, 0, 4)
        return g.reshape(S, W, KH, pages.shape[-1])

    kp, vp = gather(k_pages).float(), gather(v_pages).float()
    if k_scales is not None:
        kp = kp * (gather(k_scales).float() / _MAX_INT8)
        vp = vp * (gather(v_scales).float() / _MAX_INT8)
    k_full = torch.cat([kp, k_suffix.float()], dim=1)  # [S, W + B, KH, hd]
    v_full = torch.cat([vp, v_suffix.float()], dim=1)
    ar = torch.arange(B, device=q.device)
    row_valid = suffix_mask[:, ar, ar]  # [S, B]: the diagonal
    in_prefix = torch.arange(W, device=q.device)[None, :] < prefix_lens[:, None]  # [S, W]
    mask = torch.cat([row_valid[:, :, None] & in_prefix[:, None, :], suffix_mask], dim=-1)
    qg = q.float().reshape(S, B, KH, G, hd)
    logits = torch.einsum("sbkgd,stkd->skgbt", qg, k_full) * hd**-0.5
    m4 = mask[:, None, None]  # [S, 1, 1, B, W + B]
    logits = torch.where(m4, logits, _NEG_INF)
    mx = logits.amax(dim=-1, keepdim=True)
    p = torch.where(m4, torch.exp(logits - mx), 0.0)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("skgbt,stkd->sbkgd", p / denom, v_full)
    return o.reshape(S, B, H, hd).to(q.dtype)


def paged_suffix_attention(
    q: torch.Tensor,
    k_suffix: torch.Tensor,
    v_suffix: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    layer: int,
    prefix_lens: torch.Tensor,  # [S] int32 on CUDA
    page_indices: torch.Tensor,  # [S, wp] int32 on CUDA (row stride may exceed wp)
    suffix_mask: torch.Tensor,
    *,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    kind: str = "chain",
) -> torch.Tensor:
    """Suffix queries over paged prefix + masked in-flight suffix ->
    [S, B, H, hd] in q's dtype. ``kind`` names the mask ("chain" or "tree")
    for the launch count only; the kernel reads whatever mask it gets."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales go together")
    if q.device.type == "cpu":
        return paged_suffix_attention_plain(
            q, k_suffix, v_suffix, k_pages, v_pages, layer, prefix_lens, page_indices,
            suffix_mask, k_scales, v_scales,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_suffix_attention: unsupported device {q.device}")
    q, k_suffix, v_suffix = q.contiguous(), k_suffix.contiguous(), v_suffix.contiguous()
    suffix_mask = suffix_mask.contiguous()
    _check_cuda_args(
        q, k_suffix, v_suffix, k_pages, v_pages, layer, prefix_lens, page_indices,
        suffix_mask, k_scales, v_scales,
    )
    S, B, H, hd = q.shape
    _, KH, N, psz, _ = k_pages.shape
    out = torch.empty_like(q)
    lib = _build.load("paged_suffix_attention", _SIGNATURES)
    scaled = k_scales is not None
    rc = lib.paged_suffix_attention(
        q.data_ptr(),
        k_suffix.data_ptr(),
        v_suffix.data_ptr(),
        k_pages.data_ptr(),
        v_pages.data_ptr(),
        k_scales.data_ptr() if scaled else None,
        v_scales.data_ptr() if scaled else None,
        prefix_lens.data_ptr(),
        page_indices.data_ptr(),
        suffix_mask.data_ptr(),
        out.data_ptr(),
        S,
        B,
        H,
        KH,
        N,
        psz,
        hd,
        page_indices.shape[1],
        page_indices.stride(0),
        int(layer),
        _KV_CODES[k_pages.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_suffix_attention kernel launch failed (code {rc})")
    paged_suffix_attention.launches[kind] += 1
    return out


paged_suffix_attention.launches = {k: 0 for k in KINDS}


def _check_cuda_args(
    q, k_suffix, v_suffix, k_pages, v_pages, layer, prefix_lens, page_indices, suffix_mask,
    k_scales, v_scales,
):
    """Refuse what the kernel does not take (it reads raw pointers)."""
    name = "paged_suffix_attention"
    dev = q.device
    tensors = [q, k_suffix, v_suffix, k_pages, v_pages, prefix_lens, page_indices, suffix_mask]
    if k_scales is not None:
        tensors += [k_scales, v_scales]
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [S, B, H, hd], got {tuple(q.shape)}")
    S, B, H, hd = q.shape
    if q.dtype != torch.bfloat16 or k_suffix.dtype != q.dtype or v_suffix.dtype != q.dtype:
        raise TypeError(f"{name}: the kernel takes bf16 q and suffix K/V, got {q.dtype} / {k_suffix.dtype}")
    if k_pages.dtype not in _KV_CODES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"{name}: page dtypes {k_pages.dtype}/{v_pages.dtype} not supported (bf16, int8, fp8)")
    quant = k_pages.dtype in (torch.int8, torch.float8_e4m3fn)
    if quant != (k_scales is not None):
        raise ValueError(f"{name}: scales are required for int8/fp8 pages and only for them")
    if k_pages.dim() != 5 or k_pages.shape != v_pages.shape:
        raise ValueError(f"{name}: pages must be [n_layers, KH, N, psz, hd], got {tuple(k_pages.shape)}")
    L, KH, N, psz, khd = k_pages.shape
    if khd != hd or hd not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} (pages {khd}) not in {_HEAD_DIMS}")
    if H % KH:
        raise ValueError(f"{name}: H={H} not divisible by KH={KH}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"{name}: layer {layer} out of range [0, {L})")
    if tuple(k_suffix.shape) != (S, B, KH, hd) or v_suffix.shape != k_suffix.shape:
        raise ValueError(f"{name}: suffix K/V must be [S, B, KH, hd] = {(S, B, KH, hd)}")
    if suffix_mask.dtype != torch.bool or tuple(suffix_mask.shape) != (S, B, B):
        raise ValueError(f"{name}: suffix_mask must be bool [S, B, B]")
    if quant and (
        k_scales.dtype != torch.float32
        or v_scales.dtype != torch.float32
        or k_scales.shape != k_pages.shape[:-1] + (1,)
        or v_scales.shape != k_scales.shape
        or not k_scales.is_contiguous()
        or not v_scales.is_contiguous()
    ):
        raise ValueError(f"{name}: scales must be contiguous f32 [n_layers, KH, N, psz, 1]")
    if prefix_lens.dtype != torch.int32 or tuple(prefix_lens.shape) != (S,) or not prefix_lens.is_contiguous():
        raise ValueError(f"{name}: prefix_lens must be contiguous int32 [S]")
    if page_indices.dtype != torch.int32 or page_indices.dim() != 2 or page_indices.shape[0] != S:
        raise ValueError(f"{name}: page_indices must be int32 [S, wp]")
    if page_indices.stride(1) != 1:
        raise ValueError(f"{name}: page_indices rows must be contiguous")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError(f"{name}: pages must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_suffix, v_suffix, k_pages, v_pages)):
        raise ValueError(f"{name}: q, suffix K/V and pages must be 16-byte aligned")
    if S > 65535 or KH > 65535:
        raise ValueError(f"{name}: S={S}, KH={KH} exceed the grid's 65535")
