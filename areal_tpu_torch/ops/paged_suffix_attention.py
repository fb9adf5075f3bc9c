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
launches`` counts calls that launched the kernel, per mask kind
(``"chain"``, ``"tree"``); ``paged_suffix_attention.splits`` is the last
such call's split count.

The kernel splits the prefix window across blocks (flash-decoding):
``pick_splits`` chooses the count P from shapes alone, split p covers the
window tiles of ``split_tiles``, and with P > 1 a merge combines the splits'
normalised outputs by their log-sum-exp. ``_split_partials_plain`` and
``merge_splits_plain`` are that arithmetic in plain PyTorch.
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
TILE = 64  # the kernel's keys per tile (and query rows per block)
MAX_SPLITS = 16

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "paged_suffix_attention": ([_P] * 13 + [_I] * 12 + [_P], ctypes.c_int),
    "paged_suffix_attention_occupancy": ([_I, _I, _I, _P], ctypes.c_int),
}
_N_SM: dict[int, int] = {}  # device index -> multiprocessors


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pick_splits(S: int, KH: int, B: int, G: int, wp: int, psz: int, n_sm: int) -> int:
    """Splits of the prefix window, from shapes alone (no device read):
    enough blocks for two waves of ``n_sm`` multiprocessors, at most one
    split per window tile and MAX_SPLITS, and no split left without a tile
    of the window."""
    blocks = S * KH * _cdiv(B * G, TILE)
    tiles = _cdiv(wp * psz, TILE)
    if blocks <= 0 or tiles <= 1:
        return 1
    want = min(_cdiv(2 * n_sm, blocks), tiles, MAX_SPLITS)
    return _cdiv(tiles, _cdiv(tiles, want))


def split_tiles(wp: int, psz: int, n_splits: int, split: int) -> tuple[int, int]:
    """The window tiles [lo, hi) split ``split`` of ``n_splits`` covers (the
    kernel's arithmetic); tile t holds window tokens [t * TILE, (t + 1) *
    TILE). A split may cover none."""
    tiles = _cdiv(wp * psz, TILE)
    per = _cdiv(tiles, n_splits)
    lo = min(split * per, tiles)
    return lo, min(lo + per, tiles)


def _gather_window(k_pages, v_pages, layer, page_indices, k_scales, v_scales):
    """The window's pages of one layer as f32 [S, wp * psz, KH, hd] K and V,
    int8 / fp8 values dequantized (x * scale / 127.5)."""
    S, wp = page_indices.shape
    KH, psz = k_pages.shape[1], k_pages.shape[3]
    pt = page_indices.long()

    def gather(pages):  # [KH, S, wp, psz, d] -> [S, W, KH, d]
        g = pages[layer][:, pt].permute(1, 2, 3, 0, 4)
        return g.reshape(S, wp * psz, KH, pages.shape[-1])

    kp, vp = gather(k_pages).float(), gather(v_pages).float()
    if k_scales is not None:
        kp = kp * (gather(k_scales).float() / _MAX_INT8)
        vp = vp * (gather(v_scales).float() / _MAX_INT8)
    return kp, vp


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
    KH = k_pages.shape[1]
    G = H // KH
    kp, vp = _gather_window(k_pages, v_pages, layer, page_indices, k_scales, v_scales)
    W = kp.shape[1]
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


def _split_partials_plain(
    q, k_suffix, v_suffix, k_pages, v_pages, layer, prefix_lens, page_indices, suffix_mask,
    k_scales=None, v_scales=None, *, n_splits: int, split: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One split's part of the kernel's work, in f32: its window tiles of
    the prefix (``split_tiles``) and, for split 0, the suffix. Returns (O
    [S, KH, B * G, hd] normalised by the split's own row sums, lse [S, KH,
    B * G] natural-log log-sum-exp of the scaled logits), rows in the
    kernel's order i * G + g; a row that sees no valid key here has lse =
    -inf and O = 0."""
    S, B, H, hd = q.shape
    KH, psz = k_pages.shape[1], k_pages.shape[3]
    G = H // KH
    wp = page_indices.shape[1]
    kp, vp = _gather_window(k_pages, v_pages, layer, page_indices, k_scales, v_scales)
    W = kp.shape[1]
    lo, hi = split_tiles(wp, psz, n_splits, split)
    t = torch.arange(W, device=q.device)
    in_split = (t >= lo * TILE) & (t < hi * TILE)
    ar = torch.arange(B, device=q.device)
    row_valid = suffix_mask[:, ar, ar]  # [S, B]: the diagonal gate
    in_prefix = in_split[None, :] & (t[None, :] < prefix_lens[:, None])  # [S, W]
    sfx = suffix_mask if split == 0 else torch.zeros_like(suffix_mask)
    mask = torch.cat([row_valid[:, :, None] & in_prefix[:, None, :], sfx], dim=-1)  # [S, B, W + B]
    k_full = torch.cat([kp, k_suffix.float()], dim=1)
    v_full = torch.cat([vp, v_suffix.float()], dim=1)
    qg = q.float().reshape(S, B, KH, G, hd)
    logits = torch.einsum("sbkgd,stkd->skbgt", qg, k_full) * hd**-0.5
    m5 = mask[:, None, :, None, :]  # [S, 1, B, 1, W + B]
    logits = torch.where(m5, logits, -torch.inf)
    lse = torch.logsumexp(logits, dim=-1)  # [S, KH, B, G]; -inf where nothing is valid
    live = torch.isfinite(lse)
    p = torch.where(m5 & live[..., None], torch.exp(logits - torch.where(live, lse, 0.0)[..., None]), 0.0)
    o = torch.einsum("skbgt,stkd->skbgd", p, v_full)
    return o.reshape(S, KH, B * G, hd), lse.reshape(S, KH, B * G)


def merge_splits_plain(o_part: torch.Tensor, lse_part: torch.Tensor, B: int, G: int) -> torch.Tensor:
    """The kernel's merge: P splits' normalised rows (o_part [P, S, KH, B *
    G, hd], lse_part [P, S, KH, B * G]) weighted by exp(lse - max lse) ->
    [S, B, KH * G, hd] f32. A split with lse = -inf is left out (its O is
    not read); a row no split saw gets exact zeros. Rows are (slot, KV head,
    i * G + g) and nothing here knows the mask."""
    P, S, KH, BG, hd = o_part.shape
    mx = lse_part.amax(dim=0)
    live = torch.isfinite(lse_part)
    w = torch.where(live, torch.exp(lse_part - torch.where(torch.isfinite(mx), mx, 0.0)), 0.0)
    acc = (w[..., None] * torch.where(live[..., None], o_part.float(), 0.0)).sum(dim=0)
    wsum = w.sum(dim=0)[..., None]
    o = torch.where(wsum > 0, acc / torch.where(wsum > 0, wsum, 1.0), 0.0)
    return o.reshape(S, KH, B, G, hd).permute(0, 2, 1, 3, 4).reshape(S, B, KH * G, hd)


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
    wp = page_indices.shape[1]
    n_splits = pick_splits(S, KH, B, H // KH, wp, psz, _multiprocessors(q.device))
    out = torch.empty_like(q)
    o_part = lse_part = None
    if n_splits > 1:  # f32 scratch of the splits, merged by the kernel's second launch
        o_part = torch.empty((n_splits, S, KH, B * (H // KH), hd), dtype=torch.float32, device=q.device)
        lse_part = torch.empty((n_splits, S, KH, B * (H // KH)), dtype=torch.float32, device=q.device)
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
        o_part.data_ptr() if o_part is not None else None,
        lse_part.data_ptr() if lse_part is not None else None,
        S,
        B,
        H,
        KH,
        N,
        psz,
        hd,
        wp,
        page_indices.stride(0),
        int(layer),
        _KV_CODES[k_pages.dtype],
        n_splits,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_suffix_attention kernel launch failed (code {rc})")
    paged_suffix_attention.launches[kind] += 1
    paged_suffix_attention.splits = n_splits
    return out


paged_suffix_attention.launches = {k: 0 for k in KINDS}
paged_suffix_attention.splits = 0


def _multiprocessors(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    n = _N_SM.get(idx)
    if n is None:
        n = _N_SM[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return n


def occupancy(hd: int, kv_dtype: torch.dtype, prefill: bool) -> dict[str, int]:
    """The split kernel's registers a thread, dynamic shared memory and
    blocks an SM holds, as the CUDA runtime reports them (needs a card), in
    its prefill configuration (a (slot, KV head) cell of at least 128 rows)
    or its verify one."""
    lib = _build.load("paged_suffix_attention", _SIGNATURES)
    info = (ctypes.c_int * 3)()
    rc = lib.paged_suffix_attention_occupancy(hd, _KV_CODES[kv_dtype], int(prefill), info)
    if rc != 0:
        raise RuntimeError(f"paged_suffix_attention_occupancy failed (code {rc})")
    return {"registers": info[0], "smem_bytes": info[1], "blocks_per_sm": info[2]}


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
