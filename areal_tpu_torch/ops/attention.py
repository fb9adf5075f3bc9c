"""Attention over packed [G, L] grids: the plain masked softmax and the
hand-written flash-attention kernels of ``csrc/flash_attention.cu``.

- ``sdpa_plain`` is the twin of ``areal_tpu/ops/attention.py:sdpa_xla``: the
  masked einsum + softmax that the JAX package leaves to XLA, not a kernel.
  The serving prefill uses it, and so does the trainer with
  ``attn_impl="xla"``.
- ``flash_fwd`` (no-grad forward: the proximal-logprob recompute and the
  eval forward) is the counterpart of ``flash_fwd_pallas``; ``flash_train``
  (the trainer's differentiable attention) is the counterpart of
  ``flash_train``, which reached jax's library ``flash_attention``. They run
  three kernels: K2 ``flash_attention_fwd`` (forward, optionally keeping the
  per-row logsumexp), K3 ``flash_attention_bwd_dkv`` and K4
  ``flash_attention_bwd_dq``.
- ``fwd_tile_pairs`` is the plain twin of the three kernels' tile
  classification (which (query tile, KV tile) pairs they skip, run without
  a mask, or mask); ``occupancy`` and ``bwd_occupancy`` report K2's and
  K3 / K4's resources on the card.

Every entry point takes the model layout [G, L, H, hd] with KV heads already
repeated to H, and segment ids [G, L] (0 = padding). Query row i attends to
key row j when j <= i by column index (positions restart per segment, so
causality is not by rope position), the segments are equal and nonzero.

Dispatch is by the device of ``q``: a CPU tensor takes the plain PyTorch
version of each kernel; a CUDA tensor launches the kernel or raises (no
fallback by length or shape). Each wrapper counts its launches in
``.launches``. Padding rows (segment 0) output zeros and a logsumexp of 0
on both paths; ``sdpa_xla`` instead averages V over them, and jax's library
lets them attend to each other. Callers read valid rows only, and the loss
gives padding rows a zero gradient, so every path agrees where it matters.
"""

from __future__ import annotations

import ctypes

import torch

from areal_tpu_torch.ops import _build

_HEAD_DIMS = (64, 128)  # template instantiations of the kernels
TILE = 64  # query rows and keys per tile of every kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "flash_attention_fwd": ([_P] * 6 + [_I] * 4 + [_P], ctypes.c_int),
    "flash_attention_bwd_dkv": ([_P] * 9 + [_I] * 4 + [_P], ctypes.c_int),
    "flash_attention_bwd_dq": ([_P] * 8 + [_I] * 4 + [_P], ctypes.c_int),
    "flash_attention_fwd_occupancy": ([_I, _I, _P], ctypes.c_int),
    "flash_attention_bwd_occupancy": ([_I, _I, _P], ctypes.c_int),
}


def attention_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """[G, L] segment ids (0 = pad) -> [G, 1, L, L] bool mask, causal by
    column within the same nonzero segment (``models/qwen.py:_attention_mask``
    of the JAX package)."""
    L = segment_ids.shape[-1]
    idx = torch.arange(L, device=segment_ids.device)
    causal = idx[:, None] >= idx[None, :]
    same_seg = segment_ids[:, :, None] == segment_ids[:, None, :]
    not_pad = (segment_ids != 0)[:, :, None]
    return (causal[None] & same_seg & not_pad)[:, None]


def sdpa_plain(q, k, v, mask, head_dim: int):
    """q, k, v: [G, L, H, hd] (KV heads already repeated); mask [G, 1, L, L]
    bool. Masked logits are -1e30 (not -inf), so fully masked rows average
    their window as the JAX twin does."""
    scale = head_dim**-0.5
    logits = torch.einsum("gqhd,gkhd->ghqk", q, k).float() * scale
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("ghqk,gkhd->gqhd", probs, v)


def fwd_tile_pairs(segment_ids: torch.Tensor) -> list[tuple[int, int, int, str]]:
    """K2's classification of every (query tile, KV tile) pair of 64-row
    tiles, which K3 and K4 share (K4 walks a query tile's KV tiles, K3 a KV
    tile's query tiles), as ``(g, query tile, KV tile, kind)`` for each grid
    row g:
    "skipped" (the KV tile lies in the future, or the two tiles' nonzero
    segment-id ranges do not meet), "interior" (both tiles hold one and the
    same nonzero id in every row and the KV tile lies wholly before the
    query tile: the kernel applies no per-element mask) or "partial" (the
    kernel applies ``attention_mask``'s test element by element). Rows past
    L count as padding (segment 0)."""
    seg = segment_ids.detach().to("cpu", torch.int64)
    G, L = seg.shape
    nt = -(-L // TILE)
    tiles = torch.zeros((G, nt * TILE), dtype=torch.int64)
    tiles[:, :L] = seg
    tiles = tiles.reshape(G, nt, TILE)
    nonzero = tiles != 0
    big = torch.iinfo(torch.int64).max
    lo = torch.where(nonzero, tiles, big).amin(-1).tolist()
    hi = torch.where(nonzero, tiles, -big).amax(-1).tolist()
    one = (nonzero.all(-1) & (tiles == tiles[..., :1]).all(-1)).tolist()
    pairs = []
    for g in range(G):
        for qt in range(nt):
            for kt in range(nt):
                if kt > qt or hi[g][qt] < lo[g][kt] or hi[g][kt] < lo[g][qt]:
                    kind = "skipped"
                elif kt < qt and one[g][qt] and one[g][kt] and lo[g][qt] == lo[g][kt]:
                    kind = "interior"
                else:
                    kind = "partial"
                pairs.append((g, qt, kt, kind))
    return pairs


def resolve_impl(requested: str) -> str:
    """The training attention: "pallas" (the flash kernels; their plain
    versions on CPU tensors) or "xla" (``sdpa_plain``). Unlike the JAX
    package, "pallas" never degrades to the plain path by length or device."""
    if requested in ("pallas", "xla"):
        return requested
    if requested == "ring":
        raise NotImplementedError("ring attention (the seq axis): ROADMAP Queue A item 6b-3")
    raise ValueError(f"unknown attn_impl {requested!r} (pallas|xla)")


# ---------------------------------------------------------------------------
# plain versions of the kernels
# ---------------------------------------------------------------------------


def _masked_logits(q, k, mask):
    """Scaled f32 logits [G, H, L, L], masked to -1e30 (as ``sdpa_plain``)."""
    logits = torch.einsum("gqhd,gkhd->ghqk", q, k).float() * q.shape[-1] ** -0.5
    return torch.where(mask, logits, -1e30)


def flash_attention_fwd_plain(q, k, v, segment_ids):
    """K2's plain version: ``sdpa_plain`` under ``attention_mask`` plus the
    per-row logsumexp of the scaled logits. Returns (out [G, L, H, hd],
    lse [G, L, H] f32), padding rows zero in both."""
    mask = attention_mask(segment_ids)
    out = sdpa_plain(q, k, v, mask, q.shape[-1])
    lse = torch.logsumexp(_masked_logits(q, k, mask), dim=-1)  # [G, H, L]
    valid = segment_ids != 0
    out = torch.where(valid[:, :, None, None], out, torch.zeros_like(out))
    lse = torch.where(valid[:, None, :], lse, torch.zeros_like(lse))
    return out, lse.transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, segment_ids, dout, lse, di, out_dtype=None):
    """K3 and K4's plain version, the flash backward formulas: P = exp(S -
    lse) under the mask, dS = P * (dP - di) with dP = dO V^T, then
    dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K. It rounds where the
    kernels round: S and dP are exact f32 products of the input values, P
    and dS are rounded to the input dtype before their products (the
    kernels' tensor-core operands), every sum is f32.
    lse, di: [G, L, H] f32. Returns (dq, dk, dv) in ``out_dtype`` (q's
    dtype by default)."""
    dt = q.dtype
    q, k, v, dout = (x.float() for x in (q, k, v, dout))
    scale = q.shape[-1] ** -0.5
    mask = attention_mask(segment_ids)
    s = _masked_logits(q, k, mask)
    p = torch.where(mask, torch.exp(s - lse.transpose(1, 2)[..., None]), 0.0)
    dp = torch.einsum("gqhd,gkhd->ghqk", dout, v)
    ds = p * (dp - di.transpose(1, 2)[..., None])
    p, ds = p.to(dt).float(), ds.to(dt).float()
    dv = torch.einsum("ghqk,gqhd->gkhd", p, dout)
    dq = torch.einsum("ghqk,gkhd->gqhd", ds, k) * scale
    dk = torch.einsum("ghqk,gqhd->gkhd", ds, q) * scale
    od = out_dtype or dt
    return dq.to(od), dk.to(od), dv.to(od)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda_args(name: str, segment_ids, grids, rows=()):
    """Refuse what the kernels do not take (they read raw pointers): bf16
    contiguous [G, L, H, hd] grids with hd in _HEAD_DIMS, int32 [G, L]
    segment ids, f32 [G, L, H] row statistics, all on one device."""
    q = grids[0]
    dev = q.device
    if any(t.device != dev for t in (segment_ids, *grids, *rows)):
        raise ValueError(f"{name}: all tensors must be on one device")
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [G, L, H, hd], got {tuple(q.shape)}")
    G, L, H, hd = q.shape
    for t in grids:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bf16, got {t.dtype}")
        if t.shape != q.shape or not t.is_contiguous():
            raise ValueError(f"{name}: q/k/v/dout must be contiguous {tuple(q.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {_HEAD_DIMS}")
    if G > 65535 or H > 65535:
        raise ValueError(f"{name}: G={G}, H={H} exceed the grid's 65535")
    if segment_ids.dtype != torch.int32 or segment_ids.shape != (G, L):
        raise ValueError(f"{name}: segment_ids must be int32 [G, L]")
    if not segment_ids.is_contiguous():
        raise ValueError(f"{name}: segment_ids must be contiguous")
    for t in rows:
        if t.dtype != torch.float32 or t.shape != (G, L, H) or not t.is_contiguous():
            raise ValueError(f"{name}: lse / di must be contiguous f32 [G, L, H]")


def occupancy(hd: int, L: int) -> dict[str, int]:
    """K2's registers a thread, dynamic shared memory and blocks an SM holds
    for grid rows of L tokens (its shared memory grows by 12 bytes a 64-row
    tile of L), as the CUDA runtime reports them (needs a card)."""
    lib = _build.load("flash_attention", _SIGNATURES)
    info = (ctypes.c_int * 3)()
    rc = lib.flash_attention_fwd_occupancy(hd, L, info)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd_occupancy failed (code {rc})")
    return {"registers": info[0], "smem_bytes": info[1], "blocks_per_sm": info[2]}


def bwd_occupancy(hd: int, L: int) -> dict[str, dict[str, int]]:
    """K3's ("dkv") and K4's ("dq") registers a thread, dynamic shared
    memory and blocks an SM for grid rows of L tokens, as ``occupancy``
    reports K2's (needs a card)."""
    lib = _build.load("flash_attention", _SIGNATURES)
    info = (ctypes.c_int * 6)()
    rc = lib.flash_attention_bwd_occupancy(hd, L, info)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_occupancy failed (code {rc})")
    keys = ("registers", "smem_bytes", "blocks_per_sm")
    return {"dkv": dict(zip(keys, info[:3])), "dq": dict(zip(keys, info[3:]))}


def _launch(fn: str, *args) -> None:
    lib = _build.load("flash_attention", _SIGNATURES)
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn} kernel launch failed (code {rc})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_fwd(q, k, v, segment_ids, *, with_lse: bool):
    """K2. Returns (out [G, L, H, hd] in q's dtype, lse [G, L, H] f32 or
    None when ``with_lse`` is False)."""
    if q.device.type == "cpu":
        out, lse = flash_attention_fwd_plain(q, k, v, segment_ids)
        return out, (lse if with_lse else None)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    _check_cuda_args("flash_attention_fwd", segment_ids, (q, k, v))
    G, L, H, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((G, L, H), dtype=torch.float32, device=q.device) if with_lse else None
    _launch(
        "flash_attention_fwd",
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        segment_ids.data_ptr(),
        out.data_ptr(),
        lse.data_ptr() if with_lse else None,
        G,
        L,
        H,
        hd,
        _stream(q),
    )
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_bwd_dkv(q, k, v, segment_ids, dout, lse, di):
    """K3: (dk, dv), each [G, L, H, hd] in q's dtype."""
    if q.device.type == "cpu":
        _, dk, dv = flash_attention_bwd_plain(q, k, v, segment_ids, dout, lse, di)
        return dk, dv
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_dkv: unsupported device {q.device}")
    _check_cuda_args("flash_attention_bwd_dkv", segment_ids, (q, k, v, dout), (lse, di))
    G, L, H, hd = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(
        "flash_attention_bwd_dkv",
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        segment_ids.data_ptr(),
        dout.data_ptr(),
        lse.data_ptr(),
        di.data_ptr(),
        dk.data_ptr(),
        dv.data_ptr(),
        G,
        L,
        H,
        hd,
        _stream(q),
    )
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, segment_ids, dout, lse, di):
    """K4: dq [G, L, H, hd] in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, segment_ids, dout, lse, di)[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_dq: unsupported device {q.device}")
    _check_cuda_args("flash_attention_bwd_dq", segment_ids, (q, k, v, dout), (lse, di))
    G, L, H, hd = q.shape
    dq = torch.empty_like(q)
    _launch(
        "flash_attention_bwd_dq",
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        segment_ids.data_ptr(),
        dout.data_ptr(),
        lse.data_ptr(),
        di.data_ptr(),
        dq.data_ptr(),
        G,
        L,
        H,
        hd,
        _stream(q),
    )
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_fwd.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0


def flash_fwd(q, k, v, segment_ids):
    """Forward-only packed flash attention (no logsumexp kept): the
    counterpart of ``flash_fwd_pallas``."""
    return flash_attention_fwd(q, k, v, segment_ids, with_lse=False)[0]


class _FlashTrain(torch.autograd.Function):
    """Forward = K2 keeping the logsumexp; backward = K3 + K4, with
    di = rowsum(dO * O) computed here in plain torch (the JAX library also
    computes it outside its kernels). Deterministic, so a recompute under
    ``torch.utils.checkpoint`` reproduces the forward exactly."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids):
        out, lse = flash_attention_fwd(q, k, v, segment_ids, with_lse=True)
        ctx.save_for_backward(q, k, v, segment_ids, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, segment_ids, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        di = (dout.float() * out.float()).sum(dim=-1)  # [G, L, H]
        if q.device.type == "cpu":  # one plain call gives all three
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, segment_ids, dout, lse, di)
            return dq, dk, dv, None
        dk, dv = flash_attention_bwd_dkv(q, k, v, segment_ids, dout, lse, di)
        dq = flash_attention_bwd_dq(q, k, v, segment_ids, dout, lse, di)
        return dq, dk, dv, None


def flash_train(q, k, v, segment_ids):
    """Differentiable packed flash attention (the trainer's). q, k, v:
    [G, L, H, hd] with KV heads repeated; segment_ids [G, L] int32."""
    return _FlashTrain.apply(q, k, v, segment_ids)
