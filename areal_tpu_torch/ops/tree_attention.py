"""Tree attention over packed trie nodes: the hand-written CUDA kernels #4
(forward), #5 (dQ) and #6 (dK, dV) of ``csrc/tree_attention.cu``, their
plain versions, and the forward over a packed forest.

The counterpart of ``areal_tpu/ops/tree_attention.py``. Sequences that share
prefixes are merged into a trie (``models/tree.py``), one node per unique
prefix + token; node i attends node j when j is an ancestor of i or i itself.
The relation ships as PACKED BITS: ``words`` [N, N/32] with bit j % 32 of
word j // 32 of row i set when i attends j, plus a skip map ``block_any``
[N/128, N/128] that is 1 where any bit of the 128 x 128 tile is set. Nodes
come parent before child, so every bit lies on or below the diagonal.

Layout: q, k, v [N, H, hd] with KV heads already repeated to H and N a
multiple of ``BLOCK``; the per-row statistics (logsumexp, delta) are
[N, H] f32. The words travel as int32 (the bits of the uint32 words that
``pack_ancestor_bits`` makes, ``np.ndarray.view(np.int32)``): torch's uint32
has few operators, and ``(w >> b) & 1`` reads bit b of an int32 for b = 31
too. Rows with no set bit (padding) output zeros and a logsumexp of 0 (the
JAX kernel writes about -1e30 there); nothing reads them.

Dispatch is by the device of ``q``: a CPU tensor takes the plain PyTorch
version of each kernel; a CUDA tensor launches the kernel or raises. Each
wrapper counts its launches in ``.launches``. ``tree_tile_classes`` is the
plain twin of the kernels' walk over 64-row tile pairs, and
``fwd_occupancy`` / ``bwd_occupancy`` report their resources on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from areal_tpu_torch.models.tree import node_logprobs
from areal_tpu_torch.ops import _build

BLOCK = 128  # tile edge of the skip map
WORD = 32  # mask bits per word
TILE = 64  # tile edge of the kernels' walk
DEAD, PARTIAL, FULL = 0, 1, 2  # tile-pair classes of ``tree_tile_classes``
_HEAD_DIMS = (64, 128)  # template instantiations of the kernels

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "tree_attention_fwd": ([_P] * 7 + [_I] * 3 + [_P], ctypes.c_int),
    "tree_attention_bwd_dq": ([_P] * 9 + [_I] * 3 + [_P], ctypes.c_int),
    "tree_attention_bwd_dkv": ([_P] * 10 + [_I] * 3 + [_P], ctypes.c_int),
    "tree_attention_fwd_occupancy": ([_I, _I, _P], ctypes.c_int),
    "tree_attention_bwd_occupancy": ([_I, _I, _P], ctypes.c_int),
}


def pack_ancestor_bits(
    parent: np.ndarray, n_pad: int | None = None, block: int = BLOCK
) -> tuple[np.ndarray, np.ndarray]:
    """Parent pointers (parent before child, -1 for roots) -> (words
    [n_pad, n_pad/32] uint32, block_any [n_pad/block, n_pad/block] int32),
    bit for bit as ``areal_tpu/ops/tree_attention.py:pack_ancestor_bits``.
    Row i of ``words`` has bit j set iff j is an ancestor of i or i itself;
    rows past the nodes stay zero."""
    N = len(parent)
    n_pad = n_pad or -(-N // block) * block
    if n_pad % block or n_pad < N:
        raise ValueError(f"n_pad {n_pad} must be a multiple of {block} and >= {N}")
    words = np.zeros((n_pad, n_pad // WORD), np.uint32)
    for i in range(N):
        p = int(parent[i])
        if p >= 0:
            words[i] = words[p]
        words[i, i // WORD] |= np.uint32(1) << np.uint32(i % WORD)
    nB = n_pad // block
    block_any = words.reshape(nB, block, nB, block // WORD).any(axis=(1, 3)).astype(np.int32)
    return words, block_any


def expand_mask(words: torch.Tensor) -> torch.Tensor:
    """[N, N/32] int32 words -> the [N, N] bool mask they pack."""
    n = words.shape[1] * WORD
    col = torch.arange(n, device=words.device)
    bit = (col % WORD).to(torch.int32)
    return ((words[:, col // WORD] >> bit) & 1).bool()


def tree_tile_classes(words, tile: int = TILE) -> np.ndarray:
    """The kernels' classification of every (query tile, key tile) pair of
    ``tile``-row tiles -> int32 [nt, nt]: DEAD where none of the pair's
    bits is set, and above the diagonal (nodes come parent before child, so
    the kernels never look there); FULL where every bit is set, so #4, #5
    and #6 run the pair without a per-element test; PARTIAL otherwise.
    ``words``: the [N, N/32] int32 tensor of ``pack_ancestor_bits``' bits.
    #4 and #5 walk row qt's live pairs, #6 column kt's, all in tile
    order."""
    w = words.cpu().numpy().view(np.uint32)
    N = w.shape[0]
    if N % tile or tile % WORD or w.shape != (N, N // WORD):
        raise ValueError(f"words {w.shape} must be [N, N/{WORD}] with N a multiple of {tile}")
    nt, per = N // tile, tile // WORD
    blocks = w.reshape(nt, tile, nt, per)
    live = blocks.any(axis=(1, 3))
    full = (blocks == np.uint32(0xFFFFFFFF)).all(axis=(1, 3))
    classes = np.where(full, FULL, np.where(live, PARTIAL, DEAD)).astype(np.int32)
    return np.tril(classes)


# ---------------------------------------------------------------------------
# plain versions of the kernels
# ---------------------------------------------------------------------------


def _masked_logits(q, k, mask):
    """Scaled f32 logits [H, N, N], masked to -1e30."""
    logits = torch.einsum("qhd,khd->hqk", q, k).float() * q.shape[-1] ** -0.5
    return torch.where(mask, logits, -1e30)


def tree_attention_fwd_plain(q, k, v, words, block_any):
    """#4's plain version: the masked softmax (probabilities rounded to v's
    dtype before the product, as ``sdpa_plain``) and the per-row
    logsumexp. ``block_any`` must cover every set bit (``pack_ancestor_bits``
    makes it so); the plain version reads only the words. Returns (out
    [N, H, hd] in q's dtype, lse [N, H] f32), rows with no set bit zero."""
    mask = expand_mask(words)
    logits = _masked_logits(q, k, mask)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("hqk,khd->qhd", probs, v)
    valid = mask.any(-1)
    out = torch.where(valid[:, None, None], out, torch.zeros_like(out))
    lse = torch.where(valid[None], torch.logsumexp(logits, dim=-1), 0.0)
    return out, lse.t().contiguous()


def tree_attention_bwd_plain(q, k, v, words, block_any, dout, lse, delta, out_dtype=None):
    """#5 and #6's plain version, the flash backward formulas under the
    ancestor mask: P = exp(S - lse), dS = P (dP - delta) with dP = dO V^T,
    dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K. It rounds where the
    kernels round: S and dP are exact f32 products of the inputs, P and dS
    round to the input dtype before their products, every sum is f32.
    lse, delta: [N, H] f32. Returns (dq, dk, dv) in ``out_dtype`` (q's dtype
    by default)."""
    dt = q.dtype
    q, k, v, dout = (x.float() for x in (q, k, v, dout))
    scale = q.shape[-1] ** -0.5
    mask = expand_mask(words)
    s = _masked_logits(q, k, mask)
    p = torch.where(mask, torch.exp(s - lse.t()[..., None]), 0.0)
    dp = torch.einsum("qhd,khd->hqk", dout, v)
    ds = p * (dp - delta.t()[..., None])
    p, ds = p.to(dt).float(), ds.to(dt).float()
    dv = torch.einsum("hqk,qhd->khd", p, dout)
    dq = torch.einsum("hqk,khd->qhd", ds, k) * scale
    dk = torch.einsum("hqk,qhd->khd", ds, q) * scale
    od = out_dtype or dt
    return dq.to(od), dk.to(od), dv.to(od)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda_args(name: str, words, block_any, grids, rows=()):
    """Refuse what the kernels do not take (they read raw pointers): bf16
    contiguous [N, H, hd] tensors with N a multiple of BLOCK and hd in
    _HEAD_DIMS, int32 words [N, N/32] and block_any [N/BLOCK, N/BLOCK], f32
    [N, H] row statistics, all contiguous on one device."""
    q = grids[0]
    if any(t.device != q.device for t in (words, block_any, *grids, *rows)):
        raise ValueError(f"{name}: all tensors must be on one device")
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be [N, H, hd], got {tuple(q.shape)}")
    N, H, hd = q.shape
    for t in grids:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bf16, got {t.dtype}")
        if t.shape != q.shape or not t.is_contiguous():
            raise ValueError(f"{name}: q/k/v/dout must be contiguous {tuple(q.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
    if N % BLOCK or N == 0:
        raise ValueError(f"{name}: N={N} must be a positive multiple of {BLOCK}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {_HEAD_DIMS}")
    if H > 65535:
        raise ValueError(f"{name}: H={H} exceeds the grid's 65535")
    if words.dtype != torch.int32 or words.shape != (N, N // WORD) or not words.is_contiguous():
        raise ValueError(f"{name}: words must be contiguous int32 [N, N/32]")
    nB = N // BLOCK
    if block_any.dtype != torch.int32 or block_any.shape != (nB, nB) or not block_any.is_contiguous():
        raise ValueError(f"{name}: block_any must be contiguous int32 [N/{BLOCK}, N/{BLOCK}]")
    for t in rows:
        if t.dtype != torch.float32 or t.shape != (N, H) or not t.is_contiguous():
            raise ValueError(f"{name}: lse / delta must be contiguous f32 [N, H]")


_OCC_KEYS = ("registers", "smem_bytes", "blocks_per_sm", "local_bytes")


def fwd_occupancy(hd: int, N: int) -> dict[str, int]:
    """#4's registers a thread, dynamic shared memory, blocks an SM and
    local (spill) bytes a thread for N nodes, as the CUDA runtime reports
    them (needs a card)."""
    lib = _build.load("tree_attention", _SIGNATURES)
    info = (ctypes.c_int * 4)()
    rc = lib.tree_attention_fwd_occupancy(hd, N, info)
    if rc != 0:
        raise RuntimeError(f"tree_attention_fwd_occupancy failed (code {rc})")
    return dict(zip(_OCC_KEYS, info))


def bwd_occupancy(hd: int, N: int) -> dict[str, dict[str, int]]:
    """#6's ("dkv") and #5's ("dq") registers a thread, dynamic shared
    memory, blocks an SM and local (spill) bytes a thread for N nodes, as
    the CUDA runtime reports them (needs a card)."""
    lib = _build.load("tree_attention", _SIGNATURES)
    info = (ctypes.c_int * 8)()
    rc = lib.tree_attention_bwd_occupancy(hd, N, info)
    if rc != 0:
        raise RuntimeError(f"tree_attention_bwd_occupancy failed (code {rc})")
    return {"dkv": dict(zip(_OCC_KEYS, info[:4])), "dq": dict(zip(_OCC_KEYS, info[4:]))}


def _launch(fn: str, *args) -> None:
    lib = _build.load("tree_attention", _SIGNATURES)
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn} kernel launch failed (code {rc})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def tree_attention_fwd(q, k, v, words, block_any, *, with_lse: bool):
    """#4. Returns (out [N, H, hd] in q's dtype, lse [N, H] f32 or None when
    ``with_lse`` is False)."""
    if q.device.type == "cpu":
        out, lse = tree_attention_fwd_plain(q, k, v, words, block_any)
        return out, (lse if with_lse else None)
    if q.device.type != "cuda":
        raise ValueError(f"tree_attention_fwd: unsupported device {q.device}")
    _check_cuda_args("tree_attention_fwd", words, block_any, (q, k, v))
    N, H, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((N, H), dtype=torch.float32, device=q.device) if with_lse else None
    _launch(
        "tree_attention_fwd",
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        words.data_ptr(),
        block_any.data_ptr(),
        out.data_ptr(),
        lse.data_ptr() if with_lse else None,
        N,
        H,
        hd,
        _stream(q),
    )
    tree_attention_fwd.launches += 1
    return out, lse


def tree_attention_bwd_dq(q, k, v, words, block_any, dout, lse, delta):
    """#5: dq [N, H, hd] in q's dtype."""
    if q.device.type == "cpu":
        return tree_attention_bwd_plain(q, k, v, words, block_any, dout, lse, delta)[0]
    if q.device.type != "cuda":
        raise ValueError(f"tree_attention_bwd_dq: unsupported device {q.device}")
    _check_cuda_args("tree_attention_bwd_dq", words, block_any, (q, k, v, dout), (lse, delta))
    N, H, hd = q.shape
    dq = torch.empty_like(q)
    _launch(
        "tree_attention_bwd_dq",
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        words.data_ptr(),
        block_any.data_ptr(),
        dout.data_ptr(),
        lse.data_ptr(),
        delta.data_ptr(),
        dq.data_ptr(),
        N,
        H,
        hd,
        _stream(q),
    )
    tree_attention_bwd_dq.launches += 1
    return dq


def tree_attention_bwd_dkv(q, k, v, words, block_any, dout, lse, delta):
    """#6: (dk, dv), each [N, H, hd] in q's dtype."""
    if q.device.type == "cpu":
        _, dk, dv = tree_attention_bwd_plain(q, k, v, words, block_any, dout, lse, delta)
        return dk, dv
    if q.device.type != "cuda":
        raise ValueError(f"tree_attention_bwd_dkv: unsupported device {q.device}")
    _check_cuda_args("tree_attention_bwd_dkv", words, block_any, (q, k, v, dout), (lse, delta))
    N, H, hd = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(
        "tree_attention_bwd_dkv",
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        words.data_ptr(),
        block_any.data_ptr(),
        dout.data_ptr(),
        lse.data_ptr(),
        delta.data_ptr(),
        dk.data_ptr(),
        dv.data_ptr(),
        N,
        H,
        hd,
        _stream(q),
    )
    tree_attention_bwd_dkv.launches += 1
    return dk, dv


tree_attention_fwd.launches = 0
tree_attention_bwd_dq.launches = 0
tree_attention_bwd_dkv.launches = 0


class _TreeAttention(torch.autograd.Function):
    """Forward = #4 keeping the logsumexp; backward = delta = rowsum(dO * O)
    in plain torch (``tree_attention.py:350`` computes it outside the
    kernels too), then #6 and #5. Deterministic (no atomics), so a
    recompute under ``torch.utils.checkpoint`` reproduces the forward."""

    @staticmethod
    def forward(ctx, q, k, v, words, block_any):
        out, lse = tree_attention_fwd(q, k, v, words, block_any, with_lse=True)
        ctx.save_for_backward(q, k, v, words, block_any, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, words, block_any, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1)  # [N, H]
        if q.device.type == "cpu":  # one plain call gives all three
            dq, dk, dv = tree_attention_bwd_plain(q, k, v, words, block_any, dout, lse, delta)
            return dq, dk, dv, None, None
        dk, dv = tree_attention_bwd_dkv(q, k, v, words, block_any, dout, lse, delta)
        dq = tree_attention_bwd_dq(q, k, v, words, block_any, dout, lse, delta)
        return dq, dk, dv, None, None


def tree_attention(q, k, v, words, block_any):
    """Differentiable block-sparse ancestor-mask attention -> [N, H, hd]
    (``areal_tpu/ops/tree_attention.py:tree_attention``)."""
    return _TreeAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), words, block_any)


# ---------------------------------------------------------------------------
# the model over a packed forest
# ---------------------------------------------------------------------------


def forest_hidden(model, ids, positions, words, block_any, with_aux: bool = False):
    """Decoder body over packed trie nodes with the tree kernels in every
    layer -> final hidden states [n_pad, D] (``tree_attention.py:410``), and
    with ``with_aux`` the pair (hidden, summed MoE router aux), as JAX's
    ``forest_hidden`` returns them. ``ids`` [n_pad] node tokens (padding 0),
    ``positions`` [n_pad] node depths (the rope positions), ``words`` /
    ``block_any`` int32 device tensors of ``pack_ancestor_bits``. The
    ancestor mask keeps disjoint tries apart, so a whole forest runs as one
    call. An MoE layer routes all n_pad nodes, padding included, as one
    [1, n_pad, D] call (JAX's ``moe_ffn(h[None])``), so its aux is over the
    unique nodes, not the packed path's duplicated tokens. Layers run under
    ``torch.utils.checkpoint`` when ``cfg.remat`` is set and gradients are
    on, as in ``qwen.forward``."""
    from areal_tpu_torch.models import qwen

    out = qwen.forward_masked(model, ids[None], positions[None], (words, block_any), "tree", with_aux=with_aux)
    if with_aux:
        return out[0][0], out[1]
    return out[0]


def tree_forward_logprobs_pallas(model, pack):
    """Packed-trie forward through the tree kernels (``tree_attention.py
    :483``); differentiable. Returns node_logp [N] f32: log p(token_j |
    ancestors) for every non-root node j, 0 for roots."""
    dev = model.embed.device
    N = pack.n_nodes
    n_pad = -(-N // BLOCK) * BLOCK
    words, block_any = pack_ancestor_bits(pack.parent, n_pad)
    ids = np.zeros(n_pad, np.int64)
    ids[:N] = pack.tokens
    pos = np.zeros(n_pad, np.int64)
    pos[:N] = pack.depth
    hidden = forest_hidden(
        model,
        torch.from_numpy(ids).to(dev),
        torch.from_numpy(pos).to(dev),
        torch.from_numpy(words.view(np.int32)).to(dev),
        torch.from_numpy(block_any).to(dev),
    )
    return node_logprobs(model, pack, hidden)
