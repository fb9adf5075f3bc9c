"""Grouped matrix multiply and its backward: the hand-written CUDA kernels
and their plain twins.

``gmm`` has the contract of jax's Pallas TPU kernel ``megablox.gmm`` as
``areal_tpu/models/moe.py:227-230`` calls it (``preferred_element_type``
f32, ``transpose_rhs=False``): ``lhs [M, k]`` rows sorted by group, group
``g`` owning ``group_sizes[g]`` rows after those of groups ``0..g-1``,
times ``rhs[g] [k, n]``, giving ``[M, n]`` in f32. Rows at or past
``sum(group_sizes)`` come back as zeros (megablox leaves them
uninitialized and the JAX caller masks them). On one device every row is
computed; on an ``expert`` axis a rank's rows routed to other ranks'
experts sort past the groups (``models/moe.py``), about (1 - 1/e) of M,
and the grid, sized from M and E alone, spends that share of its work
items writing their zeros.

Its gradient is megablox's custom VJP (``megablox/ops.py:63 _gmm_bwd``),
two more kernels under ``GroupedMatmul``, a ``torch.autograd.Function``:

- ``gmm_bwd_lhs`` (dLHS, megablox ``gmm(..., transpose_rhs=True)``):
  ``grad[a:b] @ rhs[g]^T`` per group -> ``[M, k]``, zero rows past the
  groups;
- ``tgmm`` (dRHS, megablox ``tgmm``): ``lhs[a:b]^T @ grad[a:b]`` per group
  -> ``[E, k, n]``, zeros for an empty group.

Both take the f32 cotangent and multiply in f32 as megablox does with
mixed inputs (with a bf16 operand the kernels split it into two bf16
halves in registers, for mma.sync on 128-wide tiles, ``csrc/gmm.cu``);
the output dtype is an argument (megablox's ``preferred_element_type``):
``lhs.dtype`` and ``rhs.dtype`` in training, as ``_gmm_bwd`` passes them.
``bwd_occupancy`` reports the bf16 kernels' registers, shared memory,
blocks an SM and spill bytes.

The forward's bf16 kernel runs wgmma with its f32 accumulators in
registers, in two regimes picked from M and E by ``pick_bf16_tile``: 64-
or 128-row output tiles where the groups average 16 rows or more (prefill,
training), and the roles swapped where they average fewer (decode:
``out^T = rhs[g]^T lhs^T``, n on the instruction's 64-row side, a group's
rows on its 8- or 16-wide one). ``fwd_schedule`` lists its work items in
the grid's order and ``gmm_tiled`` computes gmm by walking them, the plain
twin of the kernel's schedule; ``fwd_occupancy`` reports its
instantiations' registers, shared memory, blocks an SM and spill bytes.

Dispatch is by the device of the first operand: a CPU tensor takes the
plain version; a CUDA tensor launches ``csrc/gmm.cu`` or raises, never
falls back. Each wrapper counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from areal_tpu_torch.ops import _build

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GROUPS = 512  # kMaxE in the kernel
TILES = (16, 32, 64)  # the f32 kernel's row-tile instantiations
# rows per work item of the f32 path: one group's rows are tiled from its
# own first row, so a tile of TM rows reads its expert's weights once; 16
# where the groups average fewer than 16 rows, else 64
TILE_M = 64
_TILE_M_DECODE = 16
# the bf16 kernel's rows per work item: 16 with the roles swapped (decode),
# 64- and 128-row output tiles (prefill, training)
BF16_TILES = (16, 64, 128)
FWD_BN = 128  # the bf16 kernel's output columns a block
FWD_RS = 64  # its reduction step (of k)
_MAX_ITEMS = 65535  # grid y

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "gmm_forward": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "gmm_bwd_lhs": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "tgmm": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "gmm_bwd_occupancy": ([_P], ctypes.c_int),
    "gmm_fwd_occupancy": ([_P], ctypes.c_int),
}


def gmm_plain(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """For each group g, ``lhs[a:b].float() @ rhs[g].float()`` over its rows
    [a, b); rows past the last group are zeros. Reads the sizes on the host
    (a sync on a card: the plain versions are for the CPU and for checking)."""
    M, n = lhs.shape[0], rhs.shape[2]
    out = torch.zeros((M, n), dtype=torch.float32, device=lhs.device)
    for g, a, b in _group_bounds(group_sizes, M):
        if b > a:
            out[a:b] = lhs[a:b].float() @ rhs[g].float()
    return out


def _group_bounds(group_sizes: torch.Tensor, M: int):
    """(g, a, b) of every group: its rows [a, b), clamped to M (host read)."""
    out, a = [], 0
    for g, s in enumerate(group_sizes.tolist()):
        b = min(a + max(int(s), 0), M)
        out.append((g, a, b))
        a = b
    return out


def gmm_bwd_lhs_plain(
    grad: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """For each group g, ``grad[a:b].float() @ rhs[g].float().T`` rounded
    once to ``out_dtype``; rows past the last group are zeros."""
    M, k = grad.shape[0], rhs.shape[1]
    out = torch.zeros((M, k), dtype=out_dtype, device=grad.device)
    for g, a, b in _group_bounds(group_sizes, M):
        if b > a:
            out[a:b] = (grad[a:b].float() @ rhs[g].float().t()).to(out_dtype)
    return out


def tgmm_plain(
    lhs: torch.Tensor, grad: torch.Tensor, group_sizes: torch.Tensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """For each group g, ``lhs[a:b].float().T @ grad[a:b].float()`` rounded
    once to ``out_dtype``; an empty group's matrix is zeros."""
    E, k, n = group_sizes.shape[0], lhs.shape[1], grad.shape[1]
    out = torch.zeros((E, k, n), dtype=out_dtype, device=lhs.device)
    for g, a, b in _group_bounds(group_sizes, lhs.shape[0]):
        if b > a:
            out[g] = (lhs[a:b].float().t() @ grad[a:b].float()).to(out_dtype)
    return out


def pick_tile(M: int, E: int) -> int:
    """The f32 path's rows per work item for ``M`` routed rows over ``E``
    groups: 16 when the groups average fewer than 16 rows, else
    ``TILE_M``."""
    return _TILE_M_DECODE if M < 16 * E else TILE_M


def pick_bf16_tile(M: int, E: int) -> int:
    """The bf16 kernel's regime for ``M`` routed rows over ``E`` groups: 16
    (the roles swapped) when the groups average fewer than 16 rows (decode),
    128-row tiles when they average 64 or more, else 64. chip_smoke.py's
    kernel_gmm times each regime from 4 to 128 rows a group; on the H100
    128-row tiles overtake 64 between 48 and 64 rows, and the swapped
    roles lead 64-row tiles by 1-2% at decode's ~2 rows a group but tie or
    trail them from 4 to 12 (PERF.md)."""
    if M < 16 * E:
        return 16
    return 128 if M >= 64 * E else 64


def fwd_schedule(group_sizes: torch.Tensor, M: int, n: int, tile: int):
    """The bf16 forward kernel's work, as its blocks find it: ``items`` in
    the grid's order (block index y the work item, x the column tile,
    fastest), each ``(group, first row, rows, column tile)`` with group -1
    for rows past ``sum(group_sizes)`` (zeroed), and ``grid``, the launch's
    (column tiles, work items), sized from M and E alone. Each group's rows
    are tiled from its own first row (``scan_groups`` / ``find_item`` in
    ``csrc/gmm.cu``); blocks with nothing to do are left out."""
    sizes = [max(int(s), 0) for s in group_sizes.tolist()]
    E = len(sizes)
    grid = (-(-n // FWD_BN), M // tile + E + 1)
    off, tiles = [0], [0]  # first row and first work item of each group
    for s in sizes:
        off.append(off[-1] + s)
        tiles.append(tiles[-1] + -(-s // tile))
    items = []
    for item in range(grid[1]):
        if item >= tiles[E]:  # past the real items: the next rows past the groups
            g, r0 = -1, min(off[E], M) + (item - tiles[E]) * tile
            r_end = min(r0 + tile, M)
        else:
            g = next(g for g in range(E) if tiles[g + 1] > item)
            r0 = off[g] + (item - tiles[g]) * tile
            r_end = min(off[g + 1], r0 + tile, M)
        if r0 < r_end:
            items += [(g, r0, r_end - r0, ct) for ct in range(grid[0])]
    return items, grid


def gmm_tiled(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, tile: int, items=None) -> torch.Tensor:
    """gmm computed as the bf16 kernel walks it (``fwd_schedule``'s items,
    or ``items``): per item, f32 products of ``FWD_RS``-wide k steps with
    the edges zero-filled, summed over k in the kernel's step order. At
    ``tile`` 16 the roles are swapped, ``out^T = rhs[g]^T lhs^T``: the
    item's [FWD_BN, 16] block of out^T, n on the rows. Rows no item writes
    stay NaN."""
    M, k = lhs.shape
    n = rhs.shape[2]
    out = torch.full((M, n), float("nan"))
    a32, w32 = lhs.float().cpu(), rhs.float().cpu()
    for g, r0, rows, ct in fwd_schedule(group_sizes, M, n, tile)[0] if items is None else items:
        c0 = ct * FWD_BN
        cols = min(FWD_BN, n - c0)
        if g < 0:
            out[r0:r0 + rows, c0:c0 + cols] = 0.0
            continue
        acc = torch.zeros((FWD_BN, tile) if tile == 16 else (tile, FWD_BN))
        for k0 in range(0, k, FWD_RS):
            kk = min(FWD_RS, k - k0)
            a = torch.zeros((tile, FWD_RS))
            a[:rows, :kk] = a32[r0:r0 + rows, k0:k0 + kk]
            w = torch.zeros((FWD_RS, FWD_BN))
            w[:kk, :cols] = w32[g, k0:k0 + kk, c0:c0 + cols]
            acc += w.t() @ a.t() if tile == 16 else a @ w
        got = acc.t() if tile == 16 else acc
        out[r0:r0 + rows, c0:c0 + cols] = got[:rows, :cols]
    return out


def _gmm_forward(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, tm: int | None,
                 bf16_tile: int | None) -> torch.Tensor:
    if lhs.device.type == "cpu":
        return gmm_plain(lhs, rhs, group_sizes)
    if lhs.device.type != "cuda":
        raise ValueError(f"gmm: unsupported device {lhs.device}")
    M, k = lhs.shape
    E, _, n = rhs.shape
    if lhs.dtype == torch.bfloat16:
        if tm is not None:
            raise ValueError(f"gmm: tm={tm} sets the f32 path's row tile; the bf16 path takes bf16_tile")
        tile, tiles = (pick_bf16_tile(M, E) if bf16_tile is None else bf16_tile), BF16_TILES
    else:
        if bf16_tile is not None:
            raise ValueError("gmm: bf16_tile sets the bf16 path's regime; the f32 path takes tm")
        tile, tiles = (pick_tile(M, E) if tm is None else tm), TILES
    _check_cuda_args(lhs, rhs, group_sizes, tile, tiles)
    out = torch.empty((M, n), dtype=torch.float32, device=lhs.device)
    rc = _lib().gmm_forward(
        lhs.data_ptr(),
        rhs.data_ptr(),
        group_sizes.data_ptr(),
        out.data_ptr(),
        M,
        k,
        n,
        E,
        _CODES[lhs.dtype],
        tile,
        _stream(lhs),
    )
    if rc != 0:
        raise RuntimeError(f"gmm kernel launch failed (code {rc})")
    gmm.launches += 1
    return out


class GroupedMatmul(torch.autograd.Function):
    """``gmm`` with megablox's VJP: the forward kernel, then ``gmm_bwd_lhs``
    (dLHS in ``lhs.dtype``) and ``tgmm`` (dRHS in ``rhs.dtype``) on the f32
    cotangent. Saves lhs, rhs and the device-side group sizes (no host
    sync); deterministic (no atomics), so a checkpointed recompute
    reproduces the forward."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, tm, bf16_tile=None):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        ctx.tm = tm
        return _gmm_forward(lhs, rhs, group_sizes, tm, bf16_tile)

    @staticmethod
    def backward(ctx, grad):
        lhs, rhs, group_sizes = ctx.saved_tensors
        grad = grad.float().contiguous()
        d_lhs = d_rhs = None
        if ctx.needs_input_grad[0]:
            d_lhs = gmm_bwd_lhs(grad, rhs, group_sizes, out_dtype=lhs.dtype, tm=ctx.tm)
        if ctx.needs_input_grad[1]:
            d_rhs = tgmm(lhs, grad, group_sizes, out_dtype=rhs.dtype)
        return d_lhs, d_rhs, None, None, None


def gmm(
    lhs: torch.Tensor,  # [M, k] bf16 | f32, rows sorted by group
    rhs: torch.Tensor,  # [E, k, n], lhs's dtype
    group_sizes: torch.Tensor,  # [E] int32
    *,
    tm: int | None = None,  # f32: rows per work item (16 / 32 / 64); default pick_tile
    bf16_tile: int | None = None,  # bf16: the regime (16 swapped / 64 / 128); default pick_bf16_tile
) -> torch.Tensor:
    """Grouped matmul -> [M, n] f32; differentiable in lhs and rhs (through
    ``GroupedMatmul``) when gradients are on and either requires them."""
    if torch.is_grad_enabled() and (lhs.requires_grad or rhs.requires_grad):
        return GroupedMatmul.apply(lhs, rhs, group_sizes, tm, bf16_tile)
    return _gmm_forward(lhs, rhs, group_sizes, tm, bf16_tile)


gmm.launches = 0


def gmm_bwd_lhs(
    grad: torch.Tensor,  # [M, n] f32 cotangent of gmm's output
    rhs: torch.Tensor,  # [E, k, n] bf16 | f32
    group_sizes: torch.Tensor,  # [E] int32
    *,
    out_dtype: torch.dtype,  # f32 | bf16 (training: lhs.dtype)
    tm: int | None = None,  # the f32 path's rows per work item (bf16: 128 or 64 by group size)
) -> torch.Tensor:
    """dLHS of ``gmm``: ``grad[a:b] @ rhs[g]^T`` per group -> [M, k] in
    ``out_dtype``, zero rows past the groups."""
    if grad.device.type == "cpu":
        return gmm_bwd_lhs_plain(grad, rhs, group_sizes, out_dtype)
    if grad.device.type != "cuda":
        raise ValueError(f"gmm_bwd_lhs: unsupported device {grad.device}")
    M, n = grad.shape
    E, k, _ = rhs.shape
    _check_bwd_args("gmm_bwd_lhs", grad, rhs, group_sizes, out_dtype)
    if rhs.dtype == torch.float32:
        tm = pick_tile(M, E) if tm is None else tm
    else:
        tm = None  # the bf16 kernel picks its own row tile
    if grad.dim() != 2 or rhs.dim() != 3 or rhs.shape[2] != n:
        raise ValueError(f"gmm_bwd_lhs: grad [M, n] and rhs [E, k, n], got {tuple(grad.shape)} and {tuple(rhs.shape)}")
    _check_common("gmm_bwd_lhs", M, k, n, E, group_sizes, tm)
    out = torch.empty((M, k), dtype=out_dtype, device=grad.device)
    rc = _lib().gmm_bwd_lhs(
        grad.data_ptr(),
        rhs.data_ptr(),
        group_sizes.data_ptr(),
        out.data_ptr(),
        M,
        k,
        n,
        E,
        _CODES[rhs.dtype],
        _CODES[out_dtype],
        tm or 0,
        _stream(grad),
    )
    if rc != 0:
        raise RuntimeError(f"gmm_bwd_lhs kernel launch failed (code {rc})")
    gmm_bwd_lhs.launches += 1
    return out


gmm_bwd_lhs.launches = 0


def tgmm(
    lhs: torch.Tensor,  # [M, k] bf16 | f32, rows sorted by group
    grad: torch.Tensor,  # [M, n] f32 cotangent of gmm's output
    group_sizes: torch.Tensor,  # [E] int32
    *,
    out_dtype: torch.dtype,  # f32 | bf16 (training: rhs.dtype)
) -> torch.Tensor:
    """dRHS of ``gmm``: ``lhs[a:b]^T @ grad[a:b]`` per group -> [E, k, n] in
    ``out_dtype``, zeros for an empty group."""
    if lhs.device.type == "cpu":
        return tgmm_plain(lhs, grad, group_sizes, out_dtype)
    if lhs.device.type != "cuda":
        raise ValueError(f"tgmm: unsupported device {lhs.device}")
    _check_bwd_args("tgmm", grad, lhs, group_sizes, out_dtype)
    if lhs.dim() != 2 or grad.dim() != 2 or grad.shape[0] != lhs.shape[0]:
        raise ValueError(f"tgmm: lhs [M, k] and grad [M, n], got {tuple(lhs.shape)} and {tuple(grad.shape)}")
    M, k = lhs.shape
    n, E = grad.shape[1], group_sizes.shape[0]
    _check_common("tgmm", M, k, n, E, group_sizes, None)
    out = torch.empty((E, k, n), dtype=out_dtype, device=lhs.device)
    rc = _lib().tgmm(
        lhs.data_ptr(),
        grad.data_ptr(),
        group_sizes.data_ptr(),
        out.data_ptr(),
        M,
        k,
        n,
        E,
        _CODES[lhs.dtype],
        _CODES[out_dtype],
        _stream(lhs),
    )
    if rc != 0:
        raise RuntimeError(f"tgmm kernel launch failed (code {rc})")
    tgmm.launches += 1
    return out


tgmm.launches = 0


def _occupancy(fn: str, names: tuple[str, ...]) -> dict[str, dict[str, int]]:
    info = (ctypes.c_int * (4 * len(names)))()
    rc = getattr(_lib(), fn)(info)
    if rc != 0:
        raise RuntimeError(f"{fn} failed (code {rc})")
    keys = ("registers", "smem_bytes", "blocks_per_sm", "local_bytes")
    return {name: dict(zip(keys, info[4 * i:4 * i + 4])) for i, name in enumerate(names)}


def bwd_occupancy() -> dict[str, dict[str, int]]:
    """Registers a thread, shared memory a block (static and dynamic),
    blocks an SM and local (spill) bytes a thread of the bf16-operand
    backward kernels with a bf16 output, as the CUDA runtime reports them:
    ``gmm_bwd_lhs`` at 128- and 64-row tiles, ``tgmm`` (needs a card)."""
    return _occupancy("gmm_bwd_occupancy", ("gmm_bwd_lhs/128", "gmm_bwd_lhs/64", "tgmm"))


def fwd_occupancy() -> dict[str, dict[str, int]]:
    """The same for the bf16 forward kernel's three instantiations: the
    roles swapped (``gmm/16``) and 64- and 128-row tiles (needs a card)."""
    return _occupancy("gmm_fwd_occupancy", tuple(f"gmm/{t}" for t in BF16_TILES))


def _lib():
    return _build.load("gmm", _SIGNATURES)  # built and loaded once per process


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_common(what: str, M: int, k: int, n: int, E: int, group_sizes, tm: int | None,
                  tiles: tuple[int, ...] = TILES) -> None:
    if k % 8 or n % 8:
        raise ValueError(f"{what}: k={k} and n={n} must be multiples of 8")
    if not 0 < E <= _MAX_GROUPS:
        raise ValueError(f"{what}: {E} groups, the kernel takes 1..{_MAX_GROUPS}")
    if group_sizes.dtype != torch.int32 or group_sizes.shape != (E,) or not group_sizes.is_contiguous():
        raise ValueError(f"{what}: group_sizes must be contiguous int32 [E]")
    if tm is not None:
        if tm not in tiles:
            raise ValueError(f"{what}: tm={tm} not in {tiles}")
        if M // tm + E + 1 > _MAX_ITEMS:
            raise ValueError(f"{what}: M={M} rows are too many for tm={tm} ({_MAX_ITEMS} work items)")


def _check_tensors(what: str, tensors, group_sizes) -> None:
    """The kernels read raw pointers with 16-byte copies."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors) or group_sizes.device != dev:
        raise ValueError(f"{what}: all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: operands must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: operands must be 16-byte aligned")


def _check_cuda_args(lhs, rhs, group_sizes, tm: int, tiles: tuple[int, ...]) -> None:
    """Refuse what the forward kernel does not take (``tm``: the rows per
    work item, one of ``tiles``)."""
    if lhs.dtype not in _CODES or rhs.dtype != lhs.dtype:
        raise TypeError(f"gmm: dtypes {lhs.dtype}/{rhs.dtype} not supported (both bf16 or both f32)")
    if lhs.dim() != 2 or rhs.dim() != 3 or rhs.shape[1] != lhs.shape[1]:
        raise ValueError(f"gmm: lhs [M, k] and rhs [E, k, n], got {tuple(lhs.shape)} and {tuple(rhs.shape)}")
    M, k = lhs.shape
    E, _, n = rhs.shape
    _check_common("gmm", M, k, n, E, group_sizes, tm, tiles)
    _check_tensors("gmm", (lhs, rhs), group_sizes)


def _check_bwd_args(what: str, grad, operand, group_sizes, out_dtype) -> None:
    """Refuse what a backward kernel does not take: an f32 cotangent, a bf16
    or f32 operand, an f32 or bf16 output."""
    if grad.dtype != torch.float32:
        raise TypeError(f"{what}: the cotangent must be f32 (gmm's output dtype), got {grad.dtype}")
    if operand.dtype not in _CODES or out_dtype not in _CODES:
        raise TypeError(f"{what}: operand {operand.dtype} / output {out_dtype} not supported (bf16 or f32)")
    _check_tensors(what, (grad, operand), group_sizes)
