"""Grouped matrix multiply and its backward: the hand-written CUDA kernels
and their plain twins.

``gmm`` has the contract of jax's Pallas TPU kernel ``megablox.gmm`` as
``areal_tpu/models/moe.py:227-230`` calls it (``preferred_element_type``
f32, ``transpose_rhs=False``): ``lhs [M, k]`` rows sorted by group, group
``g`` owning ``group_sizes[g]`` rows after those of groups ``0..g-1``,
times ``rhs[g] [k, n]``, giving ``[M, n]`` in f32. Rows at or past
``sum(group_sizes)`` come back as zeros (megablox leaves them
uninitialized and the JAX caller masks them; on one device every row is
computed, so the model's paths never have such rows).

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
TILES = (16, 32, 64)  # the kernel's row-tile instantiations
# rows per work item: one group's rows are tiled from its own first row, so
# a tile of TM rows reads its expert's weights once. At decode (~2 rows per
# group) 16 wastes the least; at a prefill group (~256 rows per group) 64
# reads each expert's weights a quarter as often. chip_smoke.py's
# kernel_gmm phase times all three at both shapes; on the H100 16 was the
# fastest at decode and 64 at prefill (PERF.md's kernel table)
TILE_M = 64
_TILE_M_DECODE = 16
_MAX_ITEMS = 65535  # grid y

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "gmm_forward": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "gmm_bwd_lhs": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "tgmm": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "gmm_bwd_occupancy": ([_P], ctypes.c_int),
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
    """Rows per work item for ``M`` routed rows over ``E`` groups: 16 when
    the groups average fewer than 16 rows (decode), else ``TILE_M``."""
    return _TILE_M_DECODE if M < 16 * E else TILE_M


def _gmm_forward(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, tm: int | None) -> torch.Tensor:
    if lhs.device.type == "cpu":
        return gmm_plain(lhs, rhs, group_sizes)
    if lhs.device.type != "cuda":
        raise ValueError(f"gmm: unsupported device {lhs.device}")
    M, k = lhs.shape
    E, _, n = rhs.shape
    tm = pick_tile(M, E) if tm is None else tm
    _check_cuda_args(lhs, rhs, group_sizes, tm)
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
        tm,
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
    def forward(ctx, lhs, rhs, group_sizes, tm):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        ctx.tm = tm
        return _gmm_forward(lhs, rhs, group_sizes, tm)

    @staticmethod
    def backward(ctx, grad):
        lhs, rhs, group_sizes = ctx.saved_tensors
        grad = grad.float().contiguous()
        d_lhs = d_rhs = None
        if ctx.needs_input_grad[0]:
            d_lhs = gmm_bwd_lhs(grad, rhs, group_sizes, out_dtype=lhs.dtype, tm=ctx.tm)
        if ctx.needs_input_grad[1]:
            d_rhs = tgmm(lhs, grad, group_sizes, out_dtype=rhs.dtype)
        return d_lhs, d_rhs, None, None


def gmm(
    lhs: torch.Tensor,  # [M, k] bf16 | f32, rows sorted by group
    rhs: torch.Tensor,  # [E, k, n], lhs's dtype
    group_sizes: torch.Tensor,  # [E] int32
    *,
    tm: int | None = None,  # rows per work item (16 / 32 / 64); default pick_tile
) -> torch.Tensor:
    """Grouped matmul -> [M, n] f32; differentiable in lhs and rhs (through
    ``GroupedMatmul``) when gradients are on and either requires them."""
    if torch.is_grad_enabled() and (lhs.requires_grad or rhs.requires_grad):
        return GroupedMatmul.apply(lhs, rhs, group_sizes, tm)
    return _gmm_forward(lhs, rhs, group_sizes, tm)


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


def bwd_occupancy() -> dict[str, dict[str, int]]:
    """Registers a thread, shared memory a block (static and dynamic),
    blocks an SM and local (spill) bytes a thread of the bf16-operand
    backward kernels with a bf16 output, as the CUDA runtime reports them:
    ``gmm_bwd_lhs`` at 128- and 64-row tiles, ``tgmm`` (needs a card)."""
    info = (ctypes.c_int * 12)()
    rc = _lib().gmm_bwd_occupancy(info)
    if rc != 0:
        raise RuntimeError(f"gmm_bwd_occupancy failed (code {rc})")
    keys = ("registers", "smem_bytes", "blocks_per_sm", "local_bytes")
    return {name: dict(zip(keys, info[4 * i:4 * i + 4]))
            for i, name in enumerate(("gmm_bwd_lhs/128", "gmm_bwd_lhs/64", "tgmm"))}


def _lib():
    return _build.load("gmm", _SIGNATURES)  # built and loaded once per process


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_common(what: str, M: int, k: int, n: int, E: int, group_sizes, tm: int | None) -> None:
    if k % 8 or n % 8:
        raise ValueError(f"{what}: k={k} and n={n} must be multiples of 8")
    if not 0 < E <= _MAX_GROUPS:
        raise ValueError(f"{what}: {E} groups, the kernel takes 1..{_MAX_GROUPS}")
    if group_sizes.dtype != torch.int32 or group_sizes.shape != (E,) or not group_sizes.is_contiguous():
        raise ValueError(f"{what}: group_sizes must be contiguous int32 [E]")
    if tm is not None:
        if tm not in TILES:
            raise ValueError(f"{what}: tm={tm} not in {TILES}")
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


def _check_cuda_args(lhs, rhs, group_sizes, tm: int) -> None:
    """Refuse what the forward kernel does not take."""
    if lhs.dtype not in _CODES or rhs.dtype != lhs.dtype:
        raise TypeError(f"gmm: dtypes {lhs.dtype}/{rhs.dtype} not supported (both bf16 or both f32)")
    if lhs.dim() != 2 or rhs.dim() != 3 or rhs.shape[1] != lhs.shape[1]:
        raise ValueError(f"gmm: lhs [M, k] and rhs [E, k, n], got {tuple(lhs.shape)} and {tuple(rhs.shape)}")
    M, k = lhs.shape
    E, _, n = rhs.shape
    _check_common("gmm", M, k, n, E, group_sizes, tm)
    _check_tensors("gmm", (lhs, rhs), group_sizes)


def _check_bwd_args(what: str, grad, operand, group_sizes, out_dtype) -> None:
    """Refuse what a backward kernel does not take: an f32 cotangent, a bf16
    or f32 operand, an f32 or bf16 output."""
    if grad.dtype != torch.float32:
        raise TypeError(f"{what}: the cotangent must be f32 (gmm's output dtype), got {grad.dtype}")
    if operand.dtype not in _CODES or out_dtype not in _CODES:
        raise TypeError(f"{what}: operand {operand.dtype} / output {out_dtype} not supported (bf16 or f32)")
    _check_tensors(what, (grad, operand), group_sizes)
