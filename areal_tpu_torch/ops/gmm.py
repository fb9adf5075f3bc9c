"""Grouped matrix multiply: the hand-written CUDA kernel and its plain twin.

``gmm`` has the contract of jax's Pallas TPU kernel ``megablox.gmm`` as
``areal_tpu/models/moe.py:227-230`` calls it (``preferred_element_type``
f32, ``transpose_rhs=False``): ``lhs [M, k]`` rows sorted by group, group
``g`` owning ``group_sizes[g]`` rows after those of groups ``0..g-1``,
times ``rhs[g] [k, n]``, giving ``[M, n]`` in f32. Rows at or past
``sum(group_sizes)`` come back as zeros (megablox leaves them
uninitialized and the JAX caller masks them; on one device every row is
computed, so the serving path never has such rows).

Dispatch is by the device of ``lhs``: a CPU tensor takes ``gmm_plain``; a
CUDA tensor launches ``csrc/gmm.cu`` or raises. The kernel has no backward
yet (megablox's VJP runs ``gmm(transpose_rhs=True)`` and ``tgmm``: ROADMAP
Queue A item 7b), so a CUDA call that would need one raises.
``gmm.launches`` counts kernel launches.
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
_SIGNATURES = {"gmm_forward": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int)}


def gmm_plain(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """For each group g, ``lhs[a:b].float() @ rhs[g].float()`` over its rows
    [a, b); rows past the last group are zeros. Reads the sizes on the host
    (a sync on a card: the plain version is for the CPU and for checking)."""
    M, n = lhs.shape[0], rhs.shape[2]
    parts, a = [], 0
    for g, s in enumerate(group_sizes.tolist()):
        b = min(a + max(int(s), 0), M)
        if b > a:
            parts.append(lhs[a:b].float() @ rhs[g].float())
        a = b
    parts.append(lhs.new_zeros((M - a, n), dtype=torch.float32))
    return torch.cat(parts)


def pick_tile(M: int, E: int) -> int:
    """Rows per work item for ``M`` routed rows over ``E`` groups: 16 when
    the groups average fewer than 16 rows (decode), else ``TILE_M``."""
    return _TILE_M_DECODE if M < 16 * E else TILE_M


def gmm(
    lhs: torch.Tensor,  # [M, k] bf16 | f32, rows sorted by group
    rhs: torch.Tensor,  # [E, k, n], lhs's dtype
    group_sizes: torch.Tensor,  # [E] int32
    *,
    tm: int | None = None,  # rows per work item (16 / 32 / 64); default pick_tile
) -> torch.Tensor:
    """Grouped matmul -> [M, n] f32."""
    if lhs.device.type == "cpu":
        return gmm_plain(lhs, rhs, group_sizes)
    if lhs.device.type != "cuda":
        raise ValueError(f"gmm: unsupported device {lhs.device}")
    if torch.is_grad_enabled() and (lhs.requires_grad or rhs.requires_grad):
        raise NotImplementedError("gmm backward (MoE training): ROADMAP Queue A item 7b")
    M, k = lhs.shape
    E, _, n = rhs.shape
    tm = pick_tile(M, E) if tm is None else tm
    _check_cuda_args(lhs, rhs, group_sizes, tm)
    out = torch.empty((M, n), dtype=torch.float32, device=lhs.device)
    lib = _build.load("gmm", _SIGNATURES)  # built and loaded once per process
    rc = lib.gmm_forward(
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
        torch.cuda.current_stream(lhs.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"gmm kernel launch failed (code {rc})")
    gmm.launches += 1
    return out


gmm.launches = 0


def _check_cuda_args(lhs, rhs, group_sizes, tm: int) -> None:
    """Refuse what the kernel does not take (it reads raw pointers with
    16-byte copies)."""
    if rhs.device != lhs.device or group_sizes.device != lhs.device:
        raise ValueError("gmm: all tensors must be on one device")
    if lhs.dtype not in _CODES or rhs.dtype != lhs.dtype:
        raise TypeError(f"gmm: dtypes {lhs.dtype}/{rhs.dtype} not supported (both bf16 or both f32)")
    if lhs.dim() != 2 or rhs.dim() != 3 or rhs.shape[1] != lhs.shape[1]:
        raise ValueError(f"gmm: lhs [M, k] and rhs [E, k, n], got {tuple(lhs.shape)} and {tuple(rhs.shape)}")
    M, k = lhs.shape
    E, _, n = rhs.shape
    if k % 8 or n % 8:
        raise ValueError(f"gmm: k={k} and n={n} must be multiples of 8")
    if not 0 < E <= _MAX_GROUPS:
        raise ValueError(f"gmm: {E} groups, the kernel takes 1..{_MAX_GROUPS}")
    if group_sizes.dtype != torch.int32 or group_sizes.shape != (E,) or not group_sizes.is_contiguous():
        raise ValueError("gmm: group_sizes must be contiguous int32 [E]")
    if tm not in TILES:
        raise ValueError(f"gmm: tm={tm} not in {TILES}")
    if M // tm + E + 1 > _MAX_ITEMS:
        raise ValueError(f"gmm: M={M} rows are too many for tm={tm} ({_MAX_ITEMS} work items)")
    if not (lhs.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("gmm: lhs and rhs must be contiguous")
    if lhs.data_ptr() % 16 or rhs.data_ptr() % 16:
        raise ValueError("gmm: lhs and rhs must be 16-byte aligned")
