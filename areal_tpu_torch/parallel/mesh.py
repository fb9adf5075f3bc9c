"""The device mesh of a trainer that spans several GPUs — the port of
``areal_tpu/parallel/mesh.py``.

One process drives one card (``torchrun`` starts them, ``init_distributed``
joins them into one world) and the world is laid out as a
``torch.distributed`` ``DeviceMesh`` over the JAX package's axes:

    axes = (data, fsdp, seq, model, expert, pipe)

- ``data`` x ``fsdp``: the grid rows (data parallelism). The parameters,
  their gradients and the AdamW moments shard over ``fsdp`` (FSDP2
  ``fully_shard``) and replicate over ``data`` (HSDP).
- ``model``: tensor parallelism (``parallel/tensor_parallel.py``); the
  placement of each leaf is ``models/qwen.py param_partition_specs``.
- ``seq``, ``expert``, ``pipe``: ROADMAP Queue A item 6b; the train engine
  refuses a size above 1.

Axes of size 1 stay in the mesh, as in JAX, so a world of one card runs the
same sharded code.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from areal_tpu_torch.api.alloc_mode import ParallelStrategy
from areal_tpu_torch.api.config import MeshConfig

MESH_AXES = ("data", "fsdp", "seq", "model", "expert", "pipe")
BATCH_AXES = ("data", "fsdp")


def init_distributed(device: torch.device) -> bool:
    """Join the launcher's world: NCCL for a CUDA ``device`` (the process's
    card is made current), gloo for the CPU. The rank, the world size and
    the rendezvous come from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``). Returns True when a
    world is up — this call's or one the caller started (the tests start
    theirs over a ``FileStore``) — and False outside a launcher. A world
    that does not come up raises: there is no single-process fallback."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return False
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method="env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        device_id=device if device.type == "cuda" else None,
    )
    return True


def is_lead() -> bool:
    """Rank 0 of the world, or a process outside one: the one that talks
    to the server, writes the files and logs."""
    return not dist.is_initialized() or dist.get_rank() == 0


def mesh_sizes(cfg: MeshConfig | None, n: int) -> dict[str, int]:
    """The axis sizes of ``cfg`` over ``n`` devices; the one axis at -1
    (``data`` by default) absorbs what the others leave, with the JAX
    ``make_mesh``'s checks."""
    cfg = cfg or MeshConfig()
    sizes = {a: int(getattr(cfg, a, 1)) for a in MESH_AXES}
    fixed = math.prod(v for v in sizes.values() if v != -1)
    wildcard = [k for k, v in sizes.items() if v == -1]
    if wildcard:
        if len(wildcard) != 1:
            raise ValueError("at most one mesh axis may be -1")
        if n % fixed:
            raise ValueError(f"mesh {sizes} does not divide {n} devices")
        sizes[wildcard[0]] = n // fixed
    total = math.prod(sizes.values())
    if total != n:
        raise ValueError(f"mesh {sizes} needs {total} devices, have {n}")
    return sizes


def make_mesh(cfg: MeshConfig | None, device: torch.device):
    """The world as a ``DeviceMesh`` over ``MESH_AXES`` (every axis kept,
    size 1 included); the world must be up (``init_distributed``)."""
    from torch.distributed.device_mesh import init_device_mesh

    sizes = mesh_sizes(cfg, dist.get_world_size())
    return init_device_mesh(torch.device(device).type, tuple(sizes[a] for a in MESH_AXES), mesh_dim_names=MESH_AXES)


def mesh_from_parallel_strategy(ps: ParallelStrategy, device: torch.device):
    """An allocation-mode strategy as a mesh: dp -> fsdp, tp -> model, cp ->
    seq, ep -> expert; ``pp`` must be 1."""
    if ps.pp != 1:
        raise ValueError("pipeline parallelism: pp must be 1")
    return make_mesh(MeshConfig(data=1, fsdp=ps.dp, seq=ps.cp, model=ps.tp, expert=ps.ep), device)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(MESH_AXES.index(axis))


def dp_size(mesh) -> int:
    """The data-parallel degree: rows of a grid split over data x fsdp."""
    return axis_size(mesh, "data") * axis_size(mesh, "fsdp")


def dp_rank(mesh) -> int:
    """This rank's block of grid rows, in the order in which the JAX
    ``batch_sharding`` splits rows over (data, fsdp): data-major."""
    return mesh.get_local_rank("data") * axis_size(mesh, "fsdp") + mesh.get_local_rank("fsdp")


def all_reduce(t: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over the product of ``axes`` (one all-reduce per axis of
    size above 1; none in a world of one)."""
    for a in axes:
        if axis_size(mesh, a) > 1:
            dist.all_reduce(t, op=op, group=mesh.get_group(a))
    return t


def gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's [rows, ...] block along dim 0, in ``dp_rank`` order
    (the global grid), on every rank."""
    for a in ("fsdp", "data"):  # fsdp blocks first: data-major, fsdp-minor
        n = axis_size(mesh, a)
        if n > 1:
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t.contiguous(), group=mesh.get_group(a))
            t = torch.cat(parts)
    return t
