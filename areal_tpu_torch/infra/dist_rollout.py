"""DistRolloutCoordinator: the rollout data of a trainer that spans several
ranks — the port of ``areal_tpu/infra/dist_rollout.py``.

Rank 0 alone pulls from the rollout client (the fleet's staleness
accounting sees one consumer) and broadcasts the padded batch to every rank
over ``torch.distributed``: a header (its byte count, then the JSON of the
keys, shapes and dtypes), then one broadcast per array, bf16 sent as f32
(``dist_rollout.py:62-106``).

What each rank gets differs from JAX. The JAX coordinator hands process r
its seqlen-balanced shard (``redistribute``), while ``JaxTrainEngine.
train_batch`` reads host arrays as the global batch
(``jax.device_put`` onto a global ``NamedSharding``) and its own multi-host
test feeds every process the same batch (ROADMAP Queue C, C-ref 10). The
port keeps the engine's contract: every rank gets the whole batch, the
broadcast before ``redistribute``, and the engine splits the grid rows over
the ranks itself, so a world of N computes the single-process step.
``redistribute`` is ported as it is.

A ``RolloutInterrupted`` on rank 0 (a preemption during the wait) reaches
every rank: the header says so and each rank raises it.
"""

from __future__ import annotations

import json

import numpy as np
import torch
import torch.distributed as dist

from areal_tpu_torch.infra.workflow_executor import RolloutInterrupted
from areal_tpu_torch.utils.datapack import balanced_greedy_partition

_INTERRUPTED = "__interrupted__"


def redistribute(batch: dict, n_parts: int) -> list[dict]:
    """Seqlen-balanced repartition of a padded batch into ``n_parts``
    shards (``dist_rollout.py:32``)."""
    attn = np.asarray(batch["attention_mask"])
    lens = attn.sum(-1).astype(np.int64)
    parts = balanced_greedy_partition(list(map(int, lens)), n_parts)
    return [{k: np.asarray(v)[sorted(idx)] for k, v in batch.items()} for idx in parts]


def _world() -> tuple[int, int]:
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _comm_device() -> torch.device:
    """Where the broadcast buffers live: the process's card under NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _broadcast(arr: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(_comm_device())
    dist.broadcast(t, src=0)
    return t.cpu().numpy()


class DistRolloutCoordinator:
    """Bridges a rollout client on rank 0 into the whole world."""

    def __init__(self, inference_engine):
        self.engine = inference_engine

    def _exchange(self, batch: dict | None) -> dict:
        """Rank 0's batch (None: interrupted) -> the same batch on every rank
        of a world of several."""
        rank, _ = _world()
        if rank == 0:
            header = {_INTERRUPTED: True} if batch is None else {
                k: {"shape": list(np.shape(v)), "dtype": np.asarray(v).dtype.name} for k, v in batch.items()
            }
            hbytes = np.frombuffer(json.dumps(header).encode(), np.uint8)
            hlen = np.asarray([len(hbytes)], np.int64)
        else:
            hlen = np.zeros(1, np.int64)
        hlen = int(_broadcast(hlen)[0])
        hbytes = _broadcast(hbytes if rank == 0 else np.zeros(hlen, np.uint8))
        header = json.loads(bytes(hbytes).decode())
        if header.get(_INTERRUPTED):
            raise RolloutInterrupted("rollout interrupted on rank 0")
        out = {}
        for k in sorted(header):
            shape, dtype = tuple(header[k]["shape"]), np.dtype(header[k]["dtype"])
            if dtype.kind in "OUS":  # strings and objects go pickled
                obj = [np.asarray(batch[k]) if rank == 0 else None]
                dist.broadcast_object_list(obj, src=0)
                out[k] = obj[0]
                continue
            send = np.float32 if dtype.name == "bfloat16" else dtype
            arr = np.asarray(batch[k]).astype(send) if rank == 0 else np.zeros(shape, send)
            # bools go as uint8: not every backend broadcasts torch.bool
            wire = arr.view(np.uint8) if arr.dtype == np.bool_ else arr
            got = _broadcast(wire)
            out[k] = got.view(np.bool_) if arr.dtype == np.bool_ else got
        return out

    def _pull(self, fn: str, *args, **kwargs) -> dict:
        rank, n = _world()
        if n == 1:
            if self.engine is None:
                raise RuntimeError("no inference engine connected (connect_engine)")
            return getattr(self.engine, fn)(*args, **kwargs)
        batch = None
        if rank == 0:
            try:
                batch = dict(getattr(self.engine, fn)(*args, **kwargs))
            except RolloutInterrupted:
                batch = None
        return self._exchange(batch)

    def prepare_batch(self, dataloader, workflow=None, **kw) -> dict:
        return self._pull("prepare_batch", dataloader, workflow=workflow, **kw)

    def rollout_batch(self, data: list[dict], workflow=None, **kw) -> dict:
        return self._pull("rollout_batch", data, workflow=workflow, **kw)
