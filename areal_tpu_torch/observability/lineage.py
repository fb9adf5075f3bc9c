"""Trajectory lineage: the per-trajectory record joining serving-side
provenance to training-side loss diagnostics (the port of
``areal_tpu/observability/lineage.py``).

It answers the off-policy question decoupled PPO lives on: what happened to
this trajectory between generation and the gradient: which replica
generated it at which policy version, when the trainer consumed it, and
whether its tokens still contributed gradient or arrived clipped.

A bounded ring of :class:`TrajectoryLineageRecord`, keyed by a
monotonically increasing ``lineage_id`` the ``WorkflowExecutor`` stamps
onto each accepted trajectory (the ``lineage_id`` per-sequence batch key
rides through batching, minibatch splits and the packed grids). Three
writers touch each record:

1. **accept** (the rollout dispatcher thread): task id, replica, head /
   tail version, reward, token count; registered before the journal
   append, so the journal frame's payload carries the same metadata.
2. **consume** (the trainer thread, batch pop): the policy version whose
   training step popped it.
3. **train** (the trainer thread, ``ppo_update``): the trajectory's clip
   fraction and behave approx-KL, attributed back through the packed
   grid's segment map (``trainer/ppo.py _per_sequence_stats``).

The ring is dumped beside the flight recorder's dumps (the trainer's
``close`` and preemption drain), atomically, as ``FlightRecorder.dump``
writes.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from collections import OrderedDict
from dataclasses import asdict, dataclass, field

from areal_tpu_torch.observability import catalog as obs_catalog
from areal_tpu_torch.utils import atomic_io

logger = logging.getLogger("areal_tpu_torch.lineage")

# records retained; old entries are evicted FIFO (a bounded ring, like the
# flight recorder: postmortems care about the recent window)
DEFAULT_LINEAGE_CAPACITY = 4096


@dataclass
class TrajectoryLineageRecord:
    """One accepted trajectory's life, generation -> gradient."""

    lineage_id: int
    task_id: str
    replica: str = ""
    head_version: int = -1  # min per-token policy version at acceptance
    tail_version: int = -1  # max per-token policy version
    n_tokens: int = 0
    reward: float = 0.0
    accepted_ts: float = field(default_factory=time.time)  # wall clock
    journaled: bool = False
    # consume stage (batch pop)
    consumed_version: int | None = None
    consumed_ts: float | None = None
    # train stage (ppo_update attribution)
    trained_version: int | None = None
    trained_ts: float | None = None
    train_tokens: float | None = None
    clip_fraction: float | None = None
    behave_kl: float | None = None

    @property
    def lag_at_consume(self) -> int | None:
        if self.consumed_version is None or self.head_version < 0:
            return None
        return max(0, self.consumed_version - self.head_version)


class TrajectoryLineage:
    """Bounded, thread-safe lineage ring (one per process).

    Writers arrive from the rollout dispatcher thread (accept) and the
    trainer thread (consume, train); everything is dict operations under
    one lock."""

    def __init__(self, capacity: int = DEFAULT_LINEAGE_CAPACITY):
        self.capacity = max(1, capacity)
        self._lock = threading.Lock()
        self._records: OrderedDict[int, TrajectoryLineageRecord] = OrderedDict()
        self._by_task: dict[str, int] = {}
        self._next_id = 0
        self._evicted = 0
        self._obs = obs_catalog.learning_health_metrics()

    # -- accept (rollout side) --------------------------------------------
    def register(
        self,
        task_id: str,
        replica: str = "",
        head_version: int = -1,
        tail_version: int = -1,
        n_tokens: int = 0,
        reward: float = 0.0,
        journaled: bool = False,
    ) -> int:
        """A new record for an accepted trajectory; returns its lineage id
        (stamped into the trajectory's ``lineage_id`` batch key)."""
        with self._lock:
            lid = self._next_id
            self._next_id += 1
            rec = TrajectoryLineageRecord(
                lineage_id=lid,
                task_id=task_id,
                replica=replica,
                head_version=head_version,
                tail_version=tail_version,
                n_tokens=n_tokens,
                reward=reward,
                journaled=journaled,
            )
            self._records[lid] = rec
            self._by_task[task_id] = lid
            while len(self._records) > self.capacity:
                old_lid, old = self._records.popitem(last=False)
                if self._by_task.get(old.task_id) == old_lid:
                    del self._by_task[old.task_id]
                self._evicted += 1
        self._obs.lineage_records.inc()
        return lid

    def mark_journaled(self, lineage_id: int) -> None:
        with self._lock:
            rec = self._records.get(lineage_id)
            if rec is not None:
                rec.journaled = True

    # -- consume (batch pop) ----------------------------------------------
    def mark_consumed(self, task_ids: list[str], version: int) -> None:
        now = time.time()
        with self._lock:
            for tid in task_ids:
                lid = self._by_task.get(tid)
                rec = self._records.get(lid) if lid is not None else None
                if rec is not None:
                    rec.consumed_version = int(version)
                    rec.consumed_ts = now

    # -- train (ppo_update attribution) -----------------------------------
    def record_train(
        self,
        lineage_id: int,
        version: int,
        tokens: float,
        clip_fraction: float,
        behave_kl: float | None = None,
    ) -> None:
        with self._lock:
            rec = self._records.get(lineage_id)
            if rec is None:
                return
            first_join = rec.trained_version is None
            rec.trained_version = int(version)
            rec.trained_ts = time.time()
            rec.train_tokens = float(tokens)
            rec.clip_fraction = float(clip_fraction)
            if behave_kl is not None:
                rec.behave_kl = float(behave_kl)
        if first_join:
            self._obs.lineage_joined.inc()

    # -- read side ---------------------------------------------------------
    def get(self, lineage_id: int) -> TrajectoryLineageRecord | None:
        with self._lock:
            return self._records.get(lineage_id)

    def by_task(self, task_id: str) -> TrajectoryLineageRecord | None:
        with self._lock:
            lid = self._by_task.get(task_id)
            return self._records.get(lid) if lid is not None else None

    def recent(self, n: int | None = None) -> list[TrajectoryLineageRecord]:
        with self._lock:
            recs = list(self._records.values())
        return recs if n is None else recs[-n:]

    def snapshot(self) -> dict:
        """JSON-able payload; the ``lineage_records`` key marks a lineage
        dump for a postmortem merge."""
        with self._lock:
            return {
                "role": "trainer_lineage",
                "pid": os.getpid(),
                "capacity": self.capacity,
                "evicted": self._evicted,
                "lineage_records": [asdict(r) for r in self._records.values()],
            }

    def dump(self, path: str, reason: str = "manual") -> str:
        """Atomically persist the ring beside the flight recorder's dumps
        (a crash mid-dump never tears it)."""
        snap = self.snapshot()
        snap["dump_reason"] = reason
        snap["dumped_at"] = time.time()
        atomic_io.atomic_write_text(path, json.dumps(snap, indent=1))
        logger.info(f"trajectory lineage dumped to {path} ({reason})")
        return path


def lineage_to_trace_events(snapshot: dict) -> list[dict]:
    """A lineage dump as catapult traceEvents: one span per trajectory from
    acceptance to its last known stage (consume or train), plus an instant
    at the train join carrying the loss attribution. ``args.task_id``
    matches the request timelines' ``x-areal-trace`` correlation."""
    out: list[dict] = []
    for rec in snapshot.get("lineage_records", []):
        t0 = float(rec.get("accepted_ts") or 0.0)
        end = rec.get("trained_ts") or rec.get("consumed_ts")
        args = {
            "task_id": rec.get("task_id"),
            "lineage_id": rec.get("lineage_id"),
            "replica": rec.get("replica"),
            "head_version": rec.get("head_version"),
            "tail_version": rec.get("tail_version"),
            "consumed_version": rec.get("consumed_version"),
            "reward": rec.get("reward"),
            "journaled": rec.get("journaled"),
        }
        tid = 1
        if end is not None and end >= t0:
            out.append(
                {
                    "name": f"traj {str(rec.get('task_id', ''))[:8]}",
                    "ph": "X",
                    "tid": tid,
                    "ts": t0 * 1e6,
                    "dur": (float(end) - t0) * 1e6,
                    "cat": "lineage",
                    "args": args,
                }
            )
        if rec.get("trained_ts") is not None:
            out.append(
                {
                    "name": "traj_update",
                    "ph": "i",
                    "s": "t",
                    "tid": tid,
                    "ts": float(rec["trained_ts"]) * 1e6,
                    "cat": "lineage",
                    "args": {
                        **args,
                        "trained_version": rec.get("trained_version"),
                        "clip_fraction": rec.get("clip_fraction"),
                        "behave_kl": rec.get("behave_kl"),
                        "train_tokens": rec.get("train_tokens"),
                    },
                }
            )
    return out


# ---------------------------------------------------------------------------
# the process-default ring
# ---------------------------------------------------------------------------

_LINEAGE = TrajectoryLineage()


def get_lineage() -> TrajectoryLineage:
    return _LINEAGE


def default_dump_path(tag: str = "") -> str:
    """Beside the flight recorder's dumps: ``AREAL_FLIGHT_DIR``, else a
    folder in the temp dir (``observability/timeline.py``)."""
    d = os.environ.get("AREAL_FLIGHT_DIR") or os.path.join(tempfile.gettempdir(), "areal_tpu_torch", "flight")
    name = f"lineage_{os.getpid()}"
    if tag:
        name += f"_{tag}"
    return os.path.join(d, name + ".json")
