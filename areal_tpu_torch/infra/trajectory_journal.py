"""The durable trajectory journal: accepted rollouts survive the trainer's
death (the port of ``areal_tpu/infra/trajectory_journal.py``; its files
are the JAX package's byte for byte, so each package reads the other's).

A trainer crash costs more than the lost optimizer steps: every accepted
but unconsumed trajectory, work the serving side already paid for and
which decoupled PPO could have trained on, dies with the results buffer.
The ``WorkflowExecutor`` appends every accepted trajectory (with its
per-token policy-version tags) to a crash-tolerant segmented journal; on
recovery the entries still inside the staleness bound replay into the
batch queue instead of being generated again, and over-stale entries are
counted and dropped (``areal_journal_*`` metrics).

Durability:

- The active segment (``segment_<n>.open``) is append-only: each record is
  a self-delimiting frame ``<u32 length> <8-byte sha256 prefix> <body>``,
  flushed (and fsynced unless ``fsync=False``) per append. A crash
  mid-append leaves a torn tail; reopening truncates at the last valid
  frame, so at most one trajectory is lost, never the segment.
- Sealing rewrites the segment through ``atomic_io.write_checksummed``
  (tmp file, fsync, atomic rename, checksum header) as
  ``segment_<n>.jrnl``: a sealed segment is verified on read and never
  half-written.
- Consumption is journaled too: when the trainer pops trajectories into a
  batch, a ``C`` marker records each task id and the policy version that
  trained on it. At replay, entries consumed by a step the recover
  checkpoint covers are skipped (training on them again would count them
  twice); entries consumed by a step the crash destroyed replay (the step
  runs again).

Replay policy: an entry replays iff ``restored_version - head_version <=
max_staleness`` (head_version = the smallest per-token tag), the bound
the ``StalenessManager`` enforced at admission, checked again against the
restored clock.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import pickle
import re
import struct
import tempfile
import threading
from typing import Any

import numpy as np

from areal_tpu_torch.observability import catalog
from areal_tpu_torch.utils import atomic_io

logger = logging.getLogger("areal_tpu_torch.trajectory_journal")

SEGMENT_MAGIC = b"ARLJRNL2\n"
_FRAME_HEAD = struct.Struct("<I8s")
# frame body: kind (b"T" traj / b"C" consumed-marker), version (head
# version for T, consumed-at version for C), task id, then the pickled
# payload (empty for markers). Keeping the identifying metadata OUT of
# the pickle lets gc()/consumption resolution run header-only — no
# trajectory tensors are ever deserialized just to learn a task id.
_BODY_HEAD = struct.Struct("<cqH")
_SEG_RE = re.compile(r"^segment_(\d{8})\.(open|jrnl)$")


@dataclasses.dataclass
class JournalEntry:
    """One accepted trajectory as journaled (arrays are host numpy)."""

    task_id: str
    head_version: int  # min per-token policy version in the trajectory
    tail_version: int  # max per-token policy version
    n_real_tokens: int  # attention-mask sum (dynamic-batch accounting)
    traj: dict[str, Any]
    # resolved during scan(): the policy version whose training step popped
    # this entry (None = never consumed before the crash)
    consumed_version: int | None = None
    # trajectory-lineage provenance (lineage_id/task_id/replica/reward from
    # observability/lineage.py) as journaled at append time — replay
    # re-registers the record from it, and postmortems can rebuild lineage
    # from disk when the ring died with the process
    lineage: dict[str, Any] | None = None


@dataclasses.dataclass
class _FrameMeta:
    """Header-only view of one frame (payload left pickled)."""

    kind: bytes  # b"T" | b"C"
    version: int
    task_id: str
    payload: bytes


def _frame(kind: bytes, version: int, task_id: str, payload: bytes) -> bytes:
    tid = task_id.encode("utf-8")
    body = _BODY_HEAD.pack(kind, int(version), len(tid)) + tid + payload
    return (
        _FRAME_HEAD.pack(len(body), hashlib.sha256(body).digest()[:8]) + body
    )


def _parse_body(body: bytes) -> _FrameMeta | None:
    if len(body) < _BODY_HEAD.size:
        return None
    kind, version, tid_len = _BODY_HEAD.unpack_from(body, 0)
    start = _BODY_HEAD.size
    if start + tid_len > len(body):
        return None
    return _FrameMeta(
        kind=kind,
        version=version,
        task_id=body[start : start + tid_len].decode("utf-8", "replace"),
        payload=body[start + tid_len :],
    )


def _read_frames(data: bytes) -> tuple[list[_FrameMeta], int]:
    """Parse frames; returns (metas, valid_prefix_len). Anything after
    the last intact frame — a torn tail from a crash mid-append — is
    excluded and its offset returned so callers can truncate."""
    metas: list[_FrameMeta] = []
    off = len(SEGMENT_MAGIC)
    if not data.startswith(SEGMENT_MAGIC):
        return [], 0
    while off + _FRAME_HEAD.size <= len(data):
        length, digest = _FRAME_HEAD.unpack_from(data, off)
        start = off + _FRAME_HEAD.size
        end = start + length
        if end > len(data):
            break  # torn: frame body incomplete
        body = data[start:end]
        if hashlib.sha256(body).digest()[:8] != digest:
            break  # torn/corrupt: stop at the last good frame
        meta = _parse_body(body)
        if meta is None:
            break  # checksummed-but-unparsable header: treat as tail
        metas.append(meta)
        off = end
    return metas, off


class TrajectoryJournal:
    """Crash-tolerant segmented journal of accepted trajectories.

    Thread-safe: appends arrive from the rollout dispatcher thread while
    consumption markers come from the trainer thread."""

    def __init__(
        self,
        directory: str,
        segment_max_records: int = 64,
        segment_max_bytes: int = 64 * 1024 * 1024,
        fsync: bool = True,
    ):
        self.dir = directory
        self.segment_max_records = max(1, segment_max_records)
        self.segment_max_bytes = max(1, segment_max_bytes)
        self.fsync = fsync
        self._lock = threading.Lock()
        self._fh = None  # active segment file object
        self._active_path: str | None = None
        self._active_records = 0
        self._active_bytes = 0
        self._next_seg = 0
        self._metrics = catalog.preemption_metrics()
        self.appended = 0  # trajectories appended by THIS writer
        os.makedirs(self.dir, exist_ok=True)
        self._recover_segments()

    # -- segment management ------------------------------------------------
    def _seg_path(self, n: int, open_: bool) -> str:
        return os.path.join(
            self.dir, f"segment_{n:08d}.{'open' if open_ else 'jrnl'}"
        )

    def _list_segments(self) -> list[tuple[int, str, str]]:
        out = []
        for name in os.listdir(self.dir):
            m = _SEG_RE.match(name)
            if m:
                out.append((int(m.group(1)), m.group(2), os.path.join(self.dir, name)))
        return sorted(out)

    def _recover_segments(self) -> None:
        """Seal any segment a dead writer left ``.open`` — its valid frame
        prefix survives; the torn tail (if any) is dropped and counted."""
        segs = self._list_segments()
        for n, kind, path in segs:
            self._next_seg = max(self._next_seg, n + 1)
            if kind != "open":
                continue
            with open(path, "rb") as f:
                data = f.read()
            metas, valid = _read_frames(data)
            if valid < len(data):
                logger.warning(
                    f"journal segment {os.path.basename(path)}: torn tail "
                    f"({len(data) - valid} bytes after the last intact "
                    "frame) truncated on recovery"
                )
            if metas:
                # the valid prefix is byte-identical to the frames parsed;
                # seal it verbatim under the atomic checksummed wrapper
                atomic_io.write_checksummed(
                    self._seg_path(n, open_=False), data[:valid]
                )
            os.unlink(path)

    def _open_active(self) -> None:
        n = self._next_seg
        self._next_seg += 1
        self._active_path = self._seg_path(n, open_=True)
        self._fh = open(self._active_path, "wb")
        self._fh.write(SEGMENT_MAGIC)
        self._fh.flush()
        self._active_records = 0
        self._active_bytes = len(SEGMENT_MAGIC)

    def _append_frame(
        self, kind: bytes, version: int, task_id: str, payload: bytes
    ) -> None:
        with self._lock:
            if self._fh is None:
                self._open_active()
            frame = _frame(kind, version, task_id, payload)
            self._fh.write(frame)
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            self._active_records += 1
            self._active_bytes += len(frame)
            if (
                self._active_records >= self.segment_max_records
                or self._active_bytes >= self.segment_max_bytes
            ):
                self._seal_active_locked()

    def _seal_active_locked(self) -> None:
        if self._fh is None:
            return
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        self._fh.close()
        path = self._active_path
        self._fh = None
        self._active_path = None
        if self._active_records == 0:
            os.unlink(path)
            return
        with open(path, "rb") as f:
            body = f.read()
        sealed = path[: -len(".open")] + ".jrnl"
        atomic_io.write_checksummed(sealed, body)
        os.unlink(path)

    def seal_active(self) -> None:
        """Seal the active segment NOW (preemption drain / clean shutdown):
        everything appended so far becomes an atomically-renamed,
        checksum-footed segment."""
        with self._lock:
            self._seal_active_locked()

    def close(self) -> None:
        self.seal_active()

    # -- write API ---------------------------------------------------------
    def append_trajectory(
        self,
        traj: dict[str, Any],
        task_id: str,
        head_version: int,
        tail_version: int,
        n_real_tokens: int,
        lineage: dict[str, Any] | None = None,
    ) -> None:
        """One ``T`` frame: the header carries the head version and task
        id, the pickled payload the tail version, the token count, the
        lineage metadata and every key as a host numpy array
        (``np.asarray``: a CUDA tensor raises instead of entering a
        frame), so the JAX package reads it."""
        record = {
            "tail_version": int(tail_version),
            "n_real_tokens": int(n_real_tokens),
            "traj": {k: np.asarray(v) for k, v in traj.items()},
        }
        if lineage is not None:
            record["lineage"] = dict(lineage)
        payload = pickle.dumps(record, protocol=pickle.HIGHEST_PROTOCOL)
        self._append_frame(b"T", int(head_version), task_id, payload)
        self.appended += 1
        self._metrics.journal_appended.inc()

    def mark_consumed(self, task_ids: list[str], version: int) -> None:
        """Record that a training step at ``version`` popped these
        trajectories. Durable like any record: if the step's effect is
        later checkpointed, replay skips them; if the crash destroys the
        step, replay resurrects them (the step re-runs). One header-only
        frame per task id — gc and replay resolution never unpickle
        anything to learn consumption."""
        for t in task_ids:
            self._append_frame(b"C", int(version), str(t), b"")

    # -- read API ----------------------------------------------------------
    def _read_segment(self, kind: str, path: str) -> list[_FrameMeta] | None:
        try:
            if kind == "jrnl":
                body = atomic_io.read_checksummed(path)
                metas, valid = _read_frames(body)
                if valid < len(body):
                    logger.warning(
                        f"sealed journal segment {os.path.basename(path)} "
                        "has trailing garbage past the last intact frame"
                    )
            else:
                # an .open segment read by a non-writer (e.g. replay
                # before any append): torn tail tolerated
                with open(path, "rb") as f:
                    metas, _ = _read_frames(f.read())
            return metas
        except (OSError, atomic_io.ChecksumError) as e:
            logger.warning(f"journal segment {path} unreadable: {e!r}")
            return None

    def _iter_segments(self):
        """(path, frame metas) per readable segment, in append order —
        ONE read per segment; callers decide which payloads to unpickle."""
        for n, kind, path in self._list_segments():
            metas = self._read_segment(kind, path)
            if metas is not None:
                yield path, metas

    def scan(self) -> list[JournalEntry]:
        """All journaled trajectories in append order, with consumption
        markers resolved onto them (trajectory payloads are unpickled —
        use the header-only paths in gc for metadata questions)."""
        entries: dict[str, JournalEntry] = {}
        order: list[str] = []
        for _path, metas in self._iter_segments():
            for m in metas:
                if m.kind == b"T":
                    try:
                        rec = pickle.loads(m.payload)
                    except Exception as e:  # noqa: BLE001 — one bad record
                        # must not poison the rest of the journal
                        logger.warning(f"journal record undecodable: {e!r}")
                        continue
                    e = JournalEntry(
                        task_id=m.task_id,
                        head_version=m.version,
                        tail_version=rec["tail_version"],
                        n_real_tokens=rec["n_real_tokens"],
                        traj=rec["traj"],
                        lineage=rec.get("lineage"),
                    )
                    if e.task_id not in entries:
                        order.append(e.task_id)
                    entries[e.task_id] = e
                elif m.kind == b"C" and m.task_id in entries:
                    entries[m.task_id].consumed_version = m.version
        return [entries[t] for t in order]

    def pending_for_replay(
        self, restored_version: int, max_staleness: int
    ) -> tuple[list[JournalEntry], list[JournalEntry], int]:
        """Partition the journal against a restored trainer clock.

        Returns ``(replayable, dropped_stale, n_skipped_consumed)``:

        - *replayable*: never consumed, or consumed by a training step the
          recover checkpoint does NOT cover (``consumed_version >=
          restored_version`` — that step died with the crash and will
          re-run), and still inside the staleness bound.
        - *dropped_stale*: would otherwise replay but ``restored_version -
          head_version > max_staleness`` — decoupled PPO's bound says the
          restored policy may not train on them. Returned as ENTRIES (not
          a count) so the caller can leave a per-trajectory audit trail
          (``kind=journal_drop_stale`` flight events).
        - *skipped_consumed*: consumed by a step the checkpoint covers;
          replaying would train on them twice.
        """
        replayable: list[JournalEntry] = []
        dropped_stale: list[JournalEntry] = []
        n_consumed = 0
        for e in self.scan():
            if (
                e.consumed_version is not None
                and e.consumed_version < restored_version
            ):
                n_consumed += 1
                continue
            if restored_version - e.head_version > max_staleness:
                dropped_stale.append(e)
                continue
            replayable.append(e)
        return replayable, dropped_stale, n_consumed

    def gc(self, covered_version: int) -> int:
        """Drop sealed segments that recovery can never need again: every
        trajectory in them consumed by a step at ``version <
        covered_version`` (durably inside the latest recover checkpoint).

        Header-only — ONE read per segment, no trajectory payload is
        unpickled. Consumption markers may live in a different segment
        than the trajectories they cover, and a marker is LOAD-BEARING
        while its trajectory's segment survives (deleting it would make
        the trajectory look unconsumed and replay — train on it twice).
        So candidacy runs to a fixpoint: a candidate holding a marker for
        a trajectory homed in a KEPT segment is itself kept. Marker-only
        segments become droppable once every marker they hold references
        a dropped/absent trajectory. Returns segments removed."""
        seg_paths: list[str] = []
        seg_traj_tids: list[set[str]] = []
        seg_marker_tids: list[set[str]] = []
        consumed: dict[str, int] = {}
        home: dict[str, int] = {}
        for n, kind, path in self._list_segments():
            if kind != "jrnl":
                continue
            metas = self._read_segment(kind, path)
            if metas is None:
                continue
            i = len(seg_paths)
            seg_paths.append(path)
            trajs: set[str] = set()
            markers: set[str] = set()
            for m in metas:
                if m.kind == b"T":
                    trajs.add(m.task_id)
                    home[m.task_id] = i
                elif m.kind == b"C":
                    markers.add(m.task_id)
                    consumed[m.task_id] = m.version
            seg_traj_tids.append(trajs)
            seg_marker_tids.append(markers)
        candidates = {
            i
            for i in range(len(seg_paths))
            if all(
                consumed.get(t, covered_version) < covered_version
                for t in seg_traj_tids[i]
            )
        }
        changed = True
        while changed:
            changed = False
            for i in list(candidates):
                for tid in seg_marker_tids[i]:
                    h = home.get(tid)
                    if h is not None and h not in candidates:
                        candidates.discard(i)
                        changed = True
                        break
        removed = 0
        for i in sorted(candidates):
            if not seg_traj_tids[i] and not seg_marker_tids[i]:
                continue  # defensively keep empty-parse segments
            os.unlink(seg_paths[i])
            removed += 1
        return removed

    def stats(self) -> dict[str, int]:
        segs = self._list_segments()
        return {
            "appended": self.appended,
            "segments_sealed": sum(1 for _, k, _ in segs if k == "jrnl"),
            "segments_open": sum(1 for _, k, _ in segs if k == "open"),
        }


def default_journal_dir(fileroot: str, experiment: str, trial: str) -> str:
    return os.path.join(
        fileroot, experiment or "exp", trial or "trial", "journal"
    )


def journal_from_config(cfg, fileroot: str = "", experiment: str = "", trial: str = ""):
    """Build a TrajectoryJournal from a TrajectoryJournalConfig (None when
    disabled)."""
    if cfg is None or not cfg.enabled:
        return None
    directory = cfg.dir or default_journal_dir(
        fileroot or os.path.join(tempfile.gettempdir(), "areal_tpu_torch", "experiments"), experiment, trial
    )
    return TrajectoryJournal(
        directory,
        segment_max_records=cfg.segment_max_records,
        segment_max_bytes=cfg.segment_max_bytes,
        fsync=cfg.fsync,
    )
