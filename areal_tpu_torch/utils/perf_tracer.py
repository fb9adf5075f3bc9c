"""The per-rollout session tracer of ``areal_tpu/utils/perf_tracer.py``:
the part the workflow executor and the RLVR workflow call
(``set_task_context``, ``get_session_tracer``, ``start_session`` / ``phase`` /
``finalize``). The Chrome-trace event tracer and device profiling wait for
ROADMAP Queue A item 7.

Task and session ids ride ContextVars, so a phase recorded inside a
workflow coroutine lands on that coroutine's session. Off by default;
``configure_sessions(output_dir, enabled=True)`` writes finalized sessions
to ``<output_dir>/sessions.jsonl``.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any

_task_id_var: contextvars.ContextVar[str | None] = contextvars.ContextVar("areal_trace_task", default=None)
_session_id_var: contextvars.ContextVar[str | None] = contextvars.ContextVar("areal_trace_session", default=None)


def set_task_context(task_id: str | None = None, session_id: str | None = None):
    if task_id is not None:
        _task_id_var.set(task_id)
    if session_id is not None:
        _session_id_var.set(session_id)


def get_task_context() -> tuple[str | None, str | None]:
    """(task_id, session_id) of the calling context."""
    return _task_id_var.get(), _session_id_var.get()


@dataclass
class SessionRecord:
    """The lifecycle of one rollout episode."""

    session_id: str
    start_ts: float = field(default_factory=time.time)
    phases: list[dict[str, Any]] = field(default_factory=list)
    status: str | None = None  # accepted | rejected
    end_ts: float | None = None


class SessionTracer:
    def __init__(self, output_dir: str | None = None, enabled: bool = True, flush_threshold: int = 1):
        if enabled and not output_dir:
            raise ValueError("an enabled session tracer needs output_dir")
        self.enabled = enabled
        self.output_dir = output_dir
        # finalized records buffer until this many are ready
        self.flush_threshold = max(1, flush_threshold)
        self._records: dict[str, SessionRecord] = {}
        self._done: list[dict] = []
        self._lock = threading.Lock()

    def start_session(self, session_id: str) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._records[session_id] = SessionRecord(session_id)
        _session_id_var.set(session_id)

    @contextlib.contextmanager
    def phase(self, name: str, session_id: str | None = None):
        sid = session_id or _session_id_var.get()
        t0 = time.time()
        try:
            yield
        finally:
            if self.enabled and sid is not None:
                with self._lock:
                    rec = self._records.get(sid)
                    if rec is not None:
                        rec.phases.append({"name": name, "start": t0, "dur": time.time() - t0})

    def finalize(self, session_id: str, status: str) -> None:
        if not self.enabled:
            return
        with self._lock:
            rec = self._records.pop(session_id, None)
            if rec is None:
                return
            rec.status = status
            rec.end_ts = time.time()
            self._done.append(
                {
                    "session_id": rec.session_id,
                    "start": rec.start_ts,
                    "end": rec.end_ts,
                    "status": rec.status,
                    "phases": rec.phases,
                }
            )
            ready = len(self._done) >= self.flush_threshold
        if ready:
            self.flush()

    def flush(self) -> None:
        """Append the buffered finalized records to sessions.jsonl."""
        with self._lock:
            done, self._done = self._done, []
        if not done:
            return
        os.makedirs(self.output_dir, exist_ok=True)
        with open(os.path.join(self.output_dir, "sessions.jsonl"), "a") as f:
            for d in done:
                f.write(json.dumps(d) + "\n")


_SESSIONS = SessionTracer(enabled=False)


def configure_sessions(output_dir: str | None, enabled: bool = True, flush_threshold: int = 1) -> None:
    global _SESSIONS
    _SESSIONS = SessionTracer(output_dir, enabled=enabled, flush_threshold=flush_threshold)


def get_session_tracer() -> SessionTracer:
    return _SESSIONS
