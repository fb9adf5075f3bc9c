"""The tracers of ``areal_tpu/utils/perf_tracer.py``:

- the per-rollout session tracer the workflow executor and the RLVR
  workflow call (``set_task_context``, ``get_session_tracer``,
  ``start_session`` / ``phase`` / ``finalize``);
- the trainer loop's Chrome-trace span tracer (``trace_scope``,
  ``Category``, ``configure``, ``save``): off at ``PerfTracerConfig()``'s
  defaults, where a span costs one attribute read;
- on-demand device profiling (``start_device_profile`` /
  ``stop_device_profile``): ``torch.profiler`` in place of the XLA
  profiler, its Chrome trace written to the capture directory at stop.

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
from enum import Enum
from typing import Any


class Category(str, Enum):
    COMPUTE = "compute"
    COMM = "comm"
    IO = "io"
    SCHEDULER = "scheduler"
    INSTR = "instr"

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


class PerfTracer:
    """Chrome-trace (catapult JSON) span collector for one process."""

    def __init__(self, config=None, rank: int = 0, role: str | None = None):
        self.config = config
        self.enabled = bool(config is not None and config.enabled)
        self.rank = rank
        self.role = role
        self._events: list[dict[str, Any]] = []
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._last_save_step = -1

    @contextlib.contextmanager
    def trace_scope(self, name: str, category=Category.COMPUTE, args: dict | None = None):
        if not self.enabled:
            yield
            return
        cat = category.value if isinstance(category, Category) else (category or "instr")
        ev: dict[str, Any] = {"name": name, "ph": "X", "pid": self._pid, "tid": threading.get_ident() % 2**31,
                              "cat": cat}
        task_id, session_id = get_task_context()
        if args or task_id or session_id:
            ev["args"] = {**(args or {})}
            if task_id:
                ev["args"]["task_id"] = task_id
            if session_id:
                ev["args"]["session_id"] = session_id
        t0 = time.perf_counter_ns() / 1e3
        try:
            yield
        finally:
            ev["ts"] = t0
            ev["dur"] = time.perf_counter_ns() / 1e3 - t0
            with self._lock:
                self._events.append(ev)
                cap = self.config.max_events
                if cap and len(self._events) > cap:  # keep the newest
                    del self._events[: len(self._events) - cap]

    def _path(self) -> str:
        out = self.config.output_dir or "/tmp/areal_tpu/traces"
        os.makedirs(out, exist_ok=True)
        role = f"{self.role}_" if self.role else ""
        return os.path.join(out, f"trace_{role}rank{self.rank}.json")

    def save(self, step: int | None = None, force: bool = False) -> None:
        if not self.enabled:
            return
        if not force and step is not None:
            if step - self._last_save_step < max(1, self.config.save_freq_steps):
                return
            self._last_save_step = step
        with self._lock:
            events = list(self._events)
        with open(self._path(), "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


_TRACER = PerfTracer()


def configure(config, rank: int = 0, role: str | None = None) -> None:
    """Install the span tracer of ``config`` (a ``PerfTracerConfig``); the
    session tracer follows ``config.session_tracer`` when given, else the
    span tracer's ``enabled``."""
    global _TRACER, _SESSIONS
    _TRACER = PerfTracer(config, rank=rank, role=role)
    sess = config.session_tracer
    enabled = sess.enabled if sess is not None else config.enabled
    _SESSIONS = SessionTracer(
        (config.output_dir or "/tmp/areal_tpu/traces") if enabled else None,
        enabled=enabled,
        flush_threshold=sess.flush_threshold if sess is not None else 1,
    )


def trace_scope(name: str, category=Category.COMPUTE, args: dict | None = None):
    return _TRACER.trace_scope(name, category, args)


def save(step: int | None = None, force: bool = False) -> None:
    _TRACER.save(step=step, force=force)
    _SESSIONS.flush()


# one torch.profiler capture at a time per process
_PROFILE_LOCK = threading.Lock()
_PROFILE: tuple[str, Any] | None = None


def start_device_profile(output_dir: str | None = None) -> str:
    """Begin a ``torch.profiler`` capture (CPU and, on a card, CUDA
    activity). Returns the capture directory; raises RuntimeError while
    another capture is active."""
    global _PROFILE
    import torch

    with _PROFILE_LOCK:
        if _PROFILE is not None:
            raise RuntimeError(f"device profile already active at {_PROFILE[0]}")
        root = output_dir or (_TRACER.config.output_dir if _TRACER.config is not None else None)
        d = os.path.join(root or "/tmp/areal_tpu/traces", "torch_profile", f"profile_{int(time.time() * 1000)}")
        os.makedirs(d, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        _PROFILE = (d, prof)
    return d


def stop_device_profile() -> str | None:
    """End the active capture and write its Chrome trace; returns its
    directory (None when none is active)."""
    global _PROFILE
    with _PROFILE_LOCK:
        if _PROFILE is None:
            return None
        (d, prof), _PROFILE = _PROFILE, None
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(d, "trace.json"))
    return d
