"""Cross-process trace-context propagation (``x-areal-trace``), the port of
``areal_tpu/observability/tracecontext.py``.

The perf tracer keeps task / session ids in ContextVars, so what a workflow
coroutine records lands on its rollout. Those ids die at a process
boundary; this module carries them across an HTTP hop in one header:

    x-areal-trace: task=<task_id>;session=<session_id>

Senders call :func:`inject` on their outbound headers; receivers call
:func:`extract` before doing work, which seats the ContextVars so the
request timeline the engine starts carries the originating ids.
"""

from __future__ import annotations

from typing import Mapping, MutableMapping

from areal_tpu_torch.api.wire import TRACE_HEADER
from areal_tpu_torch.utils import perf_tracer

__all__ = [
    "TRACE_HEADER",
    "format_trace_header",
    "parse_trace_header",
    "current_trace_header",
    "apply_trace_header",
    "inject",
    "extract",
]


def format_trace_header(task_id: str | None, session_id: str | None) -> str | None:
    """Encode ids into the wire value; None when there is nothing to send."""
    parts = []
    if task_id:
        parts.append(f"task={task_id}")
    if session_id:
        parts.append(f"session={session_id}")
    return ";".join(parts) if parts else None


def parse_trace_header(value: str) -> tuple[str | None, str | None]:
    """Decode a wire value into (task_id, session_id). Unknown ``k=v``
    pairs are ignored and malformed fragments never raise: a bad header must
    not fail a request."""
    task_id = session_id = None
    for part in (value or "").split(";"):
        k, _, v = part.strip().partition("=")
        if not v:
            continue
        if k == "task":
            task_id = v
        elif k == "session":
            session_id = v
    return task_id, session_id


def current_trace_header() -> str | None:
    """The header value for the calling context, or None outside a task."""
    task_id, session_id = perf_tracer.get_task_context()
    return format_trace_header(task_id, session_id)


def apply_trace_header(value: str | None) -> None:
    """Seat the ids of a received header into this context's ContextVars."""
    if not value:
        return
    task_id, session_id = parse_trace_header(value)
    if task_id or session_id:
        perf_tracer.set_task_context(task_id=task_id, session_id=session_id)


def inject(headers: MutableMapping[str, str] | None = None) -> dict:
    """``headers`` (a new dict if None) with the trace header added when the
    calling context carries ids."""
    out = dict(headers or {})
    value = current_trace_header()
    if value:
        out[TRACE_HEADER] = value
    return out


def extract(headers: Mapping[str, str]) -> tuple[str | None, str | None]:
    """Read and apply the trace header of inbound request headers (matched
    case-insensitively). Returns the (task_id, session_id) it seated,
    (None, None) when absent.

    The context is set to exactly what the header carries: a request
    without the header clears both ids, because one handler thread serves a
    keep-alive connection's requests in turn and would otherwise pass the
    previous request's ids on."""
    value = headers.get(TRACE_HEADER)
    if value is None:
        for k, v in headers.items():
            if k.lower() == TRACE_HEADER:
                value = v
                break
    perf_tracer.clear_task_context()
    if not value:
        return None, None
    apply_trace_header(value)
    return parse_trace_header(value)
