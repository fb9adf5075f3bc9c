"""Request timelines and the flight recorder, the port of
``areal_tpu/observability/timeline.py``.

- :class:`RequestTimeline` / :class:`TimelineRecorder`: every request
  gathers timestamped stage events as it moves through the decode engine
  (queued -> admitted -> radix match -> prefill -> first token -> decode
  chunks -> park / resume -> fence stall -> terminal), tagged with the
  policy version and the ``x-areal-trace`` ids. A completed timeline feeds
  the ``areal_request_*_seconds`` histograms and a per-request breakdown
  that the engine stamps onto ``ModelResponse``, so a caller can split a
  request's latency without scraping.
- :class:`FlightRecorder`: a bounded ring of significant events per process
  (admission rejects, evictions, weight stage / commit, watchdog, wedge,
  drain), served at ``/debug/flight`` and dumped atomically on a wedge and
  on SIGTERM.

Nothing here reads a device tensor: a mark is one ``time.monotonic()`` read
and a list append on the decode thread.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

from areal_tpu_torch.observability import catalog as obs_catalog

logger = logging.getLogger("areal_tpu_torch.timeline")

# per-timeline event cap: per-chunk decode events are unbounded on long
# generations; past the cap new events are counted, not stored (the stage
# *durations* come from first/terminal marks, which always record)
MAX_EVENTS_PER_TIMELINE = 256
# completed timelines retained for /debug/flight scrapes
DEFAULT_RECENT_TIMELINES = 512
# flight-recorder ring capacity (events, not bytes)
DEFAULT_FLIGHT_CAPACITY = 2048

# the only priority classes the ttft histogram may label with: the header
# is client-controlled, and every distinct value would mint a new labeled
# histogram child — unknown classes clamp to "interactive"
PRIORITY_CLASSES = ("interactive", "rollout")

# stage-name constants
QUEUED = "queued"
ADMITTED = "admitted"
RADIX_MATCH = "radix_match"
PREFILL_START = "prefill_start"
PREFILL_END = "prefill_end"
FIRST_TOKEN = "first_token"
DECODE_CHUNK = "decode_chunk"
DRAFT = "draft"  # speculative round: drafter proposed tokens for this slot
VERIFY = "verify"  # speculative round: verify forward scored + accepted
PARK = "park"
RESUME = "resume"
FENCE_STALL = "fence_stall"
TERMINAL = "terminal"


@dataclass
class RequestTimeline:
    """Stage events of one engine-side generation attempt.

    Timestamps are ``time.monotonic()`` (durations) with one paired
    ``time.time()`` anchor (``epoch_anchor`` at ``queued``) so trace
    tooling can place the spans on a cross-process wall clock.
    """

    rid: str
    priority: str = "interactive"
    task_id: str | None = None  # x-areal-trace correlation ids
    session_id: str | None = None
    version: int = -1  # policy version at admission
    queued_ts: float = field(default_factory=time.monotonic)
    epoch_anchor: float = field(default_factory=time.time)
    events: list[tuple[str, float, dict | None]] = field(default_factory=list)
    dropped_events: int = 0
    # accumulators the decode loop maintains outside the event stream
    fence_stall_s: float = 0.0
    # the portion of fence_stall_s accrued BEFORE the first token (a hold
    # can land between prefill and the first chunk): TPOT's window starts
    # at the first token, so only the remainder is subtracted from it
    fence_stall_pre_first_s: float = 0.0
    park_s: float = 0.0
    terminal_reason: str | None = None

    def __post_init__(self) -> None:
        self.events.append((QUEUED, self.queued_ts, None))

    def mark(self, stage: str, **args: Any) -> None:
        # TERMINAL is exempt from the cap: a >cap-chunk generation must
        # still record its end, or the decode span (first_token->terminal)
        # vanishes from traces and ``breakdown`` loses its right edge
        if len(self.events) >= MAX_EVENTS_PER_TIMELINE and stage != TERMINAL:
            self.dropped_events += 1
            return
        self.events.append((stage, time.monotonic(), args or None))

    def ts_of(self, stage: str) -> float | None:
        """Monotonic timestamp of the FIRST occurrence of ``stage``."""
        for name, ts, _ in self.events:
            if name == stage:
                return ts
        return None

    def breakdown(self) -> dict[str, float]:
        """Per-stage durations. ``other_s`` is the explicit residual so the
        named stages plus ``other_s`` always sum to ``total_s`` exactly —
        "stage sums ≈ wall time" is then an assertion that ``other_s`` is
        small, not an accounting identity that hides gaps."""
        t_q = self.queued_ts
        t_admit = self.ts_of(ADMITTED)
        t_ps = self.ts_of(PREFILL_START)
        t_pe = self.ts_of(PREFILL_END)
        t_first = self.ts_of(FIRST_TOKEN)
        t_term = self.ts_of(TERMINAL)
        end = t_term if t_term is not None else time.monotonic()
        total = max(0.0, end - t_q)
        queue_wait = max(0.0, (t_admit if t_admit is not None else end) - t_q)
        prefill = (
            max(0.0, t_pe - t_ps)
            if (t_ps is not None and t_pe is not None)
            else 0.0
        )
        ttft = max(0.0, t_first - t_q) if t_first is not None else 0.0
        # decode runs from the end of prefill (or the resume/aliased
        # admission when there was none) to the terminal — the first token
        # is a milestone INSIDE decode, not its start, so the first chunk's
        # compute (and its pipeline-drain latency) is attributed, not lost.
        # Hold-fence stalls are measured separately and excluded.
        t_dec = t_pe if t_pe is not None else t_admit
        if t_dec is None:
            t_dec = t_first  # defensive: admitted-mark missing
        decode = (
            max(0.0, end - t_dec - self.fence_stall_s)
            if (t_dec is not None and t_first is not None)
            else 0.0
        )
        other = max(
            0.0, total - queue_wait - prefill - decode - self.fence_stall_s
        )
        return {
            "total_s": total,
            "queue_wait_s": queue_wait,
            "prefill_s": prefill,
            "ttft_s": ttft,
            "decode_s": decode,
            "fence_stall_s": self.fence_stall_s,
            "park_s": self.park_s,
            "other_s": other,
        }

    def to_dict(self, breakdown: dict[str, float] | None = None) -> dict[str, Any]:
        """JSON-transportable record for /debug/flight and trace tooling.
        ``breakdown`` lets a caller that already computed it (the decode
        loop's ``complete``) skip the second event scan."""
        return {
            "rid": self.rid,
            "priority": self.priority,
            "task_id": self.task_id,
            "session_id": self.session_id,
            "version": self.version,
            "epoch_anchor": self.epoch_anchor,
            "queued_ts": self.queued_ts,
            "terminal_reason": self.terminal_reason,
            "dropped_events": self.dropped_events,
            "events": [
                {"stage": s, "ts": ts, **({"args": a} if a else {})}
                for s, ts, a in self.events
            ],
            "breakdown": breakdown if breakdown is not None else self.breakdown(),
        }


class TimelineRecorder:
    """Engine-side registry of request timelines.

    ``start`` is called from any submitting thread; stage marks and
    ``complete`` run on the decode loop. Completed timelines observe the
    catalogued stage histograms and are retained in a bounded deque for
    /debug scrapes. ``unterminated()`` (started minus completed) is the
    leak detector: a nonzero value once the engine is quiet means a request
    left the engine without passing through ``complete``.
    """

    def __init__(self, max_recent: int = DEFAULT_RECENT_TIMELINES):
        self._recent: deque[dict] = deque(maxlen=max_recent)
        self._lock = threading.Lock()
        self._started = 0
        self._completed = 0
        self._obs = obs_catalog.timeline_metrics()

    def start(
        self,
        rid: str,
        priority: str = "interactive",
        task_id: str | None = None,
        session_id: str | None = None,
    ) -> RequestTimeline:
        with self._lock:
            self._started += 1
        return RequestTimeline(
            rid=rid,
            priority=priority if priority in PRIORITY_CLASSES else "interactive",
            task_id=task_id,
            session_id=session_id,
        )

    def complete(
        self, tl: RequestTimeline, reason: str, n_tokens: int
    ) -> dict[str, float]:
        """Terminal mark + histogram observation. Returns the breakdown
        (the dict stamped onto ``ModelResponse``)."""
        tl.terminal_reason = reason
        tl.mark(TERMINAL, reason=reason, n_tokens=n_tokens)
        bd = tl.breakdown()
        m = self._obs
        m.queue_wait.observe(bd["queue_wait_s"])
        if bd["prefill_s"] > 0:
            m.prefill.observe(bd["prefill_s"])
        if n_tokens > 0 and bd["ttft_s"] > 0:
            m.ttft.labels(priority=tl.priority).observe(bd["ttft_s"])
        if n_tokens > 1:
            # TPOT is first-token -> terminal (fence stalls excluded) over
            # the remaining tokens — the standard inter-token latency, NOT
            # decode_s/(n-1) (decode_s includes the first chunk)
            t_first = tl.ts_of(FIRST_TOKEN)
            t_term = tl.ts_of(TERMINAL)
            if t_first is not None and t_term is not None:
                in_window_stall = max(
                    0.0, tl.fence_stall_s - tl.fence_stall_pre_first_s
                )
                tail = max(0.0, t_term - t_first - in_window_stall)
                if tail > 0:
                    m.tpot.observe(tail / (n_tokens - 1))
        if bd["fence_stall_s"] > 0:
            m.fence_stall.observe(bd["fence_stall_s"])
        if bd["park_s"] > 0:
            m.park.observe(bd["park_s"])
        with self._lock:
            self._completed += 1
            self._recent.append(tl.to_dict(breakdown=bd))
        return bd

    def unterminated(self) -> int:
        with self._lock:
            return self._started - self._completed

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "started": self._started,
                "completed": self._completed,
                "unterminated": self._started - self._completed,
                "recent": len(self._recent),
            }

    def recent(self, n: int | None = None) -> list[dict]:
        with self._lock:
            out = list(self._recent)
        if n is None:
            return out
        # n bounds the payload: 0 means none (out[-0:] would mean ALL)
        return out[-n:] if n > 0 else []


class FlightRecorder:
    """Bounded ring of significant per-process events.

    ``record`` is a lock + ring append (no I/O, no allocation beyond the
    event dict) so it is safe on the decode loop and in HTTP handlers.
    The ring keeps the newest ``capacity`` events; overflow increments
    ``dropped`` instead of growing. ``dump`` writes the snapshot to a
    temporary file and renames it into place, so a crash mid-dump never
    leaves a torn file; the wedge and SIGTERM paths both dump through it.
    """

    def __init__(
        self,
        capacity: int = DEFAULT_FLIGHT_CAPACITY,
        role: str = "proc",
    ):
        self.capacity = max(1, capacity)
        self.role = role
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._dropped = 0
        self._obs = obs_catalog.flight_metrics()

    def record(self, kind: str, severity: str = "info", **data: Any) -> None:
        ev = {
            "ts": time.time(),
            "kind": kind,
            "severity": severity,
        }
        if data:
            ev["data"] = data
        with self._lock:
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._seq += 1
            ev["seq"] = self._seq
            self._ring.append(ev)
        self._obs.events.labels(kind=kind).inc()

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "role": self.role,
                "pid": os.getpid(),
                "capacity": self.capacity,
                "dropped": self._dropped,
                "events": list(self._ring),
            }

    def dump(self, path: str, reason: str = "manual") -> str:
        """Atomically persist the ring (+ the dump reason) as JSON."""
        snap = self.snapshot()
        snap["dump_reason"] = reason
        snap["dumped_at"] = time.time()
        _atomic_write_text(path, json.dumps(snap, indent=1))
        self._obs.dumps.inc()
        logger.warning(f"flight recorder dumped to {path} ({reason})")
        return path


# ---------------------------------------------------------------------------
# process-default flight recorder + signal dump
# ---------------------------------------------------------------------------

_FLIGHT = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    return _FLIGHT


def default_dump_path(tag: str = "") -> str:
    d = os.environ.get("AREAL_FLIGHT_DIR") or os.path.join(tempfile.gettempdir(), "areal_tpu_torch", "flight")
    name = f"flight_{_FLIGHT.role}_{os.getpid()}"
    if tag:
        name += f"_{tag}"
    return os.path.join(d, name + ".json")


def install_signal_dump(path: str | None = None) -> bool:
    """Dump the flight ring on SIGTERM, then re-deliver the default
    handler (the process still terminates). Only possible from the main
    thread — returns False (and records why) anywhere else.

    The dump runs on a worker thread with a bounded join: the handler
    interrupts the main thread wherever it is, and if that spot happens
    to hold the ring lock (or a metrics shard lock), a dump attempted
    inline would deadlock against the frozen holder and the process would
    never terminate. A wedged dump worker is abandoned after the join
    timeout and SIGTERM proceeds — no dump beats no termination. Arming
    it again while armed is a no-op, so servers started one after another
    in a process do not chain dumps."""
    try:
        prev = signal.getsignal(signal.SIGTERM)
        if getattr(prev, "_flight_dump", False):
            if threading.current_thread() is not threading.main_thread():
                raise ValueError("signal only works in main thread")  # as signal.signal says it
            return True

        def _dump():
            _FLIGHT.record("sigterm", severity="warn")
            _FLIGHT.dump(path or default_dump_path("sigterm"), "sigterm")

        def _on_term(signum, frame):
            try:
                t = threading.Thread(target=_dump, daemon=True)
                t.start()
                t.join(timeout=5.0)
            finally:
                signal.signal(signal.SIGTERM, prev or signal.SIG_DFL)
                signal.raise_signal(signal.SIGTERM)

        _on_term._flight_dump = True
        signal.signal(signal.SIGTERM, _on_term)
        return True
    except ValueError:  # not the main thread
        logger.debug("signal dump unavailable off the main thread")
        return False


def timelines_to_trace_events(
    timelines: list[dict], base_epoch: float | None = None
) -> list[dict]:
    """Convert timeline records into catapult ``traceEvents``.

    Each stage span becomes an ``X`` (complete) event on the request's own
    tid row; point stages become instants. Monotonic stamps are rebased
    onto the wall clock via each record's ``epoch_anchor`` so events from
    different processes land on one comparable axis (catapult ``ts`` is
    microseconds)."""
    out: list[dict] = []
    for i, rec in enumerate(timelines):
        anchor = rec.get("epoch_anchor") or 0.0
        q_ts = rec.get("queued_ts") or 0.0

        def wall_us(mono_ts: float) -> float:
            return (anchor + (mono_ts - q_ts)) * 1e6

        args = {
            "rid": rec.get("rid"),
            "priority": rec.get("priority"),
            "version": rec.get("version"),
            "terminal": rec.get("terminal_reason"),
        }
        if rec.get("task_id"):
            args["task_id"] = rec["task_id"]
        if rec.get("session_id"):
            args["session_id"] = rec["session_id"]
        tid = 1000 + (i % 1000)
        events = rec.get("events", [])
        # first occurrence wins, matching breakdown()'s ts_of — a repeated
        # stage mark must not stretch a span over its successors
        stamps: dict[str, float] = {}
        for e in events:
            stamps.setdefault(e["stage"], e["ts"])
        # decode anchors where breakdown() anchors it — PREFILL_END (or the
        # resume/aliased admission when there was none): the first chunk's
        # compute must render as decode, not as blank space between spans
        decode_start = (
            PREFILL_END
            if PREFILL_END in stamps
            else (ADMITTED if ADMITTED in stamps else FIRST_TOKEN)
        )
        spans = (
            ("queue_wait", QUEUED, ADMITTED),
            ("prefill", PREFILL_START, PREFILL_END),
            ("decode", decode_start, TERMINAL),
        )
        for name, s0, s1 in spans:
            if name == "decode" and FIRST_TOKEN not in stamps:
                continue  # no token ever emitted: breakdown's decode_s is 0
            if s0 in stamps and s1 in stamps and stamps[s1] >= stamps[s0]:
                out.append(
                    {
                        "name": name,
                        "ph": "X",
                        "tid": tid,
                        "ts": wall_us(stamps[s0]),
                        "dur": (stamps[s1] - stamps[s0]) * 1e6,
                        "cat": "timeline",
                        "args": args,
                    }
                )
        for e in events:
            if e["stage"] in (
                RADIX_MATCH,
                DRAFT,
                VERIFY,
                PARK,
                RESUME,
                FENCE_STALL,
                TERMINAL,
            ):
                out.append(
                    {
                        "name": e["stage"],
                        "ph": "i",
                        "s": "t",
                        "tid": tid,
                        "ts": wall_us(e["ts"]),
                        "cat": "timeline",
                        "args": {**args, **(e.get("args") or {})},
                    }
                )
    return out


def flight_to_trace_events(snapshot: dict) -> list[dict]:
    """Convert a flight-recorder snapshot into catapult instant events
    (one shared tid row; ``ts`` already wall-clock)."""
    out = []
    for ev in snapshot.get("events", []):
        out.append(
            {
                "name": ev.get("kind", "event"),
                "ph": "i",
                "s": "p",
                "tid": 1,
                "ts": float(ev.get("ts", 0.0)) * 1e6,
                "cat": "flight",
                "args": {
                    "severity": ev.get("severity"),
                    **(ev.get("data") or {}),
                },
            }
        )
    return out


def _atomic_write_text(path: str, text: str) -> None:
    """Write ``text`` to ``path`` so a reader sees the old file or the new
    one, never a torn mix: a temporary file in the same directory, flushed
    and fsynced, then renamed over ``path``, then the directory fsynced."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".tmp.", dir=d)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass  # already renamed away
        raise
