"""Preemption handler: SIGTERM enters a grace-window drain state machine —
the port of ``areal_tpu/robustness/preemption.py``.

A preemptible machine gets SIGTERM and a short grace window before SIGKILL.
The trainer turns it into a clean exit inside the window: it stops at the
next step boundary (or aborts a rollout wait), dumps the last completed
step synchronously, and leaves its step loop.

The state machine::

    RUNNING --signal / request()--> DRAINING --drain done--> DRAINED

The installed handler only sets flags: no I/O, no locks, no allocation.
The drain work runs on whichever thread owns it: the trainer's step loop
polls ``requested``, and a serving process parks ``spawn_drainer``'s
thread on it, started before ``install`` so the handler never creates one.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Callable

from areal_tpu_torch.observability import catalog
from areal_tpu_torch.observability import timeline as tl_mod

logger = logging.getLogger("areal_tpu_torch.preemption")

RUNNING = "running"
DRAINING = "draining"
DRAINED = "drained"


class PreemptionHandler:
    """Flag-only signal handler and grace-window bookkeeping for one
    process. ``install()`` must run on the main thread (CPython's signal
    contract); ``request()`` works from anywhere."""

    def __init__(self, role: str, grace_s: float = 25.0, handle_sigusr1: bool = True):
        self.role = role
        self.grace_s = grace_s
        self.handle_sigusr1 = handle_sigusr1
        self.requested = threading.Event()
        self.drained = threading.Event()
        self._signum: int | None = None
        # monotonic time the signal landed, written only by the handler or
        # request() (a float rebind under the GIL; readers tolerate staleness)
        self._requested_ts: float | None = None
        self._installed: list[tuple[int, object]] = []
        self._counted = False
        self._count_lock = threading.Lock()
        self._metrics = catalog.preemption_metrics()

    # -- state -------------------------------------------------------------
    @property
    def state(self) -> str:
        if self.drained.is_set():
            return DRAINED
        if self.requested.is_set():
            return DRAINING
        return RUNNING

    @property
    def signum(self) -> int | None:
        return self._signum

    def deadline(self) -> float | None:
        """Monotonic deadline of the grace window (None until a request)."""
        if self._requested_ts is None:
            return None
        return self._requested_ts + self.grace_s

    def remaining(self) -> float:
        """Grace seconds left (inf while running, clamped at 0)."""
        dl = self.deadline()
        if dl is None:
            return float("inf")
        return max(0.0, dl - time.monotonic())

    # -- entry points ------------------------------------------------------
    def _on_signal(self, signum, frame) -> None:
        # handler context: flags only
        self._signum = signum
        self._requested_ts = time.monotonic()
        self.requested.set()

    def request(self, signum: int | None = None) -> None:
        """A programmatic preemption (a supervisor's drain, tests): the same
        transition as a delivered signal."""
        self._signum = signum
        self._requested_ts = time.monotonic()
        self.requested.set()

    def install(self) -> bool:
        """Arm SIGTERM (and SIGUSR1) -> ``_on_signal``. Main thread only;
        returns False elsewhere (``request`` still works)."""
        sigs = [signal.SIGTERM]
        if self.handle_sigusr1 and hasattr(signal, "SIGUSR1"):
            sigs.append(signal.SIGUSR1)
        try:
            for s in sigs:
                prev = signal.getsignal(s)
                signal.signal(s, self._on_signal)
                self._installed.append((s, prev))
            return True
        except ValueError:  # not the main thread
            logger.warning(
                f"preemption handler for role={self.role} not installed (off the main thread); "
                "request() still works"
            )
            return False

    def uninstall(self) -> None:
        for s, prev in self._installed:
            try:
                signal.signal(s, prev if prev is not None else signal.SIG_DFL)
            except (ValueError, TypeError):
                pass  # teardown off the main thread, or a handler that cannot be restored
        self._installed = []

    # -- accounting --------------------------------------------------------
    def note_draining(self) -> None:
        """Count the preemption once (``areal_preemption_total{role}``) and
        leave a flight-ring event; call from the draining thread, never the
        handler."""
        with self._count_lock:
            if self._counted:
                return
            self._counted = True
        self._metrics.preemptions.labels(role=self.role).inc()
        tl_mod.get_flight_recorder().record(
            "preempt_signal", severity="warn", role=self.role, signum=self._signum, grace_s=self.grace_s
        )
        logger.warning(
            f"preemption requested (role={self.role}, signum={self._signum}); draining inside a "
            f"{self.grace_s:.0f}s grace window"
        )

    def note_drained(self, drain_seconds: float | None = None) -> None:
        if drain_seconds is None and self._requested_ts is not None:
            drain_seconds = time.monotonic() - self._requested_ts
        if drain_seconds is not None:
            self._metrics.drain_seconds.observe(drain_seconds)
        self.drained.set()
        logger.info(
            f"preemption drain complete (role={self.role}"
            + (f", {drain_seconds:.2f}s" if drain_seconds is not None else "")
            + ")"
        )

    # -- serving-side drainer ---------------------------------------------
    def spawn_drainer(
        self, drain_fn: Callable[["PreemptionHandler"], None], exit_code: int | None = 0
    ) -> threading.Thread:
        """Start the drain thread now (before ``install``, so the handler
        never allocates). It waits on ``requested``, runs ``drain_fn(self)``,
        then, when ``exit_code`` is not None, ends the process with
        ``os._exit``: after a drain the serving threads may be half
        dismantled, and a wedged atexit must not eat the grace window."""

        def run():
            self.requested.wait()
            self.note_draining()
            t0 = time.monotonic()
            try:
                drain_fn(self)
            except Exception:  # noqa: BLE001 — a failed drain still exits; recovery covers it
                logger.exception("preemption drain failed")
            self.note_drained(time.monotonic() - t0)
            if exit_code is not None:
                os._exit(exit_code)

        t = threading.Thread(target=run, daemon=True, name="preempt-drainer")
        t.start()
        return t
