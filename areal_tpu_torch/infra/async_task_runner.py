"""A background asyncio loop on its own thread with thread-safe queues
(``areal_tpu/infra/async_task_runner.py``). Producers submit coroutine
factories from any thread; results come back through an output queue as
``TimedResult``; a task's exception comes back as ``TaskFailed`` and is
raised on the polling thread.
"""

from __future__ import annotations

import asyncio
import logging
import queue
import threading
import time
import uuid
from typing import Any, Awaitable, Callable

from areal_tpu_torch.api.io_struct import TimedResult

logger = logging.getLogger("areal_tpu_torch.async_task_runner")


async def _cancel_pending() -> None:
    me = asyncio.current_task()
    tasks = [t for t in asyncio.all_tasks() if t is not me]
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)


class TaskFailed(RuntimeError):
    def __init__(self, task_id: str, exc: BaseException):
        super().__init__(f"task {task_id} failed: {exc!r}")
        self.task_id = task_id
        self.exc = exc


class AsyncTaskRunner:
    def __init__(self, max_concurrency: int | None = None):
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._started = threading.Event()
        self._shutdown = threading.Event()
        self._out: queue.Queue[TimedResult | TaskFailed] = queue.Queue()
        self._n_pending = 0
        self._lock = threading.Lock()
        # completion signal for wait_all (shares _lock with _n_pending)
        self._pending_cv = threading.Condition(self._lock)
        self._sem: asyncio.Semaphore | None = None
        self._max_concurrency = max_concurrency
        self._paused: asyncio.Event | None = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        assert self._thread is None
        # the loop and its primitives are made here, before the thread:
        # made inside it, they raced readers of `self._loop` at startup.
        # asyncio.Event / Semaphore bind to the running loop on first
        # await, so building them off the loop's thread is safe.
        self._loop = asyncio.new_event_loop()
        if self._max_concurrency:
            self._sem = asyncio.Semaphore(self._max_concurrency)
        self._paused = asyncio.Event()
        self._paused.set()  # set = running

        def run():
            asyncio.set_event_loop(self._loop)
            self._started.set()
            self._loop.run_forever()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if not self._started.wait(10):
            raise TimeoutError("async task runner failed to start")

    def stop(self) -> None:
        """Cancel the tasks still on the loop and let them unwind (their
        handlers close connections and abort server-side work), then stop
        the loop: a loop stopped under pending tasks leaves coroutines that
        are never resumed."""
        loop = self._loop
        if loop is not None and loop.is_running():
            try:
                asyncio.run_coroutine_threadsafe(_cancel_pending(), loop).result(timeout=10)
            except Exception:  # noqa: BLE001 — a task that will not unwind must not block the stop
                logger.warning("pending tasks did not unwind within 10 s; stopping the loop", exc_info=True)
        if loop is not None:
            loop.call_soon_threadsafe(loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- pause/resume -----------------------------------------------------
    def pause(self) -> None:
        if self._loop:
            self._loop.call_soon_threadsafe(self._paused.clear)

    def resume(self) -> None:
        if self._loop:
            self._loop.call_soon_threadsafe(self._paused.set)

    # -- submission -------------------------------------------------------
    def submit(
        self,
        coro_fn: Callable[[], Awaitable[Any]],
        task_id: str | None = None,
    ) -> str:
        """Schedule a coroutine; its result lands in the output queue."""
        assert self._loop is not None, "runner not started"
        task_id = task_id or uuid.uuid4().hex

        async def wrapper():
            try:
                await self._paused.wait()
                if self._sem is not None:
                    async with self._sem:
                        result = await coro_fn()
                else:
                    result = await coro_fn()
                self._out.put(TimedResult(data=result, task_id=task_id))
            except Exception as e:  # noqa: BLE001
                logger.exception(f"task {task_id} failed")
                self._out.put(TaskFailed(task_id, e))
            finally:
                # a threading condition: wait_all waits on it from another
                # thread; never held across an await
                with self._pending_cv:
                    self._n_pending -= 1
                    self._pending_cv.notify_all()

        with self._lock:
            self._n_pending += 1
        asyncio.run_coroutine_threadsafe(wrapper(), self._loop)
        return task_id

    @property
    def n_pending(self) -> int:
        with self._lock:
            return self._n_pending

    # -- results ----------------------------------------------------------
    def poll_result(self, timeout: float | None = None) -> TimedResult | None:
        """Next completed task (raises TaskFailed for failed tasks)."""
        try:
            item = self._out.get(timeout=timeout) if timeout else self._out.get_nowait()
        except queue.Empty:
            return None
        if isinstance(item, TaskFailed):
            raise item
        return item

    def drain(self) -> list[TimedResult]:
        out = []
        while True:
            try:
                item = self._out.get_nowait()
            except queue.Empty:
                return out
            if isinstance(item, TaskFailed):
                raise item
            out.append(item)

    def wait_all(self, timeout: float = 60.0) -> None:
        """Block until every submitted task completed (woken on each
        completion)."""
        deadline = time.monotonic() + timeout
        with self._pending_cv:
            while self._n_pending > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"{self._n_pending} tasks still pending"
                    )
                self._pending_cv.wait(remaining)
