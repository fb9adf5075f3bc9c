"""The reward function contract and its asynchronous wrapper
(``areal_tpu/api/reward_api.py``): a synchronous reward function runs in an
executor so it never blocks the rollout event loop; a broken process pool
(a reward function that crashed its worker) is rebuilt once."""

from __future__ import annotations

import asyncio
import functools
import multiprocessing
import os
from concurrent.futures import BrokenExecutor, ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Protocol


class RewardFn(Protocol):
    def __call__(
        self,
        prompt: str,
        completions: str,
        prompt_ids: list[int],
        completion_ids: list[int],
        **kwargs,
    ) -> float: ...


class AsyncRewardWrapper:
    """Run a synchronous reward function without blocking the event loop.

    ``use_process_pool=True`` runs it in worker processes (for GIL-heavy
    verifiers). Those are started with ``spawn``, never ``fork``: a process
    that has initialised CUDA cannot be forked safely, and the rollout
    client shares its process with the card's engine. The default thread
    pool suits cheap string-match rewards. A reward function for the
    process pool must be importable by module path (``spawn`` pickles it by
    name)."""

    def __init__(
        self,
        reward_fn: Callable,
        use_process_pool: bool = False,
        max_workers: int | None = None,
    ):
        self._fn = reward_fn
        self._use_process_pool = use_process_pool
        self._max_workers = max_workers or min(8, (os.cpu_count() or 2))
        self._pool = None

    def _get_pool(self):
        if self._pool is None:
            if self._use_process_pool:
                self._pool = ProcessPoolExecutor(
                    max_workers=self._max_workers, mp_context=multiprocessing.get_context("spawn")
                )
            else:
                self._pool = ThreadPoolExecutor(max_workers=self._max_workers)
        return self._pool

    async def __call__(self, *args, **kwargs) -> float:
        loop = asyncio.get_running_loop()
        call = functools.partial(self._fn, *args, **kwargs)
        try:
            return float(await loop.run_in_executor(self._get_pool(), call))
        except BrokenExecutor:
            # the pool died (a worker crashed): rebuild once and retry
            self._pool = None
            return float(await loop.run_in_executor(self._get_pool(), call))

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
