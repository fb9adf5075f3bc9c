"""Frequency-gated checkpoint saver and evaluator — the port of
``areal_tpu/utils/saver.py`` (with ``utils/timeutil.py``'s
``FrequencyControl``).

Two save modes:

- ``save`` blocks for the whole write (``engine.save``).
- ``save_async`` blocks only for the engine's host snapshot
  (``snapshot_for_save``: on a card, copies queued on a side stream), then
  writes it on a background thread (``write_snapshot``). One write is in
  flight at a time; ``on_written`` runs once the bytes are durable (the
  ``RecoverHandler`` writes its records there, so a crash mid-write never
  leaves a record pointing at a half-written checkpoint), and
  ``wait_async`` re-raises a failed write.

The step-loop pause of each save lands in ``areal_ckpt_save_seconds{mode}``
(``observability/catalog.preemption_metrics``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Callable

from areal_tpu_torch.api.config import EvaluatorConfig, SaverConfig
from areal_tpu_torch.api.io_struct import RECOVER_FORMAT, SaveLoadMeta
from areal_tpu_torch.observability import catalog

logger = logging.getLogger("areal_tpu_torch.saver")


@dataclasses.dataclass
class FrequencyControl:
    """Fires when any of the epoch / step / seconds frequencies is crossed;
    each trigger keeps its own baseline."""

    freq_epoch: int | None = None
    freq_step: int | None = None
    freq_sec: float | None = None

    def __post_init__(self):
        self._last_time = time.monotonic()
        self._last_epoch = 0
        self._last_step = 0

    def check(self, epochs: int = 0, steps: int = 0) -> bool:
        fired = False
        now = time.monotonic()
        if self.freq_epoch and epochs - self._last_epoch >= self.freq_epoch:
            fired = True
            self._last_epoch = epochs
        if self.freq_step and steps - self._last_step >= self.freq_step:
            fired = True
            self._last_step = steps
        if self.freq_sec and now - self._last_time >= self.freq_sec:
            fired = True
            self._last_time = now
        return fired

    def state_dict(self) -> dict:
        return {
            "last_time_delta": time.monotonic() - self._last_time,
            "last_epoch": self._last_epoch,
            "last_step": self._last_step,
        }

    def load_state_dict(self, state: dict) -> None:
        self._last_time = time.monotonic() - state["last_time_delta"]
        self._last_epoch = state["last_epoch"]
        self._last_step = state["last_step"]


def _freq_ctl(config: SaverConfig) -> FrequencyControl:
    return FrequencyControl(freq_epoch=config.freq_epochs, freq_step=config.freq_steps, freq_sec=config.freq_secs)


class Saver:
    def __init__(self, config: SaverConfig, ft_spec, for_recover: bool = False):
        self.config = config
        self.ft_spec = ft_spec
        self.for_recover = for_recover
        self.freq_ctl = _freq_ctl(config)
        self._metrics = catalog.preemption_metrics()
        self._async_thread: threading.Thread | None = None
        # written by the background writer, consumed by wait_async
        self._async_lock = threading.Lock()
        self._async_exc: BaseException | None = None

    def save_root(self) -> str:
        sub = "recover" if self.for_recover else "checkpoints"
        return os.path.join(
            self.config.fileroot, self.config.experiment_name or "exp", self.config.trial_name or "trial", sub
        )

    def maybe_save(self, engine, epoch: int, step: int, global_step: int, tokenizer=None) -> str | None:
        """Save when a frequency trigger fires; returns the path if saved."""
        if not self.freq_ctl.check(epochs=epoch, steps=global_step + 1):
            return None
        return self.save(engine, epoch, step, global_step, tokenizer)

    def _ckpt_path(self, epoch: int, step: int, global_step: int) -> str:
        return os.path.join(self.save_root(), f"epoch{epoch}epochstep{step}globalstep{global_step}")

    def save(self, engine, epoch: int, step: int, global_step: int, tokenizer=None) -> str:
        """Write a checkpoint and return once it is on disk: the weights as
        HF safetensors, or for recovery the engine's whole state. A
        still-running async write lands first."""
        self.wait_async()
        t0 = time.monotonic()
        path = self._ckpt_path(epoch, step, global_step)
        os.makedirs(path, exist_ok=True)
        meta = SaveLoadMeta(
            path=path,
            weight_format=RECOVER_FORMAT if self.for_recover else "hf",
            with_optim=self.for_recover,
            tokenizer=tokenizer,
        )
        engine.save(meta)
        self._metrics.ckpt_save_seconds.labels(mode="sync").observe(time.monotonic() - t0)
        logger.info(f"saved {'recover ' if self.for_recover else ''}checkpoint to {path}")
        return path

    def save_async(
        self,
        engine,
        epoch: int,
        step: int,
        global_step: int,
        tokenizer=None,
        on_written: Callable[[str], None] | None = None,
    ) -> str:
        """Snapshot now, write on a background thread. Blocks only for the
        snapshot (the ``mode="async"`` pause) plus any previous async write
        still in flight. Engines without the snapshot / write split, and
        the HF checkpoint saver, take the sync path; ``on_written`` fires
        either way once the bytes are durable."""
        snap_fn = getattr(engine, "snapshot_for_save", None)
        write_fn = getattr(engine, "write_snapshot", None)
        if snap_fn is None or write_fn is None or not self.for_recover:
            path = self.save(engine, epoch, step, global_step, tokenizer)
            if on_written is not None:
                on_written(path)
            return path
        self.wait_async()  # one write in flight; also surfaces its error
        t0 = time.monotonic()
        snapshot = snap_fn(with_optim=True)
        self._metrics.ckpt_save_seconds.labels(mode="async").observe(time.monotonic() - t0)
        path = self._ckpt_path(epoch, step, global_step)
        os.makedirs(path, exist_ok=True)

        def writer():
            try:
                write_fn(snapshot, path)
                logger.info(f"async recover checkpoint written to {path}")
                if on_written is not None:
                    on_written(path)
            except BaseException as e:  # noqa: BLE001 — surfaced by the next
                # wait_async / save: a failed write must not be silent
                logger.exception("async checkpoint write failed")
                with self._async_lock:
                    self._async_exc = e

        self._async_thread = threading.Thread(target=writer, daemon=True, name="saver-async-write")
        self._async_thread.start()
        return path

    def wait_async(self, timeout: float | None = None) -> None:
        """Join any in-flight async write and re-raise its failure. The
        emergency dump calls this first, so a preemption never races a
        half-written periodic dump."""
        t = self._async_thread
        if t is not None:
            t.join(timeout)
            if not t.is_alive():
                self._async_thread = None
        with self._async_lock:
            exc, self._async_exc = self._async_exc, None
        if exc is not None:
            raise RuntimeError("async checkpoint write failed") from exc

    def state_dict(self) -> dict:
        return self.freq_ctl.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.freq_ctl.load_state_dict(state)


class Evaluator:
    """Frequency-gated evaluation trigger."""

    def __init__(self, config: EvaluatorConfig, ft_spec):
        self.config = config
        self.ft_spec = ft_spec
        self.freq_ctl = _freq_ctl(config)

    def maybe_evaluate(self, epoch: int, global_step: int, evaluate_fn) -> bool:
        if not self.freq_ctl.check(epochs=epoch, steps=global_step + 1):
            return False
        evaluate_fn()
        return True

    def state_dict(self) -> dict:
        return self.freq_ctl.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.freq_ctl.load_state_dict(state)
