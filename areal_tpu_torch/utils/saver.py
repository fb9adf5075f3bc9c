"""Frequency-gated checkpoint saver and evaluator — the port of
``areal_tpu/utils/saver.py`` (with ``utils/timeutil.py``'s
``FrequencyControl``).

The frequency logic and ``Evaluator.maybe_evaluate`` are ported. Writing a
checkpoint is not (ROADMAP Queue A item 3): a save that is due raises
``NotImplementedError``. At ``SaverConfig()``'s defaults no trigger is set,
so nothing is ever due.
"""

from __future__ import annotations

import dataclasses
import time

from areal_tpu_torch.api.config import EvaluatorConfig, SaverConfig


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
    def __init__(self, config: SaverConfig, ft_spec):
        self.config = config
        self.ft_spec = ft_spec
        self.freq_ctl = _freq_ctl(config)

    def maybe_save(self, engine, epoch: int, step: int, global_step: int, tokenizer=None) -> str | None:
        """Save when a frequency trigger fires; returns the path if saved."""
        if not self.freq_ctl.check(epochs=epoch, steps=global_step + 1):
            return None
        return self.save(engine, epoch, step, global_step, tokenizer)

    def save(self, engine, epoch: int, step: int, global_step: int, tokenizer=None) -> str:
        raise NotImplementedError(
            f"saving a checkpoint (due at global step {global_step}): ROADMAP Queue A item 3"
        )

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
