"""Rank-0 metric sink — the port of ``areal_tpu/utils/stats_logger.py``:
the console table, TensorBoard through ``torch.utils.tensorboard`` when it
imports (``tensorboard.path``: None = off, "" = the default log dir), and
wandb gated on its import, as in the JAX package. Absent backends degrade
to the console without error."""

from __future__ import annotations

import logging
import os
from typing import Any

from areal_tpu_torch.api.config import StatsLoggerConfig
from areal_tpu_torch.api.io_struct import StepInfo

logger = logging.getLogger("areal_tpu_torch.stats")


class StatsLogger:
    def __init__(self, config: StatsLoggerConfig, ft_spec=None):
        self.config = config
        self.ft_spec = ft_spec
        self._tb = None
        self._wandb = None
        self._init_backends()

    def _log_dir(self) -> str:
        c = self.config
        return os.path.join(c.fileroot, c.experiment_name or "exp", c.trial_name or "trial", "logs")

    def _init_backends(self) -> None:
        if self.config.tensorboard and self.config.tensorboard.path is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                path = self.config.tensorboard.path or self._log_dir()
                os.makedirs(path, exist_ok=True)
                self._tb = SummaryWriter(log_dir=path)
            except Exception:  # noqa: BLE001 — optional backend
                logger.warning("tensorboard unavailable; console only")
        if self.config.wandb and self.config.wandb.mode != "disabled":
            try:
                import wandb

                w = self.config.wandb
                if w.wandb_base_url:
                    os.environ["WANDB_BASE_URL"] = w.wandb_base_url
                if w.wandb_api_key:
                    os.environ["WANDB_API_KEY"] = w.wandb_api_key
                name = w.name or self.config.trial_name
                wandb.init(
                    mode=w.mode,
                    project=w.project or self.config.experiment_name,
                    name=name,
                    group=w.group,
                    entity=w.entity,
                    job_type=w.job_type,
                    notes=w.notes,
                    tags=w.tags,
                    config=w.config,
                    id=f"{name}_{w.id_suffix}" if w.id_suffix else None,
                    resume="allow" if w.id_suffix else None,
                    dir=self._log_dir(),
                )
                self._wandb = wandb
            except Exception:  # noqa: BLE001
                logger.warning("wandb unavailable")

    def commit(self, epoch: int, step: int, global_step: int, data: dict[str, Any]) -> None:
        flat = {k: float(v) for k, v in sorted(data.items())}
        info = StepInfo(epoch=epoch, epoch_step=step, global_step=global_step)
        lines = [f"Epoch {info.epoch + 1} step {info.epoch_step + 1} (global step {info.global_step + 1})"]
        width = max((len(k) for k in flat), default=10)
        for k, v in flat.items():
            lines.append(f"  {k:<{width}} {v:.6g}")
        logger.info("\n".join(lines))
        if self._tb is not None:
            for k, v in flat.items():
                self._tb.add_scalar(k, v, global_step)
            self._tb.flush()
        if self._wandb is not None:
            self._wandb.log(flat, step=global_step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
