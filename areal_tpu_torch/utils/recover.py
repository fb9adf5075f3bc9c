"""Checkpoint-based recovery — the part of ``areal_tpu/utils/recover.py``
the trainer loop calls. Recovery needs saved checkpoints, which wait for
ROADMAP Queue A item 3: ``RecoverConfig.mode`` other than "disabled" /
"off" raises ``NotImplementedError`` at construction, and with recovery off
``dump`` writes nothing, as in the JAX package (and the trainer starts at
step 0, as the JAX one does when ``load`` finds nothing).
"""

from __future__ import annotations

from areal_tpu_torch.api.config import RecoverConfig
from areal_tpu_torch.api.io_struct import StepInfo


class RecoverHandler:
    def __init__(self, config: RecoverConfig):
        if config.mode not in ("disabled", "off"):
            raise NotImplementedError(f"recover.mode={config.mode!r} (recovery): ROADMAP Queue A item 3")
        self.config = config

    def dump(self, engine, step_info: StepInfo, **kwargs) -> None:
        """Recovery is off: nothing is dumped."""
