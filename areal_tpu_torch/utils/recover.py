"""Checkpoint-based recovery — the port of ``areal_tpu/utils/recover.py``.

``RecoverInfo`` holds what the step loop needs to resume: the last
completed ``StepInfo``, the saver / evaluator timer states, the dataloader
position, and the checkpoint it pairs with. Recovery relaunches the trial
and ``RecoverHandler.load`` restores the engine from the newest recover
checkpoint (the train engine's "state" format: master parameters, AdamW
moments and the step count), then re-syncs the inference fleet's weights.

Mode policy:
- "disabled" / "off": never dump, never load.
- "on": load at startup when a checkpoint exists (warns when none does).
- "auto": load when a checkpoint exists, else a fresh start.

Durability: ``dump`` writes ``recover_info.pkl`` and ``latest`` through
tmp + ``os.replace`` + fsync with an embedded sha256 (``utils/atomic_io``),
after rotating the previous consistent pair to ``*.prev``. ``load``
verifies a pair (checksum, unpickle, the checkpoint's manifest) and falls
back to the ``.prev`` generation when the current one is truncated,
corrupt, dangling or incomplete, counting ``areal_recover_fallback_total``;
a crash mid-dump costs at most one recover interval. The JAX package checks
only that the checkpoint's directory exists, which its Orbax writes make
whole by a rename; the port's engine writes its state beside the old one
and renames it too (``train_engine._write_state``), and the manifest is
what a complete write ends with. The emergency dump of a step whose dump is
already durable rewrites only its record, never the checkpoint a relaunch
would load. The records pickle the port's own classes: a record of one
package does not load in the other.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle

from areal_tpu_torch.api.config import RecoverConfig
from areal_tpu_torch.api.io_struct import RECOVER_FORMAT, RECOVER_MANIFEST, SaveLoadMeta, StepInfo
from areal_tpu_torch.observability import catalog
from areal_tpu_torch.utils import atomic_io
from areal_tpu_torch.utils.saver import Saver

logger = logging.getLogger("areal_tpu_torch.recover")


@dataclasses.dataclass
class RecoverInfo:
    last_step_info: StepInfo
    saver_state: dict = dataclasses.field(default_factory=dict)
    evaluator_state: dict = dataclasses.field(default_factory=dict)
    dataloader_state: dict = dataclasses.field(default_factory=dict)
    extra: dict = dataclasses.field(default_factory=dict)
    # the checkpoint this record pairs with, so load() never depends on
    # `latest` matching the record's generation ("" on legacy records:
    # the path is in `latest`)
    ckpt_path: str = ""


class RecoverHandler:
    def __init__(self, config: RecoverConfig, ft_spec=None):
        self.config = config
        self.ft_spec = ft_spec
        self.saver = Saver(config, ft_spec, for_recover=True)
        # (step_info, ckpt_path) of the newest generation known durable: set
        # by a dump once its bytes are on disk, and by load
        self._durable: tuple[StepInfo, str] | None = None

    # -- paths -------------------------------------------------------------
    def _root(self) -> str:
        return self.saver.save_root()

    def _info_path(self, suffix: str = "") -> str:
        return os.path.join(self._root(), "recover_info.pkl" + suffix)

    def _latest_path(self, suffix: str = "") -> str:
        return os.path.join(self._root(), "latest" + suffix)

    # -- dump --------------------------------------------------------------
    def dump(
        self,
        engine,
        step_info: StepInfo,
        saver=None,
        evaluator=None,
        dataloader=None,
        stats_logger=None,
        tokenizer=None,
        force: bool = False,
        async_: bool = False,
    ) -> str | None:
        """Dump a recover generation when a frequency trigger fires
        (``force=True`` skips the gate: the preemption path).

        ``async_=True`` goes through ``Saver.save_async``: the step loop
        pauses only for the engine's snapshot, and the (info, latest) pair
        is written by the background thread after the checkpoint's bytes
        are durable, so a crash mid-write leaves the previous generation's
        records in place."""
        if self.config.mode in ("disabled", "off"):
            return None
        if not force and not self.saver.freq_ctl.check(epochs=step_info.epoch, steps=step_info.global_step + 1):
            return None
        # timer and dataloader state are captured now, paired with the snapshot
        info = self._info(step_info, saver, evaluator, dataloader)

        def write_records(path: str) -> None:
            self._write_records(info, path)
            self._durable = (step_info, path)
            logger.info(f"recover checkpoint dumped at step {step_info.global_step}")

        if async_:
            return self.saver.save_async(
                engine, step_info.epoch, step_info.epoch_step, step_info.global_step, tokenizer,
                on_written=write_records,
            )
        path = self.saver.save(engine, step_info.epoch, step_info.epoch_step, step_info.global_step, tokenizer)
        write_records(path)
        return path

    @staticmethod
    def _info(step_info: StepInfo, saver, evaluator, dataloader) -> RecoverInfo:
        return RecoverInfo(
            last_step_info=step_info,
            saver_state=saver.state_dict() if saver else {},
            evaluator_state=evaluator.state_dict() if evaluator else {},
            dataloader_state=(
                dataloader.state_dict() if dataloader is not None and hasattr(dataloader, "state_dict") else {}
            ),
        )

    def _write_records(self, info: RecoverInfo, path: str, rotate: bool = True) -> None:
        """The (info, latest) pair of the checkpoint at ``path``, checksummed
        and atomic (a torn write never passes for a record). ``rotate``
        first moves the current pair to ``.prev``: if this dump dies half
        way, load() falls back to it."""
        info.ckpt_path = path
        os.makedirs(self._root(), exist_ok=True)
        if rotate:
            for cur, prev in (
                (self._info_path(), self._info_path(".prev")),
                (self._latest_path(), self._latest_path(".prev")),
            ):
                if os.path.exists(cur):
                    os.replace(cur, prev)
        atomic_io.write_checksummed(self._info_path(), pickle.dumps(info))
        atomic_io.write_checksummed(self._latest_path(), path.encode("utf-8"))

    def dump_emergency(
        self,
        engine,
        step_info: StepInfo,
        saver=None,
        evaluator=None,
        dataloader=None,
        tokenizer=None,
    ) -> str | None:
        """The preemption path's dump: synchronous, past the frequency gate,
        and durable before it returns (an in-flight async write is joined
        first). When the newest durable generation already holds
        ``step_info`` (its periodic dump, or the checkpoint a relaunch
        loaded), the engine's state is not written again: the record alone
        is rewritten in place, with the loop's state of now, and ``.prev``
        keeps the generation before."""
        self.saver.wait_async()
        durable = self._durable
        if durable is not None and durable[0] == step_info and self._complete(durable[1]):
            self._write_records(self._info(step_info, saver, evaluator, dataloader), durable[1], rotate=False)
            logger.info(f"emergency dump: step {step_info.global_step} already durable at {durable[1]}; "
                        "record rewritten")
            return durable[1]
        path = self.dump(
            engine, step_info, saver=saver, evaluator=evaluator, dataloader=dataloader, tokenizer=tokenizer,
            force=True, async_=False,
        )
        wait = getattr(engine, "wait_for_save", None)
        if wait is not None:
            wait()
        return path

    # -- load --------------------------------------------------------------
    def should_load(self) -> bool:
        mode = self.config.mode
        if mode in ("disabled", "off"):
            return False
        exists = any(os.path.exists(self._info_path(sfx)) for sfx in ("", ".prev"))
        if mode == "on" and not exists:
            logger.warning("recover mode 'on' but no checkpoint found; fresh start")
        return exists

    @staticmethod
    def _complete(ckpt_path: str) -> bool:
        """A recover checkpoint whose write ran to its end: its manifest,
        written last, is there."""
        return os.path.exists(os.path.join(ckpt_path, RECOVER_MANIFEST))

    def _read_pair(self, suffix: str) -> tuple[RecoverInfo, str] | None:
        """One (info, ckpt_path) generation, verified: checksum, unpickle and
        the checkpoint's manifest. None when any of it is truncated,
        corrupt, dangling or incomplete."""
        info_path = self._info_path(suffix)
        if not os.path.exists(info_path):
            return None
        try:
            info: RecoverInfo = pickle.loads(atomic_io.read_checksummed(info_path))
        except Exception as e:  # noqa: BLE001 — any corruption falls back
            logger.warning(f"recover record {info_path} unreadable: {e!r}")
            return None
        ckpt_path = getattr(info, "ckpt_path", "") or ""
        if not ckpt_path:
            # a legacy record: the path lives only in `latest`
            latest = self._latest_path(suffix)
            try:
                ckpt_path = atomic_io.read_checksummed(latest).decode("utf-8").strip()
            except Exception as e:  # noqa: BLE001 — a missing or corrupt pointer
                logger.warning(f"latest pointer {latest} unreadable: {e!r}")
                return None
        if not os.path.exists(ckpt_path):
            logger.warning(f"recover record {info_path} points at missing checkpoint {ckpt_path} (dangling)")
            return None
        if not self._complete(ckpt_path):
            logger.warning(f"recover record {info_path} points at {ckpt_path}, which has no {RECOVER_MANIFEST} "
                           "(a write cut short)")
            return None
        return info, ckpt_path

    def read_recover_info(self) -> tuple[RecoverInfo, str] | None:
        """The newest loadable (info, ckpt_path) generation, falling back
        from the current record to ``.prev`` (counted in
        ``areal_recover_fallback_total``)."""
        pair = self._read_pair("")
        if pair is not None:
            return pair
        pair = self._read_pair(".prev")
        if pair is not None:
            catalog.robustness_metrics().recover_fallbacks.inc()
            logger.warning("current recover record unusable: falling back to the previous checkpoint generation")
            return pair
        return None

    def load(
        self,
        engine,
        saver=None,
        evaluator=None,
        dataloader=None,
        inference_engine=None,
        weight_update_meta=None,
    ) -> RecoverInfo | None:
        """Restore the newest loadable generation into ``engine`` and the
        loop's parts; the engine's version becomes ``global_step + 1``, and
        with an inference engine and a weight-update meta the restored
        weights are pushed to the fleet, whose version follows."""
        if not self.should_load():
            return None
        pair = self.read_recover_info()
        if pair is None:
            logger.warning("no loadable recover checkpoint (all generations corrupt or dangling); fresh start")
            return None
        info, ckpt_path = pair
        engine.load(SaveLoadMeta(path=ckpt_path, weight_format=RECOVER_FORMAT, with_optim=True))
        engine.set_version(info.last_step_info.global_step + 1)
        if saver is not None and info.saver_state:
            saver.load_state_dict(info.saver_state)
        if evaluator is not None and info.evaluator_state:
            evaluator.load_state_dict(info.evaluator_state)
        if dataloader is not None and info.dataloader_state and hasattr(dataloader, "load_state_dict"):
            dataloader.load_state_dict(info.dataloader_state)
        self._durable = (info.last_step_info, ckpt_path)
        # re-sync the fleet to the restored weights
        if inference_engine is not None and weight_update_meta is not None:
            engine.update_weights(weight_update_meta)
            inference_engine.set_version(engine.get_version())
        logger.info(f"recovered from {ckpt_path} at step {info.last_step_info.global_step}")
        return info
