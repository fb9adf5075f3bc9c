"""SFT and reward-model trainers — the port of
``areal_tpu/trainer/sft_trainer.py``.

- ``lm_loss_fn``: packed cross-entropy over the loss-masked labels (label
  alignment inside the grid, so the host rolls ``loss_mask`` back one, as
  on the PPO path).
- ``rw_loss_fn``: the Bradley-Terry pairwise loss. Sequences arrive
  interleaved (chosen, rejected); a sequence's score is the value head at
  its last token. Pairs survive the grid packing through the per-token
  ``rw_pair_id`` / ``rw_sign`` / ``rw_last_mask`` grids and an
  ``index_add_`` into ``G * L`` slots (JAX's ``segment_sum`` with the grid
  size as its segment count). Padding carries pair id 0 with a zero sign
  and a zero last-token mark, so it adds nothing to pair 0.
- ``LMEngine`` / ``RWEngine``: the update logic over a ``TorchTrainEngine``
  (the reward model's built with ``value_head=True``).
- ``SFTTrainer``: the step loop with the loader, ``Saver``, ``Evaluator``,
  ``RecoverHandler``, ``StatsLogger`` and the step timeline of
  ``PPOTrainer``; ``RWTrainer`` is the same harness over ``RWEngine``, its
  microbatch stats aggregated by pair count.

The trainers build their engine on the card unless given one (the tests
pass a CPU engine). ``allocation_mode`` sizes the engine's mesh through
``apply_allocation_mode`` and is checked as ``PPOTrainer`` checks it
(``rl_trainer.check_allocation``). Each rank of a ``torchrun`` world runs
the loop on the same batches (the loader is seeded alike everywhere);
rank 0 alone logs and writes the recover records, and every rank joins the
engine's collective saves. ``RWTrainer`` on more than one data-parallel
rank is ROADMAP Queue A item 6b: a pair's two sequences may land in
different ranks' rows.
``compile_cache.install_compile_counters`` counts XLA compilations and has
no PyTorch counterpart: it is left out.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from areal_tpu_torch.api.alloc_mode import apply_allocation_mode
from areal_tpu_torch.api.config import MicroBatchSpec, SFTConfig
from areal_tpu_torch.api.io_struct import FinetuneSpec, StepInfo
from areal_tpu_torch.engine.train_engine import TorchTrainEngine
from areal_tpu_torch.observability import step_timeline
from areal_tpu_torch.parallel.mesh import dp_size, is_lead
from areal_tpu_torch.trainer.rl_trainer import check_allocation, check_world
from areal_tpu_torch.utils import stats_tracker
from areal_tpu_torch.utils.data import (
    StatefulDataLoader,
    cycle_dataloader,
    pad_sequences_to_tensors,
    split_padded_tensor_dict_into_mb_list,
)
from areal_tpu_torch.utils.data import roll_to_label_alignment as _roll_back
from areal_tpu_torch.utils.recover import RecoverHandler
from areal_tpu_torch.utils.saver import Evaluator, Saver
from areal_tpu_torch.utils.stats_logger import StatsLogger


def lm_loss_fn(outputs: dict, b: dict):
    """Per-token NLL over the masked labels."""
    lm = (b["label_valid"] & (b["loss_mask"] > 0)).float()
    denom = torch.clamp(lm.sum(), min=1.0)
    nll = -(outputs["logprobs"] * lm).sum() / denom
    return nll, {"ppl_loss": nll.detach(), "n_valid_tokens": lm.sum()}


def rw_loss_fn(outputs: dict, b: dict):
    """Bradley-Terry: -log sigmoid(score_chosen - score_rejected)."""
    values = outputs["values"]  # [G, L]
    G, L = values.shape
    pair_id = b["rw_pair_id"].reshape(-1).long()
    last = b["rw_last_mask"]
    flat = (values * last * b["rw_sign"]).reshape(-1)
    diff = torch.zeros(G * L, dtype=flat.dtype, device=flat.device).index_add_(0, pair_id, flat)
    # a whole pair has exactly 2 last-token marks
    marks = torch.zeros(G * L, dtype=last.dtype, device=last.device).index_add_(0, pair_id, last.reshape(-1))
    valid = (marks >= 2.0).float()
    n_pairs = torch.clamp(valid.sum(), min=1.0)
    loss = -(F.logsigmoid(diff) * valid).sum() / n_pairs
    acc = ((diff > 0).float() * valid).sum() / n_pairs
    return loss, {
        "rw_loss": loss.detach(),
        "rw_acc": acc,
        "n_pairs": n_pairs,  # the weight of the aggregate across microbatches
    }


def _label_loss_mask(data) -> dict:
    data = dict(data)
    data["loss_mask"] = _roll_back(
        np.asarray(data["loss_mask"], np.float32) * np.asarray(data["attention_mask"], np.float32)
    )
    return data


def _n_loss_tokens(x) -> float:
    return float((np.asarray(x["loss_mask"]) > 0).sum())


class LMEngine:
    """SFT updates over a train engine."""

    def __init__(self, engine, mb_spec: MicroBatchSpec | None = None):
        self.engine = engine
        self.mb_spec = mb_spec or MicroBatchSpec()

    def train_lm(self, data) -> dict[str, float]:
        return self.engine.train_batch(_label_loss_mask(data), loss_fn=lm_loss_fn, loss_weight_fn=_n_loss_tokens)

    def eval_lm(self, data) -> dict[str, float]:
        return self.engine.eval_batch(_label_loss_mask(data), loss_fn=lm_loss_fn, loss_weight_fn=_n_loss_tokens)


class RWEngine:
    """Bradley-Terry reward-model updates. The engine has a value head;
    batches interleave (chosen, rejected) rows."""

    def __init__(self, engine, mb_spec: MicroBatchSpec | None = None):
        self.engine = engine
        # the split keeps pairs together (granularity 2), on a copy of the
        # caller's spec
        self.mb_spec = dataclasses.replace(mb_spec or MicroBatchSpec(), granularity=2)
        # the engine's own token-budget re-split does not know pairs and
        # could put a pair's halves in two grids, where the marks >= 2 gate
        # drops them: each call turns it off (the engine's config is shared)
        self._engine_mb_spec = MicroBatchSpec(max_tokens_per_mb=None)
        if self.mb_spec.max_tokens_per_mb is None:
            self.mb_spec = dataclasses.replace(self.mb_spec, max_tokens_per_mb=32768)

    def _prep(self, mb) -> dict:
        """The pair ids, signs (+1 chosen, -1 rejected) and last-token marks
        of one microbatch, as per-token arrays."""
        mb = dict(mb)
        attn = np.asarray(mb["attention_mask"], bool)
        B, L = attn.shape
        if B % 2:
            raise ValueError("RW batches interleave chosen / rejected pairs: an even number of rows")
        seqlens = attn.sum(-1)
        pair_id = np.broadcast_to((np.arange(B) // 2)[:, None], (B, L)).astype(np.int32)
        sign = np.broadcast_to(np.where(np.arange(B) % 2 == 0, 1.0, -1.0)[:, None], (B, L)).astype(np.float32)
        last = np.zeros((B, L), np.float32)
        last[np.arange(B), seqlens - 1] = 1.0
        mb["rw_pair_id"] = pair_id * attn
        mb["rw_sign"] = sign * attn
        mb["rw_last_mask"] = last
        return mb

    def train_rw(self, data) -> list[dict[str, float]]:
        mb_list = split_padded_tensor_dict_into_mb_list(dict(data), self.mb_spec)
        return [
            self.engine.train_batch(
                self._prep(mb),
                loss_fn=rw_loss_fn,
                loss_weight_fn=lambda x: float(len(np.asarray(x["rw_sign"]))) or 1.0,
                mb_spec=self._engine_mb_spec,
            )
            for mb in mb_list.mbs
        ]


def _collate_rows(rows) -> dict:
    return pad_sequences_to_tensors(
        [
            {"input_ids": np.asarray(r["input_ids"], np.int32), "loss_mask": np.asarray(r["loss_mask"], np.float32)}
            for r in rows
        ]
    )


class SFTTrainer:
    """The supervised fine-tuning loop. Dataset rows are pre-tokenized dicts
    ``{"input_ids": [...], "loss_mask": [...]}``."""

    # the subclass hooks (RWTrainer): the loss stat each step returns, and
    # whether the engine has a value head
    loss_key = "ppl_loss"
    value_head = False

    def __init__(self, config: SFTConfig, train_dataset, valid_dataset=None, tokenizer=None, engine=None):
        check_allocation(config)
        apply_allocation_mode(config)
        self.config = config
        self.tokenizer = tokenizer
        self.train_dataloader = StatefulDataLoader(
            train_dataset,
            batch_size=config.train_dataset.batch_size,
            shuffle=config.train_dataset.shuffle,
            seed=config.seed,
            drop_last=config.train_dataset.drop_last,
        )
        self.valid_dataset = valid_dataset
        self.ft_spec = FinetuneSpec(
            total_train_epochs=config.total_train_epochs,
            dataset_size=len(train_dataset),
            train_batch_size=config.train_dataset.batch_size,
        )
        self.engine = engine or TorchTrainEngine(config.model, value_head=self.value_head)
        if engine is None:
            self.engine.initialize(self.ft_spec)
        check_world(config)
        self.lm = LMEngine(self.engine, config.model.mb_spec)

        for c in (config.saver, config.checkpointer, config.evaluator, config.recover, config.stats_logger):
            c.experiment_name = c.experiment_name or config.experiment_name
            c.trial_name = c.trial_name or config.trial_name
            if hasattr(c, "fileroot"):
                c.fileroot = c.fileroot or config.cluster.fileroot
        self.saver = Saver(config.saver, self.ft_spec)
        self.evaluator = Evaluator(config.evaluator, self.ft_spec)
        self.recover_handler = RecoverHandler(config.recover, self.ft_spec)
        self.stats_logger = StatsLogger(config.stats_logger, self.ft_spec) if is_lead() else None
        # the RL loop's step-phase contract (rollout_wait stays 0: no bubble)
        self.step_recorder = step_timeline.StepTimelineRecorder()
        self.last_hbm_ledger: dict | None = None
        self.recover_info = self.recover_handler.load(
            self.engine, saver=self.saver, evaluator=self.evaluator, dataloader=self.train_dataloader
        )

    def _collate(self, rows) -> dict:
        return _collate_rows(rows)

    def _train_step(self, batch) -> dict:
        return self.lm.train_lm(batch)

    def train(self) -> list[float]:
        config = self.config
        start_step = self.recover_info.last_step_info.next().global_step if self.recover_info is not None else 0
        steps_per_epoch = len(self.train_dataloader)
        max_steps = config.total_train_epochs * steps_per_epoch
        if config.total_train_steps is not None:
            max_steps = min(max_steps, config.total_train_steps)

        gen = cycle_dataloader(self.train_dataloader)
        losses = []
        for global_step in range(start_step, max_steps):
            epoch = global_step // steps_per_epoch
            step = global_step % steps_per_epoch
            t0 = time.monotonic()
            tl = self.step_recorder.start(global_step)
            with tl.phase("host_prep"):
                batch = self._collate(next(gen))
            # the engine attributes its host_prep / forward_backward /
            # optimizer spans into ``tl`` through step_timeline.engine_phase
            stats = self._train_step(batch)
            self.engine.set_version(global_step + 1)
            losses.append(stats[self.loss_key])

            with tl.phase("ckpt_eval"):
                self.saver.maybe_save(self.engine, epoch, step, global_step, self.tokenizer)
                self.recover_handler.dump(
                    self.engine,
                    StepInfo(epoch=epoch, epoch_step=step, global_step=global_step, steps_per_epoch=steps_per_epoch),
                    saver=self.saver,
                    evaluator=self.evaluator,
                    dataloader=self.train_dataloader,
                    tokenizer=self.tokenizer,
                )
                if self.valid_dataset is not None:
                    self.evaluator.maybe_evaluate(epoch, global_step, self._run_eval)
            bd = self._complete_step_timeline(tl, batch)
            stats.update(step_timeline.breakdown_stat_keys(bd))
            if self.last_hbm_ledger is not None:
                stats["hbm/in_use_bytes"] = float(self.last_hbm_ledger["bytes_in_use"])
                if self.last_hbm_ledger["headroom_fraction"] is not None:
                    stats["hbm/headroom_fraction"] = float(self.last_hbm_ledger["headroom_fraction"])
            stats["step_secs"] = time.monotonic() - t0
            stats.update(stats_tracker.export_all())
            if self.stats_logger is not None:
                self.stats_logger.commit(epoch, step, global_step, stats)
        return losses

    def _complete_step_timeline(self, tl, batch) -> dict:
        """Close the step timeline: one forward / backward a step, no extra
        forwards."""
        bd, ledger = step_timeline.complete_trainer_step(
            self.step_recorder,
            tl,
            self.engine,
            self.config.telemetry,
            batch,
            remat=bool(getattr(self.config.model, "gradient_checkpointing", False)),
        )
        if ledger is not None:
            self.last_hbm_ledger = ledger
        return bd

    def _run_eval(self) -> None:
        eval_dl = StatefulDataLoader(
            self.valid_dataset, batch_size=self.config.train_dataset.batch_size, shuffle=False, drop_last=False
        )
        loss_sum = tok_sum = 0.0
        for rows in eval_dl:
            stats = self.lm.eval_lm(_collate_rows(rows))
            n = stats.get("n_valid_tokens", 1.0)
            loss_sum += stats["ppl_loss"] * n
            tok_sum += n
        with stats_tracker.scope("eval"):
            stats_tracker.get().scalar(ppl_loss=loss_sum / max(tok_sum, 1.0))

    def close(self) -> None:
        if self.stats_logger is not None:
            self.stats_logger.close()


class RWTrainer(SFTTrainer):
    """Reward-model training on the ``SFTTrainer`` harness (saver, recover
    dumps and stats logging inherited). Dataset rows are ``{"chosen_ids",
    "rejected_ids"}``; each step interleaves them, so consecutive rows form
    Bradley-Terry pairs. No validation set, as in JAX."""

    loss_key = "rw_loss"
    value_head = True

    def __init__(self, config, train_dataset, valid_dataset=None, **kw):
        if valid_dataset is not None:
            raise ValueError("RWTrainer has no eval loop (as in the JAX package): no valid_dataset")
        super().__init__(config, train_dataset, **kw)
        mesh = getattr(self.engine, "mesh", None)
        if mesh is not None and dp_size(mesh) > 1:
            raise NotImplementedError("RWTrainer on more than one data-parallel rank: ROADMAP Queue A item 6b")
        self.rw = RWEngine(self.engine, config.model.mb_spec)

    def _collate(self, rows) -> dict:
        return pad_sequences_to_tensors(
            [
                {"input_ids": np.asarray(ids, np.int32), "loss_mask": np.ones(len(ids), np.float32)}
                for item in rows
                for ids in (item["chosen_ids"], item["rejected_ids"])
            ]
        )

    def _train_step(self, batch) -> dict:
        stats_list = self.rw.train_rw(batch)
        # weighted by pair count: the last microbatch alone would report a
        # fraction of the step's pairs
        total = sum(float(s.get("n_pairs", 1.0)) for s in stats_list) or 1.0
        agg: dict[str, float] = {}
        for s in stats_list:
            w = float(s.get("n_pairs", 1.0)) / total
            for k, v in s.items():
                if isinstance(v, (int, float, np.floating)):
                    agg[k] = agg.get(k, 0.0) + float(v) * w
        agg["n_pairs"] = total
        return agg
