"""PPOTrainer: the RL training facade and its step loop — the port of
``areal_tpu/trainer/rl_trainer.py``.

Each global step runs, as the JAX trainer does (``rl_trainer.py:370-584``):

    prepare_batch -> [critic values] -> [proximal logp recompute]
    -> [reference logp] -> compute_advantages -> ppo_update
    -> [critic ppo_update] -> pause rollout -> update_weights
    -> set_version -> [save / recover] -> resume -> [eval] -> log

with the version rule ``new_version = global_step + 1`` on the trainer, the
rollout client and the servers. Over HTTP (``RemoteTorchEngine``) the
weights stream as bf16 buckets staged while generation continues, and one
commit lands inside the hold fence, which aborts nothing; under
``weight_update_mode="disk"`` the trainer writes an HF checkpoint and the
servers reload it inside the same fence.

Durable state (``rl_trainer.py:183-251``, ``:297-346``): at construction
``RecoverHandler.load`` restores the newest recover checkpoint (engine
state, saver / evaluator timers, the dataloader's position) and re-syncs
the fleet's weights, and ``train`` resumes at the step after the restored
one. Each step ends with ``saver.maybe_save`` (an HF checkpoint when due)
and then an asynchronous recover dump. With ``preemption.enabled`` (the
default) SIGTERM / SIGUSR1 only set a flag: the loop stops at the next step
boundary or aborts its rollout wait, dumps the last completed step
synchronously, seals the trajectory journal, dumps the lineage ring, sets
``preempted`` and returns.

The trajectory journal (``rollout.journal.enabled``,
``rl_trainer.py:220-253``): built from the config and attached to the
rollout client; on a recovered start the journaled trajectories still
inside ``max_head_offpolicyness`` replay into the batch queue, so the
relaunch's first batch is the work the dead trainer had accepted and not
trained on. After each recover dump the journal drops the segments that
the previous dump covers (the GC lags one recover generation). ``close``
seals the journal and dumps the lineage ring.

A critic (``config.critic``, ``rl_trainer.py:124-129``): ``critic_engine``,
or a ``TorchTrainEngine(config.critic, value_head=True)`` initialized with
the trainer's ``FinetuneSpec``. Its values enter the batch before the
proximal recompute (one more forward in the step timeline), its update
runs after the actor's, and it takes each new version with the actor; it
ships no weights. As in JAX, the recover dumps and the saver hold only the
actor: a relaunched trainer restarts its critic from ``config.critic``.

Across GPUs (``rl_trainer.py:91``): ``allocation_mode`` is live through
``apply_allocation_mode``; its train half sizes the actor's, the critic's
and the reference's meshes, and each rank of the ``torchrun`` world runs
this loop. Rank 0 alone talks to the server (the rollout client, its
journal and staleness manager), reads the dataloader, logs the stats and
writes the recover records; every rank steps together through the
engines' collectives: the rollout batch comes to all through the engine's
``DistRolloutCoordinator``, every rank joins each weight push, checkpoint
and recover dump (rank 0 writes the files), and a preemption seen on rank
0 is seen by all at the next step boundary. A gen half's ``tN`` / ``eN``
is a server serving on its model x expert cards (``DecodeEngine`` on
``mesh.model`` x ``mesh.expert``), which the trainer reaches over HTTP
like any other; a hybrid MoE spec ``(attn:...|ffn:...)`` takes its layout
from the attn half and ``ep`` from the ffn half. ``check_allocation``
refuses what waits for a later item.

Refused at construction with ``NotImplementedError`` naming the ROADMAP
Queue A item it waits for: a gen half of more than one server (item 8),
sequence or pipeline parallelism (items 6b-3, 6b-4), and a
``cluster.name_resolve.type`` other than "memory" (item 8); in a world of
several ranks, a time-based save, recover or eval
trigger (``freq_secs``: the ranks would not agree when it fires; 6b). The
weight wire follows ``resolve_weight_update_wire``: "q8" against an int8
fleet.

``compile_cache.install_compile_counters`` counts XLA compilations and has
no PyTorch counterpart: it is left out.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import threading
import time
from typing import Any, Callable

import numpy as np

import torch.distributed as dist

from areal_tpu_torch.api.alloc_mode import (AllocationMode, HybridParallelStrategy, _mesh_config_of,
                                            apply_allocation_mode)
from areal_tpu_torch.api.config import PPOConfig
from areal_tpu_torch.api.io_struct import FinetuneSpec, StepInfo, WeightUpdateMeta
from areal_tpu_torch.engine.train_engine import TorchTrainEngine
from areal_tpu_torch.infra.trajectory_journal import journal_from_config
from areal_tpu_torch.infra.workflow_executor import RolloutInterrupted
from areal_tpu_torch.observability import catalog as obs_catalog
from areal_tpu_torch.observability import lineage as lineage_mod
from areal_tpu_torch.observability import step_timeline
from areal_tpu_torch.parallel.mesh import is_lead
from areal_tpu_torch.robustness.preemption import PreemptionHandler
from areal_tpu_torch.trainer.ppo import PPOActor, PPOCritic
from areal_tpu_torch.utils import perf_tracer, stats_tracker
from areal_tpu_torch.utils.data import StatefulDataLoader
from areal_tpu_torch.utils.perf_tracer import Category
from areal_tpu_torch.utils.recover import RecoverHandler
from areal_tpu_torch.utils.saver import Evaluator, Saver
from areal_tpu_torch.utils.stats_logger import StatsLogger

logger = logging.getLogger("areal_tpu_torch.rl_trainer")


def resolve_weight_update_wire(config) -> str:
    """``weight_update_wire`` (``rl_trainer.py:43``): "auto" is "q8" when the
    serving fleet is int8-quantized (the servers' own transform, at 0.58x
    the bf16 bytes), else "bf16". Checked here, so a typo or a q8 wire to a
    fleet that is not int8 fails at the trainer's start, not at its first
    weight update."""
    wire = getattr(config, "weight_update_wire", "auto") or "auto"
    server_cfg = getattr(config, "server", None)
    int8_fleet = getattr(server_cfg, "quantization", "none") == "int8"
    if wire == "auto":
        wire = "q8" if server_cfg is not None and int8_fleet else "bf16"
    if wire not in ("bf16", "q8"):
        raise ValueError(
            f"weight_update_wire={wire!r}; valid: auto|bf16|q8 "
            "(int8 is a ServerConfig.quantization value, not a wire format)"
        )
    if wire == "q8" and not int8_fleet:
        raise ValueError(
            "weight_update_wire='q8' requires an int8-serving fleet (set server.quantization='int8'): servers "
            "refuse q8-wire leaves otherwise, at the first mid-training update"
        )
    return wire


def check_allocation(config) -> None:
    """Refuse the parts of ``allocation_mode`` that wait for a later item,
    before anything is built: a gen half of more than one server (a fleet,
    ROADMAP Queue A item 8); sequence or pipeline parallelism in either
    half (items 6b-3, 6b-4). A gen half's ``tN`` / ``eN`` is one server on
    the cards of its model x expert mesh (``server.mesh``; ``eN`` borrows
    the data-parallel degree, so ``d2e2`` is one server on 2 cards); a
    train half of any ``dN`` / ``tN`` / ``eN``, or a hybrid MoE spec
    ``(attn:...|ffn:...)``, passes here. The engines check that ``tN``
    divides the model's heads, KV heads, FFN and vocabulary and ``eN`` its
    experts (the server at ``initialize``) and that the world has the
    devices."""
    if not config.allocation_mode:
        return
    mode = AllocationMode.from_str(config.allocation_mode)
    halves = [("gen", mode.gen), ("train", mode.train), ("critic", mode.critic)]
    for half, ps in halves:
        if ps is None:
            continue
        for part in (ps.attn, ps.ffn) if isinstance(ps, HybridParallelStrategy) else (ps,):
            for dim, what, item in (("pp", "pipeline", "6b-4"), ("cp", "sequence", "6b-3")):
                if getattr(part, dim) > 1:
                    raise NotImplementedError(f"{half} half {dim}={getattr(part, dim)}: {what} parallelism is "
                                              f"ROADMAP Queue A item {item}")
    gen = mode.gen
    if gen is not None and _mesh_config_of(gen).fsdp > 1:
        raise NotImplementedError(f"gen half {gen}: {_mesh_config_of(gen).fsdp} servers; a fleet of servers is "
                                  "ROADMAP Queue A item 8")


def check_world(config) -> None:
    """In a world of several ranks every rank must reach each collective
    save at the same step: a time-based trigger (``freq_secs``) would fire
    on one rank and not another."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    for name in ("saver", "checkpointer", "evaluator", "recover"):
        if getattr(getattr(config, name), "freq_secs", None):
            raise NotImplementedError(f"{name}.freq_secs on a world of {dist.get_world_size()} ranks: ROADMAP "
                                      "Queue A item 6b")


def lead_flag(flag: bool) -> bool:
    """Rank 0's ``flag`` on every rank (one broadcast in a world of several)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return flag
    obj = [flag]
    dist.broadcast_object_list(obj, src=0)
    return bool(obj[0])


def check_supported(config: PPOConfig) -> None:
    """Raise ``NotImplementedError`` for each option of the loop whose code
    path is a later slice, before anything is built."""
    check_allocation(config)
    if config.cluster.name_resolve.type != "memory":
        raise NotImplementedError(
            f"name_resolve.type={config.cluster.name_resolve.type!r} (server discovery): ROADMAP Queue A item 8"
        )
    mode = config.weight_update_mode or config.actor.weight_update_mode
    if mode not in ("disk", "mem"):
        raise ValueError(f"weight_update_mode={mode!r}; valid: disk|mem")


class PPOTrainer:
    def __init__(
        self,
        config: PPOConfig,
        train_dataset,
        valid_dataset=None,
        rollout=None,
        eval_rollout=None,
        tokenizer=None,
        actor_engine=None,
        critic_engine=None,
        ref_engine=None,
        device=None,
    ):
        check_supported(config)
        wire = resolve_weight_update_wire(config)
        self.allocation_mode = apply_allocation_mode(config)
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

        # engines (injectable); a built one runs on the card unless
        # ``device`` says otherwise
        config.actor.temperature = config.gconfig.temperature
        self.actor_engine = actor_engine or TorchTrainEngine(config.actor, device=device)
        if actor_engine is None or getattr(self.actor_engine, "model", 1) is None:
            self.actor_engine.initialize(self.ft_spec)
        self.actor = PPOActor(config.actor, self.actor_engine)
        self.critic = None
        if config.critic is not None:
            eng = critic_engine or TorchTrainEngine(config.critic, value_head=True, device=device)
            if critic_engine is None:
                eng.initialize(self.ft_spec)
            self.critic = PPOCritic(config.critic, eng)
        self.ref = None
        if config.ref is not None:
            eng = ref_engine or TorchTrainEngine(config.ref, need_optimizer=False, device=device)
            if ref_engine is None:
                eng.initialize(self.ft_spec)
            self.ref = PPOActor(config.actor, eng)
        check_world(config)
        # rank 0 of a world of several (or the one process): it alone
        # talks to the server, logs and writes the recover records
        self._lead = is_lead()
        if not self._lead:
            rollout = eval_rollout = self.valid_dataset = None

        # the rollout client
        if rollout is None and self._lead:
            from areal_tpu_torch.inference.client import RemoteTorchEngine

            addrs = os.environ.get("AREAL_TPU_SERVER_ADDRS", "")
            rollout = RemoteTorchEngine(config.rollout, addresses=[a for a in addrs.split(",") if a])
            rollout.initialize()
        self.rollout = rollout
        # eval must not share the training executor: its results buffer
        # would interleave with training trajectories
        if eval_rollout is None and self.valid_dataset is not None:
            from areal_tpu_torch.inference.client import RemoteTorchEngine

            eval_cfg = dataclasses.replace(config.rollout, max_head_offpolicyness=10_000_000)
            eval_rollout = RemoteTorchEngine(eval_cfg, addresses=list(self.rollout.addresses))
            eval_rollout.initialize()
        self.eval_rollout = eval_rollout

        # the weight-update channel
        mode = config.weight_update_mode or config.actor.weight_update_mode
        update_dir = os.path.join(config.cluster.fileroot, config.experiment_name, config.trial_name, "update_weights")
        self.weight_update_meta = WeightUpdateMeta(type=mode, path=update_dir, with_version=True, wire_format=wire)
        self.actor_engine.connect_engine(self.rollout, self.weight_update_meta)

        for c in (config.saver, config.checkpointer, config.evaluator, config.recover, config.stats_logger):
            c.experiment_name = c.experiment_name or config.experiment_name
            c.trial_name = c.trial_name or config.trial_name
            if hasattr(c, "fileroot"):
                c.fileroot = c.fileroot or config.cluster.fileroot
        perf_tracer.configure(config.perf_tracer, rank=dist.get_rank() if dist.is_initialized() else 0,
                              role="trainer")
        self._obs = obs_catalog.trainer_metrics()
        self.step_recorder = step_timeline.StepTimelineRecorder()
        # SIGUSR2 sets this flag; the next step runs under torch.profiler
        self._profile_requested = threading.Event()
        self._prev_sigusr2 = None  # the handler train() replaced; close() puts it back
        self.last_hbm_ledger: dict | None = None
        self.saver = Saver(config.saver, self.ft_spec)
        self.evaluator = Evaluator(config.evaluator, self.ft_spec)
        self.recover_handler = RecoverHandler(config.recover, self.ft_spec)
        self.stats_logger = StatsLogger(config.stats_logger, self.ft_spec) if self._lead else None
        self.recover_info = self.recover_handler.load(
            self.actor_engine,
            saver=self.saver,
            evaluator=self.evaluator,
            dataloader=self.train_dataloader,
            inference_engine=self.rollout,
            weight_update_meta=self.weight_update_meta,
        )

        # the durable trajectory journal: accepted but unconsumed rollouts
        # survive the trainer's death; on a recovered start the in-bound
        # entries replay into the batch queue instead of being generated again
        self.journal = journal_from_config(
            config.rollout.journal,
            fileroot=config.cluster.fileroot,
            experiment=config.experiment_name,
            trial=config.trial_name,
        ) if self._lead else None
        self.last_replay: dict | None = None
        if self.journal is not None and hasattr(self.rollout, "attach_journal"):
            self.rollout.attach_journal(self.journal)
            if self.recover_info is not None and hasattr(self.rollout, "replay_from_journal"):
                t_replay = time.monotonic()
                replayed, dropped = self.rollout.replay_from_journal(config.rollout.max_head_offpolicyness)
                self.last_replay = dict(replayed=replayed, dropped=dropped, s=time.monotonic() - t_replay)
                if replayed or dropped:
                    logger.info(
                        f"recovered {replayed} journaled trajectories ({dropped} over-stale dropped) in "
                        f"{self.last_replay['s']:.2f}s: rollout regeneration saved"
                    )
        # the journal's GC lags one recover generation: segments consumed
        # below this version are durable inside a checkpoint load() reaches
        self._journal_gc_version = (
            self.recover_info.last_step_info.global_step + 1 if self.recover_info is not None else 0
        )

        # preemption: the signal handler only sets an event; the step loop
        # polls it at phase boundaries and the executor's waits abort on it
        self.preempted = False
        self.preemption: PreemptionHandler | None = None
        if config.preemption.enabled:
            self.preemption = PreemptionHandler(
                role="trainer", grace_s=config.preemption.grace_s, handle_sigusr1=config.preemption.handle_sigusr1
            )
            if self.rollout is not None and hasattr(self.rollout, "set_interrupt"):
                self.rollout.set_interrupt(self.preemption.requested)

    # -- preemption ---------------------------------------------------------
    def _preempt_requested(self) -> bool:
        """Rank 0's preemption flag, on every rank (all leave together)."""
        return lead_flag(self.preemption is not None and self.preemption.requested.is_set())

    def _handle_preemption(self, last_completed: StepInfo | None) -> None:
        """The grace-window drain (``rl_trainer.py:297``): stop rollout
        submissions, dump the last completed step synchronously and
        durably, seal the trajectory journal, dump the lineage ring, and
        mark the trial preempted; the caller leaves the loop and a relaunch
        resumes from the dump and replays the journal."""
        self.preemption.note_draining()
        t0 = time.monotonic()
        if self._lead:
            self.rollout.pause()
        if last_completed is not None:
            try:
                self.recover_handler.dump_emergency(
                    self.actor_engine,
                    last_completed,
                    saver=self.saver,
                    evaluator=self.evaluator,
                    dataloader=self.train_dataloader,
                    tokenizer=self.tokenizer,
                )
            except Exception:  # noqa: BLE001 — an older durable generation still
                # recovers the trial; dying in the grace window without an
                # exit is the one path that must not happen
                logger.exception("emergency recover dump failed")
        if self.journal is not None:
            self.journal.seal_active()
        if self._lead:
            self._dump_lineage("preempt")
        self.preemption.note_drained(time.monotonic() - t0)
        self.preempted = True
        logger.warning("trainer preempted: emergency state durable, rollout paused; leaving the step loop")

    def _on_profile_signal(self, signum, frame) -> None:
        self._profile_requested.set()  # flag only: the step loop does the work

    def _dump_lineage(self, reason: str) -> None:
        """Persist the trajectory-lineage ring beside the flight recorder's
        dumps (``lineage.default_dump_path``)."""
        ring = lineage_mod.get_lineage()
        if not ring.recent(1):
            return  # nothing recorded: no dump file
        try:
            ring.dump(lineage_mod.default_dump_path(reason), reason)
        except OSError:
            logger.exception("trajectory lineage dump failed")

    # -- step loop --------------------------------------------------------
    def train(self, workflow: Any = None, eval_workflow: Any = None, dynamic_filter_fn: Callable | None = None) -> None:
        config = self.config
        start_step = self.recover_info.last_step_info.next().global_step if self.recover_info is not None else 0
        steps_per_epoch = len(self.train_dataloader)
        max_steps = config.total_train_epochs * steps_per_epoch
        if config.total_train_steps is not None:
            max_steps = min(max_steps, config.total_train_steps)
        if self.preemption is not None:
            self.preemption.install()
        try:
            prev = signal.signal(signal.SIGUSR2, self._on_profile_signal)
            if self._prev_sigusr2 is None:
                self._prev_sigusr2 = prev
        except ValueError:
            logger.debug("SIGUSR2 profile trigger unavailable off the main thread")
        last_completed: StepInfo | None = self.recover_info.last_step_info if self.recover_info is not None else None

        for global_step in range(start_step, max_steps):
            if self._preempt_requested():
                self._handle_preemption(last_completed)
                return
            epoch = global_step // steps_per_epoch
            step = global_step % steps_per_epoch
            t_step = time.monotonic()
            profiling = bool(config.perf_tracer.profile_steps and global_step in config.perf_tracer.profile_steps)
            if self._profile_requested.is_set():
                self._profile_requested.clear()
                profiling = True
                logger.info(f"SIGUSR2: device-profiling step {global_step}")
            if profiling:
                perf_tracer.start_device_profile()

            tl = self.step_recorder.start(global_step)
            try:
                with tl.phase("rollout_wait"), perf_tracer.trace_scope(
                    "train.rollout", Category.COMPUTE, {"global_step": global_step}
                ):
                    # several ranks: rank 0 pulls, the engine hands every rank the batch
                    batch = self.actor_engine.prepare_batch(
                        self.train_dataloader, workflow=workflow, should_accept_fn=dynamic_filter_fn
                    )
            except RolloutInterrupted:
                # the signal landed during the rollout wait: abort this step
                # (the accepted work is journaled and replays after a relaunch)
                self.step_recorder.abandon(tl)
                self._handle_preemption(last_completed)
                return
            if self._preempt_requested():
                # the batch is ready, but training and the weight push can
                # outlast the grace window: abort the step; the popped batch
                # replays from the journal (its consumption marker post-dates
                # the dump)
                self.step_recorder.abandon(tl)
                self._handle_preemption(last_completed)
                return

            # the engine attributes its host_prep / forward_backward /
            # optimizer spans into ``tl`` through step_timeline.engine_phase
            n_extra_fwd = 0
            if self.critic is not None:
                with perf_tracer.trace_scope("train.compute_values", Category.COMPUTE):
                    batch["values"] = self.critic.compute_values(batch)
                n_extra_fwd += 1
            if self.actor.should_compute_prox_logp():
                with perf_tracer.trace_scope("train.recompute_logp", Category.COMPUTE):
                    batch["prox_logp"] = self.actor.compute_logp(batch)
                n_extra_fwd += 1
            if self.ref is not None:
                with perf_tracer.trace_scope("train.ref_logp", Category.COMPUTE):
                    batch["ref_logp"] = self.ref.compute_logp(batch)
                n_extra_fwd += 1
            with tl.phase("host_prep"), perf_tracer.trace_scope("train.compute_advantages", Category.COMPUTE):
                adv_batch = self.actor.compute_advantages(batch)

            t_train = time.monotonic()
            with perf_tracer.trace_scope("train.ppo_update", Category.COMPUTE):
                self.actor.ppo_update(adv_batch)
            if self.critic is not None:
                self.critic.ppo_update(adv_batch)
            train_step_secs = time.monotonic() - t_train

            # stop submissions, push the weights, advance the version
            with tl.phase("weight_publish"), perf_tracer.trace_scope("train.update_weights", Category.COMM):
                if self._lead:
                    self.rollout.pause()
                t_update = time.monotonic()
                new_version = global_step + 1
                self.actor_engine.update_weights(self.weight_update_meta)
                self.actor_engine.set_version(new_version)
                if self.critic is not None:
                    self.critic.engine.set_version(new_version)
                if self._lead:
                    self.rollout.set_version(new_version)
                if self.eval_rollout is not None:
                    self.eval_rollout.set_version(new_version)
            self._obs.update_seconds.observe(time.monotonic() - t_update)
            self._obs.version.set(new_version)

            t_save = time.monotonic()
            with tl.phase("ckpt_eval"), perf_tracer.trace_scope("train.save", Category.IO):
                self.saver.maybe_save(self.actor_engine, epoch, step, global_step, self.tokenizer)
                dumped = self.recover_handler.dump(
                    self.actor_engine,
                    StepInfo(epoch=epoch, epoch_step=step, global_step=global_step, steps_per_epoch=steps_per_epoch),
                    saver=self.saver,
                    evaluator=self.evaluator,
                    dataloader=self.train_dataloader,
                    tokenizer=self.tokenizer,
                    async_=True,
                )
                if dumped is not None and self.journal is not None:
                    # drop the segments consumed by steps the previous dump
                    # covers (this dump's write may still be in flight; the
                    # lag keeps the GC safe if it fails and recovery falls
                    # back a generation)
                    self.journal.gc(self._journal_gc_version)
                    self._journal_gc_version = new_version
            save_secs = time.monotonic() - t_save
            # resume before eval: the default eval client is the training
            # client, whose dispatcher skips submissions while paused
            if self._lead:
                self.rollout.resume()
            t_eval = time.monotonic()
            with tl.phase("ckpt_eval"):
                self._maybe_evaluate(eval_workflow or workflow, epoch, global_step)
            eval_secs = time.monotonic() - t_eval

            bd = self._complete_step_timeline(tl, batch, n_extra_fwd)
            stats = stats_tracker.export_all()
            if self._lead:
                stats.update(self.rollout.export_stats())
            stats.update(step_timeline.breakdown_stat_keys(bd))
            stats["timing/rollout"] = bd["rollout_wait_s"]
            stats["timing/train_step"] = train_step_secs
            stats["timing/update_weights"] = bd["weight_publish_s"]
            stats["timing/save"] = save_secs
            stats["timing/eval"] = eval_secs
            if self.last_hbm_ledger is not None:
                stats["hbm/in_use_bytes"] = float(self.last_hbm_ledger["bytes_in_use"])
                if self.last_hbm_ledger["headroom_fraction"] is not None:
                    stats["hbm/headroom_fraction"] = float(self.last_hbm_ledger["headroom_fraction"])
            stats["step_secs"] = time.monotonic() - t_step
            self._obs.step_seconds.observe(stats["step_secs"])
            stats["version"] = float(new_version)
            logger.info(f"step {global_step}: {step_timeline.format_phase_line(bd)}")
            if self.stats_logger is not None:
                self.stats_logger.commit(epoch, step, global_step, stats)
            last_completed = StepInfo(
                epoch=epoch, epoch_step=step, global_step=global_step, steps_per_epoch=steps_per_epoch
            )
            if profiling:
                trace_dir = perf_tracer.stop_device_profile()
                if trace_dir:
                    logger.info(f"device profile captured: {trace_dir}")
            perf_tracer.save(step=global_step)

    def _complete_step_timeline(self, tl, batch, n_extra_fwd: int) -> dict:
        bd, ledger = step_timeline.complete_trainer_step(
            self.step_recorder,
            tl,
            self.actor_engine,
            self.config.telemetry,
            batch,
            n_extra_forwards=n_extra_fwd,
            remat=bool(getattr(self.config.actor, "gradient_checkpointing", False)),
        )
        if ledger is not None:
            self.last_hbm_ledger = ledger
        return bd

    def _maybe_evaluate(self, eval_workflow, epoch: int, global_step: int) -> None:
        if self.valid_dataset is None or eval_workflow is None:
            return

        def run_eval():
            client = self.eval_rollout
            if client is None:
                return
            batch = client.rollout_batch(list(self.valid_dataset), workflow=eval_workflow)
            rewards = np.asarray(batch["rewards"], np.float32)
            with stats_tracker.scope("eval"):
                stats_tracker.get().scalar(reward=float(rewards.mean()), n_seqs=float(rewards.shape[0]))

        self.evaluator.maybe_evaluate(epoch, global_step, run_eval)

    def close(self) -> None:
        try:
            # a periodic async recover dump may still be writing: join it,
            # so close() means everything is durable
            self.saver.wait_async()
            self.recover_handler.saver.wait_async()
        except RuntimeError:
            logger.exception("async checkpoint write failed during close")
        if self.journal is not None:
            self.journal.close()
        if self._lead:
            self._dump_lineage("close")
        if self.preemption is not None:
            self.preemption.uninstall()
        if self._prev_sigusr2 is not None:
            # the installed handler is a bound method: left in place, it
            # would keep this trainer (and its engines) alive
            try:
                signal.signal(signal.SIGUSR2, self._prev_sigusr2)
            except ValueError:
                logger.debug("SIGUSR2 handler not restored off the main thread")
            self._prev_sigusr2 = None
        if self.stats_logger is not None:
            self.stats_logger.close()
        if self.rollout is not None:
            self.rollout.destroy()
