"""The rollout dispatcher: staleness-gated task submission and result
collection (``areal_tpu/infra/workflow_executor.py``).

One background dispatcher thread moves queued inputs into the
``AsyncTaskRunner`` whenever the ``StalenessManager`` grants capacity, and
drains finished episodes through format validation and accept / reject
accounting into a results buffer; a failed episode is relaunched, then
quarantined. ``prepare_batch`` keeps the pipeline full from an endless
cycle over the dataloader: the core of asynchronous RL.

``set_interrupt`` aliases the preemption handler's event into the
blocking waits: once it is set, ``wait``, ``wait_for_task`` and
``prepare_batch`` raise ``RolloutInterrupted`` instead of waiting out their
timeout.

Every accepted train trajectory is registered on the lineage ring
(``observability/lineage.py``; its ``lineage_id`` rides as a per-sequence
batch key) and then, with a journal attached (``attach_journal``),
appended to it before it becomes visible to ``wait`` / ``prepare_batch``,
which journal its consumption when they pop it; ``replay_from_journal``
re-injects what a dead trainer had accepted and not trained on. With
``dump_trajectories`` each accepted trajectory is also written as JSONL.
A failed append or dump is logged and never stops the rollout.

Not ported here: the completion callback (``set_completion_callback``
raises, ROADMAP Queue A item 8).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import tempfile
import threading
import time
import uuid
from collections import deque
from contextlib import nullcontext as _nullcontext
from typing import Any, Callable

import numpy as np

from areal_tpu_torch.api.config import InferenceEngineConfig
from areal_tpu_torch.api.workflow_api import RolloutWorkflow, resolve_workflow
from areal_tpu_torch.infra import workflow_context
from areal_tpu_torch.infra.async_task_runner import AsyncTaskRunner, TaskFailed
from areal_tpu_torch.infra.staleness_manager import StalenessManager
from areal_tpu_torch.observability import catalog
from areal_tpu_torch.observability import lineage as lineage_mod
from areal_tpu_torch.observability import timeline as tl_mod
from areal_tpu_torch.utils import perf_tracer, stats_tracker
from areal_tpu_torch.utils.data import (
    TensorDict,
    concat_padded_tensor_dicts,
    cycle_dataloader,
    pad_sequences_to_tensors,
)

logger = logging.getLogger("areal_tpu_torch.workflow_executor")


class RolloutInterrupted(RuntimeError):
    """A blocking rollout wait was interrupted (the preemption drain): the
    trainer's step aborts instead of waiting out the request timeout, which
    is far longer than the grace window."""


def check_trajectory_format(traj: TensorDict) -> None:
    """Guard a workflow's output: a non-empty dict of batched arrays with
    input_ids and attention_mask and one batch size."""
    if not isinstance(traj, dict) or not traj:
        raise ValueError(f"trajectory must be a non-empty dict, got {type(traj)}")
    if "input_ids" not in traj or "attention_mask" not in traj:
        raise ValueError(
            f"trajectory must contain input_ids and attention_mask, got {list(traj)}"
        )
    B, L = np.asarray(traj["attention_mask"]).shape
    for k, v in traj.items():
        v = np.asarray(v)
        if v.ndim == 0:
            raise ValueError(f"trajectory values must be batched arrays; {k} is scalar")
        if v.shape[0] != B:
            raise ValueError(f"{k} batch dim {v.shape[0]} != {B}")


class _TaskRecord:
    __slots__ = (
        "task_id",
        "data",
        "result",
        "accepted",
        "is_eval",
        "submit_ts",
        "workflow",
        "accept_fn",
        "strikes",
    )

    def __init__(self, task_id: str, data: Any, is_eval: bool = False):
        self.task_id = task_id
        self.data = data
        self.result: TensorDict | None = None
        self.accepted: bool | None = None
        self.is_eval = is_eval
        self.submit_ts = time.monotonic()
        # task-level resilience: what to relaunch with, and how many
        # attempts have failed so far (quarantine strikes)
        self.workflow: RolloutWorkflow | None = None
        self.accept_fn: Callable | None = None
        self.strikes = 0


class WorkflowExecutor:
    """Client-side rollout pipeline bound to one InferenceEngine."""

    def __init__(
        self,
        config: InferenceEngineConfig,
        engine,  # InferenceEngine (provides agenerate + get_version)
    ):
        config.check_supported()
        self.config = config
        self.engine = engine
        max_conc = config.max_concurrent_rollouts or config.consumer_batch_size
        self.staleness = StalenessManager(
            version_provider=engine,
            max_concurrent_rollouts=max_conc,
            consumer_batch_size=config.consumer_batch_size,
            max_staleness=config.max_head_offpolicyness,
        )
        self.runner = AsyncTaskRunner(max_concurrency=max_conc)
        self._input: queue.Queue[tuple[_TaskRecord, RolloutWorkflow, Callable | None]] = (
            queue.Queue()
        )
        # eval tasks skip staleness gating and accounting entirely
        self._input_eval: queue.Queue[
            tuple[_TaskRecord, RolloutWorkflow, Callable | None]
        ] = queue.Queue()
        # (task_id, traj, n_real_tokens): the count is cached at append time
        # so the dynamic-batch poll loop does not re-reduce every mask
        self._results: list[tuple[str, TensorDict, int]] = []
        self._eval_results: list[tuple[str, TensorDict, int]] = []
        self._done_tasks: dict[str, _TaskRecord] = {}
        # rejected tasks nobody awaits leave tombstones; bound their count
        self._reject_order: deque[str] = deque()
        self._max_reject_records = 65536
        self._cv = threading.Condition()
        self._paused = threading.Event()
        self._shutdown = threading.Event()
        self._thread: threading.Thread | None = None
        self._thread_exc: BaseException | None = None
        self._data_gen = None  # cached cycle_dataloader for prepare_batch
        # optional: attach a tokenizer to get decoded text in trajectory dumps
        self.tokenizer = None
        self._obs = catalog.executor_metrics()
        self._robust = catalog.robustness_metrics()
        self._preempt_obs = catalog.preemption_metrics()
        self._inflight = 0  # launched, not yet completed (dispatcher-only)
        # the durable trajectory journal (infra/trajectory_journal.py):
        # accepted trajectories are appended with their version tags, and
        # consumption is journaled at pop time, so a recovery knows what is
        # replayable
        self.journal = None
        # the preemption handler's event: once set, blocking waits raise
        # RolloutInterrupted
        self._interrupt: threading.Event | None = None

    # -- lifecycle --------------------------------------------------------
    def initialize(self) -> None:
        self.runner.start()
        self._thread = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._thread.start()

    def destroy(self) -> None:
        self._shutdown.set()
        if self._thread:
            self._thread.join(timeout=10)
        self.runner.stop()

    # -- pause / resume (submission side) ---------------------------------
    def pause(self) -> None:
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    # -- preemption / durability hooks ------------------------------------
    def set_interrupt(self, event: threading.Event | None) -> None:
        """Alias an external event (the PreemptionHandler's ``requested``)
        into the blocking waits: once it is set, they raise
        ``RolloutInterrupted`` instead of blocking out their timeout (the
        signal handler itself only sets the event)."""
        self._interrupt = event
        with self._cv:
            self._cv.notify_all()

    def _check_interrupt(self) -> None:
        if self._interrupt is not None and self._interrupt.is_set():
            raise RolloutInterrupted("rollout wait interrupted (preemption drain in progress)")

    def attach_journal(self, journal) -> None:
        """Attach a ``TrajectoryJournal``: every accepted train trajectory
        is appended (with its per-token version tags) and every popped
        batch is marked consumed, so a crashed trainer replays instead of
        generating again."""
        self.journal = journal

    def _version_stats(
        self, traj: TensorDict
    ) -> tuple[int, int, int, int, bool]:
        """Per-token version tags of one trajectory, summarized in ONE
        scan: ``(head, tail, lag, span, tagged)`` where head/tail are the
        min/max tagged version (current engine version when untagged),
        lag = current version - head, span = tail - head (>0 means the
        sequence decoded across a version change), and tagged
        says whether any token carried a version at all (untagged
        trajectories must not feed the staleness lag / span observations)."""
        versions = np.asarray(traj.get("versions", np.empty(0)))
        vmask = versions >= 0
        cur = int(self.engine.get_version())
        tagged = bool(versions.size and vmask.any())
        if tagged:
            head = int(versions[vmask].min())
            tail = int(versions[vmask].max())
        else:
            head = tail = cur
        return head, tail, max(0, cur - head), tail - head, tagged

    def _journal_append(
        self,
        traj: TensorDict,
        task_id: str,
        ntok: int,
        head_v: int,
        tail_v: int,
        lineage_meta: dict | None = None,
    ) -> None:
        if self.journal is None:
            return
        try:
            self.journal.append_trajectory(traj, task_id, head_v, tail_v, ntok, lineage=lineage_meta)
            if lineage_meta is not None:
                lineage_mod.get_lineage().mark_journaled(int(lineage_meta.get("lineage_id", -1)))
        except Exception:  # noqa: BLE001 — durability is best effort: a full
            # disk degrades to the behaviour without a journal, it does not
            # stop the rollout pipeline
            logger.exception("trajectory journal append failed")

    def _mark_consumed(self, task_ids: list[str]) -> None:
        """A training batch popped these trajectories: stamp the lineage
        ring with the consuming version and journal the consumption markers
        (replay skips what a checkpointed step already trained on)."""
        if not task_ids:
            return
        version = int(self.engine.get_version())
        lineage_mod.get_lineage().mark_consumed(task_ids, version)
        if self.journal is None:
            return
        try:
            self.journal.mark_consumed(task_ids, version)
        except Exception:  # noqa: BLE001 — see _journal_append
            logger.exception("trajectory journal consume-mark failed")

    def replay_from_journal(self, max_staleness: int | None = None) -> tuple[int, int]:
        """Recovery: re-inject the journaled trajectories that are pending
        (never consumed, or consumed by a step the crash destroyed) and
        still inside the staleness bound. Restores the staleness manager's
        accepted count so the capacity formula sees the replayed work.
        Returns ``(n_replayed, n_dropped_stale)``."""
        if self.journal is None:
            return 0, 0
        if max_staleness is None:
            max_staleness = self.staleness.max_staleness
        version = int(self.engine.get_version())
        replayable, dropped_stale, n_consumed = self.journal.pending_for_replay(version, max_staleness)
        n_stale = len(dropped_stale)
        ring = lineage_mod.get_lineage()
        for e in replayable:
            self.staleness.observe_version_lag(version - e.head_version)
            self.staleness.observe_version_span(e.tail_version - e.head_version)
            # a fresh lineage record for this life (the old ring died with
            # the old process); the provenance comes back from the frame's
            # payload, and the stamped lineage_id is rewritten so the train
            # step's attribution lands on the new record
            lin = e.lineage or {}
            lid = ring.register(
                task_id=e.task_id,
                replica=str(lin.get("replica", "")),
                head_version=e.head_version,
                tail_version=e.tail_version,
                n_tokens=e.n_real_tokens,
                reward=float(lin.get("reward", 0.0)),
                journaled=True,
            )
            if "lineage_id" in e.traj or lin:
                B = int(np.asarray(e.traj["attention_mask"]).shape[0])
                e.traj["lineage_id"] = np.full(B, lid, np.int64)
            with self._cv:
                self._results.append((e.task_id, e.traj, e.n_real_tokens))
                self._cv.notify_all()
        # the accepted count only: the capacity formula re-tightens as before
        # the crash without inflating this life's throughput counters
        self.staleness.restore_accepted(len(replayable))
        if replayable:
            self._preempt_obs.journal_replayed.inc(len(replayable))
        if n_stale:
            self._preempt_obs.journal_dropped_stale.inc(n_stale)
            # the counter says how many were dropped, the flight ring which
            # ones and how far past the bound
            flight = tl_mod.get_flight_recorder()
            for e in dropped_stale:
                flight.record(
                    "journal_drop_stale",
                    severity="warn",
                    task_id=e.task_id,
                    lag=version - e.head_version,
                    bound=int(max_staleness),
                    n_tokens=e.n_real_tokens,
                )
        logger.info(
            f"journal replay: {len(replayable)} trajectories re-injected, "
            f"{n_stale} dropped over-stale (bound {max_staleness}), "
            f"{n_consumed} already consumed by checkpointed steps"
        )
        return len(replayable), n_stale

    def _register_lineage(self, traj: TensorDict, task_id: str, head_v: int, tail_v: int, ntok: int) -> dict:
        """Register an accepted trajectory on the lineage ring and stamp its
        id as a per-sequence ``lineage_id`` batch key, which survives
        batching, minibatch splits and grid packing, so the train step can
        attribute its loss stats back to this task."""
        B = int(np.asarray(traj["attention_mask"]).shape[0])
        rewards = np.ravel(np.asarray(traj.get("rewards", np.zeros(B)), np.float32))
        reward = float(rewards.mean()) if rewards.size else 0.0
        replica = ",".join(list(getattr(self.engine, "addresses", []) or [])[:4]) or "inproc"
        lid = lineage_mod.get_lineage().register(
            task_id=task_id,
            replica=replica,
            head_version=head_v,
            tail_version=tail_v,
            n_tokens=ntok,
            reward=reward,
        )
        traj["lineage_id"] = np.full(B, lid, np.int64)
        return {"lineage_id": lid, "task_id": task_id, "replica": replica, "reward": reward}

    # -- dispatch loop ----------------------------------------------------
    def _dispatch_loop(self) -> None:
        try:
            while not self._shutdown.is_set():
                # eval tasks launch unconditionally (no staleness budget)
                while not self._paused.is_set():
                    try:
                        rec, workflow, accept_fn = self._input_eval.get_nowait()
                    except queue.Empty:
                        break
                    self._launch(rec, workflow, accept_fn)
                # move queued train inputs into the runner while capacity allows
                while not self._paused.is_set():
                    if self.staleness.get_capacity() <= 0:
                        break
                    try:
                        rec, workflow, accept_fn = self._input.get_nowait()
                    except queue.Empty:
                        break
                    self.staleness.on_submit()
                    self._launch(rec, workflow, accept_fn)
                # drain completed tasks. The timed poll doubles as the idle
                # wait (the loop's only pause). Failed tasks surface as
                # TaskFailed here and go through retry / quarantine instead
                # of stopping the dispatcher.
                first = True
                while True:
                    try:
                        res = self.runner.poll_result(
                            timeout=0.02 if first else None
                        )
                    except TaskFailed as tf:
                        first = False
                        self._inflight -= 1
                        self._on_task_failed(tf)
                        continue
                    first = False
                    if res is None:
                        break
                    self._inflight -= 1
                    self._on_result(res.task_id, res.data)
                # queue-depth gauges: cheap last-writer-wins sets on every
                # loop turn so a scrape always sees a fresh picture
                self._obs.input_depth.set(self._input.qsize())
                self._obs.eval_depth.set(self._input_eval.qsize())
                self._obs.inflight.set(self._inflight)
                self._obs.results_buffered.set(len(self._results))
        except BaseException as e:  # noqa: BLE001 — fail fast to callers
            logger.exception("dispatcher thread failed")
            # publish under the condition so waiters observe the failure in
            # the same wakeup that notifies them
            with self._cv:
                self._thread_exc = e
                self._cv.notify_all()

    def _launch(self, rec: _TaskRecord, workflow: RolloutWorkflow, accept_fn) -> None:
        self._obs.dispatch_latency.observe(time.monotonic() - rec.submit_ts)
        self._inflight += 1
        # kept for relaunch-on-failure (task-level resilience)
        rec.workflow = workflow
        rec.accept_fn = accept_fn

        async def run():
            # asyncio-task-local execution context: workflows and rewards
            # read it with workflow_context.get(); eval tasks' stats scope
            workflow_context.set(
                workflow_context.WorkflowContext(
                    is_eval=rec.is_eval, task_id=rec.task_id
                )
            )
            perf_tracer.set_task_context(task_id=rec.task_id)
            perf_tracer.get_session_tracer().start_session(rec.task_id)
            traj = await workflow.arun_episode(self.engine, rec.data)
            return (traj, accept_fn)

        self.runner.submit(run, task_id=rec.task_id)

    def _on_result(self, task_id: str, payload) -> None:
        traj, accept_fn = payload
        rec = self._done_tasks.get(task_id)
        if isinstance(traj, list):  # grouped per-sequence dicts -> padded batch
            traj = pad_sequences_to_tensors(traj) if traj else None
        accepted = traj is not None
        is_eval = rec.is_eval if rec is not None else False
        if accepted and self.config.check_trajectory_format:
            check_trajectory_format(traj)
        if accepted and accept_fn is not None:
            accepted = bool(accept_fn(traj))
        # this runs on the dispatcher thread, where the task ContextVar is
        # not set: scope the counters explicitly so eval accounting stays
        # out of the training curves
        tracker = stats_tracker.get()
        counter_cm = (
            tracker.scope("eval-rollout") if is_eval else _nullcontext()
        )
        # one versions scan per accepted train trajectory
        vstats = (
            self._version_stats(traj) if accepted and not is_eval else None
        )
        if accepted:
            if not is_eval:
                self.staleness.on_accept()
                if vstats[4]:  # tagged: the one scan already decided
                    _head, _tail, lag, span, _tagged = vstats
                    self.staleness.observe_version_lag(lag)
                    # a sequence decoded across a version change carries
                    # both versions; decoupled PPO corrects it per token
                    self.staleness.observe_version_span(span)
            with counter_cm:
                tracker.scalar(rollout_accepted=1.0)
            if self.config.dump_trajectories:
                try:
                    self._dump_trajectory(traj, task_id)
                except Exception:  # noqa: BLE001 — dumping must never stop the rollout
                    logger.exception("trajectory dump failed")
        else:
            if not is_eval:
                self.staleness.on_reject()
            with counter_cm:
                tracker.scalar(rollout_rejected=1.0)
        perf_tracer.get_session_tracer().finalize(
            task_id, "accepted" if accepted else "rejected"
        )
        self._log_task_latency(task_id, accepted)
        ntok = (
            int(np.asarray(traj["attention_mask"]).sum()) if accepted else 0
        )
        if accepted and not is_eval:
            head_v, tail_v, _lag, _span, _tagged = vstats
            # lineage before the journal: the frame's payload carries the
            # same provenance, so the record can be rebuilt from disk
            lineage_meta = self._register_lineage(traj, task_id, head_v, tail_v, ntok)
            # durable before visible: once a trajectory can be popped into a
            # batch it is journaled, or a crash between the pop and the next
            # dump would lose it
            self._journal_append(traj, task_id, ntok, head_v, tail_v, lineage_meta)
        with self._cv:
            if rec is not None:
                rec.result = traj if accepted else None
                rec.accepted = accepted
                rec.data = None  # release the input payload
            if accepted:
                bucket = self._eval_results if is_eval else self._results
                bucket.append((task_id, traj, ntok))
            elif rec is not None:
                self._reject_order.append(task_id)
                while len(self._reject_order) > self._max_reject_records:
                    self._done_tasks.pop(self._reject_order.popleft(), None)
            self._cv.notify_all()

    def _on_task_failed(self, tf: TaskFailed) -> None:
        """A rollout task whose coroutine raised.

        With fault tolerance enabled the task is relaunched (same record,
        same workflow) up to ``task_max_retries`` times; at
        ``task_quarantine_strikes`` failures it is dropped as poison,
        counted in ``areal_task_quarantined_total`` and accounted as a
        rejection, so the pipeline keeps flowing. With fault tolerance off
        the failure propagates and stops the dispatcher (fail fast)."""
        ft = self.config.fault_tolerance
        if not ft.enabled:
            raise tf
        task_id = tf.task_id
        rec = self._done_tasks.get(task_id)
        if rec is None or rec.workflow is None:
            logger.error(f"failed task {task_id} has no record; dropping")
            return
        rec.strikes += 1
        if (
            rec.strikes <= ft.task_max_retries
            and rec.strikes < ft.task_quarantine_strikes
        ):
            self._robust.task_retries.inc()
            logger.warning(
                f"task {task_id} attempt {rec.strikes} failed "
                f"({tf.exc!r}); relaunching"
            )
            # restamp so the dispatch-latency histogram measures queue
            # wait, not the failed attempt's runtime
            rec.submit_ts = time.monotonic()
            self._launch(rec, rec.workflow, rec.accept_fn)
            return
        self._robust.task_quarantined.inc()
        logger.error(
            f"task {task_id} quarantined after {rec.strikes} failed "
            f"attempts; last error: {tf.exc!r}"
        )
        # a failed episode's coroutine may have left sibling generations
        # running (un-cancelled gathers): cancel them server-side so the
        # server stops decoding for a task that will never use the output
        abort = getattr(self.engine, "abort_task_requests", None)
        if abort is not None:
            try:
                n = abort(task_id)
                if n:
                    logger.warning(
                        f"cancelled {n} in-flight generation(s) of "
                        f"quarantined task {task_id}"
                    )
            except Exception:  # noqa: BLE001 — cleanup must not mask the
                # quarantine accounting below
                logger.exception("abort_task_requests failed")
        if not rec.is_eval:
            self.staleness.on_reject()
        tracker = stats_tracker.get()
        counter_cm = (
            tracker.scope("eval-rollout") if rec.is_eval else _nullcontext()
        )
        with counter_cm:
            tracker.scalar(rollout_rejected=1.0)
        with self._cv:
            rec.result = None
            rec.accepted = False
            rec.data = None
            self._reject_order.append(task_id)
            while len(self._reject_order) > self._max_reject_records:
                self._done_tasks.pop(self._reject_order.popleft(), None)
            self._cv.notify_all()
        self._log_task_latency(task_id, False)

    def set_completion_callback(self, url: str, worker_id: str = "") -> None:
        raise NotImplementedError("completion callbacks (the rollout controller): ROADMAP Queue A item 8")

    def _log_task_latency(self, task_id: str, accepted: bool) -> None:
        """Per-trajectory latency line from the client's per-task sum of
        the server's stage breakdown: every generation the task issued,
        summed by stage. INFO when rollout tracing is on, DEBUG otherwise;
        always popped so the client-side aggregate cannot leak."""
        take = getattr(self.engine, "take_task_latency", None)
        if take is None:
            return
        try:
            agg = take(task_id)
        except Exception:  # noqa: BLE001 — attribution must never fail a task
            logger.exception("take_task_latency failed")
            return
        if not agg:
            return
        line = (
            f"trajectory {task_id[:8]} [{'accepted' if accepted else 'rejected'}] "
            f"latency: reqs={int(agg['requests'])} tokens={int(agg['tokens'])} "
            f"e2e={agg['e2e_s']:.3f}s queue_wait={agg['queue_wait_s']:.3f}s "
            f"prefill={agg['prefill_s']:.3f}s decode={agg['decode_s']:.3f}s "
            f"fence_stall={agg['fence_stall_s']:.3f}s park={agg['park_s']:.3f}s "
            f"ttft_max={agg['ttft_max_s']:.3f}s"
        )
        if self.config.enable_rollout_tracing:
            logger.info(line)
        else:
            logger.debug(line)

    def _check_health(self) -> None:
        if self._thread_exc is not None:
            raise RuntimeError("rollout dispatcher failed") from self._thread_exc

    # -- trajectory dumps --------------------------------------------------
    def _dump_dir(self) -> str:
        if self.config.dump_dir:
            return self.config.dump_dir
        return os.path.join(
            tempfile.gettempdir(),
            "areal_tpu_torch",
            "experiments",
            self.config.experiment_name or "exp",
            self.config.trial_name or "trial",
            "generated",
        )

    def _dump_trajectory(self, traj: TensorDict, task_id: str) -> None:
        """One JSONL record per sequence, under ``{dump_dir}/{tail_version}/``:
        seqlen, prompt_len, the version span and the reward, plus the
        decoded text when a tokenizer is attached (token ids otherwise)."""
        input_ids = np.asarray(traj["input_ids"])
        attn = np.asarray(traj["attention_mask"])
        loss_mask = np.asarray(traj.get("loss_mask", np.ones_like(attn)))
        rewards = np.asarray(traj.get("rewards", np.zeros(len(input_ids))))
        head_v, tail_v, _lag, _span, _tagged = self._version_stats(traj)
        version_dir = os.path.join(self._dump_dir(), str(tail_v))
        os.makedirs(version_dir, exist_ok=True)
        path = os.path.join(version_dir, f"{task_id}.jsonl")
        with open(path, "a") as f:
            for i in range(len(input_ids)):
                seqlen = int(attn[i].sum())
                if seqlen == 0:
                    continue
                ids = input_ids[i, :seqlen].tolist()
                mask = loss_mask[i, :seqlen].tolist()
                if not mask or mask[-1] != 1:
                    continue  # no completion tokens
                # only the leading 0-run is the prompt: multi-turn masks
                # interleave 0-runs (injected turns) with 1-runs
                prompt_end = next((j for j, m in enumerate(mask) if m == 1), seqlen)
                rec = {
                    "task_id": task_id,
                    "sample_idx": i,
                    "seqlen": seqlen,
                    "prompt_len": prompt_end,
                    "head_version": head_v,
                    "tail_version": tail_v,
                    "reward": float(np.ravel(rewards)[i]),
                }
                if self.tokenizer is not None:
                    rec["prompt"] = self.tokenizer.decode(ids[:prompt_end])
                    rec["completion"] = self.tokenizer.decode(ids[prompt_end:])
                else:
                    rec["prompt_ids"] = ids[:prompt_end]
                    rec["completion_ids"] = ids[prompt_end:]
                f.write(json.dumps(rec) + "\n")

    # -- public API (InferenceEngine rollout surface) ---------------------
    def submit(
        self,
        data: dict,
        workflow: Any = None,
        should_accept_fn: Callable | None = None,
        is_eval: bool = False,
    ) -> str:
        workflow = resolve_workflow(workflow)
        rec = _TaskRecord(uuid.uuid4().hex, data, is_eval=is_eval)
        self._done_tasks[rec.task_id] = rec
        (self._input_eval if is_eval else self._input).put(
            (rec, workflow, should_accept_fn)
        )
        return rec.task_id

    def wait(
        self, count: int, timeout: float | None = None, is_eval: bool = False
    ) -> TensorDict:
        """Block until ``count`` accepted trajectories, then pop and merge.
        Train and eval results live in separate buffers, so eval samples
        never leak into a training batch."""
        deadline = time.monotonic() + (timeout or self.config.request_timeout)
        with self._cv:
            bucket = lambda: self._eval_results if is_eval else self._results
            while len(bucket()) < count:
                self._check_health()
                self._check_interrupt()
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"waited for {count} trajectories, got {len(bucket())}"
                    )
                self._cv.wait(timeout=min(remaining, 0.2))
            out = bucket()[:count]
            if is_eval:
                self._eval_results = self._eval_results[count:]
            else:
                self._results = self._results[count:]
            for tid, _, _ in out:
                self._done_tasks.pop(tid, None)
        if not is_eval:
            self._mark_consumed([tid for tid, _, _ in out])
        return concat_padded_tensor_dicts([t for _, t, _ in out])

    def wait_for_task(self, task_id: str, timeout: float | None = None):
        deadline = time.monotonic() + (timeout or self.config.request_timeout)
        rec = self._done_tasks[task_id]
        with self._cv:
            while rec.accepted is None:
                self._check_health()
                self._check_interrupt()
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"task {task_id} not done")
                self._cv.wait(timeout=min(remaining, 0.2))
        with self._cv:
            self._done_tasks.pop(task_id, None)
            # drop this task's trajectory from the results buffers so it is
            # not consumed a second time by wait()/prepare_batch
            self._results = [r for r in self._results if r[0] != task_id]
            self._eval_results = [
                r for r in self._eval_results if r[0] != task_id
            ]
        return rec.result

    def rollout_batch(
        self, data: list[dict], workflow=None, should_accept_fn=None,
        is_eval: bool = False,
    ) -> TensorDict:
        for d in data:
            self.submit(d, workflow, should_accept_fn, is_eval=is_eval)
        return self.wait(len(data), is_eval=is_eval)

    def prepare_batch(
        self, dataloader, workflow=None, should_accept_fn=None
    ) -> TensorDict:
        """The asynchronous-RL batch source: keep the submission pipeline
        full (bounded by the staleness capacity) and return once
        consumer_batch_size trajectories are ready."""
        if self._data_gen is None:
            self._data_gen = cycle_dataloader(dataloader)
        bs = self.config.consumer_batch_size
        # dynamic batch mode: return as soon as the accepted set reaches a
        # token budget instead of a fixed count (batch sizes then track
        # response length, keeping step compute stable)
        tok_budget = self.config.dynamic_bs_max_tokens
        workflow = resolve_workflow(workflow)
        while True:
            self._check_health()
            self._check_interrupt()
            # top up submissions while there is capacity and queue space
            while (
                self.staleness.get_capacity() > 0
                and self._input.qsize() == 0
                and not self._paused.is_set()
            ):
                item = next(self._data_gen)
                for d in item if isinstance(item, list) else [item]:
                    self.submit(d, workflow, should_accept_fn)
            with self._cv:
                if tok_budget is not None and self._results:
                    n_take, total = 0, 0
                    for _, _, ntok in self._results:
                        total += ntok
                        n_take += 1
                        if total >= tok_budget:
                            break
                    if total >= tok_budget or n_take >= bs:
                        out = self._results[:n_take]
                        self._results = self._results[n_take:]
                        for tid, _, _ in out:
                            self._done_tasks.pop(tid, None)
                        self._mark_consumed([tid for tid, _, _ in out])
                        return concat_padded_tensor_dicts([t for _, t, _ in out])
                elif len(self._results) >= bs:
                    out, self._results = self._results[:bs], self._results[bs:]
                    for tid, _, _ in out:
                        self._done_tasks.pop(tid, None)
                    self._mark_consumed([tid for tid, _, _ in out])
                    return concat_padded_tensor_dicts([t for _, t, _ in out])
                # _on_result notifies _cv on every completion (which is also
                # when capacity frees up); the short timeout re-checks
                # capacity changes that notify nobody (a version bump)
                self._cv.wait(timeout=0.05)

    def export_stats(self) -> dict[str, float]:
        return {f"rollout/{k}": float(v) for k, v in self.staleness.export_stats().items()}
