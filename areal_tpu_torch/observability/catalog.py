"""The metric families the rollout loop registers, copied from
``areal_tpu/observability/catalog.py`` with the same names, labels, help
texts and buckets: ``staleness_metrics``, ``executor_metrics``,
``lifecycle_metrics``, ``client_metrics``, ``robustness_metrics``,
``preemption_metrics``, and the trainer loop's ``trainer_metrics`` and
``train_obs_metrics`` (the latter without the XLA compile counters, which
have no PyTorch counterpart). The other families wait for the modules that
register them (ROADMAP Queue A items 2, 3, 7 and 8).

Factories are idempotent (the registry dedups by name).
"""

from __future__ import annotations

from types import SimpleNamespace

from areal_tpu_torch.observability.metrics import Registry, get_registry

# short-latency buckets for TTFT / dispatch (sub-ms to 10s)
FAST_BUCKETS = (
    0.0005,
    0.001,
    0.0025,
    0.005,
    0.01,
    0.025,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
    2.5,
    5.0,
    10.0,
)
# version-lag buckets (integer staleness steps)
LAG_BUCKETS = (0, 1, 2, 3, 4, 6, 8, 12, 16, 32)


def staleness_metrics(reg: Registry | None = None) -> SimpleNamespace:
    """StalenessManager: admission-control visibility."""
    r = reg or get_registry()
    return SimpleNamespace(
        capacity=r.gauge(
            "areal_rollout_capacity",
            "Remaining rollout admission capacity (staleness-bounded).",
        ),
        running=r.gauge(
            "areal_rollout_running", "Rollouts currently in flight."
        ),
        submitted=r.counter(
            "areal_rollout_submitted_total", "Rollout tasks admitted."
        ),
        accepted=r.counter(
            "areal_rollout_accepted_total",
            "Rollout trajectories accepted into the training buffer.",
        ),
        rejected=r.counter(
            "areal_rollout_rejected_total",
            "Rollout trajectories rejected (filter or empty result).",
        ),
        version_lag=r.histogram(
            "areal_rollout_version_lag",
            "Policy-version lag (current - head version) of accepted "
            "trajectories.",
            buckets=LAG_BUCKETS,
        ),
        version_span=r.histogram(
            "areal_rollout_version_span",
            "Per-trajectory policy-version spread (max - min per-token "
            "version): >0 means the sequence spanned a weight commit.",
            buckets=LAG_BUCKETS,
        ),
        mixed_version=r.counter(
            "areal_rollout_mixed_version_total",
            "Accepted trajectories whose tokens span more than one policy "
            "version (generated across a zero-pause weight commit).",
        ),
    )


def executor_metrics(reg: Registry | None = None) -> SimpleNamespace:
    """WorkflowExecutor: queue depths + dispatch latency."""
    r = reg or get_registry()
    return SimpleNamespace(
        input_depth=r.gauge(
            "areal_executor_input_queue_depth",
            "Queued train rollout tasks awaiting staleness capacity.",
        ),
        eval_depth=r.gauge(
            "areal_executor_eval_queue_depth",
            "Queued eval rollout tasks awaiting dispatch.",
        ),
        inflight=r.gauge(
            "areal_executor_inflight_tasks",
            "Rollout tasks launched and not yet completed.",
        ),
        results_buffered=r.gauge(
            "areal_executor_results_buffered",
            "Accepted trajectories buffered awaiting wait()/prepare_batch.",
        ),
        # default (latency-wide) buckets: gate waits under exhausted
        # staleness capacity routinely run tens of seconds to minutes
        dispatch_latency=r.histogram(
            "areal_executor_dispatch_latency_seconds",
            "Time from submit() to task launch (staleness-gate wait).",
        ),
    )


def lifecycle_metrics(reg: Registry | None = None) -> SimpleNamespace:
    """The request lifecycle (ROADMAP Queue A item 2): deadlines,
    cancellation, admission control, and load shedding across the stack."""
    r = reg or get_registry()
    return SimpleNamespace(
        admission_rejected=r.counter(
            "areal_admission_rejected_total",
            "Generation requests rejected at admission with 429 + "
            "Retry-After, by reason (queue_depth | page_headroom).",
            label_names=("reason",),
        ),
        deadline_exceeded=r.counter(
            "areal_request_deadline_exceeded_total",
            "Requests reaped at their deadline (queued or mid-decode); "
            "partial output returned with truncated_by=deadline.",
        ),
        aborts=r.counter(
            "areal_abort_total",
            "In-flight requests cancelled via /abort_request (client "
            "disconnects, workflow task failures) — slots and KV pages "
            "reclaimed instead of decoding for a caller that is gone.",
        ),
        queue_depth=r.gauge(
            "areal_request_queue_depth",
            "Lifecycle view of engine admission pressure: submission queue "
            "+ backlog depth the admission-control gate compares against "
            "lifecycle.max_queue_depth.",
        ),
        watchdog_fired=r.counter(
            "areal_slot_watchdog_fired_total",
            "Active slots aborted by the per-slot progress watchdog (no "
            "token emitted within lifecycle.watchdog_s).",
        ),
        gateway_shed=r.counter(
            "areal_gateway_shed_total",
            "Requests load-shed at the gateway with 429 + Retry-After, by "
            "priority class (rollout sheds before interactive).",
            label_names=("priority",),
        ),
        gateway_latency=r.histogram(
            "areal_gateway_admitted_latency_seconds",
            "End-to-end latency of requests ADMITTED through the gateway, "
            "by priority class (interactive | rollout).",
            label_names=("priority",),
        ),
        gateway_inflight=r.gauge(
            "areal_gateway_inflight",
            "Requests currently forwarded through the gateway, by "
            "priority class.",
            label_names=("priority",),
        ),
    )


def client_metrics(reg: Registry | None = None) -> SimpleNamespace:
    """The rollout client: the trainer-side weight-update path."""
    r = reg or get_registry()
    return SimpleNamespace(
        updates=r.counter(
            "areal_weight_update_total", "Weight updates pushed to the fleet."
        ),
        update_bytes=r.counter(
            "areal_weight_update_bytes_total",
            "Encoded weight bytes uploaded (trainer side; 1x per bucket "
            "regardless of relay fan-out).",
        ),
        pause_seconds=r.histogram(
            "areal_weight_update_pause_seconds",
            "Fleet availability gap per update (pause->continue window).",
        ),
        # zero-pause protocol split (ROADMAP Queue A 1b): staging streams
        # while generation runs; only the commit fence costs availability
        stage_seconds=r.histogram(
            "areal_update_stage_secs",
            "Streamed weight-update staging window (begin -> last bucket "
            "staged), during which generation keeps running.",
        ),
        commit_pause_seconds=r.histogram(
            "areal_update_pause_secs",
            "Per-update availability gap under the zero-pause protocol: "
            "the commit fence window only.",
        ),
        tokens_during_update=r.counter(
            "areal_generation_tokens_during_update",
            "Tokens the fleet generated while weight updates were staging "
            "(summed from commit responses; zero-pause visibility).",
        ),
        scrape_retries=r.counter(
            "areal_client_scrape_retries_total",
            "Metric-scrape GETs retried after a timeout or error.",
        ),
    )


def robustness_metrics(reg: Registry | None = None) -> SimpleNamespace:
    """The fault-tolerance layer: retries and task retry / quarantine here;
    circuits, supervision and chaos with ROADMAP Queue A item 8."""
    r = reg or get_registry()
    return SimpleNamespace(
        replica_state=r.gauge(
            "areal_replica_state",
            "Replica health by address: 0 in rotation (healthy), "
            "1 suspect (half-open circuit / failed probes), "
            "2 evicted (circuit open or supervisor-declared dead).",
            label_names=("replica",),
        ),
        retries=r.counter(
            "areal_retry_total",
            "HTTP requests retried after a failure, by call kind.",
            label_names=("kind",),
        ),
        circuit_open=r.counter(
            "areal_circuit_open_total",
            "Circuit-breaker open transitions (replica evicted from "
            "rotation after consecutive failures).",
        ),
        failovers=r.counter(
            "areal_failover_total",
            "Requests re-routed to a different replica after the preferred "
            "one failed or tripped open.",
        ),
        budget_exhausted=r.counter(
            "areal_retry_budget_exhausted_total",
            "Retries skipped because the retry token budget was exhausted "
            "(fail-fast under fleet-wide outage).",
        ),
        task_retries=r.counter(
            "areal_task_retry_total",
            "Rollout tasks relaunched after a failed attempt.",
        ),
        task_quarantined=r.counter(
            "areal_task_quarantined_total",
            "Rollout tasks dropped as poison after exhausting their "
            "retry strikes.",
        ),
        replica_respawns=r.counter(
            "areal_replica_respawn_total",
            "Dead rollout workers respawned by the controller supervisor.",
        ),
        replica_resyncs=r.counter(
            "areal_replica_resync_total",
            "Replicas that rejoined the fleet needing re-sync (respawned "
            "workers re-versioned by the supervisor; servers refreshed by "
            "the next weight-update fan-out).",
        ),
        recover_fallbacks=r.counter(
            "areal_recover_fallback_total",
            "Recovery loads that fell back to the previous checkpoint "
            "after detecting a corrupt or dangling recover record.",
        ),
        chaos_injected=r.counter(
            "areal_chaos_injected_total",
            "Faults injected by the chaos harness, by kind.",
            label_names=("kind",),
        ),
    )


def preemption_metrics(reg: Registry | None = None) -> SimpleNamespace:
    """Preemption tolerance and the trajectory journal (ROADMAP Queue A
    item 3): graceful-drain visibility across trainer and serving roles."""
    r = reg or get_registry()
    return SimpleNamespace(
        preemptions=r.counter(
            "areal_preemption_total",
            "Preemption signals honored (SIGTERM/SIGUSR1 entered the "
            "grace-window drain state machine), by process role "
            "(trainer | inference_server | rollout_worker).",
            label_names=("role",),
        ),
        drain_seconds=r.histogram(
            "areal_drain_seconds",
            "Graceful-drain duration: signal (or drain request) to "
            "drained — trainer rollout drain, or serving finish-or-park "
            "of in-flight decodes.",
            buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0),
        ),
        ckpt_save_seconds=r.histogram(
            "areal_ckpt_save_seconds",
            "Step-loop pause per recover/checkpoint save, by mode: "
            "\"sync\" blocks for the full Orbax write, \"async\" only for "
            "the host snapshot (the write runs on a background thread).",
            label_names=("mode",),
            buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0),
        ),
        journal_appended=r.counter(
            "areal_journal_appended_total",
            "Accepted trajectories appended to the durable trajectory "
            "journal (infra/trajectory_journal.py).",
        ),
        journal_replayed=r.counter(
            "areal_journal_replayed_total",
            "Journaled trajectories replayed into the batch queue on "
            "recovery (still inside the staleness bound — rollout work "
            "saved instead of re-generated).",
        ),
        journal_dropped_stale=r.counter(
            "areal_journal_dropped_stale_total",
            "Journaled trajectories dropped at replay: over-stale for the "
            "restored policy version, or already consumed by a training "
            "step the recover checkpoint covers.",
        ),
    )


def trainer_metrics(reg: Registry | None = None) -> SimpleNamespace:
    """PPOTrainer: step cadence + policy version."""
    r = reg or get_registry()
    return SimpleNamespace(
        step_seconds=r.histogram(
            "areal_train_step_seconds",
            "Wall-clock seconds per global training step.",
            buckets=(1.0, 5.0, 15.0, 30.0, 60.0, 120.0, 300.0, 600.0, 1800.0),
        ),
        version=r.gauge(
            "areal_train_version", "Current policy version (global step + 1)."
        ),
        update_seconds=r.histogram(
            "areal_train_update_weights_seconds",
            "Trainer-side update_weights duration per step.",
        ),
    )


def train_obs_metrics(reg: Registry | None = None) -> SimpleNamespace:
    """Trainer goodput observatory (observability/step_timeline.py):
    step-phase attribution, utilization and the device-memory ledger. The
    phase histogram labels by the step phase taxonomy (rollout_wait |
    host_prep | forward_backward | optimizer | weight_publish | ckpt_eval |
    other)."""
    r = reg or get_registry()
    return SimpleNamespace(
        phase_seconds=r.histogram(
            "areal_train_phase_seconds",
            "Wall-clock seconds per training-step phase (rollout_wait is "
            "the async bubble: blocking in prepare_batch). Named phases + "
            "the explicit `other` residual sum exactly to the step wall "
            "time (areal_train_step_seconds).",
            label_names=("phase",),
            buckets=(0.001, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0),
        ),
        bubble_fraction=r.gauge(
            "areal_train_bubble_fraction",
            "rollout_wait / step wall time of the last completed step — "
            "the trainer bubble fully-async RL is supposed to remove.",
        ),
        mfu=r.gauge(
            "areal_train_mfu",
            "Model FLOPs utilization over the last step's compute window "
            "(forward_backward + optimizer phases) vs the chip peak spec "
            "(TelemetryConfig.chip_peak_tflops overrides unknown chips).",
        ),
        tokens_per_chip=r.gauge(
            "areal_train_tokens_per_sec_per_chip",
            "Trained tokens per second per chip over the last full step "
            "(end-to-end goodput; the bubble fraction explains gaps vs "
            "the compute-window MFU).",
        ),
        hbm_bytes=r.gauge(
            "areal_hbm_bytes",
            "Itemized device-memory ledger by component (params, "
            "opt_state, kv_page_pool, radix_cache, staged_update, "
            "in_use, limit); device memory_stats where available, "
            "analytic byte sums on CPU.",
            label_names=("component",),
        ),
        hbm_headroom=r.gauge(
            "areal_hbm_headroom_fraction",
            "Free fraction of device memory (1 - in_use/limit) — the "
            "OOM-headroom number to alert on.",
        ),
    )
