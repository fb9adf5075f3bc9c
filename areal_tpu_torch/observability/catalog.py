"""The metric families the port registers, copied from
``areal_tpu/observability/catalog.py`` with the same names, labels, help
texts and buckets: ``staleness_metrics``, ``executor_metrics``, the serving
engine's ``engine_metrics``, ``kernel_metrics``, ``prefix_cache_metrics``,
``lifecycle_metrics`` and ``speculative_metrics``, the request timelines'
``timeline_metrics`` and the flight recorder's ``flight_metrics``, the
server's ``server_metrics``, ``client_metrics``, ``robustness_metrics``,
``preemption_metrics``, ``autopilot_metrics``, and the trainer loop's
``trainer_metrics``, ``train_obs_metrics`` (without the XLA compile
counters, which have no PyTorch counterpart) and
``learning_health_metrics``. The other families wait for the modules that
register them (ROADMAP Queue A items 7 and 8).
``register_all`` instantiates them in the JAX catalog's order.

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


def engine_metrics(reg: Registry | None = None) -> SimpleNamespace:
    """DecodeEngine: decode-loop throughput counters."""
    r = reg or get_registry()
    return SimpleNamespace(
        generated_tokens=r.counter(
            "areal_decode_generated_tokens_total",
            "Tokens emitted by the decode loop.",
        ),
        completed=r.counter(
            "areal_decode_completed_total",
            "Generation requests finished (stop/length).",
        ),
        aborted=r.counter(
            "areal_decode_aborted_total",
            "Generation requests aborted (weight-update pause/preemption).",
        ),
        prefills=r.counter(
            "areal_decode_prefills_total", "Sequences prefilled."
        ),
        prefill_tokens=r.counter(
            "areal_decode_prefill_tokens_total",
            "Prompt tokens actually prefilled (radix-cached prefix tokens "
            "excluded — the denominator's complement for prefix hit rate).",
        ),
        chunks=r.counter(
            "areal_decode_chunks_total", "Jitted decode chunks executed."
        ),
        batch_occupancy=r.gauge(
            "areal_decode_batch_occupancy",
            "Active decode slots (of ServerConfig.max_batch_size).",
        ),
    )


def prefix_cache_metrics(reg: Registry | None = None) -> SimpleNamespace:
    """Cross-request radix prefix cache over the paged KV pool
    (inference/paged_kv.py RadixPrefixCache): prompt-KV reuse visibility.
    Hit rate = hit_tokens / (hit_tokens + areal_decode_prefill_tokens_total)."""
    r = reg or get_registry()
    return SimpleNamespace(
        lookups=r.counter(
            "areal_prefix_cache_lookups_total",
            "Radix-cache prefix lookups at admission.",
        ),
        hit_tokens=r.counter(
            "areal_prefix_cache_hit_tokens_total",
            "Prompt tokens served from radix-cached KV pages instead of "
            "prefill (page refcount bumps, zero FLOPs).",
        ),
        inserted_pages=r.counter(
            "areal_prefix_cache_inserted_pages_total",
            "KV pages published into the radix tree at request "
            "completion/park time.",
        ),
        evicted_pages=r.counter(
            "areal_prefix_cache_evicted_pages_total",
            "Radix-cached pages released (LRU-leaf eviction under pool "
            "pressure, capacity eviction, or flush at a weight commit).",
        ),
        pages_held=r.gauge(
            "areal_prefix_cache_pages_held",
            "KV pages currently owned by the radix tree.",
        ),
    )


def lifecycle_metrics(reg: Registry | None = None) -> SimpleNamespace:
    """The request lifecycle (``inference/decode_engine.py``): deadlines,
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


def timeline_metrics(reg: Registry | None = None) -> SimpleNamespace:
    """Request timeline observatory (observability/timeline.py): per-stage
    latency attribution for every engine request. Completed timelines feed
    these histograms; the same breakdown is stamped per-request onto
    ``ModelResponse`` (queue_wait_s / prefill_s / decode_s / ...)."""
    r = reg or get_registry()
    return SimpleNamespace(
        queue_wait=r.histogram(
            "areal_request_queue_wait_seconds",
            "Submission-to-admission wait per request (engine queue + "
            "backlog + slot availability).",
            buckets=FAST_BUCKETS,
        ),
        prefill=r.histogram(
            "areal_request_prefill_seconds",
            "Prefill window per admitted request (suffix-only on a radix "
            "prefix hit; zero-prefill resumes are not observed).",
            buckets=FAST_BUCKETS,
        ),
        ttft=r.histogram(
            "areal_request_ttft_seconds",
            "Engine-side time to first token (queued -> first emitted "
            "token), by priority class (interactive | rollout).",
            label_names=("priority",),
            buckets=FAST_BUCKETS,
        ),
        tpot=r.histogram(
            "areal_request_tpot_seconds",
            "Time per output token after the first (first-token to "
            "terminal over tokens - 1); hold-fence stalls excluded.",
            buckets=(
                0.0001,
                0.00025,
                0.0005,
                0.001,
                0.0025,
                0.005,
                0.01,
                0.025,
                0.05,
                0.1,
                0.25,
                1.0,
            ),
        ),
        fence_stall=r.histogram(
            "areal_request_fence_stall_seconds",
            "Per-request decode stall under weight-commit hold fences "
            "(zero-pause protocol; docs/weight_sync.md).",
            buckets=FAST_BUCKETS,
        ),
        park=r.histogram(
            "areal_request_park_seconds",
            "Parked-KV wait resumed requests carried (abort pause -> "
            "resume round-trip; rid-affinity KV reuse).",
        ),
    )


def flight_metrics(reg: Registry | None = None) -> SimpleNamespace:
    """Fleet flight recorder (observability/timeline.py FlightRecorder):
    significant-event ring visibility."""
    r = reg or get_registry()
    return SimpleNamespace(
        events=r.counter(
            "areal_flight_events_total",
            "Events recorded into the process flight ring, by kind "
            "(admission_reject, evict_radix, evict_parked, preempt, "
            "weight_stage, weight_commit, circuit_open, watchdog, wedge, "
            "quarantine, gateway_shed, ...).",
            label_names=("kind",),
        ),
        dumps=r.counter(
            "areal_flight_dumps_total",
            "Flight-ring dumps persisted to disk (wedge escalation, "
            "SIGTERM, or manual /debug tooling).",
        ),
    )


def server_metrics(reg: Registry | None = None) -> SimpleNamespace:
    """Inference HTTP server: per-request latency + pause/update windows."""
    r = reg or get_registry()
    return SimpleNamespace(
        requests=r.counter(
            "areal_server_requests_total",
            "HTTP requests served, by endpoint.",
            label_names=("endpoint",),
        ),
        ttft=r.histogram(
            "areal_server_ttft_seconds",
            "Per-request time to first token.",
            buckets=FAST_BUCKETS,
        ),
        request_latency=r.histogram(
            "areal_server_generate_seconds",
            "Per-request end-to-end /generate latency.",
        ),
        paused=r.gauge(
            "areal_server_paused",
            "1 while generation is paused for a weight update, else 0.",
        ),
        pauses=r.counter(
            "areal_server_pause_total", "pause_generation calls."
        ),
        resumes=r.counter(
            "areal_server_resume_total", "continue_generation calls."
        ),
        queue_depth=r.gauge(
            "areal_server_queue_depth",
            "Engine submission queue + admission backlog depth.",
        ),
        update_bucket_bytes=r.counter(
            "areal_weight_update_bucket_bytes_total",
            "Streamed weight-bucket bytes received (server side).",
        ),
        update_stage_seconds=r.histogram(
            "areal_weight_update_stage_seconds",
            "Server-side begin->commit latency of a staged weight update.",
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


def learning_health_metrics(reg: Registry | None = None) -> SimpleNamespace:
    """The learning-health observatory: decoupled-PPO loss diagnostics
    conditioned on per-token version lag, computed by ``grpo_loss_fn`` on
    the device and exported once per ``ppo_update``, and the trajectory
    lineage ring's counters. The ``lag_bucket`` label values are the
    staleness manager's taxonomy (``0 | 1 | 2 | 4+``); gauges carry the
    last step's view, the ``*_total`` counters a windowable one."""
    r = reg or get_registry()
    return SimpleNamespace(
        clip_ratio=r.gauge(
            "areal_train_lag_clip_ratio",
            "Fraction of the bucket's valid tokens whose PPO ratio was "
            "clipped in the last update (1.0 = the bucket contributes no "
            "gradient), by version-lag bucket.",
            label_names=("lag_bucket",),
        ),
        behave_kl=r.gauge(
            "areal_train_lag_behave_kl",
            "Mean behave approx-KL (|log pi_prox - log pi_behave|) of the "
            "bucket's uncapped tokens in the last update — how far the "
            "policy moved since the tokens were generated, by lag bucket.",
            label_names=("lag_bucket",),
        ),
        approx_kl=r.gauge(
            "areal_train_lag_approx_kl",
            "Mean approx-KL (log pi_theta - log pi_prox) of the bucket's "
            "valid tokens in the last update, by lag bucket.",
            label_names=("lag_bucket",),
        ),
        imp_weight=r.gauge(
            "areal_train_lag_behave_imp_weight",
            "Mean behave importance weight of the bucket's uncapped "
            "tokens in the last update, by lag bucket.",
            label_names=("lag_bucket",),
        ),
        cap_hit=r.gauge(
            "areal_train_lag_cap_hit_share",
            "Fraction of the bucket's valid tokens whose behave "
            "importance weight hit behav_imp_weight_cap (dead weight: "
            "masked out of the loss), by lag bucket.",
            label_names=("lag_bucket",),
        ),
        token_share=r.gauge(
            "areal_train_lag_token_share",
            "The bucket's share of the last update's valid tokens, by lag "
            "bucket (shares sum to 1 when version tags are present).",
            label_names=("lag_bucket",),
        ),
        tokens_total=r.counter(
            "areal_train_lag_tokens_total",
            "Valid loss tokens trained, by version-lag bucket (the "
            "windowable denominator for the autopilot's learning-health "
            "guard).",
            label_names=("lag_bucket",),
        ),
        clipped_total=r.counter(
            "areal_train_lag_clipped_total",
            "Clipped loss tokens trained, by version-lag bucket.",
            label_names=("lag_bucket",),
        ),
        capped_total=r.counter(
            "areal_train_lag_capped_total",
            "Loss tokens masked out at behav_imp_weight_cap, by version-lag "
            "bucket (the cap-hit tail as a windowable counter).",
            label_names=("lag_bucket",),
        ),
        behave_kl_sum=r.counter(
            "areal_train_lag_behave_kl_sum_total",
            "Sum of behave approx-KL over trained tokens, by lag bucket "
            "(divide a window's delta by the tokens_total delta for the "
            "windowed mean the guard acts on).",
            label_names=("lag_bucket",),
        ),
        lineage_records=r.counter(
            "areal_lineage_records_total",
            "Trajectory lineage records registered (one per accepted "
            "train trajectory; observability/lineage.py ring).",
        ),
        lineage_joined=r.counter(
            "areal_lineage_joined_total",
            "Lineage records joined to training-step loss stats (the "
            "generate->journal->consume->update chain closed for that "
            "trace id).",
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
    """Preemption tolerance, checkpoint saves and the trajectory journal:
    graceful-drain visibility across trainer and serving roles."""
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


def autopilot_metrics(reg: Registry | None = None) -> SimpleNamespace:
    """Goodput autopilot (areal_tpu/autopilot/): the adaptive control
    plane's decision audit. Every setpoint change also lands in the
    flight ring as ``kind=autopilot_decision`` with the signal values
    that drove it (docs/autopilot.md)."""
    r = reg or get_registry()
    return SimpleNamespace(
        decisions=r.counter(
            "areal_autopilot_decisions_total",
            "Autopilot setpoint changes applied, by controller "
            "(staleness | admission | cache | fleet) and reason "
            "(trainer_starved | queue_wait_high | shed_under_capacity | "
            "hbm_pressure | sustained_idle | sustained_backlog | ...).",
            label_names=("controller", "reason"),
        ),
        setpoint=r.gauge(
            "areal_autopilot_setpoint",
            "Current autopilot-managed setpoint value, by knob "
            "(max_staleness | max_queue_depth | min_free_pages | "
            "gateway_interactive_headroom | radix_max_fraction | "
            "target_replicas).",
            label_names=("knob",),
        ),
        last_action_age=r.gauge(
            "areal_autopilot_last_action_age_seconds",
            "Seconds since each controller last changed a setpoint "
            "(refreshed every control round; -1 until a controller has "
            "acted).",
            label_names=("controller",),
        ),
        signal_holds=r.counter(
            "areal_autopilot_signal_hold_total",
            "Control rounds a controller held position because a required "
            "signal was absent or older than autopilot.signal_ttl_s (the "
            "stale-signal degradation mirroring the router's round-robin "
            "fallback).",
            label_names=("controller",),
        ),
        guard_vetoes=r.counter(
            "areal_autopilot_guard_veto_total",
            "Setpoint changes vetoed by a learning-health guard (the "
            "staleness controller declining to raise the bound while the "
            "high-lag bucket's tokens are clipped dead weight), by "
            "controller. Audited as kind=autopilot_guard_veto flight "
            "events.",
            label_names=("controller",),
        ),
        apply_failures=r.counter(
            "areal_autopilot_apply_failures_total",
            "Actuations that failed to apply (replica knob POST errored, "
            "drain/undrain failed); the controller's setpoint stands and "
            "the next round re-applies.",
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


def kernel_metrics(reg: Registry | None = None) -> SimpleNamespace:
    """Kernel observatory (observability/kernel_probe.py): per-decode-step
    phase attribution + roofline join (docs/perf.md "Kernel observatory")."""
    r = reg or get_registry()
    return SimpleNamespace(
        phase_seconds=r.histogram(
            "areal_decode_phase_seconds",
            "Per-decode-step host wall seconds by loop phase (admission, "
            "radix_match, prefill, draft, dispatch, device_wait, verify, "
            "bookkeeping, other); named phases + other sum exactly to the "
            "step wall.",
            label_names=("phase",),
            buckets=FAST_BUCKETS,
        ),
        step_flops=r.gauge(
            "areal_decode_step_flops",
            "Model FLOPs of the last drained decode chunk, from the "
            "compiled executable's cost_analysis or the analytic fallback.",
        ),
        roofline_fraction=r.gauge(
            "areal_decode_roofline_fraction",
            "Achieved over attainable FLOP/s of the last completed decode "
            "step: attainable = min(peak FLOPs, intensity x peak HBM bw).",
        ),
    )


def speculative_metrics(reg: Registry | None = None) -> SimpleNamespace:
    """Speculative decoding (docs/serving.md "Speculative decoding"):
    draft/verify/accept accounting. Acceptance rate =
    accepted_tokens / draft_tokens; each verify round also emits one base
    token that is never at risk, so round throughput is
    (accepted_length + 1) tokens per forward."""
    r = reg or get_registry()
    return SimpleNamespace(
        rounds=r.counter(
            "areal_spec_rounds_total",
            "Speculative draft+verify rounds executed by the decode loop.",
        ),
        draft_tokens=r.counter(
            "areal_spec_draft_tokens_total",
            "Draft tree tokens proposed to the verify forward, by drafter "
            "source (prompt n-gram lookup vs radix prefix tree).",
            label_names=("source",),
        ),
        accepted_tokens=r.counter(
            "areal_spec_accepted_tokens_total",
            "Draft tokens accepted by the target sampler (tokens emitted "
            "beyond each round's base token).",
        ),
        accepted_length=r.histogram(
            "areal_spec_accepted_length",
            "Accepted draft length per slot-round (0 = all drafts "
            "rejected; the base token still emits).",
            buckets=LAG_BUCKETS,
        ),
        rollback_pages=r.counter(
            "areal_spec_rollback_pages_total",
            "KV pages rolled back through the refcounted pool after "
            "partial acceptance (speculative over-allocation freed; "
            "rejected-draft KV itself never lands — it routes to the "
            "trash page).",
        ),
    )


# register_all's order in the JAX catalog, over the families ported so far
ALL_FACTORIES = (
    staleness_metrics,
    executor_metrics,
    engine_metrics,
    kernel_metrics,
    prefix_cache_metrics,
    lifecycle_metrics,
    timeline_metrics,
    flight_metrics,
    server_metrics,
    client_metrics,
    trainer_metrics,
    train_obs_metrics,
    learning_health_metrics,
    robustness_metrics,
    preemption_metrics,
    autopilot_metrics,
    speculative_metrics,
)


def register_all(reg: Registry | None = None) -> Registry:
    """Instantiate every catalogued family."""
    r = reg or get_registry()
    for factory in ALL_FACTORIES:
        factory(r)
    return r
