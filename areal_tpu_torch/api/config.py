"""Configuration: the fields of ``areal_tpu/api/config.py`` that the
port's slices read, with the same names and defaults (one exception is
marked below). No YAML loader: configs are built in code.

- Serving: ``ServerConfig`` (and ``MeshConfig``, ``PrefixCacheConfig``,
  ``SpeculativeConfig``, ``RequestLifecycleConfig`` and
  ``PreemptionConfig``). Weights given in code keep their model config's
  dtype (``models/qwen.py:ModelConfig.dtype``); weights loaded from
  ``model_path`` take ``ServerConfig.dtype``.
- Training: ``NormConfig``, ``OptimizerConfig``, ``TrainEngineConfig``,
  ``PPOActorConfig`` and ``PPOCriticConfig``.
- The rollout client: ``InferenceEngineConfig`` and its fleet and lifecycle
  sub-configs (``RoutingConfig``, ``FaultToleranceConfig``, ...), which
  ``InferenceEngineConfig.check_supported`` holds at their defaults where
  the one-server path does not read them.
- The trainer loop: ``PPOConfig`` over ``BaseExperimentConfig`` and the
  sub-configs they hold (datasets, saver / evaluator / recover, the stats
  logger, cluster, scheduler, launcher, tracers, telemetry, preemption).
  ``PPOConfig`` keeps the JAX package's defaults, ``weight_update_mode=
  "disk"`` and ``preemption.enabled=True`` among them. ``SFTConfig`` and
  ``RWConfig`` hold one ``TrainEngineConfig`` (``trainer/sft_trainer.py``).

Knobs whose code paths have not been ported yet stay here so configs keep
their shape; ``DecodeEngine._check_supported`` and
``TorchTrainEngine._check_supported`` raise ``NotImplementedError`` (naming
ROADMAP.md) when one is switched on.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

from areal_tpu_torch.api.io_struct import GenerationHyperparameters
from areal_tpu_torch.utils.data import MicroBatchSpec


@dataclass
class MeshConfig:
    """Device-mesh axis sizes (``areal_tpu/api/config.py`` ``MeshConfig``,
    the axes of ``parallel/mesh.py``). The train engine lays a
    ``torch.distributed`` world out by them: ``data`` replicates, ``fsdp``
    shards (FSDP2) and ``model`` is tensor parallelism; the one axis at -1
    absorbs the world (by default ``data``, so a world of N is N replicas).
    ``seq``, ``expert`` and ``pipe`` above 1 are refused (ROADMAP Queue A
    item 6b), and so is any axis above 1 for the decode engine (serving on
    a mesh is 6b too)."""

    data: int = -1
    fsdp: int = 1
    seq: int = 1
    model: int = 1
    expert: int = 1
    pipe: int = 1


@dataclass
class PrefixCacheConfig:
    """Cross-request radix prefix cache over the paged KV pool
    (``inference/paged_kv.py RadixPrefixCache``): finished requests publish
    their full pages; an admission aliases the longest cached page-aligned
    prefix and prefills only the suffix."""

    enabled: bool = True
    # hard cap on tree-held pages; None derives it from max_fraction
    max_pages: int | None = None
    # cap as a share of the page pool when max_pages is None
    max_fraction: float = 0.5
    # at a weight commit: "flush" drops the tree (its KV is stale under the
    # new policy); "keep" retains it (the staleness ablation)
    across_updates: str = "flush"

    def __post_init__(self):
        if self.across_updates not in ("flush", "keep"):
            raise ValueError(
                f"prefix_cache.across_updates must be 'flush' or 'keep', got {self.across_updates!r}"
            )


@dataclass
class SpeculativeConfig:
    """Speculative decoding on the paged engine: a host drafter proposes up
    to ``spec_depth`` tokens per slot, one verify forward scores them all,
    and the engine keeps the longest prefix its own sampler agrees with."""

    enabled: bool = False
    drafter: str = "ngram"  # "ngram" chains | "tree" (tree_width chains merged)
    spec_depth: int = 4  # draft tokens per chain per round
    tree_width: int = 2  # tree drafter: chains merged into the tree
    max_ngram: int = 4  # longest n-gram the prompt lookup tries
    use_radix: bool = True  # also draft from the radix prefix cache

    def __post_init__(self):
        if self.drafter not in ("ngram", "tree"):
            raise ValueError(f"speculative.drafter must be 'ngram' or 'tree', got {self.drafter!r}")
        if self.spec_depth < 1:
            raise ValueError("speculative.spec_depth must be >= 1")
        if self.tree_width < 1:
            raise ValueError("speculative.tree_width must be >= 1")
        if self.max_ngram < 1:
            raise ValueError("speculative.max_ngram must be >= 1")

    def max_nodes(self) -> int:
        """Verify width B: tree nodes per slot including the pending token."""
        width = self.tree_width if self.drafter == "tree" else 1
        return 1 + self.spec_depth * width


@dataclass
class RequestLifecycleConfig:
    """Overload-safe serving: request deadlines, cancellation, admission
    control and progress watchdogs (``areal_tpu/api/config.py:228``).

    One dataclass serves both sides of the wire. Client side
    (``InferenceEngineConfig.lifecycle``): ``default_deadline_s`` stamps a
    deadline on every generation request that carries none, sent as the
    ``x-areal-deadline`` header (absolute unix-epoch seconds), and a 429
    waits out its Retry-After within ``backpressure_wait_s``. Server side
    (``ServerConfig.lifecycle``): admission control answers 429 +
    Retry-After when the queue or the page pool is saturated, the decode
    loop reaps deadline-expired slots between chunks (partial output with
    ``truncated_by="deadline"``), and a per-slot watchdog aborts slots that
    stop emitting tokens. The gateway fields wait for ROADMAP Queue A item
    8 (``openai/``)."""

    enabled: bool = True
    # client side: deadline stamped on requests that carry none (seconds
    # from submission; None = only explicit per-request deadlines apply)
    default_deadline_s: float | None = None
    # admission control: reject /generate with 429 when the engine queue +
    # backlog reaches this depth. 0 = unbounded (off).
    max_queue_depth: int = 0
    # free-page headroom gate: reject when free pool pages plus
    # radix-reclaimable pages fall below this. 0 = off.
    min_free_pages: int = 0
    # Retry-After seconds returned with 429 rejections
    retry_after_s: float = 1.0
    # bounded multiplicative jitter on the emitted hint and the client's
    # backpressure wait: each is scattered into [x, x*(1+jitter)]
    retry_after_jitter: float = 0.5
    # client side: wall-clock seconds a request keeps honoring 429
    # Retry-After hints before giving up; the waits spend no failure-retry
    # attempt. 0 = fail on the first 429.
    backpressure_wait_s: float = 30.0
    # per-slot progress watchdog: an active slot that emits no token for
    # this long is aborted. 0 = off.
    watchdog_s: float = 0.0
    # wedge escalation: when the decode loop makes no pass for this long
    # while work is pending, /health answers 503 "wedged". 0 = off.
    engine_stall_escalate_s: float = 0.0
    gateway_max_inflight: int = 0
    gateway_interactive_headroom: int = 0


@dataclass
class PreemptionConfig:
    """Preemption-tolerant lifecycle: SIGTERM (or SIGUSR1) makes the
    trainer stop at the next step boundary, dump the last completed step
    synchronously and leave ``train`` (``robustness/preemption.py``). The
    server reads ``drain_budget_s`` as the default budget of ``POST
    /drain``."""

    enabled: bool = True
    grace_s: float = 25.0
    drain_budget_s: float = 10.0
    exit_code: int = 0
    handle_sigusr1: bool = True


@dataclass
class ServerConfig:
    """Inference server + decode engine settings."""

    # the HF checkpoint a server loads when it is given no weights, and the
    # dtype it serves them at (weights given in code keep their model
    # config's dtype)
    model_path: str = ""
    dtype: str = "bfloat16"
    max_batch_size: int = 32
    max_seq_len: int = 32768
    page_size: int = 128  # KV page granularity (paged attention)
    # KV page-pool budget in GiB. None = dense-equivalent pool
    # (max_batch_size x max_seq_len tokens)
    kv_hbm_gb: float | None = None
    # attention-window bucket granularity (rows): the decode chunk passes
    # ceil(window / page_size) page-table columns to the attention
    attn_window_step: int = 512
    decode_steps_per_call: int = 16  # tokens decoded per chunk
    mesh: MeshConfig = field(default_factory=MeshConfig)
    port: int = 0  # 0 = pick a free port
    host: str = "0.0.0.0"
    enable_prefix_caching: bool = True
    prefix_cache: PrefixCacheConfig = field(default_factory=PrefixCacheConfig)
    speculative: SpeculativeConfig = field(default_factory=SpeculativeConfig)
    enable_frequency_penalty: bool = False
    # sampling RNG seed; None seeds from the clock
    seed: int | None = None
    # serving weight quantization: "none" | "int8"
    quantization: str = "none"
    # KV-cache quantization: "none" | "int8" | "fp8" (per-token-vector
    # scales, inference/paged_kv.py)
    kv_quantization: str = "none"
    # the hold fence's safety net: a hold whose /continue_generation got
    # lost self-releases after this many seconds (<= 0: never)
    hold_fence_timeout_s: float = 30.0
    # keep aborted requests' KV parked in their slots across weight updates
    # so the client's abort -> resubmit loop resumes with zero re-prefill.
    # The retained KV was computed under the previous policy, the staleness
    # decoupled PPO already corrects through per-token versions. False
    # recomputes the KV under the new weights on every resume.
    kv_reuse_across_updates: bool = True
    # request lifecycle: admission control, deadline reaping between decode
    # chunks, the per-slot watchdog and the wedge detector
    lifecycle: RequestLifecycleConfig = field(default_factory=RequestLifecycleConfig)
    # the drain (POST /drain): admission stops (429), in-flight decodes
    # finish or park within preemption.drain_budget_s
    preemption: PreemptionConfig = field(default_factory=PreemptionConfig)
    # shared secret POST /autopilot/knobs must carry in the
    # x-areal-autopilot-token header. Empty = unauthenticated.
    autopilot_token: str = ""
    # where streamed weight-update buckets stage while generation runs:
    # "device" copies each bucket to the card on arrival (a second copy of
    # the weights until the commit), "host" keeps them in pinned host memory
    # and does the one host-to-device copy inside the commit fence
    weight_stage_target: str = "device"


@dataclass
class NormConfig:
    """Advantage / reward normalization."""

    mean_level: str = "batch"  # none|batch|group
    std_level: str = "batch"
    # consecutive rows per group; 1 (the default) makes PPOActor fall back
    # to PPOActorConfig.group_size only when set to 0
    group_size: int = 1
    mean_leave1out: bool = False  # RLOO leave-one-out baseline
    std_unbiased: bool = False  # Bessel (n-1) correction on the std


@dataclass
class OptimizerConfig:
    """AdamW after clipping by the global norm, with a warmup-then-main LR
    schedule (``engine/train_engine.py:make_lr_schedule``)."""

    type: str = "adamw"
    lr: float = 2e-5
    weight_decay: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    lr_scheduler_type: str = "constant"  # constant|linear|cosine
    warmup_steps_proportion: float = 0.001
    min_lr_ratio: float = 0.0
    gradient_clipping: float = 1.0


@dataclass
class TrainEngineConfig:
    path: str = ""  # HF model path (config.json + safetensors)
    init_from_scratch: bool = False  # random weights even when path is set
    dtype: str = "bfloat16"  # compute dtype of the forward and backward
    param_dtype: str = "float32"  # master weights and optimizer state
    # "pallas": the hand-written flash-attention kernels (their plain
    # versions on a CPU tensor); "xla": the plain masked softmax attention
    attn_impl: str = "pallas"
    gradient_checkpointing: bool = True
    # under gradient_checkpointing: "nothing" recomputes each layer in the
    # backward (torch.utils.checkpoint per layer); "dots_nobatch" saves the
    # layer's projections and recomputes the rest; "everything" saves all
    remat_policy: str = "nothing"
    mb_spec: MicroBatchSpec = field(default_factory=MicroBatchSpec)
    bucket_step: int = 512  # grid width granularity (tokens)
    logprob_chunk_size: int = 1024  # tokens per vocab-logit chunk
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # LoRA: rank-r adapters on ``lora_targets`` over a frozen base; 0 =
    # full fine-tuning. Only the adapters (and a value head) train
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: list[str] = field(default_factory=lambda: ["wq", "wk", "wv", "wo"])
    # "mem" streams bf16 buckets over HTTP, "disk" exports HF safetensors
    # that the servers reload. The JAX package defaults to "disk"; the port
    # keeps "mem", the default its earlier slices were built and measured on
    weight_update_mode: str = "mem"  # disk|mem
    # tree training: merge shared-prefix sequences (GRPO groups) into tries
    # and run forward and backward once per unique node through the tree
    # kernels (ops/tree_attention.py); the loss still sees per-sequence
    # edge-gathered logprobs
    tree_training: bool = False
    tree_node_budget: int = 2048  # max trie nodes per microbatch forward
    tree_node_bucket: int = 512  # node-axis bucketing
    # a VLM: train the vision tower with the LM. False (the default) keeps
    # it frozen, its embeddings computed once per batch outside the loss;
    # True runs it inside the forward / backward, so its gradients flow
    train_vision_tower: bool = False


@dataclass
class PPOActorConfig(TrainEngineConfig):
    """PPO-family algorithm switches (``trainer/ppo.py`` dispatches on them)."""

    group_size: int = 1
    ppo_n_minibatches: int = 4
    # clipping
    eps_clip: float = 0.2
    eps_clip_higher: float | None = None  # DAPO asymmetric upper clip
    c_clip: float | None = None  # dual-clip PPO
    # rewards / advantages
    reward_scaling: float = 1.0
    reward_bias: float = 0.0
    reward_clip: float = 20.0
    group_reward_norm: bool = False
    adv_norm: NormConfig | None = field(default_factory=NormConfig)
    gamma: float = 1.0
    lam: float = 1.0
    # KL regularization
    kl_ctl: float = 0.0
    kl_estimator: str = "k1"  # k1|k2|k3
    # overlong penalty (DAPO); max_response_length is the generation cap
    overlong_reward_penalty: bool = False
    overlong_tokens: int = 0
    overlong_penalty_factor: float = 0.0
    max_response_length: int = 0
    mask_too_long_tokens: bool = False
    mask_no_eos_with_zero: bool = False  # zero task reward for truncated seqs
    # decoupled PPO / staleness correction
    recompute_logprob: bool = True
    use_decoupled_loss: bool = True
    behav_imp_weight_cap: float | None = None
    # token|sequence x mask|truncate, or disabled
    behave_imp_weight_mode: str = "token_mask"
    prox_logp_mode: str = "recompute"  # recompute|loglinear|metrics
    imp_ratio_level: str = "token"  # token|sequence (GSPO)
    # SAPO soft gates
    use_sapo_loss: bool = False
    sapo_tau_pos: float = 1.0
    sapo_tau_neg: float = 1.05
    # M2PO second-moment masking
    use_m2po_loss: bool = False
    m2po_tau: float = 0.04
    # entropy & misc
    entropy_coeff: float = 0.0
    temperature: float = 1.0


@dataclass
class PPOCriticConfig(TrainEngineConfig):
    """A value model's settings: ``PPOTrainer`` builds the critic's engine
    from them with a value head (``trainer/ppo.py PPOCritic``)."""

    ppo_n_minibatches: int = 4
    eps_clip: float = 0.5
    mask_no_eos_with_zero: bool = False


# -- the rollout client -----------------------------------------------------


@dataclass
class OpenAIProxyConfig:
    """The agentic OpenAI-proxy layer (ROADMAP Queue A item 8)."""

    tool_call_parser: str = "qwen"
    chat_template_type: str = "hf"  # hf|concat
    engine_max_tokens: int = 0
    capacity: int = 128
    admin_api_key: str = ""  # empty = generate one at start_proxy time
    tier: "GatewayTierConfig" = field(default_factory=lambda: GatewayTierConfig())


@dataclass
class GatewayTierConfig:
    """The sharded gateway tier (ROADMAP Queue A item 8)."""

    enabled: bool = False
    n_shards: int = 1
    vnodes: int = 64
    namespace: str = "gateway_tier/default"
    membership_ttl_s: float = 5.0
    membership_poll_s: float = 1.0
    static_shards: list[str] = field(default_factory=list)
    route_adopt: bool = True


@dataclass
class ChaosConfig:
    """Seeded fault injection at the HTTP boundary (ROADMAP Queue A item 8)."""

    enabled: bool = False
    seed: int = 0
    drop_prob: float = 0.0
    delay_prob: float = 0.0
    delay_s: float = 0.05
    error_prob: float = 0.0
    hang_prob: float = 0.0
    hang_s: float = 2.0
    stall_prob: float = 0.0
    stall_s: float = 0.5
    preempt_prob: float = 0.0
    gateway_kill_prob: float = 0.0
    path_prefix: str = ""


@dataclass
class TrajectoryJournalConfig:
    """The durable trajectory journal (``infra/trajectory_journal.py``):
    off by default; ``dir`` defaults to ``{fileroot}/{experiment}/{trial}/journal``."""

    enabled: bool = False
    dir: str = ""
    segment_max_records: int = 64
    segment_max_bytes: int = 64 * 1024 * 1024
    fsync: bool = True


@dataclass
class FaultToleranceConfig:
    """Retrying transport, circuit breaking and failover, replica supervision,
    and the executor's task retry / quarantine. The one-server rollout path
    reads ``enabled``, the backoff fields and the two task fields; the rest
    wait for ROADMAP Queue A item 8."""

    enabled: bool = True
    backoff_base_s: float = 0.2
    backoff_max_s: float = 10.0
    backoff_jitter: float = 0.2
    retry_budget: float = 64.0
    retry_budget_refill: float = 0.5
    circuit_failure_threshold: int = 5
    circuit_recovery_s: float = 5.0
    failover: bool = True
    probe_interval_s: float = 5.0
    probe_timeout_s: float = 2.0
    probe_failures_to_evict: int = 3
    max_respawns: int = 3
    task_max_retries: int = 2
    task_quarantine_strikes: int = 3
    chaos: ChaosConfig = field(default_factory=ChaosConfig)


@dataclass
class RoutingConfig:
    """Cache-aware replica selection (ROADMAP Queue A item 8)."""

    poll_interval_s: float = 2.0
    snapshot_ttl_s: float = 15.0
    shadow_page_size: int = 128
    shadow_max_pages: int = 8192
    w_prefix: float = 2.0
    w_queue: float = 1.0
    w_pages: float = 0.5
    w_ttft: float = 0.25
    queue_norm: int = 16
    w_inflight: float = 1.0
    rush_slack_s: float = 2.0
    demote_penalty: float = 2.0
    demote_s: float = 5.0
    role_map: dict[str, str] = field(default_factory=dict)
    long_prompt_tokens: int = 1024
    affinity_ttl_s: float = 3600.0


@dataclass
class StalenessControllerConfig:
    """Autopilot: retunes ``max_head_offpolicyness`` from the trainer bubble."""

    enabled: bool = True
    min_staleness: int = 0
    max_staleness: int = 8
    grow_bubble_fraction: float = 0.25
    shrink_bubble_fraction: float = 0.05
    wide_span_p99: float = 1.0
    cooldown_s: float = 30.0
    learning_guard: bool = True
    guard_high_lag_kl: float = 0.5
    guard_high_lag_clip_fraction: float = 0.9
    guard_min_token_share: float = 0.01


@dataclass
class AdmissionControllerConfig:
    """Autopilot: AIMD on the engine's admission gates."""

    enabled: bool = True
    min_queue_depth: int = 4
    max_queue_depth: int = 256
    queue_depth_step: int = 4
    queue_depth_decrease: float = 0.5
    high_queue_wait_s: float = 5.0
    low_queue_wait_s: float = 1.0
    high_shed_rate_per_s: float = 1.0
    min_free_pages_floor: int = 0
    min_free_pages_ceiling: int = 256
    free_pages_step: int = 8
    high_reap_rate_per_s: float = 0.5
    min_headroom: int = 0
    max_headroom: int = 64
    headroom_step: int = 2
    narrow_after_quiet_rounds: int = 6
    cooldown_s: float = 10.0


@dataclass
class CacheControllerConfig:
    """Autopilot: grows or shrinks the radix cache's share of the pool."""

    enabled: bool = True
    min_fraction: float = 0.1
    max_fraction: float = 0.8
    fraction_step: float = 0.05
    high_hit_rate: float = 0.3
    low_hit_rate: float = 0.02
    high_headroom_fraction: float = 0.15
    low_headroom_fraction: float = 0.05
    cooldown_s: float = 20.0


@dataclass
class FleetControllerConfig:
    """Autopilot: drains or undrains replicas with the load."""

    enabled: bool = True
    min_replicas: int = 1
    max_replicas: int = 0
    drain_below_load: float = 0.3
    undrain_above_queue: float = 2.0
    sustain_rounds: int = 3
    undrain_sustain_rounds: int = 1
    cooldown_s: float = 30.0


@dataclass
class AutopilotConfig:
    """The goodput autopilot's controllers (ROADMAP Queue A item 8)."""

    enabled: bool = False
    interval_s: float = 5.0
    signal_ttl_s: float = 30.0
    token: str = ""
    metrics_addr: str = ""
    staleness: StalenessControllerConfig = field(
        default_factory=StalenessControllerConfig
    )
    admission: AdmissionControllerConfig = field(
        default_factory=AdmissionControllerConfig
    )
    cache: CacheControllerConfig = field(default_factory=CacheControllerConfig)
    fleet: FleetControllerConfig = field(default_factory=FleetControllerConfig)


@dataclass
class InferenceEngineConfig:
    """Client-side rollout controls, the staleness bound among them
    (``areal_tpu/api/config.py:700``). ``check_supported`` names the ROADMAP
    item each unported field waits for."""

    experiment_name: str = ""
    trial_name: str = ""
    max_concurrent_rollouts: int | None = None
    queue_size: int | None = None
    consumer_batch_size: int = 1
    max_head_offpolicyness: int = 0  # the staleness bound
    enable_rollout_tracing: bool = False
    check_trajectory_format: bool = True
    schedule_policy: str = "round_robin"
    routing_policy: str = "round_robin"
    routing: RoutingConfig = field(default_factory=RoutingConfig)
    request_timeout: float = 3600.0
    request_retries: int = 3
    pause_grace_period: float = 0.0
    setup_timeout: float = 120.0
    dump_trajectories: bool = False
    dump_dir: str | None = None
    # prepare_batch returns once the accepted trajectories hold this many
    # tokens instead of a fixed consumer_batch_size (None = fixed)
    dynamic_bs_max_tokens: int | None = None
    # the streamed weight update: bucket size, the relay (not ported) and
    # the commit fence (hold | abort | none)
    weight_chunk_mb: int = 128
    weight_update_relay: bool = False
    weight_commit_fence: str = "hold"
    openai: OpenAIProxyConfig | None = None
    tokenizer_path: str = ""  # chat templating for the proxy layer
    fault_tolerance: FaultToleranceConfig = field(
        default_factory=FaultToleranceConfig
    )
    lifecycle: RequestLifecycleConfig = field(
        default_factory=RequestLifecycleConfig
    )
    journal: TrajectoryJournalConfig = field(
        default_factory=TrajectoryJournalConfig
    )
    autopilot: AutopilotConfig = field(default_factory=AutopilotConfig)
    speculative: SpeculativeConfig = field(default_factory=SpeculativeConfig)

    def check_supported(self) -> None:
        """Raise ``NotImplementedError`` for a field set away from its
        default whose code path is a later slice of the port: the rollout
        path here is one server, no routing brain, no gateway and no
        autopilot."""
        if self.routing_policy != "round_robin" or self.schedule_policy != "round_robin":
            raise NotImplementedError(
                f"routing_policy={self.routing_policy!r} / schedule_policy={self.schedule_policy!r}: "
                "ROADMAP Queue A item 8 (routing)"
            )
        if self.routing != RoutingConfig():
            raise NotImplementedError("routing: ROADMAP Queue A item 8 (routing)")
        ft = self.fault_tolerance
        ported = ("enabled", "backoff_base_s", "backoff_max_s", "backoff_jitter", "task_max_retries",
                  "task_quarantine_strikes")
        default = FaultToleranceConfig()
        changed = [
            f.name for f in fields(ft) if f.name not in ported and getattr(ft, f.name) != getattr(default, f.name)
        ]
        if changed:
            raise NotImplementedError(
                f"fault_tolerance.{changed[0]} (retry budget, circuit breakers, failover, fleet "
                "probe, chaos): ROADMAP Queue A item 8 (robustness)"
            )
        lc = self.lifecycle
        if (lc.gateway_max_inflight, lc.gateway_interactive_headroom) != (0, 0):
            raise NotImplementedError("lifecycle.gateway_* (gateway load shedding): ROADMAP Queue A item 8")
        if self.autopilot != AutopilotConfig():
            raise NotImplementedError("autopilot: ROADMAP Queue A item 8")
        if self.openai is not None:
            raise NotImplementedError("openai (agentic proxy layer): ROADMAP Queue A item 8")



# -- the trainer loop ---------------------------------------------------------


@dataclass
class SaverConfig:
    experiment_name: str = ""
    trial_name: str = ""
    fileroot: str = "/tmp/areal_tpu/experiments"
    freq_epochs: int | None = None
    freq_steps: int | None = None
    freq_secs: float | None = None


@dataclass
class EvaluatorConfig(SaverConfig):
    pass


@dataclass
class RecoverConfig(SaverConfig):
    mode: str = "disabled"  # disabled|off|on|auto
    retries: int = 3


@dataclass
class WandBConfig:
    mode: str = "disabled"
    project: str | None = None
    name: str | None = None
    group: str | None = None
    wandb_base_url: str = ""
    wandb_api_key: str = ""
    entity: str | None = None
    job_type: str | None = None
    notes: str | None = None
    tags: list[str] | None = None
    config: dict | None = None
    id_suffix: str = "train"


@dataclass
class TensorBoardConfig:
    path: str | None = None  # None = off, "" = the default log dir


@dataclass
class StatsLoggerConfig:
    experiment_name: str = ""
    trial_name: str = ""
    fileroot: str = "/tmp/areal_tpu/experiments"
    wandb: WandBConfig = field(default_factory=WandBConfig)
    tensorboard: TensorBoardConfig = field(default_factory=TensorBoardConfig)


@dataclass
class NameResolveConfig:
    type: str = "memory"  # memory|nfs|etcd3 (only "memory" is ported)
    nfs_record_root: str = "/tmp/areal_tpu/name_resolve"
    etcd3_addr: str = "localhost:2379"


@dataclass
class ClusterSpecConfig:
    name_resolve: NameResolveConfig = field(default_factory=NameResolveConfig)
    cluster_name: str = "local"
    fileroot: str = "/tmp/areal_tpu/experiments"
    n_nodes: int = 1
    n_accelerators_per_node: int = 8


@dataclass
class SchedulerConfig:
    type: str = "local"  # local|ray|slurm
    startup_timeout: float = 300.0


@dataclass
class LauncherConfig:
    n_servers: int = 1
    inference_server_cpus_per_gpu: int = 4
    inference_server_mem_per_gpu: int = 32768
    trainer_cpus_per_gpu: int = 4
    trainer_mem_per_gpu: int = 32768


@dataclass
class SessionTracerConfig:
    """Per-rollout-session tracing; when None on ``PerfTracerConfig`` it
    follows the perf tracer's ``enabled``."""

    enabled: bool = False
    flush_threshold: int = 256


@dataclass
class TelemetryConfig:
    enabled: bool = True
    scrape_interval_s: float = 5.0
    scrape_timeout_s: float = 2.0
    scrape_retries: int = 1
    export_port: int = 0
    dashboard_refresh_s: float = 2.0
    # the chip's peak bf16 TFLOPs and memory GB for the step timeline's
    # utilization; None = not reported (never guessed)
    chip_peak_tflops: float | None = None
    chip_hbm_gb: float | None = None


@dataclass
class PerfTracerConfig:
    enabled: bool = False
    output_dir: str | None = None
    save_freq_steps: int = 10
    max_events: int = 200_000
    # global steps that run under torch.profiler
    profile_steps: list[int] | None = None
    session_tracer: SessionTracerConfig | None = None


@dataclass
class DatasetConfig:
    path: str = ""
    type: str = ""
    batch_size: int = 1
    shuffle: bool = True
    max_length: int | None = None
    drop_last: bool = True


@dataclass
class BaseExperimentConfig:
    experiment_name: str = "test-exp"
    trial_name: str = "test-trial"
    cluster: ClusterSpecConfig = field(default_factory=ClusterSpecConfig)
    allocation_mode: str = ""
    seed: int = 1
    total_train_epochs: int = 1
    total_train_steps: int | None = None
    total_train_n_seqs: int | None = None
    tokenizer_path: str = ""
    weight_update_mode: str = "disk"
    # mem-mode stream encoding: "auto" = q8 for an int8-serving fleet, else
    # bf16 (q8 is not ported)
    weight_update_wire: str = "auto"
    train_dataset: DatasetConfig = field(default_factory=DatasetConfig)
    valid_dataset: DatasetConfig | None = None
    saver: SaverConfig = field(default_factory=SaverConfig)
    checkpointer: SaverConfig = field(default_factory=SaverConfig)
    evaluator: EvaluatorConfig = field(default_factory=EvaluatorConfig)
    recover: RecoverConfig = field(default_factory=RecoverConfig)
    stats_logger: StatsLoggerConfig = field(default_factory=StatsLoggerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    launcher: LauncherConfig = field(default_factory=LauncherConfig)
    perf_tracer: PerfTracerConfig = field(default_factory=PerfTracerConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    preemption: PreemptionConfig = field(default_factory=PreemptionConfig)


@dataclass
class SFTConfig(BaseExperimentConfig):
    model: TrainEngineConfig = field(default_factory=TrainEngineConfig)


@dataclass
class RWConfig(BaseExperimentConfig):
    model: TrainEngineConfig = field(default_factory=TrainEngineConfig)


@dataclass
class PPOConfig(BaseExperimentConfig):
    async_training: bool = True
    gconfig: GenerationHyperparameters = field(default_factory=GenerationHyperparameters)
    rollout: InferenceEngineConfig = field(default_factory=InferenceEngineConfig)
    server: ServerConfig = field(default_factory=ServerConfig)
    actor: PPOActorConfig = field(default_factory=PPOActorConfig)
    critic: PPOCriticConfig | None = None
    ref: TrainEngineConfig | None = None


@dataclass
class GRPOConfig(PPOConfig):
    pass
