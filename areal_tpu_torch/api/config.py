"""Configuration: the fields of ``areal_tpu/api/config.py`` that the
port's slices read, with the same names and defaults (one exception is
marked below). No YAML loader: configs are built in code.

- Serving: ``ServerConfig`` (and ``MeshConfig``, ``PrefixCacheConfig`` and
  ``SpeculativeConfig``). The weights' dtype is the model config's
  (``models/qwen.py:ModelConfig.dtype``).
- Training: ``NormConfig``, ``OptimizerConfig``, ``TrainEngineConfig`` and
  ``PPOActorConfig``.

Knobs whose code paths have not been ported yet stay here so configs keep
their shape; ``DecodeEngine._check_supported`` and
``TorchTrainEngine._check_supported`` raise ``NotImplementedError`` (naming
ROADMAP.md) when one is switched on.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from areal_tpu_torch.utils.data import MicroBatchSpec


@dataclass
class MeshConfig:
    """Device-mesh axis sizes (``areal_tpu/api/config.py`` ``MeshConfig``).
    The port runs on one device; any axis above 1 is refused."""

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
class ServerConfig:
    """Inference server + decode engine settings."""

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
    path: str = ""  # HF model path (loading a checkpoint: not ported)
    dtype: str = "bfloat16"  # compute dtype of the forward and backward
    param_dtype: str = "float32"  # master weights and optimizer state
    # "pallas": the hand-written flash-attention kernels (their plain
    # versions on a CPU tensor); "xla": the plain masked softmax attention
    attn_impl: str = "pallas"
    gradient_checkpointing: bool = True
    # under gradient_checkpointing: "nothing" recomputes each layer in the
    # backward (torch.utils.checkpoint per layer); "everything" saves all
    remat_policy: str = "nothing"
    mb_spec: MicroBatchSpec = field(default_factory=MicroBatchSpec)
    bucket_step: int = 512  # grid width granularity (tokens)
    logprob_chunk_size: int = 1024  # tokens per vocab-logit chunk
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    lora_rank: int = 0  # 0 = full fine-tuning (LoRA: not ported)
    # only "mem" is ported, so it is the default here (the JAX package's
    # default is "disk", which writes a checkpoint: not ported)
    weight_update_mode: str = "mem"  # disk|mem
    # tree training: merge shared-prefix sequences (GRPO groups) into tries
    # and run forward and backward once per unique node through the tree
    # kernels (ops/tree_attention.py); the loss still sees per-sequence
    # edge-gathered logprobs
    tree_training: bool = False
    tree_node_budget: int = 2048  # max trie nodes per microbatch forward
    tree_node_bucket: int = 512  # node-axis bucketing
    train_vision_tower: bool = False  # not ported


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
