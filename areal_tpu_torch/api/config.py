"""Configuration: the fields of ``areal_tpu/api/config.py`` that the
port's slices read, with the same names and defaults (one exception is
marked below). No YAML loader: configs are built in code.

- Serving: ``ServerConfig`` (and ``MeshConfig`` and the prefix-cache and
  speculative sections). The weights' dtype is the model config's
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
    """Cross-request radix prefix cache (not ported yet)."""

    enabled: bool = True


@dataclass
class SpeculativeConfig:
    """Speculative decoding on the paged engine (not ported yet)."""

    enabled: bool = False


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
    tree_training: bool = False  # not ported
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
