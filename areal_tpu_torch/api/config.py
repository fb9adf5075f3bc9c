"""Serving configuration: the fields of ``areal_tpu/api/config.py``
``ServerConfig`` that the port's serving slice reads, with the same names
and defaults. No YAML loader: the config is built in code.

Knobs whose code paths have not been ported yet stay here so configs keep
their shape; ``DecodeEngine`` raises ``NotImplementedError`` when one is
switched on (see ``DecodeEngine._check_supported``). The weights' dtype is
the model config's (``models/qwen.py:ModelConfig.dtype``).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class MeshConfig:
    """Device-mesh axis sizes (``areal_tpu/api/config.py`` ``MeshConfig``).
    The port serves on one device; any axis above 1 is refused."""

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
