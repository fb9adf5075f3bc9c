"""Request/response structs of the serving path and the trainer's
``FinetuneSpec`` / ``WeightUpdateMeta``, copied from
``areal_tpu/api/io_struct.py`` (plain lists on the host; tensors live only
inside the engines)."""

from __future__ import annotations

import dataclasses
import enum
import uuid
from typing import Any


@dataclasses.dataclass
class GenerationHyperparameters:
    """Sampling controls."""

    n_samples: int = 1
    max_new_tokens: int = 16384
    min_new_tokens: int = 0
    max_tokens: int | None = None  # total budget incl. prompt; None = unlimited
    greedy: bool = False
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1
    stop_token_ids: list[int] = dataclasses.field(default_factory=list)
    stop: list[str] = dataclasses.field(default_factory=list)
    frequency_penalty: float = 0.0
    # generate to the full token budget even when a stop token appears
    ignore_eos: bool = False
    skip_special_tokens: bool = True

    def new(self, **kwargs) -> "GenerationHyperparameters":
        return dataclasses.replace(self, **kwargs)


class StopReason(str, enum.Enum):
    STOP = "stop"  # EOS / stop token
    LENGTH = "length"  # max_new_tokens reached
    ABORT = "abort"  # interrupted (weight update in flight) — resumable
    TOOL_CALLS = "tool_calls"
    DEADLINE = "deadline"  # deadline expired; partial output returned
    CANCEL = "cancelled"  # client gone / task failed


@dataclasses.dataclass
class ModelRequest:
    """One generation request."""

    input_ids: list[int] = dataclasses.field(default_factory=list)
    gconfig: GenerationHyperparameters = dataclasses.field(
        default_factory=GenerationHyperparameters
    )
    rid: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex)
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)
    # vision inputs: pixel patches [P, patch_dim] and (t, h, w) grids
    image_data: list[Any] | None = None
    image_grid_thw: list[Any] | None = None
    deadline: float | None = None  # absolute unix-epoch seconds


# per-stage latency keys of the request-timeline breakdown
TIMING_FIELDS = (
    "queue_wait_s",
    "prefill_s",
    "decode_s",
    "fence_stall_s",
    "park_s",
)


@dataclasses.dataclass
class ModelResponse:
    """Generation result with per-token bookkeeping.

    ``output_versions[i]`` is the policy version that produced output token
    i — the input to decoupled-PPO staleness correction."""

    input_tokens: list[int] = dataclasses.field(default_factory=list)
    output_tokens: list[int] = dataclasses.field(default_factory=list)
    output_logprobs: list[float] = dataclasses.field(default_factory=list)
    output_versions: list[int] = dataclasses.field(default_factory=list)
    stop_reason: str = StopReason.STOP.value
    truncated_by: str = ""
    latency: float = 0.0
    ttft: float = 0.0
    queue_wait_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    fence_stall_s: float = 0.0
    park_s: float = 0.0
    rid: str = ""
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def input_len(self) -> int:
        return len(self.input_tokens)

    @property
    def output_len(self) -> int:
        return len(self.output_tokens)


@dataclasses.dataclass
class WeightUpdateMeta:
    """How trainer weights reach the decode engine. Only ``type="mem"`` is
    ported: the train engine hands its exported state dict to the connected
    ``DecodeEngine.update_weights_from_params`` in process. "disk" (write a
    checkpoint, servers reload it) raises ``NotImplementedError``; the
    default is "mem" for that reason (the JAX package defaults to "disk")."""

    type: str = "mem"
    path: str | None = None
    with_version: bool = True
    alloc_mode: Any | None = None
    chunked_mem_mb: int = 128
    lora_only: bool = False
    lora_scale: float = 0.0
    wire_format: str = "bf16"


@dataclasses.dataclass
class FinetuneSpec:
    total_train_epochs: int
    dataset_size: int
    train_batch_size: int

    @property
    def steps_per_epoch(self) -> int:
        return max(1, self.dataset_size // self.train_batch_size)

    @property
    def total_train_steps(self) -> int:
        return self.total_train_epochs * self.steps_per_epoch
