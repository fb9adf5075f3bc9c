"""Request/response structs of the serving path, copied from
``areal_tpu/api/io_struct.py`` (plain lists on the host; tensors live only
inside the engine)."""

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
