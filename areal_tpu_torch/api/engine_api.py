"""Engine contracts: ``TrainEngine`` and ``InferenceEngine``
(``areal_tpu/api/engine_api.py``). Data containers are host-side
``dict[str, np.ndarray]`` ("TensorDict"); loss functions follow the
packed-1D protocol ``loss_fn(model_outputs, packed_input) -> scalar``.

``engine/train_engine.py TorchTrainEngine`` is the port's ``TrainEngine``
(its ``save`` / ``load`` raise until ROADMAP Queue A item 3);
``inference/client.py RemoteTorchEngine`` is the port's ``InferenceEngine``."""

from __future__ import annotations

import abc
from typing import Any, Callable

from areal_tpu_torch.api.io_struct import (
    FinetuneSpec,
    ModelRequest,
    ModelResponse,
    WeightUpdateMeta,
)
from areal_tpu_torch.utils.data import TensorDict


class TrainEngine(abc.ABC):
    """A training backend bound to one model (actor / critic / ref)."""

    def initialize(self, ft_spec: FinetuneSpec | None = None, **kwargs) -> None:
        raise NotImplementedError

    def destroy(self) -> None:
        pass

    # -- versioning (staleness bookkeeping) -------------------------------
    @abc.abstractmethod
    def set_version(self, version: int) -> None: ...

    @abc.abstractmethod
    def get_version(self) -> int: ...

    # -- train / eval / forward on packed batches -------------------------
    @abc.abstractmethod
    def train_batch(
        self,
        input_: TensorDict,
        loss_fn: Callable,
        loss_weight_fn: Callable[[TensorDict], float],
    ) -> dict[str, float]:
        """Split into microbatches, accumulate grads, take one optimizer step."""

    @abc.abstractmethod
    def forward_batch(
        self,
        input_: TensorDict,
        output_key: str = "logprobs",
        post_hook: Callable | None = None,
    ) -> Any:
        """Forward only over microbatches, outputs in input order."""

    def eval_batch(
        self,
        input_: TensorDict,
        loss_fn: Callable,
        loss_weight_fn: Callable[[TensorDict], float],
    ) -> dict[str, float]:
        raise NotImplementedError

    # -- rollout plumbing (when connected to an inference engine) ----------
    def connect_engine(self, engine: "InferenceEngine", meta: WeightUpdateMeta | None = None) -> None:
        raise NotImplementedError

    def prepare_batch(self, *args, **kwargs) -> TensorDict:
        raise NotImplementedError

    def rollout_batch(self, *args, **kwargs) -> TensorDict:
        raise NotImplementedError

    # -- weights ----------------------------------------------------------
    @abc.abstractmethod
    def update_weights(self, meta: WeightUpdateMeta) -> None:
        """Push current weights to the connected inference engine."""

    @abc.abstractmethod
    def save(self, meta) -> None: ...

    @abc.abstractmethod
    def load(self, meta) -> None: ...

    def onload(self) -> None:
        pass

    def offload(self) -> None:
        pass

    def export_stats(self) -> dict[str, float]:
        return {}


class InferenceEngine(abc.ABC):
    """Client handle to a generation fleet."""

    def initialize(self, *args, **kwargs) -> None:
        raise NotImplementedError

    def destroy(self) -> None:
        pass

    # -- generation -------------------------------------------------------
    @abc.abstractmethod
    async def agenerate(self, req: ModelRequest) -> ModelResponse:
        """Generation that survives interruption: loops on the "abort" stop
        reason, accumulating tokens and per-token policy versions."""

    # -- rollout submission -----------------------------------------------
    @abc.abstractmethod
    def submit(self, data: dict, workflow=None, should_accept_fn=None) -> str: ...

    @abc.abstractmethod
    def wait(self, count: int, timeout: float | None = None) -> TensorDict: ...

    def wait_for_task(self, task_id: str, timeout: float | None = None):
        raise NotImplementedError

    @abc.abstractmethod
    def rollout_batch(self, data: list[dict], workflow=None, should_accept_fn=None) -> TensorDict: ...

    @abc.abstractmethod
    def prepare_batch(self, dataloader, workflow=None, should_accept_fn=None) -> TensorDict: ...

    # -- submission pause / resume (client side) --------------------------
    def pause(self) -> None:
        """Stop submitting new tasks (the dispatcher pauses)."""
        raise NotImplementedError

    def resume(self) -> None:
        raise NotImplementedError

    # -- server-side generation pause (weight updates) --------------------
    def pause_generation(self) -> None:
        raise NotImplementedError

    def continue_generation(self) -> None:
        raise NotImplementedError

    # -- weights + versioning --------------------------------------------
    @abc.abstractmethod
    def update_weights(self, meta: WeightUpdateMeta) -> None: ...

    @abc.abstractmethod
    def set_version(self, version: int) -> None: ...

    @abc.abstractmethod
    def get_version(self) -> int: ...

    def get_capacity(self) -> int:
        raise NotImplementedError

    def export_stats(self) -> dict[str, float]:
        return {}
