"""The rollout workflow contract (``areal_tpu/api/workflow_api.py``)."""

from __future__ import annotations

import abc
import importlib
from typing import Union

from areal_tpu_torch.utils.data import TensorDict


class RolloutWorkflow(abc.ABC):
    """One episode of data collection.

    ``arun_episode`` returns a trajectory dict (keys such as input_ids /
    loss_mask / logprobs / versions / rewards as per-token 1D or scalar
    numpy arrays, see ``utils/data.pad_sequences_to_tensors``), a list of
    such dicts (grouped sampling), or None to reject the episode."""

    @abc.abstractmethod
    async def arun_episode(self, engine, data: dict) -> TensorDict | list[TensorDict] | None: ...


# an instance, or an import path "package.module:Class" / "package.module.Class"
WorkflowLike = Union[RolloutWorkflow, str]


def _import_from_string(path: str):
    module, _, name = path.rpartition(":") if ":" in path else path.rpartition(".")
    return getattr(importlib.import_module(module), name)


def resolve_workflow(workflow: WorkflowLike, **kwargs) -> RolloutWorkflow:
    if isinstance(workflow, RolloutWorkflow):
        return workflow
    if isinstance(workflow, str):
        return _import_from_string(workflow)(**kwargs)
    raise TypeError(f"cannot resolve workflow from {workflow!r}")
