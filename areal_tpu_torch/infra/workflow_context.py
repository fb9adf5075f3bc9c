"""Per-task workflow execution context (``areal_tpu/infra/workflow_context.py``).

A frozen dataclass in a ContextVar, so each of the interleaved rollout
coroutines on the runner's loop sees its own. The executor sets it as it
launches an episode; workflows and rewards read it with ``get()``; stats
recorded inside an eval task land under ``eval-rollout/`` (``stat_scope``
and the stats tracker's prefix hook), out of the training curves.
"""

from __future__ import annotations

from contextvars import ContextVar
from dataclasses import dataclass

from areal_tpu_torch.utils import stats_tracker as _stats_tracker


@dataclass(frozen=True)
class WorkflowContext:
    is_eval: bool = False
    task_id: str | None = None


_current: ContextVar[WorkflowContext] = ContextVar("areal_workflow_context", default=WorkflowContext())


def set(ctx: WorkflowContext) -> None:  # noqa: A001 — the JAX package's name
    _current.set(ctx)


def get() -> WorkflowContext:
    return _current.get()


def stat_scope() -> str:
    """Stats scope of the current task: eval rollouts are kept apart."""
    return "eval-rollout" if get().is_eval else ""


_stats_tracker.register_prefix_hook(stat_scope)
