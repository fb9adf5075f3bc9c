"""Fault tolerance: the preemption handler (``robustness/preemption.py``).
The retrying transport, circuit breakers, replica supervision and chaos
injection of ``areal_tpu/robustness/`` are ROADMAP Queue A item 8."""

from areal_tpu_torch.robustness.preemption import DRAINED, DRAINING, RUNNING, PreemptionHandler

__all__ = ["DRAINED", "DRAINING", "RUNNING", "PreemptionHandler"]
