"""Staleness-bounded rollout admission (``areal_tpu/infra/staleness_manager.py``).

The capacity formula (``get_capacity``) bounds how many rollouts may run at
once so that no accepted trajectory is more than ``max_staleness``
versions behind the policy that trains on it:

    capacity = min(max_concurrent - running,
                   (max_staleness + version + 1) * consumer_bs
                     - (accepted + running))

``version`` comes from a ``VersionProvider`` (the rollout client).
"""

from __future__ import annotations

import threading
from typing import Protocol

from areal_tpu_torch.api.io_struct import RolloutStat
from areal_tpu_torch.observability import catalog

# ---------------------------------------------------------------------------
# Version-lag buckets, one definition for every reader of "the high-lag
# bucket" (the loss-side bucket stats, the metric labels, the autopilot).
#
# lag = consuming policy version - per-token policy version. Buckets:
#   "0"  : lag <= 0 (on-policy; unknown/untagged tokens clamp here)
#   "1"  : lag == 1 (one weight commit behind — the η=1 steady state)
#   "2"  : 2 <= lag <= 3
#   "4+" : lag >= 4 (the deep-off-policy tail the staleness bound exists
#          to keep useful; the guard watches this bucket)
# ---------------------------------------------------------------------------
LAG_BUCKET_EDGES = (0, 1, 2, 4)
LAG_BUCKET_LABELS = ("0", "1", "2", "4+")
HIGH_LAG_BUCKET = "4+"


def lag_bucket_index(lag: int) -> int:
    """Bucket index of one lag value (keep in step with the edges)."""
    if lag >= 4:
        return 3
    if lag >= 2:
        return 2
    if lag >= 1:
        return 1
    return 0


class VersionProvider(Protocol):
    def get_version(self) -> int: ...


class StalenessManager:
    def __init__(
        self,
        version_provider: VersionProvider,
        max_concurrent_rollouts: int,
        consumer_batch_size: int,
        max_staleness: int = 0,
    ):
        self._vp = version_provider
        self.max_concurrent_rollouts = max_concurrent_rollouts
        self.consumer_batch_size = consumer_batch_size
        self.max_staleness = max_staleness
        self._lock = threading.Lock()
        self.stat = RolloutStat()
        self._metrics = catalog.staleness_metrics()

    def get_capacity(self) -> int:
        with self._lock:
            version = self._vp.get_version()
            concurrency_cap = self.max_concurrent_rollouts - self.stat.running
            staleness_cap = (
                (self.max_staleness + version + 1) * self.consumer_batch_size
                - self.stat.accepted
                - self.stat.running
            )
            capacity = min(concurrency_cap, staleness_cap)
            self._metrics.capacity.set(capacity)
            self._metrics.running.set(self.stat.running)
            return capacity

    # -- accounting (called by the dispatcher) ----------------------------
    def on_submit(self, n: int = 1) -> None:
        with self._lock:
            self.stat.submitted += n
            self.stat.running += n
        self._metrics.submitted.inc(n)

    def on_accept(self, n: int = 1) -> None:
        with self._lock:
            self.stat.running -= n
            self.stat.accepted += n
        self._metrics.accepted.inc(n)

    def on_reject(self, n: int = 1) -> None:
        with self._lock:
            self.stat.running -= n
            self.stat.rejected += n
        self._metrics.rejected.inc(n)

    def restore_accepted(self, n: int = 1) -> None:
        """Recovery-time accounting (trajectory-journal replay): the
        trajectories were submitted and accepted in a previous life, so
        only the accepted count re-enters the capacity formula. The bound
        re-tightens exactly as before the crash, while the cumulative
        submitted / accepted counters (this life's throughput) are not
        inflated by re-counting old work."""
        if n <= 0:
            return
        with self._lock:
            self.stat.accepted += n

    def observe_version_lag(self, lag: int) -> None:
        """Record an accepted trajectory's version lag (current policy
        version minus the oldest per-token version in the trajectory) —
        the drifting-version-mix signal the staleness bound exists for."""
        self._metrics.version_lag.observe(max(0, lag))

    def observe_version_span(self, span: int) -> None:
        """Record an accepted trajectory's per-token version spread (max -
        min tagged version). Under zero-pause weight sync a sequence that
        decodes across a commit carries BOTH versions token-by-token; span
        > 0 counts it as a mixed-version trajectory, the population decoupled
        PPO's per-token importance correction exists for."""
        self._metrics.version_span.observe(max(0, span))
        if span > 0:
            self._metrics.mixed_version.inc()

    def export_stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "submitted": self.stat.submitted,
                "running": self.stat.running,
                "accepted": self.stat.accepted,
                "rejected": self.stat.rejected,
            }
