"""Scoped statistics with denominators (``areal_tpu/utils/stats_tracker.py``).

- ``denominator(**masks)`` registers boolean masks;
- ``stat(denominator=..., **values)`` records masked values whose
  AVG / MIN / MAX are taken over the mask;
- ``scalar(**values)`` records plain scalars (averaged on export);
- scopes nest through ``scope("name")``, giving keys such as
  ``actor/importance_weight/avg``.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from enum import Enum

import numpy as np


class ReduceType(Enum):
    AVG = "avg"
    SUM = "sum"
    MIN = "min"
    MAX = "max"
    SCALAR = "scalar"


_PREFIX_HOOK = None  # () -> str; installed by infra/workflow_context


def register_prefix_hook(fn) -> None:
    """Install the task-context scope hook (one slot; latest wins)."""
    global _PREFIX_HOOK
    _PREFIX_HOOK = fn


class StatsTracker:
    def __init__(self):
        self._lock = threading.RLock()
        self._scope = threading.local()
        self._denoms: dict[str, list[np.ndarray]] = defaultdict(list)
        # each stat entry pairs the value with the mask snapshot active at
        # record time (the denominator's most recently registered mask)
        self._stats: dict[str, list[tuple[np.ndarray, np.ndarray]]] = defaultdict(list)
        self._scalars: dict[str, list[float]] = defaultdict(list)
        self._reduce_types: dict[str, set[ReduceType]] = defaultdict(
            lambda: {ReduceType.AVG}
        )

    # -- scoping ----------------------------------------------------------
    def _prefix(self) -> str:
        prefix = getattr(self._scope, "prefix", "")
        # the task-context hook (infra/workflow_context installs it):
        # prepends "eval-rollout/" inside an eval rollout task
        hook = _PREFIX_HOOK
        if hook is not None:
            ctx_scope = hook()
            if ctx_scope:
                return f"{ctx_scope}/{prefix}"
        return prefix

    @contextmanager
    def scope(self, name: str):
        # save/restore the RAW thread-local prefix: going through _prefix()
        # would bake a context-derived scope into the thread-local and
        # double-prefix (and permanently misroute) later keys
        old = getattr(self._scope, "prefix", "")
        self._scope.prefix = f"{old}{name}/"
        try:
            yield self
        finally:
            self._scope.prefix = old

    def _key(self, name: str) -> str:
        return f"{self._prefix()}{name}"

    # -- recording --------------------------------------------------------
    def denominator(self, **masks) -> None:
        with self._lock:
            for name, mask in masks.items():
                m = np.asarray(mask)
                assert m.dtype == np.bool_ or m.dtype == bool, (name, m.dtype)
                self._denoms[self._key(name)].append(m)

    def stat(
        self,
        denominator: str,
        reduce_type: ReduceType | None = None,
        **values,
    ) -> None:
        denom_key = self._key(denominator)
        with self._lock:
            if denom_key not in self._denoms:
                raise ValueError(f"unknown denominator {denominator!r}")
            mask = self._denoms[denom_key][-1]
            for name, val in values.items():
                key = self._key(name)
                self._stats[key].append((np.asarray(val, dtype=np.float64), mask))
                if reduce_type is not None:
                    self._reduce_types[key] = {reduce_type}
                elif key not in self._reduce_types:
                    self._reduce_types[key] = {
                        ReduceType.AVG,
                        ReduceType.MIN,
                        ReduceType.MAX,
                    }

    def scalar(self, **values) -> None:
        with self._lock:
            for name, val in values.items():
                self._scalars[self._key(name)].append(float(val))

    # -- export -----------------------------------------------------------
    def export(self, key: str | None = None, reset: bool = True) -> dict[str, float]:
        with self._lock:
            result: dict[str, float] = {}
            for dkey, masks in self._denoms.items():
                if key and not dkey.startswith(key):
                    continue
                total = sum(int(m.sum()) for m in masks)
                result[dkey] = float(total)
            for skey, entries in self._stats.items():
                if key and not skey.startswith(key):
                    continue
                vsum = vcnt = 0.0
                vmin, vmax = float("inf"), float("-inf")
                for val, m in entries:
                    if m.shape != val.shape:
                        m = np.broadcast_to(m, val.shape)
                    cnt = m.sum()
                    if cnt:
                        vsum += float((val * m).sum())
                        vcnt += float(cnt)
                        vmin = min(vmin, float(val[m].min()))
                        vmax = max(vmax, float(val[m].max()))
                kinds = self._reduce_types[skey]
                suffixed = len(kinds) > 1
                if vcnt > 0:
                    if ReduceType.AVG in kinds:
                        result[f"{skey}/avg" if suffixed else skey] = vsum / vcnt
                    if ReduceType.SUM in kinds:
                        result[f"{skey}/sum" if suffixed else skey] = vsum
                    if ReduceType.MIN in kinds:
                        result[f"{skey}/min" if suffixed else skey] = vmin
                    if ReduceType.MAX in kinds:
                        result[f"{skey}/max" if suffixed else skey] = vmax
            for ckey, vals in self._scalars.items():
                if key and not ckey.startswith(key):
                    continue
                if vals:
                    result[ckey] = sum(vals) / len(vals)
            if reset:
                if key is None:
                    self._denoms.clear()
                    self._stats.clear()
                    self._scalars.clear()
                else:
                    for d in (self._denoms, self._stats, self._scalars):
                        for k in [k for k in d if k.startswith(key)]:
                            del d[k]
            return result


DEFAULT_TRACKER = StatsTracker()

scope = DEFAULT_TRACKER.scope
denominator = DEFAULT_TRACKER.denominator
stat = DEFAULT_TRACKER.stat
scalar = DEFAULT_TRACKER.scalar
export = DEFAULT_TRACKER.export

@contextmanager
def record_timing(name: str):
    """Record a wall-clock scope as ``timing/<name>`` seconds."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        DEFAULT_TRACKER.scalar(**{f"timing/{name}": time.perf_counter() - t0})


def export_all(reset: bool = True) -> dict[str, float]:
    """Export the default tracker plus every named tracker, name-prefixed."""
    out = DEFAULT_TRACKER.export(reset=reset)
    with _NAMED_LOCK:
        named = list(_NAMED.items())
    for name, tr in named:
        for k, v in tr.export(reset=reset).items():
            out[f"{name}/{k}"] = v
    return out


_NAMED: dict[str, StatsTracker] = {}
_NAMED_LOCK = threading.Lock()


def get(name: str = "") -> StatsTracker:
    """The named tracker registry ("" is the default tracker)."""
    if not name:
        return DEFAULT_TRACKER
    with _NAMED_LOCK:
        if name not in _NAMED:
            _NAMED[name] = StatsTracker()
        return _NAMED[name]
