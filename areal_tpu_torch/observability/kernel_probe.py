"""The decode-loop probe: per-pass phase attribution and the roofline — the
port of ``areal_tpu/observability/kernel_probe.py``.

Every pass of the decode loop that does real work becomes one
:class:`DecodeStepTimeline`: named phases plus an explicit ``other_s``
residual sum exactly to the pass's wall time.

Phases (host wall-clock spans on the decode thread):

    admission     lifecycle reaping, queue pops, slot updates, duplicates
    radix_match   prefix-cache lookups of newly admitted requests
    prefill       prompt prefills (cold and suffix-only)
    draft         the speculative drafter's proposals
    dispatch      launching the decode chunk (or the verify forward)
    device_wait   waiting for the previous chunk's packed result: the one
                  place the host waits on the card
    verify        the speculative round's blocking download
    bookkeeping   crediting tokens: stop checks, responses, stats

The loop dispatches chunk N and only then waits for chunk N-1, so the card
runs behind the host and the device time the host sees is ``device_wait``.
What happens inside a chunk (page gather, attention and MLP, sampling) is
split analytically from the model's FLOPs (``stats()['device_attribution']``),
because timing it from the host would need a sync in the loop.

Costs are analytic (``hw_accounting.decode_step_costs`` /
``prefill_costs``), recorded under the source ``"analytic"``: the JAX probe
reads FLOPs and bytes from XLA's compiled cost analysis and falls back to
the same formulas where the backend reports none; eager PyTorch compiles no
program, so the fallback is the port's only source. The engine keys a
chunk's cost by its shape — steps, slots and the page-table width whose
half it takes as the mean context. Joined with the card's peaks from
``hw_accounting`` (or a one-time CPU calibration where the card is unknown)
this gives each step's roofline fraction: achieved FLOP/s over
``min(peak FLOP/s, intensity × peak bandwidth)``.

A phase mark is two ``time.monotonic()`` reads and a dict add; nothing here
reads a device tensor or synchronizes.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Iterator

from areal_tpu_torch.observability import catalog as obs_catalog
from areal_tpu_torch.observability import hw_accounting as hw

# canonical phase order; breakdown() also carries any ad-hoc phase a caller added, so the identity never
# silently drops one
DECODE_PHASES = (
    "admission",
    "radix_match",
    "prefill",
    "draft",
    "dispatch",
    "device_wait",
    "verify",
    "bookkeeping",
)

# completed step breakdowns retained for self-tests / statusz scrapes
DEFAULT_RECENT_STEPS = 64


class DecodeStepTimeline:
    """Phase accumulator for ONE productive pass of the decode loop.

    Unlike the trainer's :class:`~.step_timeline.StepTimeline` (outer phase
    wins, inner contributions suppressed), decode phases nest
    *exclusively*: entering an inner phase PAUSES the enclosing one, so
    ``radix_match`` inside ``admission`` and ``prefill`` inside the admit
    path each own their own span and the named sum still can never exceed
    the wall clock. All marks are ``time.monotonic()`` reads on the decode
    thread — no device sync, no host pulls.
    """

    __slots__ = ("started_ts", "phases", "_stack", "_t0")

    def __init__(self) -> None:
        self.started_ts = time.monotonic()
        self.phases: dict[str, float] = {p: 0.0 for p in DECODE_PHASES}
        self._stack: list[str] = []  # open phase names, innermost last
        self._t0 = 0.0  # start of the current exclusive span

    def add(self, name: str, seconds: float) -> None:
        self.phases[name] = self.phases.get(name, 0.0) + max(0.0, seconds)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        now = time.monotonic()
        if self._stack:
            # pause the enclosing phase: credit its span so far, then let
            # the inner phase own the clock until it exits
            self.add(self._stack[-1], now - self._t0)
        self._stack.append(name)
        self._t0 = now
        try:
            yield
        finally:
            now = time.monotonic()
            self.add(name, now - self._t0)
            self._stack.pop()
            self._t0 = now  # the enclosing phase resumes here

    def breakdown(self, end_ts: float | None = None) -> dict[str, float]:
        """Per-phase durations + ``other_s`` residual + ``total_s``.

        Identity: ``sum(<phase>_s) + other_s ==
        total_s`` exactly. Spans are exclusive on one thread, so the only
        way the named sum can exceed the wall clock is sub-microsecond
        float noise — ``total_s`` absorbs it instead of clamping a phase."""
        end = end_ts if end_ts is not None else time.monotonic()
        named = sum(self.phases.values())
        total = max(0.0, end - self.started_ts, named)
        bd: dict[str, float] = {f"{p}_s": v for p, v in self.phases.items()}
        bd["other_s"] = total - named
        bd["total_s"] = total
        return bd


# ---------------------------------------------------------------------------
# cost extraction + roofline math
# ---------------------------------------------------------------------------


def roofline_fraction(
    flops: float,
    nbytes: float,
    elapsed_s: float,
    peak_flops: float | None,
    peak_membw: float | None,
    n_chips: int = 1,
) -> float | None:
    """Achieved/attainable fraction under the classic roofline:
    ``attainable = min(peak_flops, intensity * peak_membw)`` where
    intensity = flops/byte. None when the inputs can't support a number
    (no FLOP count, no peak, zero window) — never fabricated."""
    if flops <= 0.0 or elapsed_s <= 0.0 or not peak_flops:
        return None
    chips = max(1, int(n_chips))
    attainable = peak_flops * chips
    if nbytes > 0.0 and peak_membw:
        attainable = min(attainable, (flops / nbytes) * peak_membw * chips)
    if attainable <= 0.0:
        return None
    return min(1.0, (flops / elapsed_s) / attainable)


class KernelProbe:
    """Per-engine kernel observatory: step timelines + cost registry +
    roofline attribution.

    The decode loop opens one timeline per pass (``begin_step``), abandons
    idle/paused/held passes, and completes productive ones with the
    cost key of the chunk it DRAINED this pass (steady state drains
    exactly one chunk per pass, so per-step FLOPs are the drained chunk's
    cost). Construction is init-time only: peak resolution may calibrate
    the CPU with real work, which is why it must never run on the hot
    path."""

    def __init__(
        self,
        model_cfg=None,
        n_chips: int = 1,
        device: Any | None = None,
        max_recent: int = DEFAULT_RECENT_STEPS,
        calibrate: bool = True,
        peak_flops: float | None = None,
        peak_membw: float | None = None,
    ):
        self.model_cfg = model_cfg
        self.n_chips = max(1, int(n_chips))
        self._obs = obs_catalog.kernel_metrics()
        self._lock = threading.Lock()
        self._costs: dict[tuple, dict[str, Any]] = {}
        self._recent: deque[dict] = deque(maxlen=max_recent)
        self._started = 0
        self._completed = 0
        self._abandoned = 0
        self._phase_sums: dict[str, float] = {p: 0.0 for p in DECODE_PHASES}
        self._other_sum = 0.0
        self._total_sum = 0.0
        self._tokens_sum = 0.0
        self._flops_sum = 0.0
        self._roofline_sum = 0.0
        self._roofline_n = 0
        if peak_flops is not None:
            self.peak_flops, self.peak_membw = peak_flops, peak_membw
            self.peak_source = "override"
        else:
            self.peak_flops = hw.chip_peak_flops(device)
            self.peak_membw = hw.chip_peak_membw(device)
            self.peak_source = "spec"
            if self.peak_flops is None and calibrate and hw.is_cpu(device):
                # the CPU: measure it once so the roofline fraction is still
                # a real number, not null (init-time only — this does real
                # work); a card the table does not know stays "unknown"
                self.peak_flops, self.peak_membw = hw.calibrate_host_peaks()
                self.peak_source = "calibrated"
            elif self.peak_flops is None:
                self.peak_source = "unknown"

    # -- cost registry -----------------------------------------------------

    def record_cost(
        self, key: tuple, flops: float, nbytes: float, source: str
    ) -> None:
        with self._lock:
            self._costs[key] = {
                "flops": float(flops),
                "bytes": float(nbytes),
                "source": source,
            }

    def cost_for(self, key: tuple | None) -> dict[str, Any] | None:
        if key is None:
            return None
        with self._lock:
            return self._costs.get(key)

    # -- step lifecycle ----------------------------------------------------

    def begin_step(self) -> DecodeStepTimeline:
        with self._lock:
            self._started += 1
        return DecodeStepTimeline()

    def abandon_step(self, tl: DecodeStepTimeline) -> None:
        """Discard a pass that did no chunk work (idle poll, paused,
        hold-fence window, cache torn down): no metrics, no identity
        record — recorded steps are always real steps."""
        with self._lock:
            self._abandoned += 1

    def complete_step(
        self,
        tl: DecodeStepTimeline,
        tokens: int = 0,
        cost_key: tuple | None = None,
    ) -> dict[str, float]:
        """Close a productive pass. ``cost_key`` is the cost key of
        the chunk drained this pass; its registered cost supplies the
        step's FLOPs/bytes for the roofline join."""
        bd = tl.breakdown()
        cost = self.cost_for(cost_key)
        flops = cost["flops"] if cost else 0.0
        nbytes = cost["bytes"] if cost else 0.0
        frac = roofline_fraction(
            flops,
            nbytes,
            bd["total_s"],
            self.peak_flops,
            self.peak_membw,
            self.n_chips,
        )
        for p in tl.phases:
            self._obs.phase_seconds.labels(phase=p).observe(bd[f"{p}_s"])
        self._obs.phase_seconds.labels(phase="other").observe(bd["other_s"])
        if flops > 0.0:
            self._obs.step_flops.set(flops)
        if frac is not None:
            self._obs.roofline_fraction.set(frac)
            bd["roofline_fraction"] = frac
        with self._lock:
            self._completed += 1
            for p, v in tl.phases.items():
                self._phase_sums[p] = self._phase_sums.get(p, 0.0) + v
            self._other_sum += bd["other_s"]
            self._total_sum += bd["total_s"]
            self._tokens_sum += max(0, int(tokens))
            self._flops_sum += flops
            if frac is not None:
                self._roofline_sum += frac
                self._roofline_n += 1
            self._recent.append(
                {
                    "breakdown": bd,
                    "tokens": int(tokens),
                    "flops": flops,
                    "bytes": nbytes,
                    "cost_source": cost["source"] if cost else None,
                }
            )
        return bd

    # -- summaries ---------------------------------------------------------

    def recent(self, n: int | None = None) -> list[dict]:
        with self._lock:
            out = list(self._recent)
        if n is None:
            return out
        return out[-n:] if n > 0 else []

    def stats(self) -> dict[str, Any]:
        """Steady-state summary for /statusz ``kernels``: per-phase mean seconds (dominant phase named),
        mean roofline fraction, cost registry, peak provenance."""
        with self._lock:
            n = self._completed
            phase_means = {
                p: (self._phase_sums.get(p, 0.0) / n if n else 0.0)
                for p in DECODE_PHASES
            }
            other_mean = self._other_sum / n if n else 0.0
            total_mean = self._total_sum / n if n else 0.0
            roofline_mean = (
                self._roofline_sum / self._roofline_n
                if self._roofline_n
                else None
            )
            tok_s = (
                self._tokens_sum / self._total_sum if self._total_sum else 0.0
            )
            costs = {
                "|".join(str(k) for k in key): dict(v)
                for key, v in self._costs.items()
            }
            flops_sum = self._flops_sum
            started, abandoned = self._started, self._abandoned
        dominant = None
        if n:
            spans = dict(phase_means)
            spans["other"] = other_mean
            dominant = max(spans, key=spans.get)
        out: dict[str, Any] = {
            "steps": n,
            "started": started,
            "abandoned": abandoned,
            "phase_means_s": phase_means,
            "other_mean_s": other_mean,
            "total_mean_s": total_mean,
            "dominant_phase": dominant,
            "roofline_fraction": roofline_mean,
            "tok_s": tok_s,
            "flops_total": flops_sum,
            "peaks": {
                "flops": self.peak_flops,
                "membw": self.peak_membw,
                "source": self.peak_source,
                "n_chips": self.n_chips,
            },
            "costs": costs,
        }
        # analytic split of the device window: a chunk's page gather,
        # attention + MLP forward and sampling cannot be timed from the host
        # without a sync, but their FLOP / byte shares follow from the dims
        if self.model_cfg is not None:
            try:
                out["device_attribution"] = hw.decode_device_attribution(
                    self.model_cfg
                )
            except Exception:  # noqa: BLE001 — attribution is advisory
                pass
        return out
