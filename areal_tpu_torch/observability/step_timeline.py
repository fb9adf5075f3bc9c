"""Trainer step-phase timeline — the port of
``areal_tpu/observability/step_timeline.py``.

Every global step gets named phases plus an explicit ``other_s`` residual
that sum exactly to the step's wall time:

    rollout_wait       blocking in prepare_batch — the async bubble
    host_prep          grid packing, device copies, advantage computation
    forward_backward   device compute (no-grad forwards + forward/backward)
    optimizer          the optimizer step
    weight_publish     rollout pause + weight stream/commit + set_version
    ckpt_eval          saver/recover dumps + evaluation
    other_s            everything unattributed (stats export, logging, ...)

The trainer thread owns the timeline; the train engine contributes its
host_prep / forward_backward / optimizer spans through the thread-local
``engine_phase`` hook. Spans are host wall time: the engine's stat read
(one device-to-host copy per batch) closes each forward_backward span, so
device work queued inside it lands there.

The utilization inputs read the card through PyTorch where the JAX package
reads the XLA device: model FLOPs come from the model dims (the JAX
``hw_accounting.train_step_flops``), the chip peak only from
``TelemetryConfig.chip_peak_tflops`` (None otherwise, as the JAX package
does for a chip it does not know: MFU is then not reported), and the
memory ledger from ``torch.cuda.memory_allocated`` / ``mem_get_info`` on a
card, or the analytic byte sums on the CPU.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import deque
from typing import Any, Iterator

from areal_tpu_torch.observability import catalog as obs_catalog

logger = logging.getLogger("areal_tpu_torch.step_timeline")

PHASES = (
    "rollout_wait",
    "host_prep",
    "forward_backward",
    "optimizer",
    "weight_publish",
    "ckpt_eval",
)

DEFAULT_RECENT_STEPS = 64


class StepTimeline:
    """Phase accumulator for one global training step. Phases are duration
    accumulators; while a trainer-level phase is open, ``engine_phase``
    contributions are suppressed (the enclosing span owns that time)."""

    __slots__ = ("step", "started_ts", "epoch_anchor", "phases", "_open_depth")

    def __init__(self, step: int):
        self.step = step
        self.started_ts = time.monotonic()
        self.epoch_anchor = time.time()
        self.phases: dict[str, float] = {p: 0.0 for p in PHASES}
        self._open_depth = 0

    def add(self, name: str, seconds: float) -> None:
        self.phases[name] = self.phases.get(name, 0.0) + max(0.0, seconds)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.monotonic()
        self._open_depth += 1
        try:
            yield
        finally:
            self._open_depth -= 1
            self.add(name, time.monotonic() - t0)

    def breakdown(self, end_ts: float | None = None) -> dict[str, float]:
        """Per-phase durations + ``other_s`` + ``total_s``, with
        ``sum(<phase>_s) + other_s == total_s`` exactly."""
        end = end_ts if end_ts is not None else time.monotonic()
        named = sum(self.phases.values())
        total = max(0.0, end - self.started_ts, named)
        bd: dict[str, float] = {f"{p}_s": v for p, v in self.phases.items()}
        bd["other_s"] = total - named
        bd["total_s"] = total
        bd["bubble_fraction"] = self.phases.get("rollout_wait", 0.0) / total if total > 0 else 0.0
        return bd


_tl_local = threading.local()


def current_step_timeline() -> StepTimeline | None:
    return getattr(_tl_local, "tl", None)


def _set_current(tl: StepTimeline | None) -> None:
    _tl_local.tl = tl


@contextlib.contextmanager
def engine_phase(name: str) -> Iterator[None]:
    """Attribute the enclosed span to the calling thread's open step
    timeline; a no-op outside a step or inside an explicit trainer phase."""
    tl = current_step_timeline()
    if tl is None or tl._open_depth > 0:
        yield
    else:
        with tl.phase(name):
            yield


class StepTimelineRecorder:
    """Trainer-side registry of step timelines: ``start`` opens a step (the
    thread's current timeline), ``complete`` closes it, observes the phase
    histograms and utilization gauges, and keeps the breakdown in a bounded
    deque."""

    def __init__(self, max_recent: int = DEFAULT_RECENT_STEPS):
        self._recent: deque[dict] = deque(maxlen=max_recent)
        self._lock = threading.Lock()
        self._obs = obs_catalog.train_obs_metrics()

    def start(self, step: int) -> StepTimeline:
        tl = StepTimeline(step)
        _set_current(tl)
        return tl

    def complete(
        self,
        tl: StepTimeline,
        tokens: float | None = None,
        flops: float | None = None,
        n_chips: int = 1,
        peak_flops_per_chip: float | None = None,
    ) -> dict[str, float]:
        """Close the step; returns the breakdown. MFU is over the compute
        window (forward_backward + optimizer), ``mfu_step`` over the step."""
        if current_step_timeline() is tl:
            _set_current(None)
        bd = tl.breakdown()
        for p in tl.phases:
            self._obs.phase_seconds.labels(phase=p).observe(bd[f"{p}_s"])
        self._obs.phase_seconds.labels(phase="other").observe(bd["other_s"])
        self._obs.bubble_fraction.set(bd["bubble_fraction"])
        chips = max(1, int(n_chips))
        if tokens is not None and tokens > 0 and bd["total_s"] > 0:
            bd["tok_s_per_chip"] = tokens / bd["total_s"] / chips
            self._obs.tokens_per_chip.set(bd["tok_s_per_chip"])
        if flops is not None and flops > 0 and peak_flops_per_chip is not None and peak_flops_per_chip > 0:
            compute_s = bd["forward_backward_s"] + bd["optimizer_s"]
            peak = peak_flops_per_chip * chips
            if compute_s > 0:
                bd["mfu"] = min(1.0, flops / (compute_s * peak))
                self._obs.mfu.set(bd["mfu"])
            if bd["total_s"] > 0:
                bd["mfu_step"] = min(1.0, flops / (bd["total_s"] * peak))
        with self._lock:
            self._recent.append({"step": tl.step, "epoch_anchor": tl.epoch_anchor, "breakdown": bd})
        return bd

    def abandon(self, tl: StepTimeline) -> None:
        """Discard an aborted step without observing metrics."""
        if current_step_timeline() is tl:
            _set_current(None)

    def recent(self, n: int | None = None) -> list[dict]:
        with self._lock:
            out = list(self._recent)
        if n is None:
            return out
        return out[-n:] if n > 0 else []


# -- utilization inputs (areal_tpu/observability/hw_accounting.py) ----------


def matmul_params(mcfg) -> int:
    """Parameters that multiply per token: every layer's projections (an
    MoE layer's top-k experts and router) and the LM head."""
    h = mcfg.hidden_size
    hd = mcfg.head_dim_
    q_dim, kv_dim = mcfg.num_heads * hd, mcfg.num_kv_heads * hd
    attn = h * q_dim + 2 * h * kv_dim + q_dim * h
    if getattr(mcfg, "num_experts", 0) > 0:
        inter = mcfg.moe_intermediate_size or mcfg.intermediate_size
        mlp = mcfg.num_experts_per_tok * 3 * h * inter + h * mcfg.num_experts
    else:
        mlp = 3 * h * mcfg.intermediate_size
    return mcfg.num_layers * (attn + mlp) + mcfg.vocab_size * h


def train_step_flops(mcfg, n_tokens: float, n_extra_forwards: int = 0, remat: bool = False) -> float:
    """Model FLOPs of one optimizer step over ``n_tokens``: fwd (2M) + bwd
    (4M) [+ remat recompute 2M] + 2M per extra no-grad forward pass."""
    per_tok = (6 + (2 if remat else 0) + 2 * max(0, n_extra_forwards)) * matmul_params(mcfg)
    return float(per_tok) * float(n_tokens)


def chip_peak_flops(override_tflops: float | None = None) -> float | None:
    """Peak bf16 FLOPs/s of one chip: the TelemetryConfig override, else
    None (MFU is then not reported rather than guessed)."""
    if override_tflops is not None and override_tflops > 0:
        return float(override_tflops) * 1e12
    return None


def build_hbm_ledger(
    components: dict[str, int],
    device=None,
    override_hbm_gb: float | None = None,
    exclude_from_total: tuple[str, ...] = (),
) -> dict[str, Any]:
    """Itemized device-memory account. On a card ``bytes_in_use`` is
    ``torch.cuda.memory_allocated`` and the limit the card's total memory
    (``mem_get_info``); on the CPU the ledger is analytic: in_use = the
    itemized sum, limit = the override when set."""
    import torch

    itemized = sum(v for k, v in components.items() if k not in exclude_from_total)
    if device is not None and torch.device(device).type == "cuda":
        in_use = int(torch.cuda.memory_allocated(device))
        limit = int(torch.cuda.mem_get_info(device)[1])
        source = "device"
        peak = int(torch.cuda.max_memory_allocated(device))
    else:
        in_use = itemized
        limit = int(float(override_hbm_gb) * 1e9) if override_hbm_gb else None
        source = "analytic"
        peak = None
    return {
        "components": dict(components),
        "itemized_bytes": itemized,
        "bytes_in_use": in_use,
        "bytes_limit": limit,
        "peak_bytes": peak,
        "headroom_fraction": max(0.0, 1.0 - in_use / limit) if limit else None,
        "source": source,
    }


def observe_hbm_ledger(ledger: dict[str, Any], obs=None) -> None:
    obs = obs or obs_catalog.train_obs_metrics()
    for name, nbytes in ledger["components"].items():
        obs.hbm_bytes.labels(component=name).set(float(nbytes))
    obs.hbm_bytes.labels(component="in_use").set(float(ledger["bytes_in_use"]))
    if ledger["bytes_limit"]:
        obs.hbm_bytes.labels(component="limit").set(float(ledger["bytes_limit"]))
    if ledger["headroom_fraction"] is not None:
        obs.hbm_headroom.set(float(ledger["headroom_fraction"]))


def complete_trainer_step(
    recorder: StepTimelineRecorder,
    tl: StepTimeline,
    engine,
    telemetry,
    batch,
    n_extra_forwards: int = 0,
    remat: bool = False,
) -> tuple[dict[str, float], dict | None]:
    """Close a trainer step: token count from the batch, model FLOPs from
    the engine's dims, the chip peak from ``telemetry``; complete the
    timeline and refresh the memory ledger. Returns ``(breakdown,
    ledger-or-None)``."""
    import numpy as np

    tokens = flops = None
    try:
        tokens = float(np.asarray(batch["attention_mask"]).sum())
    except (KeyError, TypeError):
        pass
    mcfg = getattr(engine, "model_cfg", None)
    if mcfg is not None and tokens:
        flops = train_step_flops(mcfg, tokens, n_extra_forwards=n_extra_forwards, remat=remat)
    bd = recorder.complete(
        tl,
        tokens=tokens,
        flops=flops,
        n_chips=1,
        peak_flops_per_chip=chip_peak_flops(telemetry.chip_peak_tflops),
    )
    ledger = None
    if hasattr(engine, "hbm_ledger"):
        try:
            ledger = engine.hbm_ledger(override_hbm_gb=telemetry.chip_hbm_gb)
            observe_hbm_ledger(ledger)
        except Exception:  # noqa: BLE001 — accounting never kills a step
            logger.exception("hbm ledger refresh failed")
    return bd, ledger


def format_phase_line(bd: dict[str, float]) -> str:
    """One-line step-phase summary for the trainer log."""
    parts = [f"step {bd['total_s']:.2f}s"]
    for p in PHASES:
        v = bd.get(f"{p}_s", 0.0)
        if v > 0.0005:
            parts.append(f"{p} {v:.2f}s")
    if bd.get("other_s", 0.0) > 0.0005:
        parts.append(f"other {bd['other_s']:.2f}s")
    parts.append(f"bubble {bd.get('bubble_fraction', 0.0):.0%}")
    if "mfu" in bd:
        parts.append(f"mfu {bd['mfu']:.1%}")
    if "tok_s_per_chip" in bd:
        parts.append(f"{bd['tok_s_per_chip']:.0f} tok/s/chip")
    return " | ".join(parts)


def breakdown_stat_keys(bd: dict[str, Any]) -> dict[str, float]:
    """Breakdown -> flat per-step stats keys (``phase/<name>_s`` + the
    utilization scalars)."""
    out = {f"phase/{p}_s": float(bd.get(f"{p}_s", 0.0)) for p in PHASES}
    out["phase/other_s"] = float(bd.get("other_s", 0.0))
    out["bubble_fraction"] = float(bd.get("bubble_fraction", 0.0))
    for k in ("mfu", "mfu_step", "tok_s_per_chip"):
        if k in bd:
            out[k] = float(bd[k])
    return out
