"""Hardware accounting: model FLOPs and bytes from model dims, the card's
peak rates, and the device-memory ledger — the port of
``areal_tpu/observability/hw_accounting.py``.

- ``transformer_param_counts`` / ``train_step_flops`` / ``decode_step_costs``
  / ``prefill_costs`` / ``decode_device_attribution``: analytic FLOPs and
  bytes from the dims of ``models/qwen.py``'s ``ModelConfig``, the same
  formulas as the JAX module (eager PyTorch has no compiled cost analysis,
  so these are the port's only cost source).
- The peak table is keyed on ``torch.cuda.get_device_name``; a card it does
  not know (and the CPU) gets None, and ``calibrate_host_peaks`` measures
  the CPU once instead.
- The ledger (``build_hbm_ledger``): an itemized account of where device
  memory goes beside the device's own view — ``torch.cuda.memory_stats``
  and ``mem_get_info`` on a card, the analytic byte sums on the CPU.

Formulas (per token; M = matmul parameters = non-embedding parameters plus
the LM head, which multiplies even when tied):

- forward 2·M FLOPs, backward 4·M; recompute adds 2·M, each extra no-grad
  forward 2·M;
- decode attention 4·L·ctx·q_dim FLOPs (QKᵀ and PV), prefill attention
  2·L·T²·q_dim over a T-token prompt.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

# dense bf16 peak FLOP/s, memory bytes and peak memory bandwidth (bytes/s)
# of one card, keyed by a lowercase substring of torch.cuda.get_device_name;
# the first match wins
CHIP_SPECS: tuple[tuple[str, float, float, float], ...] = (
    # NVIDIA H100 80GB HBM3 (SXM5): 989 TFLOP/s dense bf16, 80 GB, 3.35 TB/s
    ("h100 80gb hbm3", 989e12, 80e9, 3.35e12),
)


def _spec(device: Any | None) -> tuple[float, float, float] | None:
    name = _device_kind(device)
    if name is None:
        return None
    for sub, flops, mem, bw in CHIP_SPECS:
        if sub in name:
            return flops, mem, bw
    return None


def chip_peak_flops(device: Any | None = None, override_tflops: float | None = None) -> float | None:
    """Peak dense bf16 FLOP/s of one card. ``override_tflops`` (in TFLOP/s)
    wins; a card the table does not know, and the CPU, give None."""
    if override_tflops is not None and override_tflops > 0:
        return float(override_tflops) * 1e12
    s = _spec(device)
    return s[0] if s else None


def chip_hbm_bytes(device: Any | None = None, override_gb: float | None = None) -> float | None:
    """Memory bytes of one card: the analytic ledger's limit when the
    device reports none."""
    if override_gb is not None and override_gb > 0:
        return float(override_gb) * 1e9
    s = _spec(device)
    return s[1] if s else None


def chip_peak_membw(device: Any | None = None, override_gbps: float | None = None) -> float | None:
    """Peak memory bandwidth (bytes/s) of one card: the roofline's memory
    ceiling; None for a card the table does not know."""
    if override_gbps is not None and override_gbps > 0:
        return float(override_gbps) * 1e9
    s = _spec(device)
    return s[2] if s else None


def is_cpu(device: Any | None) -> bool:
    """True for the CPU, and for no device when there is no card."""
    if device is None:
        return not torch.cuda.is_available()
    return torch.device(device).type == "cpu"


def _device_kind(device: Any | None) -> str | None:
    """The lowercase CUDA device name of ``device`` (the current CUDA device
    when None); None on the CPU or without a card."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    try:
        return torch.cuda.get_device_name(device).lower()
    except (RuntimeError, AssertionError):  # no CUDA driver
        return None


# ---------------------------------------------------------------------------
# model FLOPs from dims
# ---------------------------------------------------------------------------


def transformer_param_counts(mcfg) -> dict[str, int]:
    """Parameter counts from model dims: ``total``, ``embedding`` (the input
    lookup table) and ``matmul`` (the parameters that multiply per token:
    non-embedding plus the LM head, a matmul even when weight-tied)."""
    h = mcfg.hidden_size
    L = mcfg.num_layers
    q_dim = mcfg.num_heads * mcfg.head_dim_
    kv_dim = mcfg.num_kv_heads * mcfg.head_dim_
    attn = h * q_dim + 2 * h * kv_dim + q_dim * h
    if getattr(mcfg, "num_experts", 0) > 0:
        inter = mcfg.moe_intermediate_size or mcfg.intermediate_size
        mlp = mcfg.num_experts * 3 * h * inter + h * mcfg.num_experts
        # per-token matmul work routes through the top-k experts only
        mlp_active = mcfg.num_experts_per_tok * 3 * h * inter + h * mcfg.num_experts
    else:
        mlp = mlp_active = 3 * h * mcfg.intermediate_size
    norms = (2 * L + 1) * h
    embed = mcfg.vocab_size * h
    head = embed  # the lm-head matmul (shares the table when tied)
    total = L * (attn + mlp) + norms + embed
    if not mcfg.tie_word_embeddings:
        total += head
    matmul = L * (attn + mlp_active) + head
    return {"total": total, "embedding": embed, "matmul": matmul}


def train_step_flops(mcfg, n_tokens: float, n_extra_forwards: int = 0, remat: bool = False) -> float:
    """Model FLOPs of one optimizer step over ``n_tokens``: fwd (2M) + bwd
    (4M) [+ recompute 2M] + 2M per extra no-grad forward pass."""
    m = transformer_param_counts(mcfg)["matmul"]
    per_tok = (6 + (2 if remat else 0) + 2 * max(0, n_extra_forwards)) * m
    return float(per_tok) * float(n_tokens)


_DTYPE_BYTES = {
    "float32": 4,
    "bfloat16": 2,
    "float16": 2,
    "float8_e4m3fn": 1,
    "int8": 1,
}


def _param_dtype_bytes(mcfg) -> int:
    return _DTYPE_BYTES.get(str(getattr(mcfg, "dtype", "bfloat16")), 2)


def decode_step_costs(
    mcfg,
    n_steps: int,
    n_slots: int,
    ctx_len: float,
    kv_bytes_per_elem: int | None = None,
) -> dict[str, float]:
    """Analytic FLOPs and memory bytes of one decode chunk (``n_steps``
    sampling steps over ``n_slots`` slots at mean context ``ctx_len``). Per
    token: 2·M matmul FLOPs + 4·L·ctx·q_dim attention; bytes = the matmul
    weights read once per step (the slots share the read) + each token's
    KV history read."""
    pc = transformer_param_counts(mcfg)
    L = mcfg.num_layers
    q_dim = mcfg.num_heads * mcfg.head_dim_
    kv_dim = mcfg.num_kv_heads * mcfg.head_dim_
    kvb = kv_bytes_per_elem or _param_dtype_bytes(mcfg)
    tokens = float(n_steps) * float(n_slots)
    attn_flops = 4.0 * L * float(ctx_len) * q_dim
    flops = tokens * (2.0 * pc["matmul"] + attn_flops)
    kv_read = float(ctx_len) * kv_dim * 2.0 * kvb * L
    nbytes = float(n_steps) * pc["matmul"] * _param_dtype_bytes(mcfg) + tokens * kv_read
    return {"flops": flops, "bytes": nbytes, "tokens": tokens}


def prefill_costs(mcfg, n_tokens: float) -> dict[str, float]:
    """Analytic FLOPs and bytes of prefilling ``n_tokens`` prompt tokens:
    2·M per token + causal attention 2·L·T²·q_dim; bytes = one weight read
    + the KV write."""
    pc = transformer_param_counts(mcfg)
    L = mcfg.num_layers
    q_dim = mcfg.num_heads * mcfg.head_dim_
    kv_dim = mcfg.num_kv_heads * mcfg.head_dim_
    T = float(n_tokens)
    flops = 2.0 * pc["matmul"] * T + 2.0 * L * T * T * q_dim
    b = _param_dtype_bytes(mcfg)
    nbytes = pc["matmul"] * b + T * kv_dim * 2.0 * b * L
    return {"flops": flops, "bytes": nbytes, "tokens": T}


def decode_device_attribution(mcfg, ctx_len: float = 512.0) -> dict[str, float]:
    """FLOP shares of a decode step's device window among the parts the host
    cannot time without a sync: the attention + MLP forward and the sampler
    (vocab-sized), plus the page gather's share of the step's bytes. The two
    FLOP shares sum to 1; they split the measured ``device_wait`` window
    analytically."""
    pc = transformer_param_counts(mcfg)
    L = mcfg.num_layers
    q_dim = mcfg.num_heads * mcfg.head_dim_
    attn = 4.0 * L * float(ctx_len) * q_dim
    forward = 2.0 * pc["matmul"] + attn
    sampling = 6.0 * mcfg.vocab_size  # softmax + transform + select, ~O(V)
    costs = decode_step_costs(mcfg, 1, 1, ctx_len)
    gather_bytes = costs["bytes"] - pc["matmul"] * _param_dtype_bytes(mcfg)
    total = forward + sampling
    return {
        "attention_mlp_forward": forward / total,
        "sampling": sampling / total,
        "page_gather_byte_share": (gather_bytes / costs["bytes"] if costs["bytes"] else 0.0),
    }


# one measurement per process (the CPU has no CHIP_SPECS row)
_CALIBRATED: dict[str, tuple[float, float]] = {}


def calibrate_host_peaks(force: bool = False) -> tuple[float, float]:
    """Measure the CPU's achievable FLOP/s (a 384² f32 matmul) and memory
    bandwidth (a 16 MiB add, read + write), best of three after a warm-up.
    Init-time only: it does real work and must never run on the decode
    loop."""
    if not force and "cpu" in _CALIBRATED:
        return _CALIBRATED["cpu"]
    n = 384
    a = torch.ones((n, n), dtype=torch.float32)
    _ = (a @ a)[0, 0].item()  # warm
    best_f = 0.0
    for _i in range(3):
        t0 = time.monotonic()
        _ = (a @ a)[0, 0].item()
        dt = max(1e-9, time.monotonic() - t0)
        best_f = max(best_f, 2.0 * n * n * n / dt)
    big = torch.ones(4 * 1024 * 1024, dtype=torch.float32)  # 16 MiB
    _ = (big + 1.0)[0].item()
    best_b = 0.0
    nbytes = big.numel() * big.element_size()
    for _i in range(3):
        t0 = time.monotonic()
        _ = (big + 1.0)[0].item()
        dt = max(1e-9, time.monotonic() - t0)
        best_b = max(best_b, 2.0 * nbytes / dt)
    _CALIBRATED["cpu"] = (best_f, best_b)
    return _CALIBRATED["cpu"]


# ---------------------------------------------------------------------------
# the device-memory ledger
# ---------------------------------------------------------------------------


def step_transient_bytes(params_bytes: int, opt_state_bytes: int, donate: bool) -> int:
    """Analytic peak of the optimizer step's memory beyond the standing
    parameters and optimizer state: one gradient set always; a step that
    does not update in place holds both generations until the new one is
    written."""
    transient = params_bytes  # grads
    if not donate:
        transient += params_bytes + opt_state_bytes
    return int(transient)


def tree_bytes(tree) -> int:
    """Total buffer bytes of a nest of tensors / numpy arrays (dicts, lists,
    tuples, modules); 0 for None."""
    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        return int(tree.numel() * tree.element_size())
    if isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    if isinstance(tree, torch.nn.Module):
        return sum(tree_bytes(t) for t in tree.state_dict().values())
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if np.isscalar(tree):
        return int(np.asarray(tree).nbytes)
    return 0


def device_memory_stats(device: Any | None = None) -> dict | None:
    """The card's own memory view: ``bytes_in_use`` (allocated by PyTorch),
    ``peak_bytes_in_use``, ``bytes_reserved`` (held by its caching
    allocator), and ``bytes_limit`` / ``bytes_free`` from ``mem_get_info``.
    None on the CPU, which switches the ledger to its analytic sums."""
    if device is None or torch.device(device).type != "cuda":
        return None
    ms = torch.cuda.memory_stats(device)
    free, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": int(ms.get("reserved_bytes.all.current", 0)),
        "bytes_limit": int(total),
        "bytes_free": int(free),
    }


def build_hbm_ledger(
    components: dict[str, int],
    device=None,
    override_hbm_gb: float | None = None,
    exclude_from_total: tuple[str, ...] = (),
) -> dict[str, Any]:
    """Itemized device-memory account. ``components`` maps name -> bytes;
    ``exclude_from_total`` names entries that are views into another entry
    (the radix cache owns pages inside the KV pool), so the itemized total
    never counts a byte twice. On a card ``bytes_in_use`` is the allocated
    bytes and the limit the card's total memory; on the CPU the ledger is
    analytic: in_use = the itemized sum, limit = the override when set."""
    itemized = sum(v for k, v in components.items() if k not in exclude_from_total)
    ms = device_memory_stats(device)
    if ms is not None:
        in_use = ms["bytes_in_use"]
        limit = ms["bytes_limit"]
        peak = ms["peak_bytes_in_use"]
        source = "device"
    else:
        in_use = itemized
        limit = int(float(override_hbm_gb) * 1e9) if override_hbm_gb else None
        peak = None
        source = "analytic"
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
    """Export one ledger onto the catalogued gauges (``areal_hbm_bytes`` by
    component, and the headroom fraction when the limit is known)."""
    if obs is None:
        from areal_tpu_torch.observability import catalog as obs_catalog

        obs = obs_catalog.train_obs_metrics()
    for name, nbytes in ledger["components"].items():
        obs.hbm_bytes.labels(component=name).set(float(nbytes))
    obs.hbm_bytes.labels(component="in_use").set(float(ledger["bytes_in_use"]))
    if ledger["bytes_limit"]:
        obs.hbm_bytes.labels(component="limit").set(float(ledger["bytes_limit"]))
    if ledger["headroom_fraction"] is not None:
        obs.hbm_headroom.set(float(ledger["headroom_fraction"]))
