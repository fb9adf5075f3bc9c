"""Continuous-batching generation engine over a paged KV cache — the port of
``areal_tpu/inference/decode_engine.py`` for one CUDA device.

The shape of the JAX engine is kept:

- S decode slots draw KV pages from a shared ``PagePool``; requests admit
  into free slots through a batched cold prefill (``qwen.forward_prefill`` +
  ``paged_kv.scatter_prefill``), then all slots step together in chunks of
  ``decode_steps_per_call`` steps (``qwen.forward_decode_paged`` + the
  sampler). Attention reads the pages through the hand-written CUDA kernel
  (``ops/paged_attention.py``).
- Slot state lives on the device between chunks. A chunk returns ONE packed
  int32 ``[2*n_steps + 3, S]`` array — token rows, logprob-bit rows, then
  emit_count / final-active / final-pos — copied to pinned host memory
  without blocking; the host reads it after dispatching the next chunk, so
  the device computes chunk N+1 while the host books chunk N. No per-step
  ``.item()`` / ``.cpu()``.
- Per-token policy versions: every emitted token carries the weight version
  that produced it; ``update_weights_from_params`` swaps weights between
  chunks (in place, stream-ordered after the chunk in flight).
- The streamed weight update (``areal_tpu/inference/decode_engine.py:1446``):
  ``begin_staged_update`` opens a staging area, ``stage_weight_bucket``
  stages each bucket while generation continues (copied to the card on a
  side stream as it arrives, or kept in pinned host memory under
  ``weight_stage_target="host"``), and ``commit_staged_weights`` checks
  every name and shape, then has the loop copy the staged tensors into the
  served parameters between chunks, all or nothing. The JAX engine swaps
  the parameter tree; here the served tensors keep their addresses (a
  ``copy_`` in place), which gives the same function and leaves them
  usable by a captured CUDA graph.
- ``pause_generation`` (abort mode) ends every in-flight request with
  ``stop_reason="abort"`` and its partial tokens and PARKS its KV in its
  slot (``_Parked``, rid affinity): the client's resubmit of prompt +
  tokens so far under the same rid resumes there with zero re-prefill,
  across a weight commit too unless ``kv_reuse_across_updates=False``. The
  parked request's full pages are also published into the radix tree, so a
  resubmit whose parking was evicted (pool pressure: radix leaves go first,
  then the oldest parking) or whose ids changed (the next turn of an
  episode) prefills only its suffix.
- ``pause_generation(mode="hold")``, the commit fence: the loop drains its
  in-flight chunk and idles with slots, KV and device state intact
  (``wait_fence_ack`` returns once it has); a commit applies at the top of
  the next pass, and ``continue_generation`` resumes decoding in place, so
  a request that spans the commit carries both versions. The hold releases
  itself after ``hold_fence_timeout_s``.
- The request lifecycle (``decode_engine.py:871-1329``): ``abort_request``
  cancels one request, queued, decoding or parked; deadlines
  (``ModelRequest.deadline``) are reaped between chunks with the partial
  output (``truncated_by="deadline"``), and a request whose deadline passed
  in the queue never prefills; the per-slot watchdog aborts a slot that
  emitted nothing for ``lifecycle.watchdog_s``; ``is_wedged`` reports a
  loop that made no pass for ``lifecycle.engine_stall_escalate_s`` while
  work is pending; ``check_admission`` is the server's 429 gate (queue
  depth, free-page headroom, draining); ``drain`` closes admission, lets
  in-flight decodes finish within a budget and parks the rest;
  ``apply_autopilot_knobs`` sets the gates and the radix cap; and
  ``release_memory`` / ``resume_memory`` move the served weights to pinned
  host memory and drop the KV pool, then bring both back.
- The frequency penalty (``enable_frequency_penalty``): a [S, V] count
  table of each slot's generated tokens lives on the device (uint16
  values, saturating at 65,535, held in an int16 tensor); the chunk
  subtracts ``frequency_penalty * counts`` from the raw logits before the
  sampler and counts each sampled token, with no host sync. Admission
  zeroes a slot's counts and a resume restores its emitted tokens'.
- Prefix sharing, as in the JAX engine's defaults: identical prompts of one
  admission pass (a GRPO group's samples) prefill once and the others alias
  the primary's full pages plus a private copy of the page holding row
  ``plen-1`` (``_admit_duplicates``); finished requests publish their full
  pages into the radix prefix cache (``paged_kv.RadixPrefixCache``), and an
  admission whose prompt has a cached page-aligned prefix aliases those
  pages and prefills only the suffix (``qwen.forward_prefill_paged``: the
  chain-mask launch of kernel #3, ``ops/paged_suffix_attention.py``). The
  tree is flushed at a weight commit under ``across_updates="flush"``.
- Speculative decoding (``speculative.enabled``): a synchronous round per
  loop pass — the host drafter proposes a token tree per slot, one verify
  forward scores it (``qwen.forward_verify_paged``, the tree-mask launch of
  kernel #3), the accept walk re-runs the sampler position by position,
  only accepted-path rows write KV into real pages, and pages allocated
  past the accepted tokens roll back to the pool.

- Observability (``decode_engine.py:317-341``): every request carries a
  ``RequestTimeline`` from ``submit`` to ``_finish``, whose breakdown
  (queue wait, prefill, decode, fence stall, park; ``other_s`` the
  residual) rides the response; significant events (wedge, watchdog,
  drain, weight stage / commit, evictions, preemption) go into the
  process's flight ring; the ``KernelProbe`` splits every productive pass
  of the loop into named host phases whose sum plus ``other_s`` is the
  pass's wall time, ``device_wait`` being the one wait on the card; and
  ``hbm_ledger`` itemizes the device memory. None of it reads a device
  tensor or synchronizes on the loop.

- Weights from disk: with no ``params``, ``initialize`` loads the HF
  checkpoint at ``ServerConfig.model_path`` at ``ServerConfig.dtype``,
  straight onto the card one tensor at a time (``models/hf.py``);
  ``update_weights_from_disk`` reloads a trainer's export through the same
  apply site as ``update_weights_from_params`` (``decode_engine.py:1605``),
  in place, under the same version, parking and radix-flush rules.

- int8 weight serving (``quantization="int8"``, ``decode_engine.py:405-418``):
  ``initialize`` replaces each layer's dense projections by their int8
  form (``qwen.quantize_model_int8``: ``<t>_q8`` int8 and ``<t>_scale`` f32
  parameters, so every walker of ``model.named_parameters()`` sees them:
  the update checks, the copies, ``hbm_ledger``, ``release_memory``). The
  base structure (names and shapes before quantization) is kept: a
  bf16-named update (params, staged buckets, a disk reload) is checked
  against it and re-quantized on apply, from the serving dtype as JAX
  does; a q8-wire (served-form) staged update, decided once at the commit,
  is checked against the served structure and copied as it is. A
  served-form leaf staged into an engine that is not int8 is refused at
  stage time, before any weight changes.
- LoRA updates (``update_weights_lora``, ``decode_engine.py:1356-1436``):
  adapter buckets (``layers/<t>_lora_a`` [n, in, r], ``layers/<t>_lora_b``
  [n, r, out], the JAX layout) fold into the served base cumulatively,
  W += s (A_new B_new - A_old B_old) in f32, every name and shape checked
  before the first weight changes. Refused after a full update (the base
  may hold merged adapters), on an int8 engine, and for an unknown target.

- Image inputs (a VLM, ``decode_engine.py:1870-1955``): a request's
  ``image_data`` (pixel patches [P, patch_dim]) and ``image_grid_thw`` go
  through the vision tower at admission (``_image_embeds_for``: one tower
  call per request at ``pad_patch_bucket``'s padded patch count under the
  patch mask), and the merged embeddings enter the cold prefill at the
  prompt's image-pad positions (``qwen.forward_prefill(...,
  image_embeds=)``); they stay on the card. Image requests are kept out of
  the duplicate split and the radix match (their KV depends on the image
  too); a finished one still publishes its pages, as in JAX (ROADMAP Queue
  C, C-ref 8).

Not ported yet (raise ``NotImplementedError``, see ``_check_supported``):
serving on a multi-device mesh (ROADMAP Queue A item 6b).

Eager PyTorch compiles nothing, so admission does not pad prefill groups to
compiled sizes: a group pads to its longest prompt (or suffix).
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Callable

import numpy as np
import torch

from areal_tpu_torch.api.config import ServerConfig
from areal_tpu_torch.api import io_struct
from areal_tpu_torch.api.io_struct import ModelRequest, ModelResponse, StopReason
from areal_tpu_torch.device import resolve_device
from areal_tpu_torch.inference import paged_kv
from areal_tpu_torch.inference import speculative as spec_mod
from areal_tpu_torch.models import qwen
from areal_tpu_torch.models import vision as vis
from areal_tpu_torch.models.hf import checkpoint_has_vision, load_params_from_hf
from areal_tpu_torch.observability import catalog as obs_catalog
from areal_tpu_torch.observability import hw_accounting as hw
from areal_tpu_torch.observability import kernel_probe
from areal_tpu_torch.observability import timeline as tl_mod
from areal_tpu_torch.utils import offload, perf_tracer
from areal_tpu_torch.utils.data import round_up_to_bucket

logger = logging.getLogger("areal_tpu_torch.decode_engine")

_MAX_STOP = 8  # stop-token-id slots per request (padded with -1)
_TOPK_CAP = 1024  # static candidate-set size for per-slot top-k/top-p
_PREFILL_SIZES = (8, 4, 2, 1)  # batched-prefill group sizes
_COUNT_MAX = 65535  # the frequency penalty's counts saturate here (uint16)
# the exact leaf names of the int8 serving form (a q8-wire update's leaves)
_SERVED_FORM_LEAVES = frozenset(f"{t}{suf}" for t in qwen.QUANT_TARGETS for suf in ("_q8", "_scale"))


def _served_form(names) -> bool:
    return any(n.rsplit(".", 1)[-1] in _SERVED_FORM_LEAVES for n in names)


@dataclass
class _Task:
    req: ModelRequest
    callback: Callable[[ModelResponse], None]
    submit_time: float = field(default_factory=time.monotonic)
    slot: int = -1
    out_tokens: list[int] = field(default_factory=list)
    out_logprobs: list[float] = field(default_factory=list)
    out_versions: list[int] = field(default_factory=list)
    first_token_time: float | None = None
    # "cancelled" (/abort_request), "deadline" or "watchdog" when reaped
    truncated_by: str = ""
    # stage events and the breakdown stamped onto the response
    timeline: tl_mod.RequestTimeline | None = None


@dataclass
class _Parked:
    """KV retained across an abort pause, for rid affinity
    (``decode_engine.py:102``). The client resubmits ``prompt + emitted``
    under the same rid after continue_generation; while the slot's pages are
    intact the decode state is restored with zero re-prefill. The entry owns
    the slot's pages until the resume or an eviction."""

    slot: int
    full_ids: list[int]  # prompt + emitted; the cache holds all but the last
    pos: int  # decode position of the pending (last) token
    pages: list[int] = field(default_factory=list)  # owned KV pages
    # policy version each page's KV was computed under (parallel to pages)
    page_versions: list[int] = field(default_factory=list)
    n_emitted: int = 0  # completion tokens so far (the penalty's restore)
    park_time: float = field(default_factory=time.monotonic)


# ---------------------------------------------------------------------------
# sampler (decode_engine.py:131-234). Random numbers are arguments, so a
# test can hand the JAX and the port versions the same uniforms.
# ---------------------------------------------------------------------------


def _sample_blocks(V: int) -> int:
    """Block count for the hierarchical sampler: the largest divisor of V
    that is <= 512."""
    for nb in range(min(V, 512), 0, -1):
        if V % nb == 0:
            return nb
    return 1


def _inverse_cdf_sample(scaled: torch.Tensor, u: torch.Tensor):
    """Exact categorical sampling with ONE uniform per row (u [S, 1] in
    [0, 1)): pick a block from the block-level CDF, then the token inside
    the block from the residual uniform. Returns (ids [S], logp [S],
    lse [S, 1]) with logp the exact log-softmax of the drawn token."""
    S, V = scaled.shape
    NB = _sample_blocks(V)
    inner = V // NB
    blocks = scaled.reshape(S, NB, inner)
    block_lse = torch.logsumexp(blocks, dim=-1)  # [S, NB]
    lse = torch.logsumexp(block_lse, dim=-1, keepdim=True)
    bprob = torch.exp(block_lse - lse)
    bcum = torch.cumsum(bprob, dim=-1)
    ut = u * bcum[:, -1:]
    b = (bcum <= ut).sum(dim=-1).clamp(max=NB - 1)  # [S]
    prev = torch.gather(bcum, 1, (b - 1).clamp(min=0)[:, None])[:, 0]
    cum_excl = torch.where(b > 0, prev, torch.zeros_like(prev))
    pb = torch.gather(bprob, 1, b[:, None])[:, 0]
    u_in = (ut[:, 0] - cum_excl) / pb.clamp(min=1e-30)
    blk = torch.gather(blocks, 1, b[:, None, None].expand(S, 1, inner))[:, 0]
    blk_lse = torch.gather(block_lse, 1, b[:, None])  # [S, 1]
    icum = torch.cumsum(torch.exp(blk - blk_lse), dim=-1)  # [S, inner]
    idx = (icum <= u_in[:, None] * icum[:, -1:]).sum(dim=-1).clamp(max=inner - 1)
    ids = b * inner + idx
    logp = (torch.gather(scaled, 1, ids[:, None]) - lse)[:, 0]
    return ids, logp, lse


def _sample_step(
    logits: torch.Tensor,
    u_full: torch.Tensor,
    u_cap: torch.Tensor | None,
    state: dict,
    capped: bool,
    greedy_any: bool = True,
):
    """One sampling step. logits [S, V] f32; sampling knobs are per-slot
    tensors in ``state`` (temp, greedy, top_k, top_p). ``u_full`` [S, 1]
    feeds the full-vocab draw; ``u_cap`` [S, min(V, 1024)] uniforms in
    (0, 1) feed the top-k/top-p draw, a Gumbel-max over the kept candidates
    (what ``jax.random.categorical`` computes from its own uniforms)."""
    V = logits.shape[-1]
    temp, greedy = state["temp"], state["greedy"]
    safe_t = torch.clamp(temp, min=1e-6)[:, None]
    scaled = logits / safe_t
    sampled, samp_logp, lse = _inverse_cdf_sample(scaled, u_full)
    use_cap = cap_logp = None
    if capped:
        K = min(V, _TOPK_CAP)
        top_vals, top_idx = torch.topk(scaled, K, dim=-1)  # sorted desc
        eff_k = torch.where(state["top_k"] > 0, state["top_k"], V)
        mask_k = torch.arange(K, device=logits.device)[None, :] < eff_k[:, None]
        probs = torch.softmax(top_vals, dim=-1)
        cum_excl = torch.cumsum(probs, dim=-1) - probs
        mask_p = cum_excl < state["top_p"][:, None]
        keep = mask_k & mask_p
        keep[:, 0] = True
        cap_logits = torch.where(keep, top_vals, -1e30)
        gumbel = -torch.log(-torch.log(u_cap))
        cap_pos = torch.argmax(gumbel + cap_logits, dim=-1)
        cap_ids = torch.gather(top_idx, 1, cap_pos[:, None])[:, 0]
        cap_logp = torch.gather(torch.log_softmax(cap_logits, dim=-1), 1, cap_pos[:, None])[:, 0]
        use_cap = (state["top_k"] > 0) | (state["top_p"] < 1.0)
        sampled = torch.where(use_cap, cap_ids, sampled)
    if greedy_any:
        arg = torch.argmax(logits, dim=-1)
        next_ids = torch.where(greedy, arg, sampled)
        greedy_logp = (torch.gather(scaled, 1, arg[:, None]) - lse)[:, 0]
        logp = torch.where(greedy, greedy_logp, samp_logp)
    else:
        next_ids = sampled
        logp = samp_logp
    if capped:
        logp = torch.where(use_cap & ~greedy, cap_logp, logp)
    return next_ids, logp


def load_params(model: qwen.QwenModel, params) -> None:
    """Copy ``params`` (a ``QwenModel`` or a state dict of tensors / numpy
    arrays, e.g. ``models/convert.from_jax_params``) into ``model`` in
    place, casting to the model's dtype. Every parameter must be present.

    All or nothing: every name, every shape and every value's conversion to
    a tensor is checked before the first copy, so a payload that fails any
    check raises and changes no weight. The JAX engine gets the same effect
    by building the new parameter tree and assigning it only once built
    (``areal_tpu/inference/decode_engine.py:1611``); here the copy stays in
    place, because a second full copy of a large model (57 GiB for
    Qwen3-30B-A3B) does not fit beside the first."""
    srcs = _checked_sources(_param_specs(model), params)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(srcs[name])


def _param_specs(model: qwen.QwenModel) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """Every parameter's name -> (shape, dtype)."""
    return {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}


def _checked_sources(specs: dict, params, exact_dtype: bool = False) -> dict[str, torch.Tensor]:
    """``params`` as tensors keyed by the names of ``specs`` (name -> (shape,
    dtype), ``_param_specs``), after checking that the names match exactly
    and every shape fits and every dtype casts (with ``exact_dtype``, the
    int8 serving form's leaves must have their own dtype: an int8 table is
    never cast from a float); raises (and copies nothing) otherwise."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    missing = sorted(set(specs) - set(params))
    extra = sorted(set(params) - set(specs))
    if missing or extra:
        raise ValueError(f"weight update mismatch: missing {missing[:4]}, unexpected {extra[:4]}")
    srcs = {}
    for name, (shape, dtype) in specs.items():
        src = params[name]
        if not isinstance(src, torch.Tensor):
            src = torch.as_tensor(np.asarray(src))
        if tuple(src.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(src.shape)} != {shape}")
        if src.is_complex() or (exact_dtype and _served_form([name]) and src.dtype != dtype):
            # copy_ would drop an imaginary part with a warning, or truncate
            # a float into an int8 table
            raise TypeError(f"{name}: dtype {src.dtype} does not cast to {dtype}")
        srcs[name] = src
    return srcs


class DecodeEngine:
    """Continuous-batching generation over one model replica on one device."""

    def __init__(
        self,
        config: ServerConfig,
        params=None,
        model_cfg: qwen.ModelConfig | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self._check_supported(config)
        self.config = config
        self.params = params  # QwenModel or state dict; the model is built in initialize
        self.model_cfg = model_cfg
        self.model: qwen.QwenModel | None = None
        self._version = 0
        self._paused = threading.Event()  # set = paused (aborts in-flight)
        self._pause_ack = threading.Event()  # set once the loop has ended them
        self._held = threading.Event()  # set = the hold fence (no aborts)
        self._hold_ack = threading.Event()  # set once the in-flight chunk drained
        self._hold_since = 0.0
        # the streamed update's staging area (None = no update open)
        self._staged: dict[str, torch.Tensor] | None = None
        self._stage_target = config.weight_stage_target
        self._stage_gen_snapshot = 0
        self._stage_stream = None  # side CUDA stream of the device target's copies
        self._stage_buf: torch.Tensor | None = None  # reused host buffer of a bucket
        self._stage_buf_lock = threading.Lock()
        self.last_update_gen_tokens = 0  # tokens emitted from begin to commit
        # rids cancelled by abort_request, reaped by the loop between chunks
        self._abort_lock = threading.Lock()
        self._abort_rids: set[str] = set()
        self._shutdown = threading.Event()
        self._wakeup = threading.Event()
        self._queue: queue.Queue[_Task] = queue.Queue()
        self._backlog: deque[_Task] = deque()  # tasks popped but not admitted
        self._pending_weight_update: tuple | None = None
        self._weight_update_error: Exception | None = None
        self._weight_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._loop_error: BaseException | None = None
        self.initialized = False
        self._parked: dict[str, _Parked] = {}  # rid -> KV retained across an abort
        self.stats = {
            "generated_tokens": 0,
            "completed": 0,
            "aborted": 0,
            "cancelled": 0,
            "chunks": 0,
            "kv_resumes": 0,  # same-rid resubmits resumed from parked KV
            "deadline_reaped": 0,  # the JAX engine's "deadline_exceeded"
            "watchdog_fired": 0,
            "decode_steps": 0,
            "prefills": 0,
            "prefill_batches": 0,
            "suffix_prefill_batches": 0,  # of prefill_batches: warm (suffix-only) forwards
            "prefill_tokens": 0,
            "preempted": 0,
            "prefix_cache_hits": 0,
            "prefix_cache_misses": 0,
            "prefix_hit_tokens": 0,
            "prefix_shared": 0,
            "spec_rounds": 0,
            "spec_draft_tokens": 0,
            "spec_accepted_tokens": 0,
            "spec_rollback_pages": 0,
        }
        # device-stream time of prefill batches, decode chunks and spec
        # rounds, as CUDA event pairs read after the fact (never a sync on
        # the hot loop)
        self._prefill_events: list[tuple] = []
        self._vision_events: list[tuple] = []  # tower calls at admission (n = images)
        self._chunk_events: list[tuple] = []
        self._spec_events: list[tuple] = []
        self._radix: paged_kv.RadixPrefixCache | None = None  # built in initialize
        self._radix_flush_req: tuple[threading.Event, list[int]] | None = None
        # speculative decoding: non-None only while enabled
        self._spec_cfg = None
        self._drafter = None
        # registry counters beside the stats (observability/catalog.py)
        self._obs = obs_catalog.engine_metrics()
        self._obs_pc = obs_catalog.prefix_cache_metrics()
        self._obs_lc = obs_catalog.lifecycle_metrics()
        self._obs_spec = obs_catalog.speculative_metrics()
        # request timelines and the flight ring /debug/flight serves
        self.timeline = tl_mod.TimelineRecorder()
        self.flight = tl_mod.get_flight_recorder()
        self._hold_marked = False  # one FENCE_STALL mark per hold window
        self._wedge_dumped = False  # one flight dump per wedge episode
        # the decode-loop probe, built in initialize; _ktl is the current
        # pass's open timeline (decode thread only)
        self.kprobe: kernel_probe.KernelProbe | None = None
        self._ktl: kernel_probe.DecodeStepTimeline | None = None
        # decode-loop liveness: the last time the loop began a pass (the
        # wedge detector reads it from /health's thread)
        self._last_loop_ts = time.monotonic()
        # the drain: set = admission closed; a terminal drain cannot end
        self._draining = threading.Event()
        self._drain_terminal = False
        self._drain_summary: dict | None = None
        # setpoints applied through POST /autopilot/knobs, for /statusz
        self._autopilot_lock = threading.Lock()
        self._autopilot_knobs: dict[str, float] = {}
        self._autopilot_applied_at: float | None = None
        self._offloaded = False  # release_memory moved the weights to the host
        self._freq_enabled = bool(config.enable_frequency_penalty)
        self._quantized = config.quantization == "int8"
        # the served model's names, shapes and dtypes before int8
        # quantization: bf16-named updates are checked against these
        self._base_specs: dict | None = None
        # the adapters folded so far, by target ({} = none yet); None after a
        # full update, whose base may already hold merged adapters
        self._lora_prev: dict[str, tuple[torch.Tensor, torch.Tensor]] | None = {}

    @staticmethod
    def _check_supported(cfg: ServerConfig) -> None:
        """Refuse the options whose code paths are later slices of the port
        (ROADMAP.md Queue A)."""
        if cfg.quantization not in (None, "", "none", "int8"):
            raise ValueError(f"unknown quantization {cfg.quantization!r}")
        m = cfg.mesh
        if max(m.data, m.fsdp, m.seq, m.model, m.expert, m.pipe) > 1:
            raise NotImplementedError("serving on a multi-device mesh (tensor-parallel serving): ROADMAP Queue A "
                                      "item 6b")
        if cfg.kv_quantization not in (None, "", "none", "int8", "fp8"):
            raise ValueError(f"unknown kv_quantization {cfg.kv_quantization!r}")
        if cfg.weight_stage_target not in ("device", "host"):
            raise ValueError(f"unknown weight_stage_target {cfg.weight_stage_target!r}")

    # -- lifecycle --------------------------------------------------------
    def initialize(self) -> None:
        cfg = self.config
        if self.params is None:
            if not cfg.model_path:
                raise ValueError("ServerConfig.model_path or params is required")
            t0 = time.monotonic()
            mcfg = qwen.ModelConfig.from_hf_path(cfg.model_path)
            mcfg = replace(mcfg, dtype=cfg.dtype, remat=False)
            self.model, self.model_cfg = load_params_from_hf(cfg.model_path, mcfg, device=self.device)
            logger.info(f"loaded {cfg.model_path} in {time.monotonic() - t0:.1f}s")
        elif isinstance(self.params, qwen.QwenModel) and self.params.device == self.device:
            self.model = self.params
            self.model_cfg = self.model.cfg
        else:
            if self.model_cfg is None:
                raise ValueError("model_cfg is required with a state dict")
            self.model = qwen.QwenModel(self.model_cfg, self.device)
            load_params(self.model, self.params)
        self.params = None  # the engine serves self.model; no second copy
        self._base_specs = _param_specs(self.model)
        if self._quantized:
            # a QwenModel handed over is served, so quantized, in place
            qwen.quantize_model_int8(self.model)
        S = cfg.max_batch_size
        self._init_paged_cache()
        # host mirror of per-slot state; the authoritative copy between
        # chunks is on the device (self._dev_state)
        self._slot_task: list[_Task | None] = [None] * S
        # last time each slot made progress (admission or a token); the
        # per-slot watchdog compares it with lifecycle.watchdog_s
        self._slot_progress: list[float] = [0.0] * S
        self._state = {
            "ids": np.zeros(S, np.int64),
            "pos": np.zeros(S, np.int64),
            "active": np.zeros(S, bool),
            "remaining": np.zeros(S, np.int64),
            "temp": np.ones(S, np.float32),
            "greedy": np.zeros(S, bool),
            "top_k": np.full(S, -1, np.int64),
            "top_p": np.ones(S, np.float32),
            # stop tokens are honored only once remaining - 1 <= min_rem
            "min_rem": np.zeros(S, np.int64),
            "freq_pen": np.zeros(S, np.float32),
            "stop_ids": np.full((S, _MAX_STOP), -1, np.int64),
        }
        self._dev_state = {
            k: torch.from_numpy(v.copy()).to(self.device) for k, v in self._state.items()
        }
        # the frequency penalty's per-slot counts of generated tokens: on
        # the device only (the host never reads them), allocated only when
        # the penalty is enabled; restores due after the next slot update
        self._freq_counts: torch.Tensor | None = None
        self._pending_count_restore: list[tuple[int, np.ndarray]] = []
        self._init_freq_counts()
        seed = cfg.seed if cfg.seed is not None else time.time_ns() % (2**31)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        if cfg.speculative.enabled:
            self._spec_cfg = cfg.speculative
            self._drafter = spec_mod.build_drafter(cfg.speculative, radix=self._radix)
        # init-time: on the CPU the probe measures the host's peaks once
        self.kprobe = kernel_probe.KernelProbe(model_cfg=self.model_cfg, n_chips=1, device=self.device)
        self.initialized = True
        logger.info(
            f"decode engine ready on {self.device}: {S} slots x {cfg.max_seq_len} ctx, "
            f"{self.pool.n_pages} KV pages x {cfg.page_size} tokens"
        )

    def _init_freq_counts(self) -> None:
        """The [S, V] count table: uint16 values (saturating at 65,535, as the
        JAX engine's) in an int16 tensor, read back as ``& 0xFFFF``."""
        if self._freq_enabled:
            self._freq_counts = torch.zeros(
                (self.config.max_batch_size, self.model_cfg.vocab_size), dtype=torch.int16, device=self.device
            )

    def memory_bytes(self) -> dict:
        """Device bytes of the serving state beside the weights: the KV
        page pool and the frequency penalty's count table."""
        kv = sum(t.numel() * t.element_size() for t in self.cache.values()) if self.cache else 0
        fc = self._freq_counts
        return {"kv_pool": int(kv), "freq_counts": int(fc.numel() * fc.element_size()) if fc is not None else 0}

    def _init_paged_cache(self) -> None:
        """The page pool: page arrays on the device, allocator and block
        tables on the host. Size from ``kv_hbm_gb`` when set, else a
        dense-equivalent S x T tokens."""
        cfg, mcfg = self.config, self.model_cfg
        S, T, psz = cfg.max_batch_size, cfg.max_seq_len, cfg.page_size
        self._maxp = -(-T // psz)  # pages per sequence (ceil)
        kv_quant = cfg.kv_quantization if cfg.kv_quantization in ("int8", "fp8") else False
        if cfg.kv_hbm_gb is not None:
            n_pages = paged_kv.n_pages_for_budget(
                int(cfg.kv_hbm_gb * (1 << 30)),
                mcfg.num_layers,
                mcfg.num_kv_heads,
                psz,
                mcfg.head_dim_,
                torch.empty((), dtype=mcfg.torch_dtype).element_size(),
                quant=kv_quant,
            )
        else:
            n_pages = S * self._maxp + 1  # +1: trash page 0
        self.pool = paged_kv.PagePool(n_pages)
        self.cache = paged_kv.init_paged_cache(
            mcfg, n_pages, psz, quant=kv_quant, device=self.device
        )
        self._slot_pages: list[list[int]] = [[] for _ in range(S)]
        # policy version each slot page's KV was computed under (parallel to
        # _slot_pages): under the flush policy stale pages are never published
        self._slot_page_versions: list[list[int]] = [[] for _ in range(S)]
        self._pt_host = np.zeros((S, self._maxp), np.int32)
        pc = cfg.prefix_cache
        if pc.enabled and cfg.enable_prefix_caching:
            cap = pc.max_pages if pc.max_pages is not None else int((n_pages - 1) * pc.max_fraction)
            self._radix = paged_kv.RadixPrefixCache(self.pool, psz, max(0, min(cap, n_pages - 1)))
        else:
            self._radix = None

    def start(self) -> None:
        if not self.initialized:
            self.initialize()
        assert self._thread is None
        self._thread = threading.Thread(target=self._loop, name="decode-loop", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._shutdown.set()
        self._wakeup.set()
        if self._thread:
            self._thread.join(timeout=60)
            self._thread = None

    # -- request API (any thread) ----------------------------------------
    def submit(self, req: ModelRequest, callback: Callable[[ModelResponse], None]):
        if self._loop_error is not None:
            raise RuntimeError("decode loop failed") from self._loop_error
        # the timeline starts at submission, tagged with the x-areal-trace
        # ids the calling context carries (the server seats them)
        task_id, session_id = perf_tracer.get_task_context()
        tl = self.timeline.start(
            req.rid,
            priority=str(req.metadata.get("priority") or "interactive"),
            task_id=task_id,
            session_id=session_id,
        )
        self._queue.put(_Task(req=req, callback=callback, timeline=tl))
        self._wakeup.set()

    def generate_sync(self, req: ModelRequest, timeout: float = 600.0) -> ModelResponse:
        done = threading.Event()
        box: list[ModelResponse] = []

        def cb(resp):
            box.append(resp)
            done.set()

        self.submit(req, cb)
        if not done.wait(timeout):
            raise TimeoutError(f"generation timed out after {timeout}s")
        return box[0]

    def abort_request(self, rid: str) -> bool:
        """Cancel one request by rid, queued, decoding or parked
        (``decode_engine.py:857``). Thread-safe: the decode loop reaps the rid
        between chunks (the slot deactivated, its pages freed or published
        as a finished request's are, a parking's pages freed, the callback
        fired with stop_reason "cancelled"). Unknown rids are a no-op.
        Returns True when the rid was queued for cancellation (False for an
        empty rid)."""
        if not rid:
            return False
        with self._abort_lock:
            self._abort_rids.add(rid)
        self._wakeup.set()
        return True

    # -- the request lifecycle (decode_engine.py:871-1142) ------------------
    def _lifecycle(self):
        lc = self.config.lifecycle
        return lc if lc.enabled else None

    def admission_snapshot(self) -> dict:
        """Point-in-time admission-control inputs (the 429 payload and the
        /statusz lifecycle section). Any thread: the reads are racy but
        monotone, which a gate that need only be about right tolerates."""
        pool = getattr(self, "pool", None)
        return {
            "queue_depth": self._queue.qsize() + len(self._backlog),
            "free_pages": pool.available if pool is not None else 0,
            "radix_pages": self._radix.pages_held if self._radix is not None else 0,
            "n_pages": pool.n_pages if pool is not None else 0,
            "active_slots": sum(1 for t in getattr(self, "_slot_task", ()) if t is not None),
            "max_batch_size": self.config.max_batch_size,
        }

    def check_admission(self) -> tuple[bool, str, dict]:
        """The gate of new generation requests: (admit, reason, snapshot),
        ``reason`` naming the tripped gate ("draining" | "queue_depth" |
        "page_headroom"). A draining engine admits nothing, lifecycle config
        or not."""
        lc = self._lifecycle()
        snap = self.admission_snapshot()
        if self._draining.is_set():
            return False, "draining", snap
        if lc is None:
            return True, "", snap
        if lc.max_queue_depth > 0 and snap["queue_depth"] >= lc.max_queue_depth:
            return False, "queue_depth", snap
        # radix pages count as headroom: the first rung of the eviction ladder
        if lc.min_free_pages > 0 and snap["free_pages"] + snap["radix_pages"] < lc.min_free_pages:
            return False, "page_headroom", snap
        return True, "", snap

    def apply_autopilot_knobs(self, knobs: dict) -> dict:
        """Apply control-plane setpoints: the admission gates
        (``max_queue_depth``, ``min_free_pages``) and the radix cache's
        ``radix_max_fraction`` (a page cap; a running loop evicts LRU leaves
        down to a shrunk cap between chunks, a stopped engine at once).
        Unknown keys are ignored. Returns ``autopilot_status()``."""
        applied: dict[str, float] = {}
        lc = self.config.lifecycle
        for k in ("max_queue_depth", "min_free_pages"):
            if knobs.get(k) is not None:
                setattr(lc, k, max(0, int(knobs[k])))
                applied[k] = float(getattr(lc, k))
        frac = knobs.get("radix_max_fraction")
        if frac is not None and self._radix is not None:
            frac = max(0.0, min(1.0, float(frac)))
            n = self.pool.n_pages - 1
            self._radix.max_pages = max(0, min(int(n * frac), n))
            applied["radix_max_fraction"] = frac
            if self._thread is not None and self._thread.is_alive():
                self._wakeup.set()  # the tree belongs to the loop while it runs
            else:
                self._service_radix_cap()
        if applied:
            with self._autopilot_lock:
                self._autopilot_knobs.update(applied)
                self._autopilot_applied_at = time.time()
        return self.autopilot_status()

    def autopilot_status(self) -> dict:
        """The /statusz ``autopilot`` section: the setpoints applied (empty
        until the control plane pushes one)."""
        with self._autopilot_lock:
            return {"knobs": dict(self._autopilot_knobs), "applied_at": self._autopilot_applied_at}

    def _service_radix_cap(self) -> None:
        """Evict radix leaves down to a shrunk cap (the loop's thread, or
        inline while the loop is down)."""
        r = self._radix
        if r is not None and r.pages_held > r.max_pages:
            freed = r.evict(r.pages_held - r.max_pages)
            if freed:
                self._obs_pc.evicted_pages.inc(freed)

    def is_wedged(self) -> bool:
        """True when the decode loop made no pass for
        ``lifecycle.engine_stall_escalate_s`` while work is pending (the
        per-slot watchdog runs on that loop and cannot fire then), or when
        the loop died with work pending: /health answers 503. A paused or
        held loop idles by design and is never wedged. The first report of
        a wedge episode dumps the flight ring to disk (the replica is about
        to be evicted); a wedge that clears re-arms the dump."""
        lc = self._lifecycle()
        if lc is None or lc.engine_stall_escalate_s <= 0 or self._thread is None:
            return False
        busy = any(t is not None for t in getattr(self, "_slot_task", ())) or (
            self._queue.qsize() + len(self._backlog) > 0
        )
        if not self._thread.is_alive():
            wedged = busy
        elif self.is_paused:
            return False
        else:
            wedged = busy and time.monotonic() - self._last_loop_ts > lc.engine_stall_escalate_s
        if not wedged:
            self._wedge_dumped = False
        elif not self._wedge_dumped:
            self._wedge_dumped = True
            self.flight.record("wedge", severity="error")
            try:
                self.flight.dump(tl_mod.default_dump_path("wedge"), "wedge")
            except OSError:
                logger.exception("wedge flight dump failed")
        return wedged

    def _reap_lifecycle(self, pending: dict | None) -> dict | None:
        """Service cancellations, deadlines and the per-slot watchdog between
        chunks, on the decode loop (``decode_engine.py:1017``). Reaped
        requests leave through ``_finish`` with a non-abort reason, so their
        pages are freed or published as a completion's are. When anything is
        reaped the chunk in flight is drained first (its tokens credited with
        their version tags); the no-reap path touches nothing. Takes and
        returns the loop's in-flight chunk."""
        lc = self._lifecycle()
        with self._abort_lock:
            aborts, self._abort_rids = self._abort_rids, set()
        if lc is None and not aborts:
            return pending
        now = time.time()

        def expired(task: _Task) -> bool:
            dl = task.req.deadline
            return lc is not None and dl is not None and now > dl

        def watchdog_hit(slot: int) -> bool:
            return (
                lc is not None
                and lc.watchdog_s > 0
                and bool(self._state["active"][slot])
                and self._slot_progress[slot] > 0
                and time.monotonic() - self._slot_progress[slot] > lc.watchdog_s
            )

        hit = bool(aborts) or any(expired(t) for t in self._backlog) or any(
            t is not None and (expired(t) or watchdog_hit(slot)) for slot, t in enumerate(self._slot_task)
        )
        if not hit:
            # a queued request's deadline is also enforced at admission
            return pending
        self._drain(pending)
        while True:  # queued work first, in the order _admit_pending takes it
            try:
                self._backlog.append(self._queue.get_nowait())
            except queue.Empty:
                break
        kept: deque[_Task] = deque()
        counted: set[str] = set()  # rids whose cancel _finish already counted
        for task in self._backlog:
            if task.req.rid and task.req.rid in aborts:
                task.truncated_by = "cancelled"
                counted.add(task.req.rid)
                self._finish(task, StopReason.CANCEL.value)
            elif expired(task):
                task.truncated_by = "deadline"
                self._finish(task, StopReason.DEADLINE.value)
            else:
                kept.append(task)
        self._backlog = kept
        st = self._state
        rows = []
        for slot, task in enumerate(self._slot_task):
            if task is None:
                continue
            if task.req.rid and task.req.rid in aborts:
                task.truncated_by = "cancelled"
                counted.add(task.req.rid)
                reason = StopReason.CANCEL.value
            elif expired(task):
                task.truncated_by = "deadline"
                reason = StopReason.DEADLINE.value
            elif watchdog_hit(slot):
                task.truncated_by = "watchdog"
                reason = StopReason.CANCEL.value
                self.stats["watchdog_fired"] += 1
                self._obs_lc.watchdog_fired.inc()
                self.flight.record("watchdog", severity="error", slot=slot, rid=task.req.rid)
                logger.warning(
                    f"slot {slot} watchdog: no token in {lc.watchdog_s:.1f}s (rid={task.req.rid}); aborting the slot"
                )
            else:
                continue
            if st["active"][slot]:
                rows.append(self._pack_row(slot, 0, int(st["pos"][slot]), False, 0))
            self._finish(task, reason)
        if rows and self.cache is not None:
            self._apply_slot_updates(rows)
        # a cancelled parking frees its pages (deadlines leave a parking
        # alone: its owner may still resume; eviction pressure bounds it)
        for rid in aborts:
            p = self._parked.pop(rid, None)
            if p is not None:
                self._drop_parking(p)
                if rid not in counted:
                    self.stats["cancelled"] += 1
                    self._obs_lc.aborts.inc()
        return None  # the chunk in flight was drained above

    # -- pause / weights --------------------------------------------------
    def pause_generation(self, mode: str = "abort", timeout: float = 10.0) -> None:
        """Stop the decode loop until ``continue_generation``.

        mode "abort": in-flight requests complete with stop_reason "abort"
        and their partial tokens, and their full pages go into the radix
        tree, so the client's resubmit of prompt + emitted prefills only its
        suffix. Returns once the running loop has ended them (at most
        ``timeout`` seconds), so a version set right after the pause tags
        only later tokens.

        mode "hold", the commit fence (``decode_engine.py:1143``): the loop
        finishes its in-flight chunk and idles without aborting anything;
        returns at once (``wait_fence_ack`` waits for the drain)."""
        if mode == "hold":
            self._hold_ack.clear()
            self._hold_since = time.monotonic()
            self._held.set()
            self._wakeup.set()
            return
        if mode != "abort":
            raise ValueError(f"unknown pause mode {mode!r}")
        self._paused.set()
        self._wakeup.set()
        if self._thread is not None and self._thread.is_alive():
            self._pause_ack.wait(timeout)

    def wait_fence_ack(self, timeout: float = 10.0) -> bool:
        """Block until the loop has reached the hold fence (its in-flight
        chunk drained); True at once when the loop is not running."""
        if self._thread is None or not self._thread.is_alive():
            return True
        return self._hold_ack.wait(timeout)

    def continue_generation(self) -> None:
        self._paused.clear()
        self._held.clear()
        self._pause_ack.clear()
        self._hold_ack.clear()
        self._wakeup.set()

    @property
    def is_paused(self) -> bool:
        return self._paused.is_set() or self._held.is_set()

    @property
    def is_abort_paused(self) -> bool:
        """The abort pause only: a hold keeps its slots live."""
        return self._paused.is_set()

    # -- the drain (decode_engine.py:1191-1329) -------------------------------
    @property
    def is_draining(self) -> bool:
        return self._draining.is_set()

    def begin_drain(self, terminal: bool = False) -> None:
        """Close admission (``check_admission`` answers "draining") while
        in-flight decodes keep running. ``terminal`` marks the drain of an
        exiting process, which can never end; it is sticky."""
        if terminal:
            self._drain_terminal = True
        if not self._draining.is_set():
            self._draining.set()
            self.flight.record("drain_begin", severity="warn", terminal=bool(terminal))
        self._wakeup.set()

    def end_drain(self) -> bool:
        """Re-open admission; refused (False) for a terminal drain."""
        if self._drain_terminal:
            logger.warning("end_drain refused: this drain is terminal (the process is exiting)")
            return False
        self._draining.clear()
        return True

    def drain(self, budget_s: float = 10.0, terminal: bool = False) -> dict:
        """Stop admission, let in-flight decodes finish within ``budget_s``,
        then park (rid affinity, partial tokens returned) or abort the
        survivors and the queue. Blocks until the engine is quiescent and
        returns (and keeps for /statusz) a summary with the page audit:
        ``leaked_pages`` counts pool pages held by neither the radix tree nor
        a parking, ``unterminated_timelines`` requests that left without a
        terminal mark. Any thread."""
        t0 = time.monotonic()
        self.begin_drain(terminal=terminal)
        aborted_before = self.stats["aborted"]
        deadline = t0 + max(0.0, budget_s)
        finished_in_budget = True
        while True:
            loop_alive = self._thread is not None and self._thread.is_alive()
            busy = any(t is not None for t in self._slot_task) or (self._queue.qsize() + len(self._backlog) > 0)
            if not busy:
                break
            if not loop_alive or self.is_paused or time.monotonic() >= deadline:
                # nothing finishes on its own (or the budget is spent)
                finished_in_budget = False
                break
            time.sleep(0.02)
        if self._thread is not None and self._thread.is_alive():
            # the abort pause parks the survivors; the paused loop, seeing
            # the drain, aborts the queue
            self.pause_generation(timeout=max(5.0, budget_s))
            qdeadline = time.monotonic() + 5.0
            while self._queue.qsize() + len(self._backlog) > 0 and time.monotonic() < qdeadline:
                self._wakeup.set()
                time.sleep(0.01)
        else:
            # no loop: this thread owns the state
            self._paused.set()
            self._abort_all()
            self._abort_queued()
        # a parked request's full pages are also published into the radix
        # tree: count each held page once (the JAX summary's sum counts such
        # a page twice and can go negative)
        held = set(self._radix.pages()) if self._radix is not None else set()
        for p in list(self._parked.values()):
            held.update(p.pages)
        summary = {
            "draining": True,
            "drain_seconds": time.monotonic() - t0,
            "finished_in_budget": finished_in_budget,
            "budget_s": budget_s,
            "parked": len(self._parked),
            "aborted": self.stats["aborted"] - aborted_before,
            "leaked_pages": int(self.pool.used - len(held)),
            "unterminated_timelines": self.timeline.stats()["unterminated"],
        }
        self._drain_summary = summary
        self.flight.record(
            "drain_end",
            severity="warn",
            seconds=round(summary["drain_seconds"], 3),
            parked=summary["parked"],
            aborted=summary["aborted"],
            leaked_pages=summary["leaked_pages"],
        )
        logger.warning(
            f"drain complete in {summary['drain_seconds']:.2f}s (finished_in_budget={finished_in_budget}, "
            f"parked={summary['parked']}, aborted={summary['aborted']}, leaked_pages={summary['leaked_pages']})"
        )
        return summary

    def drain_status(self) -> dict:
        """The /statusz drain section: the live flag, whether the drain is
        terminal, and the last drain's summary."""
        out = dict(self._drain_summary) if self._drain_summary is not None else {}
        out["draining"] = self._draining.is_set()
        out["terminal"] = bool(self._drain_terminal)
        return out

    # -- memory release (decode_engine.py:1651-1704) ------------------------
    def release_memory(self) -> None:
        """Free the card for a colocated trainer: the served weights go to
        pinned host memory and the KV pool, the count table and every
        parking are dropped (the loop idles with no cache until
        ``resume_memory``). Needs the abort pause; waits for its ack."""
        if not self._paused.is_set():
            raise RuntimeError("pause_generation before release_memory")
        if self._thread is not None and self._thread.is_alive() and not self._pause_ack.wait(timeout=120):
            raise TimeoutError("decode loop did not acknowledge the pause")
        if self._offloaded:
            return
        t0 = time.monotonic()
        while self._evict_oldest_parked() is not None:
            pass
        offload.offload_module(self.model)
        self._offloaded = True
        self.cache = None  # pages are recreated by prefills; parked KV is lost
        self._freq_counts = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        logger.info(f"released memory in {time.monotonic() - t0:.2f}s")

    def resume_memory(self) -> None:
        """Bring the weights back to the card and build a fresh KV pool."""
        if not self._offloaded:
            return
        t0 = time.monotonic()
        offload.onload_module(self.model, self.device)
        self._init_paged_cache()  # a fresh pool: every request was aborted
        self._init_freq_counts()
        if self._spec_cfg is not None:
            self._drafter = spec_mod.build_drafter(self._spec_cfg, radix=self._radix)
        self._offloaded = False
        logger.info(f"resumed memory in {time.monotonic() - t0:.2f}s")

    def update_weights_from_params(self, params, version: int | None = None) -> None:
        """Swap in new weights (a ``QwenModel`` or a state dict) between
        chunks; tokens of later chunks carry ``version``. Blocks until the
        decode loop has applied them."""
        self._run_weight_update(("params", params), version)

    def update_weights_lora(self, flat: dict, scale: float, version: int | None = None) -> None:
        """Fold adapter deltas into the served base weights between chunks,
        without the whole tree (``decode_engine.py:1356``): ``flat`` holds
        ``layers/<t>_lora_a`` [n, in, r] and ``layers/<t>_lora_b`` [n, r,
        out] for some targets t, and the fold is cumulative, W += scale (A B
        - A_prev B_prev) in f32. The engine must have started from the
        adapter-free base; a fold after a full update, on an int8 engine or
        for an unknown target raises and changes no weight. Blocks until
        applied."""
        self._run_weight_update(("lora", (flat, float(scale))), version)

    def _apply_lora_delta(self, flat: dict, scale: float) -> None:
        prev = self._lora_prev
        if prev is None:
            raise RuntimeError(
                "lora_only update after a full weight update: the serving base is no longer the adapter-free "
                "checkpoint; push full updates (lora_only=False) or restart servers from the base"
            )
        cfg = self.model_cfg
        layers = self.model.layers
        tensors = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v)) for k, v in flat.items()}
        targets = sorted({k.split("/")[-1].rsplit("_lora_", 1)[0] for k in tensors})
        # every check before the first fold
        for t in targets:
            for s in ("a", "b"):
                if f"layers/{t}_lora_{s}" not in tensors:
                    raise ValueError(f"lora bucket missing layers/{t}_lora_{s}")
            w = layers[0]._parameters.get(t)
            if w is None or w.dim() != 2 or t not in qwen.DENSE_MATRICES:
                raise ValueError(f"unknown lora target {t!r}")
            a_s, b_s = tuple(tensors[f"layers/{t}_lora_a"].shape), tuple(tensors[f"layers/{t}_lora_b"].shape)
            w_s = (cfg.num_layers, w.shape[1], w.shape[0])  # the JAX [n, in, out]
            if len(a_s) != 3 or len(b_s) != 3 or (a_s[0], a_s[1], b_s[2]) != w_s or a_s[2] != b_s[1]:
                raise ValueError(f"lora shapes {a_s}x{b_s} do not fold into {t} {w_s}")
        new_prev = {}
        with torch.no_grad():
            for t in targets:
                a = tensors[f"layers/{t}_lora_a"].to(self.device, torch.float32)
                b = tensors[f"layers/{t}_lora_b"].to(self.device, torch.float32)
                pa, pb = prev.get(t, (torch.zeros_like(a), torch.zeros_like(b)))
                # [n, out, in]: the port's layout of A B - A_prev B_prev
                delta = torch.einsum("nir,nro->noi", a, b) - torch.einsum("nir,nro->noi", pa, pb)
                for layer, d in zip(layers, delta):
                    w = getattr(layer, t)
                    w.copy_((w.float() + scale * d).to(w.dtype))
                new_prev[t] = (a, b)
        # merged, not replaced: targets absent from this bucket keep their state
        self._lora_prev = {**prev, **new_prev}

    def _write_weights(self, srcs: dict[str, torch.Tensor], non_blocking: bool = False) -> None:
        """Copy checked sources into the served parameters in place. A
        base-named target of an int8 engine is cast to the serving dtype on
        the card and re-quantized into its ``_q8`` / ``_scale`` pair."""
        own = dict(self.model.named_parameters())
        with torch.no_grad():
            for name, src in srcs.items():
                p = own.get(name)
                if p is not None:
                    p.copy_(src, non_blocking=non_blocking)
                    continue
                w = src.to(self.device, self.model_cfg.torch_dtype, non_blocking=non_blocking)
                q8, sc = qwen.quantize_dense_int8(w)
                own[f"{name}_q8"].copy_(q8)
                own[f"{name}_scale"].copy_(sc)

    def update_weights_from_disk(self, path: str, version: int | None = None) -> None:
        """Reload the weights from the HF checkpoint at ``path`` between
        chunks, in place (every name and shape checked first: a checkpoint
        that does not fit raises and changes no weight); tokens of later
        chunks carry ``version``. The loop is blocked for the whole load, as
        in the JAX engine. Blocks until applied."""
        self._run_weight_update(("disk", path), version)

    def _run_weight_update(self, payload: tuple, version: int | None) -> None:
        """Hand ``payload`` to the decode loop and wait until it applied it
        (applied here when the loop is not running); re-raises its error."""
        with self._weight_lock:
            self._pending_weight_update = (payload, version)
        self._wakeup.set()
        if self._thread is None:
            self._apply_weight_update()
        else:
            while True:
                with self._weight_lock:
                    if self._pending_weight_update is None:
                        break
                if self._loop_error is not None:
                    raise RuntimeError("decode loop failed") from self._loop_error
                time.sleep(0.005)
        with self._weight_lock:
            err, self._weight_update_error = self._weight_update_error, None
        if err is not None:
            raise err

    def _apply_weight_update(self) -> None:
        with self._weight_lock:
            upd = self._pending_weight_update
            if upd is None:
                return
            (kind, params), version = upd
            t0 = time.monotonic()
            try:
                # in place: the copy is ordered on the stream after the
                # chunk in flight, which keeps reading the old weights
                if kind == "lora":
                    if self._quantized:
                        raise RuntimeError(
                            "lora_only updates cannot fold into int8-quantized serving weights; push full "
                            "updates or serve with quantization='none'"
                        )
                    self._apply_lora_delta(*params)
                else:
                    # the fold's base is unknown after a full update: it may
                    # already hold merged adapters
                    self._lora_prev = None
                if kind == "params":
                    self._write_weights(_checked_sources(self._base_specs, params))
                elif kind == "disk" and self._quantized:
                    loaded, _ = load_params_from_hf(params, self.model_cfg, device=self.device, vision_seed=None)
                    # an export without visual.* (the trainer's) leaves the served tower as it is
                    keep_tower = self.model_cfg.vision is not None and not checkpoint_has_vision(params)
                    self._write_weights({n: p for n, p in loaded.named_parameters()
                                         if not (keep_tower and n.startswith("vision."))})
                    del loaded
                elif kind == "disk":
                    load_params_from_hf(params, model=self.model, vision_seed=None)
                elif kind == "staged":
                    self._copy_staged(params)
                if version is not None:
                    self._version = version
                # both commit paths (params and staged) apply here: parked KV
                # survives the commit unless kv_reuse_across_updates is off
                if not self.config.kv_reuse_across_updates:
                    while self._evict_oldest_parked() is not None:
                        pass
                # KV cached under the old weights is stale: the default policy
                # drops the tree (pages aliased by live slots survive until
                # those slots free them); "keep" retains it
                if self._radix is not None and self.config.prefix_cache.across_updates == "flush":
                    self._radix.flush()
                self.flight.record(
                    "weight_commit", update_kind=kind, version=self._version, secs=round(time.monotonic() - t0, 4)
                )
            except Exception as e:  # noqa: BLE001 — a bad payload fails that
                # update (the waiter re-raises), not the decode loop
                self._weight_update_error = e
                logger.error(f"weight update failed: {type(e).__name__}: {e}")
            self._pending_weight_update = None

    # -- the streamed weight update -----------------------------------------
    def begin_staged_update(self, stage_target: str | None = None) -> None:
        """Open a staging area for streamed buckets; generation keeps
        running. ``stage_target`` overrides ``weight_stage_target`` for this
        update: "device" copies each bucket to the card as it arrives (a
        second copy of the weights until the commit), "host" keeps the
        buckets in pinned host memory and copies them inside the commit."""
        target = stage_target or self.config.weight_stage_target
        if target not in ("device", "host"):
            raise ValueError(f"unknown weight_stage_target {target!r}")
        with self._weight_lock:
            self._staged = {}
            self._stage_target = target
            self._stage_gen_snapshot = self.stats["generated_tokens"]
        self.flight.record("weight_stage", target=target)

    @contextlib.contextmanager
    def stage_buffer(self, nbytes: int):
        """A host uint8 buffer of ``nbytes`` to read one bucket's body into
        (pinned on a card, so the copy to the device runs on a side stream).
        The device target reuses one buffer, held until the bucket staged
        (its tensors are copied out); the host target keeps each bucket's
        buffer as its staged storage."""
        pin = self.device.type == "cuda"
        if self._stage_target == "host":
            yield torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
            return
        with self._stage_buf_lock:
            if self._stage_buf is None or self._stage_buf.numel() < nbytes:
                self._stage_buf = None
                self._stage_buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
            yield self._stage_buf[:nbytes]

    def stage_weight_bucket(self, flat: dict[str, torch.Tensor]) -> None:
        """Stage one decoded bucket without touching the served weights. The
        device target copies it to the card on a side stream and returns
        once the copies landed (the decode stream never queues behind them);
        the host target keeps the tensors as they are."""
        if not self._quantized and _served_form(flat):
            raise RuntimeError(
                "q8-wire weight update against a non-quantized engine; set ServerConfig.quantization='int8' or "
                "use wire_format='bf16'"
            )
        with self._weight_lock:
            if self._staged is None:
                raise RuntimeError("no staged update open (begin_staged_update first)")
            target = self._stage_target
        if target == "host":
            staged = dict(flat)
        elif self.device.type == "cuda":
            if self._stage_stream is None:
                self._stage_stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._stage_stream):
                staged = {n: t.to(self.device, non_blocking=True) for n, t in flat.items()}
            done = torch.cuda.Event()
            done.record(self._stage_stream)
            done.synchronize()
        else:
            staged = {n: t.clone() for n, t in flat.items()}
        with self._weight_lock:
            if self._staged is not None:  # None: aborted meanwhile
                self._staged.update(staged)

    def commit_staged_weights(self, version: int | None = None) -> None:
        """Apply the staged update between chunks and tag later tokens with
        ``version``. Every name and shape is checked first: a mismatch
        raises and changes no weight. A retried commit of the version
        already applied (its answer lost on the wire) acks."""
        with self._weight_lock:
            flat, self._staged = self._staged, None
            target = self._stage_target
        if not flat:
            if version is not None and self._version == int(version):
                logger.info(f"commit v{version} retried after it already applied; acking")
                return
            raise AssertionError("no staged weights")
        # the served form is decided here, once: a q8-wire update is checked
        # against the served structure and copied as it is, a bf16 one
        # against the base structure (re-quantized on an int8 engine)
        if _served_form(flat):
            srcs = _checked_sources(_param_specs(self.model), flat, exact_dtype=True)
        else:
            srcs = _checked_sources(self._base_specs, flat)
        self._run_weight_update(("staged", (srcs, target)), version)
        self.last_update_gen_tokens = self.stats["generated_tokens"] - self._stage_gen_snapshot

    def _copy_staged(self, staged: tuple) -> None:
        """Copy checked staged tensors into the served parameters in place
        (on the decode loop's stream, after the chunk in flight)."""
        srcs, target = staged
        cuda = self.device.type == "cuda"
        self._write_weights(srcs, non_blocking=cuda)
        if cuda:
            stream = torch.cuda.current_stream(self.device)
            if target == "host":
                stream.synchronize()  # the pinned buffers go when this returns
            else:
                for t in srcs.values():  # made on the side stream, read here
                    t.record_stream(stream)

    def abort_staged_update(self) -> None:
        """Drop a partially staged update; serving weights and version stay
        as they are. Safe when nothing is staged."""
        with self._weight_lock:
            self._staged = None

    def set_version(self, v: int) -> None:
        self._version = v

    def get_version(self) -> int:
        return self._version

    # -- the device-memory ledger (decode_engine.py:1712) -------------------
    def hbm_ledger(self, override_hbm_gb: float | None = None) -> dict:
        """Itemized device memory of this replica: the weights, the KV page
        pool, the radix cache's held pages (a view into the pool, left out
        of the itemized total), a staged weight update, and the frequency
        penalty's count table; beside the card's own view
        (``torch.cuda.memory_stats`` / ``mem_get_info``), or the analytic
        sums on the CPU. Any thread: it reads sizes and allocator counters,
        never a tensor's values."""
        cache = self.cache
        kv_bytes = hw.tree_bytes(cache)
        pool = getattr(self, "pool", None)
        page_bytes = kv_bytes / pool.n_pages if pool is not None and pool.n_pages else 0
        radix_pages = self._radix.pages_held if self._radix is not None else 0
        with self._weight_lock:
            staged = dict(self._staged) if self._staged else None
        on_card = self.model is not None and not self._offloaded
        components = {
            "params": hw.tree_bytes(self.model) if on_card else 0,
            "kv_page_pool": kv_bytes,
            "radix_cache": int(radix_pages * page_bytes),
            "staged_update": hw.tree_bytes(staged) if self._stage_target == "device" else 0,
            "freq_counts": hw.tree_bytes(self._freq_counts),
        }
        return hw.build_hbm_ledger(
            components,
            device=self.device,
            override_hbm_gb=override_hbm_gb,
            exclude_from_total=("radix_cache",),
        )

    # -- the decode-loop probe ---------------------------------------------
    def _kphase(self, name: str):
        """A phase span on the current pass's probe timeline; a null context
        outside a recorded pass (shutdown, direct calls from tests). Two
        clock reads per span, never a device sync."""
        tl = self._ktl
        if tl is None:
            return contextlib.nullcontext()
        return tl.phase(name)

    def _abandon_kstep(self) -> None:
        """Discard the current pass's timeline (an idle, paused or held pass,
        or no cache): every recorded step is a pass that did chunk work."""
        if self._ktl is not None and self.kprobe is not None:
            self.kprobe.abandon_step(self._ktl)
        self._ktl = None

    def _close_kstep(self, step_tl, productive, tokens: int, cost_key) -> None:
        """Complete the pass's timeline when it did chunk work, else
        abandon it."""
        if step_tl is None:
            return
        if productive:
            self._ktl = None
            self.kprobe.complete_step(step_tl, tokens=tokens, cost_key=cost_key)
        else:
            self._abandon_kstep()

    def kernel_stats(self) -> dict:
        """The probe's summary for /statusz ``kernels`` ({} before
        initialize)."""
        if self.kprobe is None:
            return {}
        return self.kprobe.stats()

    def _register_cost(self, key: tuple, costs: dict) -> None:
        """Record the analytic cost of a program shape once (a dict lookup
        after the first time)."""
        if self.kprobe is not None and self.kprobe.cost_for(key) is None:
            self.kprobe.record_cost(key, costs["flops"], costs["bytes"], "analytic")

    # -- prefix cache (cross-request radix reuse) --------------------------
    def prefix_cache_stats(self) -> dict:
        """Point-in-time radix-cache state (``decode_engine.py:1741``)."""
        if self._radix is None:
            return {"enabled": False}
        return {
            "enabled": True,
            "pages_held": self._radix.pages_held,
            "max_pages": self._radix.max_pages,
            "page_size": self.config.page_size,
            **self._radix.stats,
            # counted once per admitted request, not per backlog retry
            "hits": self.stats["prefix_cache_hits"],
            "misses": self.stats["prefix_cache_misses"],
            "hit_tokens": self.stats["prefix_hit_tokens"],
        }

    def flush_prefix_cache(self, timeout: float = 10.0) -> int:
        """Drop every radix-cached page (``POST /flush_prefix_cache``). The
        tree belongs to the decode loop, so a running loop performs the flush
        between chunks; this call only hands it the request. Returns the
        pages dropped (0 on timeout or when the cache is off)."""
        if self._radix is None:
            return 0
        if self._thread is None or not self._thread.is_alive():
            return self._radix.flush()
        with self._weight_lock:
            req = self._radix_flush_req
            if req is None:  # concurrent callers share one request
                req = (threading.Event(), [])
                self._radix_flush_req = req
        ev, box = req
        self._wakeup.set()
        ev.wait(timeout)
        return box[0] if box else 0

    def _service_radix_flush(self) -> None:
        with self._weight_lock:
            req, self._radix_flush_req = self._radix_flush_req, None
        if req is None:
            return
        ev, box = req
        box.append(self._radix.flush() if self._radix is not None else 0)
        ev.set()

    def pool_audit(self) -> dict:
        """Page accounting of the pool (call while no request is being
        admitted or decoded): every allocated page's refcount equals the
        number of live slots and parkings holding it plus one if the radix
        tree holds it, and free + allocated == total. ``ok`` is that check.
        Also the device bytes of the KV pool and of the frequency penalty's
        count table."""
        holders: dict[int, int] = {}
        parked = [p.pages for p in self._parked.values()]
        for pages in self._slot_pages + parked:
            for p in pages:
                holders[p] = holders.get(p, 0) + 1
        radix_pages = self._radix.pages() if self._radix is not None else []
        for p in radix_pages:
            holders[p] = holders.get(p, 0) + 1
        rc = self.pool._rc
        allocated = [p for p in range(1, self.pool.n_pages) if rc[p] > 0]
        ok = (
            all(int(rc[p]) == holders.get(p, 0) for p in range(1, self.pool.n_pages))
            and self.pool.available + len(allocated) == self.pool.n_pages - 1
        )
        return {
            "total": self.pool.n_pages - 1,
            "free": self.pool.available,
            "slot_pages": len({p for pages in self._slot_pages for p in pages}),
            "parked_pages": len({p for pages in parked for p in pages}),
            "radix_pages": len(radix_pages),
            "ok": ok,
            **{f"{k}_bytes": v for k, v in self.memory_bytes().items()},
        }

    # -- speculative decoding ---------------------------------------------
    def set_speculative(self, enabled: bool) -> None:
        """Switch speculative decoding on or off from the next loop pass
        (``decode_engine.py:3263``); a spec pass always drains the pipelined
        chunk before its own round."""
        spec = self.config.speculative
        spec.enabled = bool(enabled)
        if enabled:
            self._drafter = spec_mod.build_drafter(spec, radix=self._radix)
            self._spec_cfg = spec
        else:
            self._spec_cfg = None
            self._drafter = None
        self._wakeup.set()

    # -- timing (device stream) -------------------------------------------
    def device_seconds(self) -> dict:
        """Summed device-stream seconds of prefill batches, decode chunks and
        speculative rounds recorded so far (CUDA only; synchronizes on the
        recorded events)."""
        def total(evs):
            s = 0.0
            for e0, e1, _ in evs:
                e1.synchronize()
                s += e0.elapsed_time(e1) / 1000.0
            return s

        return {
            "prefill_s": total(self._prefill_events),
            "prefill_tokens": sum(n for _, _, n in self._prefill_events),
            "decode_s": total(self._chunk_events),
            "decode_steps": sum(n for _, _, n in self._chunk_events),
            "spec_s": total(self._spec_events),
            "spec_rounds": len(self._spec_events),
            "vision_s": total(self._vision_events),
            "vision_images": sum(n for _, _, n in self._vision_events),
        }

    def _event_pair_start(self):
        if self.device.type != "cuda":
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _event_pair_end(self, e0, store: list, n: int) -> None:
        if e0 is None:
            return
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record()
        store.append((e0, e1, n))

    # -- host <-> device ---------------------------------------------------
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Upload without waiting for the work in flight: pinned staging +
        non_blocking copy (PyTorch's pinned-memory cache keeps the staging
        buffer alive until the copy has run)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    # -- admission --------------------------------------------------------
    def _parked_slots(self) -> set[int]:
        return {p.slot for p in self._parked.values()}

    def _free_slots(self) -> list[int]:
        parked = self._parked_slots()
        return [i for i, t in enumerate(self._slot_task) if t is None and i not in parked]

    def _drop_parking(self, p: _Parked) -> None:
        """Free a parking's pages (its entry already popped)."""
        self.pool.free(p.pages)
        self._slot_pages[p.slot] = []
        self._slot_page_versions[p.slot] = []
        self._pt_host[p.slot] = 0

    def _evict_oldest_parked(self) -> int | None:
        """Free the least recently parked slot and its pages (a resume of
        that rid falls back to a prefill); its slot, or None."""
        if not self._parked:
            return None
        rid = min(self._parked, key=lambda r: self._parked[r].park_time)
        p = self._parked.pop(rid)
        self._drop_parking(p)
        return p.slot

    def _try_resume(self, task: _Task) -> np.ndarray | None:
        """rid affinity (``decode_engine.py:2440``): when this rid's abort
        left its slot's KV parked and the resubmitted ids are exactly prompt
        + emitted, restore the decode state with zero prefill; the slot's
        update row, or None. A rid resubmitted with other ids drops its
        parking."""
        rid = task.req.rid
        p = self._parked.pop(rid, None) if rid else None
        if p is None:
            return None
        ids = list(task.req.input_ids)
        if ids != p.full_ids:
            self.pool.free(p.pages)  # the slot's own lists were emptied at park
            return None
        slot = p.slot
        if task.timeline is not None:
            # the abort-pause round trip this resume closes, on the resumed
            # attempt (the aborted one terminated with stop_reason "abort")
            park_s = max(0.0, time.monotonic() - p.park_time)
            task.timeline.park_s += park_s
            task.timeline.mark(tl_mod.RESUME, park_s=round(park_s, 6))
        task.slot = slot
        self._slot_task[slot] = task
        # page ownership and the block-table row (zeroed at park time, so a
        # chunk in flight could not write into the retained pages)
        self._slot_pages[slot] = p.pages
        self._slot_page_versions[slot] = list(p.page_versions)
        self._pt_host[slot] = 0
        self._pt_host[slot, : len(p.pages)] = p.pages
        row = self._slot_update_row(task, slot, ids[-1], p.pos, self._budget(task, len(ids)))
        if self._freq_counts is not None and self._effective_freq_pen(task) != 0.0 and p.n_emitted:
            # one logical request across the abort: the completion tokens
            # emitted before the park keep their counts; the slot update
            # zeroes the slot, so the restore applies right after it
            counts = np.bincount(np.asarray(ids[-p.n_emitted :], np.int64), minlength=self.model_cfg.vocab_size)
            self._pending_count_restore.append((slot, np.minimum(counts, _COUNT_MAX)))
        self.stats["kv_resumes"] += 1
        return row

    def _admit_pending(self) -> list[np.ndarray]:
        """Admit backlog + queue into slots (``decode_engine.py:2492``): parked
        rids resume in place; identical prompts of this pass prefill once and
        alias (duplicates);
        primaries with a radix-cached prefix prefill only their suffix; the
        rest batch-prefill by length bucket. Returns the slot-update rows."""
        T = self.config.max_seq_len
        psz = self.config.page_size
        rows: list[np.ndarray] = []
        to_prefill: list[tuple[_Task, int]] = []
        free = self._free_slots()
        while not self._paused.is_set():
            if self._backlog:
                task = self._backlog.popleft()
            else:
                try:
                    task = self._queue.get_nowait()
                except queue.Empty:
                    break
            P_len = len(task.req.input_ids)
            if P_len >= T - 2 or P_len == 0:
                self._finish(task, StopReason.LENGTH.value)
                continue
            dl = task.req.deadline
            if self._lifecycle() is not None and dl is not None and time.time() > dl:
                # expired while queued: no prefill for a spent budget
                task.truncated_by = "deadline"
                self._finish(task, StopReason.DEADLINE.value)
                continue
            row = self._try_resume(task)
            if row is not None:
                rows.append(row)
                continue
            if not free:
                evicted = self._evict_oldest_parked()
                if evicted is None:
                    self._backlog.appendleft(task)  # all slots busy
                    break
                free.append(evicted)
            to_prefill.append((task, free.pop(0)))

        # identical prompts (a GRPO group's samples): the first prefills,
        # the others alias its pages after it; an image request never takes
        # part (its KV depends on the image too)
        primaries: list[tuple[_Task, int]] = []
        dup_pairs: list[tuple[_Task, int, int]] = []  # (task, slot, src_slot)
        first_slot: dict[tuple, int] = {}
        for task, slot in to_prefill:
            key = tuple(task.req.input_ids)
            if task.req.image_data is None and key in first_slot:
                dup_pairs.append((task, slot, first_slot[key]))
            else:
                if task.req.image_data is None:
                    first_slot[key] = slot
                primaries.append((task, slot))

        cold: list[tuple[_Task, int]] = []
        warm: list[tuple[_Task, int, list[int], list[int]]] = []
        with self._kphase("radix_match"):
            for task, slot in primaries:
                m = self._radix_match(task)
                if m is None:
                    cold.append((task, slot))
                else:
                    warm.append((task, slot, *m))

        def batched(groups: dict, run) -> None:
            for _, group in sorted(groups.items()):
                i = 0
                while i < len(group):
                    A = next(a for a in _PREFILL_SIZES if a <= len(group) - i)
                    rows.extend(run(group[i : i + A]))
                    i += A

        by_bucket: dict[int, list] = {}
        for task, slot in cold:
            bucket = min(T, round_up_to_bucket(len(task.req.input_ids), 256))
            by_bucket.setdefault(bucket, []).append((task, slot))
        with self._kphase("prefill"):
            batched(by_bucket, self._prefill_group)
        # warm admissions group by SUFFIX bucket, the only tokens prefilled
        warm_by_bucket: dict[int, list] = {}
        for w in warm:
            sfx = len(w[0].req.input_ids) - len(w[2]) * psz
            warm_by_bucket.setdefault(min(T, round_up_to_bucket(sfx, 256)), []).append(w)
        with self._kphase("prefill"):
            batched(warm_by_bucket, self._prefill_group_prefixed)
        if dup_pairs:
            rows.extend(self._admit_duplicates(dup_pairs))
        return rows

    def _reclaim_pages(self, n: int) -> bool:
        """The eviction ladder below the free pool (``decode_engine.py:2315``):
        radix LRU leaves first (any published page is re-created by a
        prefill), then parked KV (whose loss costs a re-prefill). True when
        anything was freed."""
        if self._radix is not None:
            freed = self._radix.evict(n)
            if freed > 0:
                self._obs_pc.evicted_pages.inc(freed)
                self.flight.record("evict_radix", pages=freed)
                return True
        slot = self._evict_oldest_parked()
        if slot is not None:
            self.flight.record("evict_parked", severity="warn", slot=slot)
        return slot is not None

    def _alloc(self, n: int) -> list[int] | None:
        pages = self.pool.alloc(n)
        while pages is None and self._reclaim_pages(n):
            pages = self.pool.alloc(n)
        return pages

    def _radix_match(self, task: _Task) -> tuple[list[int], list[int]] | None:
        """Longest cached page-aligned prefix of a fresh admission
        (``decode_engine.py:2603``), with the pool refs on the matched pages
        taken at once (a task that backlogs later releases them). The page
        holding row ``plen-1`` is never matched: the decode head writes
        there, and aliased pages are immutable. An image request never
        matches: its KV depends on the image too."""
        if self._radix is None or task.req.image_data is not None:
            return None
        ids = task.req.input_ids
        pages, versions = self._radix.match(ids, max_pages=(len(ids) - 1) // self.config.page_size)
        if not pages:
            self.stats["prefix_cache_misses"] += 1
            return None
        self.pool.ref(pages)
        return pages, versions

    def _prefill_group_prefixed(
        self, group: list[tuple[_Task, int, list[int], list[int]]]
    ) -> list[np.ndarray]:
        """Admit tasks whose prompt prefix is radix-cached
        (``decode_engine.py:2625``): alias the matched pages (already
        ref'd), allocate pages for the suffix only, and run the suffix-only
        prefill over the cached prefix (padded to the longest suffix)."""
        psz = self.config.page_size
        admitted = []
        for task, slot, mpages, mvers in group:
            sfx = len(task.req.input_ids) - len(mpages) * psz
            pages = self._alloc(-(-sfx // psz))
            if pages is None:
                # pool pressure: drop the match refs, retry as a fresh admission
                self.pool.free(mpages)
                self._backlog.append(task)
                continue
            all_pages = list(mpages) + pages
            self._slot_pages[slot] = all_pages
            self._slot_page_versions[slot] = list(mvers) + [self._version] * len(pages)
            self._pt_host[slot] = 0
            self._pt_host[slot, : len(all_pages)] = all_pages
            admitted.append((task, slot, mpages, pages))
        if not admitted:
            return []
        for task, slot, mpages, _ in admitted:
            if task.timeline is not None:
                task.timeline.mark(tl_mod.ADMITTED, slot=slot)
                task.timeline.mark(tl_mod.RADIX_MATCH, hit_pages=len(mpages), hit_tokens=len(mpages) * psz)
                task.timeline.mark(tl_mod.PREFILL_START)
        A = len(admitted)
        P = max(len(t.req.input_ids) - len(m) * psz for t, _, m, _ in admitted)
        npg = -(-P // psz)
        # the prefix page-table width doubles to a power of two, as in JAX
        wp = 1
        while wp < max(len(m) for _, _, m, _ in admitted):
            wp *= 2
        ids_np = np.zeros((A, P), np.int64)
        plens = np.zeros(A, np.int64)
        offs = np.zeros(A, np.int64)
        flat_pages = np.zeros((A, npg), np.int32)  # 0 = trash page for pads
        ppt = np.zeros((A, wp), np.int32)
        for j, (task, _, mpages, pages) in enumerate(admitted):
            n_tok = len(mpages) * psz
            ids = task.req.input_ids
            ids_np[j, : len(ids) - n_tok] = ids[n_tok:]
            plens[j] = len(ids) - n_tok
            offs[j] = n_tok
            flat_pages[j, : len(pages)] = pages
            ppt[j, : len(mpages)] = mpages
        e0 = self._event_pair_start()
        ids_t = self._to_device(ids_np)
        plens_t, offs_t = self._to_device(plens), self._to_device(offs)
        steps = torch.arange(P, device=self.device)[None]
        positions = offs_t[:, None] + steps
        seg = (steps < plens_t[:, None]).to(torch.int64)
        _, ks, vs = qwen.forward_prefill_paged(
            self.model, ids_t, positions, seg, self.cache, self._to_device(ppt), offs_t
        )
        paged_kv.scatter_prefill(self.cache, ks, vs, self._to_device(flat_pages.reshape(-1)), psz)
        del ks, vs
        n_sfx = int(plens.sum())
        self._event_pair_end(e0, self._prefill_events, n_sfx)
        rows = []
        hit_tokens = 0
        for j, (task, slot, mpages, _) in enumerate(admitted):
            if task.timeline is not None:
                task.timeline.mark(tl_mod.PREFILL_END, suffix_tokens=int(plens[j]))
            ids = task.req.input_ids
            task.req.metadata["cached_prefix_tokens"] = len(mpages) * psz
            hit_tokens += len(mpages) * psz
            task.slot = slot
            self._slot_task[slot] = task
            rows.append(
                self._slot_update_row(task, slot, int(ids[-1]), len(ids) - 1, self._budget(task, len(ids)))
            )
        self.stats["prefills"] += A
        self.stats["prefill_batches"] += 1
        self.stats["suffix_prefill_batches"] += 1
        self.stats["prefill_tokens"] += n_sfx
        self.stats["prefix_cache_hits"] += A
        self.stats["prefix_hit_tokens"] += hit_tokens
        return rows

    def _admit_duplicates(self, pairs: list[tuple[_Task, int, int]]) -> list[np.ndarray]:
        """Duplicates by page aliasing (``decode_engine.py:2739``): share the
        primary's full prompt pages (refcount + 1, no copy) and take a
        private copy of the page holding row ``plen-1``, which decode writes."""
        psz = self.config.page_size
        rows: list[np.ndarray] = []
        copy_dst: list[int] = []
        copy_src: list[int] = []
        for task, slot, src_slot in pairs:
            ids = task.req.input_ids
            plen = len(ids)
            prim = self._slot_pages[src_slot]
            n_shared = (plen - 1) // psz  # pages decode never writes
            if len(prim) <= n_shared:
                # the primary was not admitted (pool pressure): retry later
                self._backlog.append(task)
                continue
            priv = self._alloc(1)
            if priv is None:
                self._backlog.append(task)
                continue
            shared = prim[:n_shared]
            self.pool.ref(shared)
            pages = list(shared) + priv
            copy_dst.append(priv[0])
            copy_src.append(prim[n_shared])
            self._slot_pages[slot] = pages
            # the private page is a copy, so it keeps the primary page's version
            self._slot_page_versions[slot] = list(self._slot_page_versions[src_slot][: n_shared + 1])
            self._pt_host[slot] = 0
            self._pt_host[slot, : len(pages)] = pages
            task.slot = slot
            self._slot_task[slot] = task
            rows.append(self._slot_update_row(task, slot, int(ids[-1]), plen - 1, self._budget(task, plen)))
        if copy_dst:
            # stream-ordered after the primaries' prefills
            paged_kv.copy_pages(
                self.cache,
                self._to_device(np.asarray(copy_dst, np.int64)),
                self._to_device(np.asarray(copy_src, np.int64)),
            )
        self.stats["prefix_shared"] += len(copy_dst)
        return rows

    def _publish_prefix(self, full_ids: list[int], pages: list[int], versions: list[int], pos: int) -> None:
        """Publish a finished request's full pages into the radix tree
        (``decode_engine.py:2925``): only pages strictly below ``pos`` (the
        page holding ``pos`` may still take a write from a chunk in flight),
        and under the flush policy only up to the first page stamped with an
        older weight version."""
        if self._radix is None:
            return
        psz = self.config.page_size
        n_pub = min(pos // psz, len(pages), len(full_ids) // psz)
        if self.config.prefix_cache.across_updates == "flush":
            k = 0
            while k < n_pub and versions[k] == self._version:
                k += 1
            n_pub = k
        if n_pub > 0:
            adopted = self._radix.insert(full_ids[: n_pub * psz], pages[:n_pub], versions[:n_pub])
            if adopted:
                self._obs_pc.inserted_pages.inc(adopted)

    def _prefill_group(self, group: list[tuple[_Task, int]]) -> list[np.ndarray]:
        """Allocate pages, run one batched prefill (padded to the longest
        prompt) and scatter its KV into the pages."""
        psz = self.config.page_size
        admitted: list[tuple[_Task, int]] = []
        for task, slot in group:
            need = -(-len(task.req.input_ids) // psz)
            pages = self._alloc(need)
            if pages is None:
                self._backlog.append(task)  # pool pressure: retry later
                continue
            self._slot_pages[slot] = pages
            self._slot_page_versions[slot] = [self._version] * need
            self._pt_host[slot] = 0
            self._pt_host[slot, :need] = pages
            admitted.append((task, slot))
        if not admitted:
            return []
        for task, slot in admitted:
            if task.timeline is not None:
                task.timeline.mark(tl_mod.ADMITTED, slot=slot)
                task.timeline.mark(tl_mod.PREFILL_START)
        A = len(admitted)
        P = max(len(t.req.input_ids) for t, _ in admitted)
        npg = -(-P // psz)
        ids_np = np.zeros((A, P), np.int64)
        plens = np.zeros(A, np.int64)
        flat_pages = np.zeros((A, npg), np.int32)  # 0 = trash page for pads
        for j, (task, slot) in enumerate(admitted):
            ids = task.req.input_ids
            ids_np[j, : len(ids)] = ids
            plens[j] = len(ids)
            flat_pages[j, : len(self._slot_pages[slot])] = self._slot_pages[slot]
        img = self._image_embeds_for(admitted, ids_np)
        e0 = self._event_pair_start()
        ids_t = self._to_device(ids_np)
        plens_t = self._to_device(plens)
        positions = torch.arange(P, device=self.device)[None].expand(A, P)
        seg = (positions < plens_t[:, None]).to(torch.int64)
        _, ks, vs = qwen.forward_prefill(self.model, ids_t, positions, seg, image_embeds=img)
        paged_kv.scatter_prefill(
            self.cache, ks, vs, self._to_device(flat_pages.reshape(-1)), psz
        )
        del ks, vs
        n_tok = int(plens.sum())
        self._event_pair_end(e0, self._prefill_events, n_tok)
        rows = []
        for j, (task, slot) in enumerate(admitted):
            P_len = int(plens[j])
            if task.timeline is not None:
                task.timeline.mark(tl_mod.PREFILL_END, prompt_tokens=P_len)
            task.slot = slot
            self._slot_task[slot] = task
            rows.append(
                self._slot_update_row(
                    task, slot, int(ids_np[j, P_len - 1]), P_len - 1, self._budget(task, P_len)
                )
            )
        self.stats["prefills"] += A
        self.stats["prefill_batches"] += 1
        self.stats["prefill_tokens"] += n_tok
        return rows

    def _image_embeds_for(self, group: list[tuple[_Task, int]], ids_np: np.ndarray) -> torch.Tensor | None:
        """A VLM admission (``decode_engine.py:1870``): the tower over each
        image request's patches (``image_data`` [P, patch_dim]), padded to
        ``pad_patch_bucket``'s count under the patch mask, at its grid's
        (row, col) positions (all (0, 0), with a warning, without
        ``image_grid_thw``), and the merged embeddings placed at the
        prompt's image-pad slots. Returns [A, P, D] f32 on the device (rows
        of text requests zero), or None when no request of the group carries
        an image. A count mismatch warns and places the fewer."""
        mcfg = self.model_cfg
        if mcfg.vision is None or all(t.req.image_data is None for t, _ in group):
            return None
        vcfg = mcfg.vision
        merge2 = vcfg.spatial_merge**2
        emb = torch.zeros((len(group), ids_np.shape[1], mcfg.hidden_size), dtype=torch.float32, device=self.device)
        e0 = self._event_pair_start()
        n_img = 0
        with torch.no_grad():
            for j, (task, _) in enumerate(group):
                if task.req.image_data is None:
                    continue
                px = np.asarray(task.req.image_data, np.float32)
                P = px.shape[0]
                if task.req.image_grid_thw is not None:
                    pos = vis.grid_pos_ids(task.req.image_grid_thw, vcfg.spatial_merge)
                else:
                    # all-zero rope positions lose the spatial structure
                    logger.warning(f"rid={task.req.rid}: image_data without image_grid_thw; vision rope "
                                   "positions default to (0,0) per patch")
                    pos = np.zeros((P, 2), np.int32)
                Ppad = vis.pad_patch_bucket(P, merge2)
                out = vis.vision_forward(
                    self.model.vision,
                    vcfg,
                    self._to_device(np.pad(px, ((0, Ppad - P), (0, 0)))),
                    torch.arange(Ppad, device=self.device) < P,
                    self._to_device(np.pad(pos.astype(np.int32), ((0, Ppad - P), (0, 0)))),
                )
                slots = np.nonzero(ids_np[j] == mcfg.image_token_id)[0]
                if len(slots) != P // merge2:
                    logger.warning(f"VLM mismatch rid={task.req.rid}: {len(slots)} image-pad tokens vs "
                                   f"{P // merge2} merged patch embeddings")
                n = min(len(slots), P // merge2)
                emb[j, self._to_device(slots[:n])] = out[:n].float()
                n_img += 1
        self._event_pair_end(e0, self._vision_events, n_img)
        return emb

    def _pack_row(
        self,
        slot: int,
        last_id: int,
        pos: int,
        active: bool,
        remaining: int,
        top_k: int = -1,
        greedy: bool = False,
        temp: float = 1.0,
        top_p: float = 1.0,
        stops: list[int] | None = None,
        min_rem: int | None = None,
        freq_pen: float = 0.0,
    ) -> np.ndarray:
        """The ONE place that knows the packed row's column order (must
        match ``_apply_slot_updates``): updates the host mirror and builds
        the f32 row (token ids < 2^24 are exact in f32)."""
        stops = (list(stops or []) + [-1] * _MAX_STOP)[:_MAX_STOP]
        if min_rem is None:
            min_rem = remaining
        st = self._state
        st["ids"][slot] = last_id
        st["pos"][slot] = pos
        st["active"][slot] = active
        st["remaining"][slot] = remaining
        st["temp"][slot] = temp
        st["greedy"][slot] = greedy
        st["top_k"][slot] = top_k
        st["top_p"][slot] = top_p
        st["min_rem"][slot] = min_rem
        st["freq_pen"][slot] = freq_pen
        st["stop_ids"][slot] = stops
        return np.asarray(
            [slot, last_id, pos, active, remaining, top_k, greedy, temp, top_p, min_rem, freq_pen, *stops],
            np.float32,
        )

    def _slot_update_row(
        self, task: _Task, slot: int, last_id: int, pos: int, remaining: int
    ) -> np.ndarray:
        self._slot_progress[slot] = time.monotonic()  # the watchdog's baseline
        if task.timeline is not None:
            task.timeline.version = self._version
            # the prefill paths mark ADMITTED before their prefill; resumes
            # and duplicates are stamped here
            if task.timeline.ts_of(tl_mod.ADMITTED) is None:
                task.timeline.mark(tl_mod.ADMITTED, slot=slot)
        g = task.req.gconfig
        temp = 0.0 if g.greedy else g.temperature
        greedy = bool(g.greedy or g.temperature == 0.0)
        top_k = g.top_k if g.top_k and g.top_k > 0 else -1
        if top_k > _TOPK_CAP:
            logger.warning(
                f"top_k={top_k} exceeds the static candidate cap {_TOPK_CAP}; "
                f"clamping (rid={task.req.rid})"
            )
            top_k = _TOPK_CAP
        return self._pack_row(
            slot,
            last_id,
            pos,
            True,
            remaining,
            top_k=top_k,
            greedy=greedy,
            temp=temp,
            top_p=g.top_p if g.top_p else 1.0,
            stops=[] if g.ignore_eos else g.stop_token_ids,
            min_rem=max(0, remaining - max(0, g.min_new_tokens - len(task.out_tokens))),
            freq_pen=self._effective_freq_pen(task),
        )

    def _effective_freq_pen(self, task: _Task) -> float:
        """The request's frequency penalty, or 0 when the engine runs without
        the count table (warned once, then served unpenalized)."""
        fp = float(task.req.gconfig.frequency_penalty or 0.0)
        if fp and not self._freq_enabled:
            if not getattr(self, "_freq_pen_warned", False):
                self._freq_pen_warned = True
                logger.warning(
                    "frequency_penalty requested but ServerConfig.enable_frequency_penalty is off — ignoring"
                )
            return 0.0
        return fp

    def _budget(self, task: _Task, prompt_len: int) -> int:
        g = task.req.gconfig
        T = self.config.max_seq_len
        budget = g.max_new_tokens
        if g.max_tokens is not None:
            budget = min(budget, g.max_tokens - prompt_len)
        return max(1, min(budget, T - 1 - prompt_len))

    def _apply_slot_updates(self, rows: list[np.ndarray]) -> None:
        """Scatter packed rows into the device state: one upload."""
        if not rows:
            return
        upd = self._to_device(np.stack(rows))
        sl = upd[:, 0].long()
        st = self._dev_state
        st["ids"][sl] = upd[:, 1].long()
        st["pos"][sl] = upd[:, 2].long()
        st["active"][sl] = upd[:, 3] > 0
        st["remaining"][sl] = upd[:, 4].long()
        st["top_k"][sl] = upd[:, 5].long()
        st["greedy"][sl] = upd[:, 6] > 0
        st["temp"][sl] = upd[:, 7]
        st["top_p"][sl] = upd[:, 8]
        st["min_rem"][sl] = upd[:, 9].long()
        st["freq_pen"][sl] = upd[:, 10]
        st["stop_ids"][sl] = upd[:, 11 : 11 + _MAX_STOP].long()
        if self._freq_counts is not None:
            # (re)admission resets the slot's counts; a resume's restore
            # follows
            self._freq_counts[sl] = 0
            for slot, counts in self._pending_count_restore:
                self._freq_counts[slot] = self._to_device(counts.astype(np.int64)).to(torch.int16)
        self._pending_count_restore.clear()

    # -- pages ------------------------------------------------------------
    def _ensure_pages(self, ahead: int | None = None) -> None:
        """Allocation-ahead: every active slot gets pages covering
        ``pos + ahead`` writes — by default ``2*n_steps`` (host pos can be
        one in-flight chunk stale); a speculative round passes its exact
        coverage. On pool exhaustion, evict radix leaves first, then preempt
        the active slot with the most remaining budget (it aborts with its
        partial tokens); a slot that cannot grow but whose pages cover one
        more chunk has its budget clamped to that coverage instead."""
        st = self._state
        psz = self.config.page_size
        n_steps = self.config.decode_steps_per_call
        if ahead is None:
            ahead = 2 * n_steps
        deact_rows: list[np.ndarray] = []
        clamp_rows: list[tuple[int, int]] = []
        for slot in np.nonzero(st["active"])[0]:
            if not st["active"][slot]:  # preempted by an earlier iteration
                continue
            need = min(self._maxp, -(-(int(st["pos"][slot]) + ahead + 1) // psz))
            pages = self._slot_pages[slot]
            while len(pages) < need:
                got = self.pool.alloc(need - len(pages))
                if got is None and self._reclaim_pages(need - len(pages)):
                    continue
                if got is None:
                    victim = self._preempt_victim()
                    if victim is None or victim == slot:
                        covered = len(pages) * psz - 1 - (int(st["pos"][slot]) + n_steps)
                        if covered <= 0:
                            deact_rows.append(self._preempt(int(slot)))
                            break
                        st["remaining"][slot] = min(int(st["remaining"][slot]), covered)
                        clamp_rows.append((int(slot), covered))
                        break
                    deact_rows.append(self._preempt(victim))
                    continue
                self._pt_host[slot, len(pages) : len(pages) + len(got)] = got
                pages.extend(got)
                self._slot_page_versions[slot].extend([self._version] * len(got))
        if deact_rows:
            self._apply_slot_updates(deact_rows)
        if clamp_rows:
            self._apply_remaining_clamp(clamp_rows)

    def _apply_remaining_clamp(self, rows: list[tuple[int, int]]) -> None:
        """remaining := min(remaining, cap) for the given slots on the
        device, keeping remaining - min_rem invariant; pos/ids untouched."""
        upd = self._to_device(np.asarray(rows, np.int64))
        sl, cap = upd[:, 0], upd[:, 1]
        st = self._dev_state
        old = st["remaining"][sl]
        new = torch.minimum(old, cap)
        st["remaining"][sl] = new
        st["min_rem"][sl] = torch.clamp(st["min_rem"][sl] - (old - new), min=0)
        st["active"][sl] = st["active"][sl] & (new > 0)

    def _preempt_victim(self) -> int | None:
        st = self._state
        best, best_rem = None, -1
        for slot, task in enumerate(self._slot_task):
            if task is None or not st["active"][slot]:
                continue
            if int(st["remaining"][slot]) > best_rem:
                best, best_rem = slot, int(st["remaining"][slot])
        return best

    def _preempt(self, slot: int) -> np.ndarray:
        """Abort one active slot to reclaim its pages; returns its
        deactivation row."""
        row = self._pack_row(slot, 0, int(self._state["pos"][slot]), False, 0)
        task = self._slot_task[slot]
        self.flight.record("preempt", severity="warn", slot=slot, rid=task.req.rid)
        self._finish(task, StopReason.ABORT.value)
        self.stats["preempted"] += 1
        return row

    # -- decode -----------------------------------------------------------
    def _dispatch_chunk(self) -> dict | None:
        """Enqueue one decode chunk against the device-resident state and
        return a pending record; its packed result is read later."""
        cfg = self.config
        T, psz = cfg.max_seq_len, cfg.page_size
        st = self._state
        if not st["active"].any():
            return None
        self._ensure_pages()
        active = st["active"]
        if not active.any():
            return None
        n_steps = cfg.decode_steps_per_call
        max_pos = int(st["pos"][active].max())
        window = min(T, round_up_to_bucket(max_pos + 1 + 2 * n_steps, cfg.attn_window_step))
        wp = min(self._maxp, -(-window // psz))
        capped = bool(((st["top_k"] > 0) | (st["top_p"] < 1.0))[active].any())
        greedy_any = bool(st["greedy"][active].any())
        freq_any = self._freq_counts is not None and bool((st["freq_pen"] != 0.0)[active].any())
        # the chunk's cost by shape: steps x slots at half the window's
        # page-table width as the mean context
        key = ("chunk", n_steps, len(active), wp)
        self._register_cost(key, hw.decode_step_costs(self.model_cfg, n_steps, len(active), wp * psz / 2.0))
        e0 = self._event_pair_start()
        packed = self._run_chunk(n_steps, self._to_device(self._pt_host[:, :wp]), capped, greedy_any, freq_any)
        self._event_pair_end(e0, self._chunk_events, n_steps)
        if self.device.type == "cuda":
            host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = packed, None
        return {
            "packed": host,
            "ready": ready,
            "n_steps": n_steps,
            "key": key,
            "version": self._version,
            "was_active": active.copy(),
            # task identity per slot at dispatch: a slot can turn over
            # before the drain, and its results belong to the OLD task
            "tasks": list(self._slot_task),
        }

    def _run_chunk(
        self, n_steps: int, page_table: torch.Tensor, capped: bool, greedy_any: bool, freq_any: bool = False
    ):
        """n_steps of decode for all slots (the body of the JAX
        ``_chunk_fn``). Updates the device state and returns the packed
        int32 [2*n_steps + 3, S] result, still on the device. ``freq_any``:
        some active slot has a frequency penalty; each step subtracts
        ``freq_pen * counts`` from the raw logits before the sampler and
        counts the sampled token of every active slot, on the device."""
        T = self.config.max_seq_len
        psz = self.config.page_size
        st = self._dev_state
        S = st["ids"].shape[0]
        K = min(self.model_cfg.vocab_size, _TOPK_CAP)
        tiny = torch.finfo(torch.float32).tiny
        ids, pos, active, remaining = st["ids"], st["pos"], st["active"], st["remaining"]
        toks, logps, emits = [], [], []
        for _ in range(n_steps):
            hidden, _ = qwen.forward_decode_paged(
                self.model, ids, pos, self.cache, page_table, page_size=psz
            )
            logits = qwen.compute_logits(self.model, hidden)
            if freq_any:
                logits = logits - st["freq_pen"][:, None] * self._counts_f32()
            u_full = torch.rand((S, 1), generator=self._gen, device=self.device)
            u_cap = None
            if capped:
                u_cap = torch.rand((S, K), generator=self._gen, device=self.device).clamp_(min=tiny)
            next_ids, logp = _sample_step(logits, u_full, u_cap, st, capped, greedy_any)
            if freq_any:
                self._count_tokens(next_ids, active)
            emitted = active
            hit_stop = (next_ids[:, None] == st["stop_ids"]).any(dim=-1) & (
                remaining - 1 <= st["min_rem"]
            )
            new_pos = pos + 1
            remaining = remaining - active.long()
            still = active & ~hit_stop & (remaining > 0) & (new_pos < T - 1)
            ids = torch.where(active, next_ids, ids)
            pos = torch.where(active, new_pos, pos)
            active = still
            toks.append(next_ids)
            logps.append(logp)
            emits.append(emitted)
        st.update(ids=ids, pos=pos, active=active, remaining=remaining)
        self.stats["decode_steps"] += n_steps
        return torch.cat(
            [
                torch.stack(toks).to(torch.int32),  # [n_steps, S]
                torch.stack(logps).float().view(torch.int32),  # f32 bits
                torch.stack(emits).sum(dim=0, dtype=torch.int32)[None],
                active.to(torch.int32)[None],
                pos.to(torch.int32)[None],
            ]
        )

    def _counts_f32(self) -> torch.Tensor:
        """The count table as f32 [S, V] (the int16 storage read as uint16)."""
        return (self._freq_counts.to(torch.int32) & 0xFFFF).float()

    def _count_tokens(self, ids: torch.Tensor, active: torch.Tensor) -> None:
        """counts[s, ids[s]] += active[s], saturating at 65,535, in place (a
        gather and a scatter: no host sync, capturable in a CUDA graph)."""
        idx = ids[:, None]
        cur = self._freq_counts.gather(1, idx).to(torch.int32) & 0xFFFF
        new = torch.clamp(cur + active[:, None].to(torch.int32), max=_COUNT_MAX)
        self._freq_counts.scatter_(1, idx, new.to(torch.int16))

    def _spec_round(self) -> tuple[int, tuple | None]:
        """One synchronous speculative round (``decode_engine.py:3285``): the
        host drafter proposes, one verify + accept call scores and commits,
        the packed result drains through the normal bookkeeping, and pages
        allocated past the accepted tokens roll back. Synchronous because
        the accept decision gates the next round's drafts. Returns the
        credited token count and the round's cost key."""
        cfg = self.config
        st = self._state
        if not st["active"].any():
            return 0, None
        psz, T = cfg.page_size, cfg.max_seq_len
        B = self._spec_cfg.max_nodes()
        # exact coverage of this round's writes (rows pos..pos+B-1) plus the
        # next pending row; host pos is authoritative (no chunk in flight)
        self._ensure_pages(ahead=B)
        active = st["active"]
        if not active.any():
            return 0, None
        with self._kphase("draft"):
            contexts = {
                int(slot): list(self._slot_task[slot].req.input_ids) + self._slot_task[slot].out_tokens
                for slot in np.nonzero(active)[0]
                if self._slot_task[slot] is not None
            }
            bundle = spec_mod.draft_batch(self._drafter, contexts, len(active), B - 1)
            for slot in contexts:
                task = self._slot_task[slot]
                nd = int(bundle.n_draft[slot])
                if nd and task.timeline is not None:
                    task.timeline.mark(tl_mod.DRAFT, n_draft=nd, source=bundle.sources[slot])
        max_pos = int(st["pos"][active].max())
        window = min(T, round_up_to_bucket(max_pos + 1 + B, cfg.attn_window_step))
        wp = min(self._maxp, -(-window // psz))
        capped = bool(((st["top_k"] > 0) | (st["top_p"] < 1.0))[active].any())
        greedy_any = bool(st["greedy"][active].any())
        # the verify forward ~ one decode step of B tokens a slot
        key = ("spec", B, len(active), wp)
        self._register_cost(key, hw.decode_step_costs(self.model_cfg, 1, len(active) * B, wp * psz / 2.0))
        with self._kphase("dispatch"):
            e0 = self._event_pair_start()
            packed = self._run_spec(B, self._to_device(self._pt_host[:, :wp]), capped, greedy_any, bundle)
            self._event_pair_end(e0, self._spec_events, B)
        with self._kphase("verify"):
            # the round's one blocking download: the verify forward's device
            # time (the speculative twin of device_wait)
            packed_host = packed.cpu()
        pending = {
            "packed": packed_host,
            "ready": None,
            "n_steps": B,
            "key": key,
            "version": self._version,
            "was_active": active.copy(),
            "tasks": list(self._slot_task),
        }
        # acceptance accounting before _drain changes slot ownership
        emit_count = packed_host[2 * B].numpy()
        n_accepted = 0
        source_tokens: dict[str, int] = {}
        for s, task in enumerate(pending["tasks"]):
            if task is None or not active[s] or not bundle.n_draft[s]:
                continue
            acc = max(0, int(emit_count[s]) - 1)
            n_accepted += acc
            src = bundle.sources[s]
            source_tokens[src] = source_tokens.get(src, 0) + int(bundle.n_draft[s])
            self._obs_spec.accepted_length.observe(acc)
            if task.timeline is not None:
                task.timeline.mark(tl_mod.VERIFY, n_accepted=acc)
        self.stats["spec_rounds"] += 1
        self.stats["spec_draft_tokens"] += int(bundle.n_draft.sum())
        self.stats["spec_accepted_tokens"] += n_accepted
        self._obs_spec.rounds.inc()
        self._obs_spec.accepted_tokens.inc(n_accepted)
        for src, n in source_tokens.items():
            self._obs_spec.draft_tokens.labels(source=src).inc(n)
        credited = self._drain(pending)
        rolled = self._rollback_spec_pages()
        if rolled:
            self.stats["spec_rollback_pages"] += rolled
            self._obs_spec.rollback_pages.inc(rolled)
        return credited, key

    def _run_spec(self, B: int, page_table: torch.Tensor, capped: bool, greedy_any: bool, bundle):
        """Verify + accept for all slots (the body of the JAX ``_spec_fn``,
        ``decode_engine.py:2089``). Row 0 per slot is the pending token, rows
        1..B-1 the draft nodes; ``forward_verify_paged`` scores all of them,
        then an unrolled walk re-runs ``_sample_step`` position by position
        and follows the tree edge whose draft token equals the sampled one,
        so every emitted token is what the sequential path would emit. Only
        visited rows write KV into real pages; the rest go to trash page 0.
        Updates the device state; returns the packed int32 [2B + 3, S]
        result in ``_run_chunk``'s layout."""
        T, psz = self.config.max_seq_len, self.config.page_size
        st = self._dev_state
        S = st["ids"].shape[0]
        K = B - 1
        dev = self.device
        Kc = min(self.model_cfg.vocab_size, _TOPK_CAP)
        tiny = torch.finfo(torch.float32).tiny
        d_tokens = self._to_device(bundle.tokens.astype(np.int64))  # [S, K]
        d_parent = self._to_device(bundle.parent_row.astype(np.int64))
        d_depth = self._to_device(bundle.depth.astype(np.int64))
        d_mask = self._to_device(bundle.mask)  # [S, B, B] bool
        d_count = self._to_device(bundle.n_draft.astype(np.int64))
        pos0 = st["pos"]
        ids_nodes = torch.cat([st["ids"][:, None], d_tokens], dim=1)  # [S, B]
        depth_full = torch.cat([torch.zeros((S, 1), dtype=torch.int64, device=dev), d_depth], dim=1)
        # the clamp keeps indices in range for inactive slots with a stale
        # pos (their page-table rows are zero: everything lands in trash)
        positions = torch.clamp(pos0[:, None] + depth_full, max=T - 1)
        hidden, ks, vs = qwen.forward_verify_paged(
            self.model, ids_nodes, positions, d_mask, self.cache, page_table, pos0
        )
        logits = qwen.compute_logits(self.model, hidden)  # [S, B, V]
        row_valid = torch.arange(1, B, device=dev)[None, :] <= d_count[:, None]  # [S, K]
        slot_idx = torch.arange(S, device=dev)
        node_idx = torch.arange(B, device=dev)[None, :]
        cur = torch.zeros(S, dtype=torch.int64, device=dev)  # row the walk is at
        cont = st["active"]  # still emitting this round
        alive = st["active"]  # lives past the round
        pos_c, rem_c, ids_c = pos0, st["remaining"], st["ids"]
        # rows whose KV becomes context: the root and the accepted path
        row_ok = node_idx == 0
        row_ok = row_ok.expand(S, B)
        toks, logps, emits = [], [], []
        for j in range(B):
            lg = logits[slot_idx, cur]  # [S, V]
            u_full = torch.rand((S, 1), generator=self._gen, device=dev)
            u_cap = None
            if capped:
                u_cap = torch.rand((S, Kc), generator=self._gen, device=dev).clamp_(min=tiny)
            t_j, logp_j = _sample_step(lg, u_full, u_cap, st, capped, greedy_any)
            emits.append(cont)
            toks.append(t_j)
            logps.append(logp_j)
            hit_stop = (t_j[:, None] == st["stop_ids"]).any(dim=-1) & (rem_c - 1 <= st["min_rem"])
            new_pos = pos_c + cont.long()
            rem_c = rem_c - cont.long()
            step_alive = cont & ~hit_stop & (rem_c > 0) & (new_pos < T - 1)
            alive = torch.where(cont, step_alive, alive)
            ids_c = torch.where(cont, t_j, ids_c)
            pos_c = new_pos
            if j < K:
                # follow the tree edge whose draft token is the sampled one
                match = (d_parent == cur[:, None]) & (d_tokens == t_j[:, None]) & row_valid
                child = match.to(torch.int32).argmax(dim=1) + 1  # first match
                cont = step_alive & match.any(dim=1)
                cur = torch.where(cont, child, cur)
                row_ok = row_ok | ((node_idx == child[:, None]) & cont[:, None])
        st.update(ids=ids_c, pos=pos_c, active=alive, remaining=rem_c)
        # selective KV commit: visited rows to their page rows, others to trash
        wp = page_table.shape[1]
        page_idx = torch.clamp(positions // psz, 0, wp - 1)
        pages = torch.gather(page_table.long(), 1, page_idx)
        pages = torch.where(row_ok, pages, 0)
        L, _, _, KH, hd = ks.shape
        paged_kv.scatter_token_rows(
            self.cache,
            ks.reshape(L, S * B, KH, hd),
            vs.reshape(L, S * B, KH, hd),
            pages.reshape(-1),
            (positions % psz).reshape(-1),
        )
        return torch.cat(
            [
                torch.stack(toks).to(torch.int32),  # [B, S]
                torch.stack(logps).float().view(torch.int32),
                torch.stack(emits).sum(dim=0, dtype=torch.int32)[None],
                alive.to(torch.int32)[None],
                pos_c.to(torch.int32)[None],
            ]
        )

    def _rollback_spec_pages(self) -> int:
        """Free pages past each live slot's committed coverage (rows 0..pos:
        the written KV and the pending row) after a round
        (``decode_engine.py:3395``). Rejected drafts never wrote into them
        (their rows went to trash), so this is an allocator-level rollback."""
        st = self._state
        psz = self.config.page_size
        freed = 0
        for slot in np.nonzero(st["active"])[0]:
            if self._slot_task[slot] is None:
                continue
            need = -(-(int(st["pos"][slot]) + 1) // psz)
            pages = self._slot_pages[slot]
            if len(pages) <= need:
                continue
            tail = pages[need:]
            self.pool.free(tail)
            self._slot_pages[slot] = pages[:need]
            del self._slot_page_versions[slot][need:]
            self._pt_host[slot, need : need + len(tail)] = 0
            freed += len(tail)
        return freed

    def _drain(self, pending: dict | None) -> int:
        """Read one chunk's packed result and credit tokens / finish tasks.
        Slots admitted after the chunk was dispatched are excluded via the
        was_active snapshot. Returns the credited token count."""
        if pending is None:
            return 0
        with self._kphase("device_wait"):
            # the one wait on the card: its span is the device time the host
            # sees in this pass (the pinned copy lands when the event does)
            if pending["ready"] is not None:
                pending["ready"].synchronize()
            packed = pending["packed"].numpy()
        credited = 0
        with self._kphase("bookkeeping"):
            n_steps = pending["n_steps"]
            version = pending["version"]
            was_active = pending["was_active"]
            toks = packed[:n_steps]
            logps = packed[n_steps : 2 * n_steps].view(np.float32)
            emit_count = packed[2 * n_steps]
            active = packed[2 * n_steps + 1].astype(bool)
            pos = packed[2 * n_steps + 2]
            st = self._state
            now = time.monotonic()
            for slot, task in enumerate(pending["tasks"]):
                if task is None or not was_active[slot]:
                    continue
                if task is not self._slot_task[slot]:
                    continue  # slot turned over since dispatch
                c = int(emit_count[slot])
                if c:
                    credited += c
                    if task.first_token_time is None:
                        task.first_token_time = now
                        if task.timeline is not None:
                            task.timeline.mark(tl_mod.FIRST_TOKEN)
                    if task.timeline is not None:
                        # one mark per slot per chunk; the timeline's event
                        # cap bounds long generations
                        task.timeline.mark(tl_mod.DECODE_CHUNK, n_tokens=c, version=version)
                    self._slot_progress[slot] = now  # the watchdog: progress seen
                    task.out_tokens.extend(toks[:c, slot].tolist())
                    task.out_logprobs.extend(logps[:c, slot].tolist())
                    task.out_versions.extend([version] * c)
                    self.stats["generated_tokens"] += c
                    self._obs.generated_tokens.inc(c)
                st["pos"][slot] = int(pos[slot])
                if c:
                    st["ids"][slot] = int(toks[c - 1, slot])
                st["remaining"][slot] -= c
                st["active"][slot] = bool(active[slot])
                if not active[slot]:
                    last = task.out_tokens[-1] if task.out_tokens else -1
                    g = task.req.gconfig
                    if (
                        not g.ignore_eos
                        and last in g.stop_token_ids
                        and len(task.out_tokens) >= g.min_new_tokens
                    ):
                        reason = StopReason.STOP.value
                    else:
                        reason = StopReason.LENGTH.value
                    self._finish(task, reason)
            self.stats["chunks"] += 1
            self._obs.chunks.inc()
        return credited

    def _finish(self, task: _Task, reason: str) -> None:
        if task.slot >= 0:
            self._slot_task[task.slot] = None
            self._state["active"][task.slot] = False
            if reason != StopReason.ABORT.value:
                # completed requests publish prompt + output pages before the
                # free below (the tree's own refs keep them); aborts and
                # preemptions do not
                self._publish_prefix(
                    list(task.req.input_ids) + list(task.out_tokens),
                    self._slot_pages[task.slot],
                    self._slot_page_versions[task.slot],
                    int(self._state["pos"][task.slot]),
                )
            # zeroing the block-table row steers a later chunk's stale write
            # for this slot to the trash page
            self.pool.free(self._slot_pages[task.slot])
            self._slot_pages[task.slot] = []
            self._slot_page_versions[task.slot] = []
            self._pt_host[task.slot] = 0
        bd: dict[str, float] = {}
        if task.timeline is not None:
            # the terminal mark and the histograms; the breakdown rides the
            # response, so callers split latency without scraping
            bd = self.timeline.complete(task.timeline, reason, len(task.out_tokens))
        now = time.monotonic()
        resp = ModelResponse(
            input_tokens=list(task.req.input_ids),
            output_tokens=task.out_tokens,
            output_logprobs=task.out_logprobs,
            output_versions=task.out_versions,
            stop_reason=reason,
            truncated_by=task.truncated_by,
            latency=now - task.submit_time,
            ttft=(task.first_token_time or now) - task.submit_time,
            **{k: bd.get(k, 0.0) for k in io_struct.TIMING_FIELDS},
            rid=task.req.rid,
            metadata=dict(task.req.metadata),
        )
        if reason == StopReason.ABORT.value:
            self.stats["aborted"] += 1
            self._obs.aborted.inc()
        elif reason == StopReason.DEADLINE.value:
            self.stats["deadline_reaped"] += 1
            self._obs_lc.deadline_exceeded.inc()
        elif reason == StopReason.CANCEL.value:
            self.stats["cancelled"] += 1
            self._obs_lc.aborts.inc()
        else:
            self.stats["completed"] += 1
            self._obs.completed.inc()
        try:
            task.callback(resp)
        except Exception:  # noqa: BLE001 — one caller's callback must not
            # take the decode loop down
            logger.exception("generation callback failed")

    def _abort_all(self) -> None:
        """Finish every in-flight request with stop_reason "abort" and
        deactivate its slot on the device (``decode_engine.py:3021``). A
        decoding request with a rid parks: its pages move to a ``_Parked``
        entry (``_finish`` then frees nothing) and its block-table row is
        zeroed, so a chunk still in flight writes to the trash page. Its full
        pages are also published into the radix tree: if the parking is
        evicted, or the rid comes back with extended ids (an episode's next
        turn), the tree still serves them."""
        st = self._state
        deact = []
        for slot, task in enumerate(self._slot_task):
            if task is None:
                continue
            rid = task.req.rid
            if st["active"][slot]:
                deact.append(slot)
                if rid:
                    p = _Parked(
                        slot=slot,
                        full_ids=list(task.req.input_ids) + list(task.out_tokens),
                        pos=int(st["pos"][slot]),
                        pages=self._slot_pages[slot],
                        page_versions=list(self._slot_page_versions[slot]),
                        n_emitted=len(task.out_tokens),
                    )
                    self._parked[rid] = p
                    if task.timeline is not None:
                        task.timeline.mark(tl_mod.PARK, n_emitted=len(task.out_tokens))
                    self._publish_prefix(p.full_ids, p.pages, p.page_versions, p.pos)
                    self._slot_pages[slot] = []
                    self._slot_page_versions[slot] = []
                    self._pt_host[slot] = 0
            self._finish(task, StopReason.ABORT.value)
        if deact and self.cache is not None:
            self._apply_slot_updates([self._pack_row(s, 0, int(st["pos"][s]), False, 0) for s in deact])

    def _abort_queued(self) -> None:
        while True:
            try:
                self._backlog.append(self._queue.get_nowait())
            except queue.Empty:
                break
        while self._backlog:
            self._finish(self._backlog.popleft(), StopReason.ABORT.value)

    def _loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        pending: dict | None = None
        try:
            with torch.no_grad():
                while not self._shutdown.is_set():
                    self._last_loop_ts = time.monotonic()
                    # the probe: one timeline a pass; idle, paused and held
                    # passes abandon it, so every recorded step did chunk
                    # work and its phases sum to its wall time
                    step_tl = self.kprobe.begin_step() if self.kprobe is not None else None
                    self._ktl = step_tl
                    self._apply_weight_update()
                    self._service_radix_flush()
                    self._service_radix_cap()
                    with self._kphase("admission"):
                        pending = self._reap_lifecycle(pending)
                    if self._paused.is_set():
                        self._abandon_kstep()
                        self._drain(pending)
                        pending = None
                        self._abort_all()
                        if self._draining.is_set():
                            # a draining engine leaves no queued request
                            # without its terminal response
                            self._abort_queued()
                        self._pause_ack.set()
                        self._wakeup.wait(timeout=0.05)
                        self._wakeup.clear()
                        continue
                    if self._held.is_set():
                        # the commit fence: drain the in-flight chunk, then
                        # idle with slots, KV and device state intact; a
                        # commit applies at the top of the next pass
                        expiry = self.config.hold_fence_timeout_s
                        if expiry > 0 and time.monotonic() - self._hold_since > expiry:
                            logger.warning(
                                f"hold fence exceeded {expiry:.0f}s without a continue_generation; "
                                "self-releasing"
                            )
                            self._held.clear()
                            self._hold_ack.clear()
                            self._abandon_kstep()
                            continue
                        # a held pass is abandoned even when it drains the
                        # chunk in flight: its wall time is fence stall
                        self._abandon_kstep()
                        drained_chunk = pending is not None
                        self._drain(pending)
                        pending = None
                        # a hold is legitimate idleness: keep the watchdog's
                        # baselines fresh
                        now = time.monotonic()
                        for slot, t in enumerate(self._slot_task):
                            if t is not None:
                                self._slot_progress[slot] = now
                        if not self._hold_marked:
                            # one FENCE_STALL mark per hold window on every
                            # live request; the seconds accrue pass by pass
                            self._hold_marked = True
                            for t in self._slot_task:
                                if t is not None and t.timeline is not None:
                                    t.timeline.mark(tl_mod.FENCE_STALL)
                        self._hold_ack.set()
                        # the stall opens at the top of this pass (a staged
                        # commit applied there is fence stall), or after the
                        # drain when this pass drained a real chunk (that
                        # chunk's compute is decode time)
                        t_stall = time.monotonic() if drained_chunk else self._last_loop_ts
                        self._wakeup.wait(timeout=0.05)
                        self._wakeup.clear()
                        dt_stall = time.monotonic() - t_stall
                        for t in self._slot_task:
                            if t is not None and t.timeline is not None:
                                t.timeline.fence_stall_s += dt_stall
                                if t.first_token_time is None:
                                    # before the first token: outside TPOT's window
                                    t.timeline.fence_stall_pre_first_s += dt_stall
                        continue
                    if self.cache is None:
                        # memory released and not yet resumed
                        self._abandon_kstep()
                        self._wakeup.wait(timeout=0.05)
                        self._wakeup.clear()
                        continue
                    self._hold_marked = False  # the next hold window marks afresh
                    with self._kphase("admission"):
                        rows = self._admit_pending()
                        self._apply_slot_updates(rows)
                    spec_on = self._spec_cfg is not None and self._drafter is not None
                    if spec_on and self._freq_counts is not None:
                        # the penalty's per-step counts do not fit parallel
                        # verify scoring: the sequential chunk serves while
                        # any active slot has one
                        st = self._state
                        spec_on = not bool((st["freq_pen"] != 0.0)[st["active"]].any())
                    if spec_on:
                        # synchronous speculative pass: drain the pipelined
                        # chunk first (the spec-off -> on switch), then one
                        # round; a weight update applies only at the top of
                        # a pass, so draft and verify share one version
                        drained_key = pending["key"] if pending is not None else None
                        n_pipe = self._drain(pending)
                        pending = None
                        n_spec, spec_key = self._spec_round()
                        self._close_kstep(
                            step_tl, drained_key is not None or spec_key is not None or rows,
                            n_pipe + n_spec, spec_key or drained_key,
                        )
                        if spec_key is None and not any(t is not None for t in self._slot_task):
                            self._wakeup.wait(timeout=0.05)
                            self._wakeup.clear()
                        continue
                    # dispatch the next chunk, then read the previous one
                    # while it computes
                    with self._kphase("dispatch"):
                        dispatched = self._dispatch_chunk()
                    drained_key = pending["key"] if pending is not None else None
                    n_drained = self._drain(pending)
                    pending = dispatched
                    # a pass that drained, dispatched or admitted is a real
                    # step; a bare poll is not
                    self._close_kstep(
                        step_tl, drained_key is not None or dispatched is not None or rows, n_drained, drained_key
                    )
                    if pending is None and not any(t is not None for t in self._slot_task):
                        self._wakeup.wait(timeout=0.05)
                        self._wakeup.clear()
                # shutdown: every submitted request gets its terminal response
                self._ktl = None
                self._drain(pending)
                self._abort_all()
                self._abort_queued()
        except BaseException as e:  # noqa: BLE001 — the loop thread's boundary:
            # record the failure, end every request, and refuse new ones
            self._loop_error = e
            logger.exception("decode loop failed")
            for slot, task in enumerate(self._slot_task):
                if task is not None:
                    self._finish(task, StopReason.ABORT.value)
            self._abort_queued()
            if not isinstance(e, Exception):
                raise
