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
- ``pause_generation`` (abort mode) ends every in-flight request with
  ``stop_reason="abort"`` and its partial tokens, publishing its full pages
  into the radix tree, and returns once it has; the client resubmits prompt
  + tokens so far, which prefills only the suffix.
- ``abort_request(rid)`` cancels one request, queued or decoding: the loop
  reaps it between chunks (the chunk in flight drained first) and answers
  ``stop_reason="cancelled"``.
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

Not ported yet (raise ``NotImplementedError``, see ``_check_supported``):
int8 weights, frequency penalty, image inputs, multi-device meshes and
loading HF checkpoints. Also not ported: KV parking across an abort
(a resubmit re-prefills its last partial page through a radix hit), the
autopilot's radix cap, the hold fence (ROADMAP Queue A 1b), deadlines and
the watchdog (item 2), and the observability surfaces.

Eager PyTorch compiles nothing, so admission does not pad prefill groups to
compiled sizes: a group pads to its longest prompt (or suffix).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
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
from areal_tpu_torch.utils.data import round_up_to_bucket

logger = logging.getLogger("areal_tpu_torch.decode_engine")

_MAX_STOP = 8  # stop-token-id slots per request (padded with -1)
_TOPK_CAP = 1024  # static candidate-set size for per-slot top-k/top-p
_PREFILL_SIZES = (8, 4, 2, 1)  # batched-prefill group sizes


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
    truncated_by: str = ""  # "cancelled" when /abort_request reaped it


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
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise ValueError(f"weight update mismatch: missing {missing[:4]}, unexpected {extra[:4]}")
    srcs = {}
    for name, p in own.items():
        src = params[name]
        if not isinstance(src, torch.Tensor):
            src = torch.as_tensor(np.asarray(src))
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(p.shape)}")
        if src.is_complex():  # copy_ would drop the imaginary part with a warning
            raise TypeError(f"{name}: dtype {src.dtype} does not cast to {p.dtype}")
        srcs[name] = src
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(srcs[name])


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
        self.stats = {
            "generated_tokens": 0,
            "completed": 0,
            "aborted": 0,
            "cancelled": 0,
            "chunks": 0,
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
        self._chunk_events: list[tuple] = []
        self._spec_events: list[tuple] = []
        self._radix: paged_kv.RadixPrefixCache | None = None  # built in initialize
        self._radix_flush_req: tuple[threading.Event, list[int]] | None = None
        # speculative decoding: non-None only while enabled
        self._spec_cfg = None
        self._drafter = None

    @staticmethod
    def _check_supported(cfg: ServerConfig) -> None:
        """Refuse the options whose code paths are later slices of the port
        (ROADMAP.md Queue A)."""
        if cfg.quantization not in (None, "", "none"):
            raise NotImplementedError(
                f"quantization={cfg.quantization!r}: ROADMAP Queue A, LoRA / int8 weights"
            )
        if cfg.enable_frequency_penalty:
            raise NotImplementedError("frequency penalty: ROADMAP Queue A, engine lifecycle")
        m = cfg.mesh
        if max(m.data, m.fsdp, m.seq, m.model, m.expert, m.pipe) > 1:
            raise NotImplementedError("multi-device mesh: ROADMAP Queue A, multi-GPU")
        if cfg.kv_quantization not in (None, "", "none", "int8", "fp8"):
            raise ValueError(f"unknown kv_quantization {cfg.kv_quantization!r}")

    # -- lifecycle --------------------------------------------------------
    def initialize(self) -> None:
        cfg = self.config
        if self.params is None:
            raise NotImplementedError(
                "loading weights from an HF checkpoint waits for a checkpoint in "
                "the repository; pass params (and model_cfg with a state dict)"
            )
        if isinstance(self.params, qwen.QwenModel) and self.params.device == self.device:
            self.model = self.params
            self.model_cfg = self.model.cfg
        else:
            if self.model_cfg is None:
                raise ValueError("model_cfg is required with a state dict")
            self.model = qwen.QwenModel(self.model_cfg, self.device)
            load_params(self.model, self.params)
        self.params = None  # the engine serves self.model; no second copy
        S = cfg.max_batch_size
        self._init_paged_cache()
        # host mirror of per-slot state; the authoritative copy between
        # chunks is on the device (self._dev_state)
        self._slot_task: list[_Task | None] = [None] * S
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
            "stop_ids": np.full((S, _MAX_STOP), -1, np.int64),
        }
        self._dev_state = {
            k: torch.from_numpy(v.copy()).to(self.device) for k, v in self._state.items()
        }
        seed = cfg.seed if cfg.seed is not None else time.time_ns() % (2**31)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        if cfg.speculative.enabled:
            self._spec_cfg = cfg.speculative
            self._drafter = spec_mod.build_drafter(cfg.speculative, radix=self._radix)
        self.initialized = True
        logger.info(
            f"decode engine ready on {self.device}: {S} slots x {cfg.max_seq_len} ctx, "
            f"{self.pool.n_pages} KV pages x {cfg.page_size} tokens"
        )

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
        if req.image_data is not None:
            raise NotImplementedError("image inputs: ROADMAP Queue A, vision")
        if self._loop_error is not None:
            raise RuntimeError("decode loop failed") from self._loop_error
        self._queue.put(_Task(req=req, callback=callback))
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
        """Cancel one request by rid, queued or decoding
        (``decode_engine.py:857``). Thread-safe: the decode loop reaps the rid
        between chunks (the slot deactivated, its pages freed or published
        as a finished request's are, the callback fired with stop_reason
        "cancelled"). Unknown rids are a no-op. Returns True when the rid
        was queued for cancellation (False for an empty rid)."""
        if not rid:
            return False
        with self._abort_lock:
            self._abort_rids.add(rid)
        self._wakeup.set()
        return True

    def _reap_aborts(self, pending: dict | None) -> dict | None:
        """Service ``abort_request`` between chunks (``decode_engine.py:1017``,
        its cancellation part: deadlines and the watchdog wait for ROADMAP
        Queue A item 2). When a queued or decoding request is hit, the chunk
        in flight is drained first, so the tokens it emitted are credited
        with their version tags; cancelled requests then leave through
        ``_finish``. Takes and returns the loop's in-flight chunk."""
        with self._abort_lock:
            aborts, self._abort_rids = self._abort_rids, set()
        if not aborts:
            return pending
        hit = any(t.req.rid in aborts for t in self._backlog) or any(
            t is not None and t.req.rid in aborts for t in self._slot_task
        )
        if not hit:
            with self._queue.mutex:
                hit = any(t.req.rid in aborts for t in self._queue.queue)
        if not hit:
            return pending
        self._drain(pending)
        while True:  # queued work first, in the order _admit_pending takes it
            try:
                self._backlog.append(self._queue.get_nowait())
            except queue.Empty:
                break
        kept: deque[_Task] = deque()
        for task in self._backlog:
            if task.req.rid in aborts:
                task.truncated_by = "cancelled"
                self._finish(task, StopReason.CANCEL.value)
            else:
                kept.append(task)
        self._backlog = kept
        rows = []
        for slot, task in enumerate(self._slot_task):
            if task is not None and task.req.rid in aborts:
                if self._state["active"][slot]:
                    rows.append(self._pack_row(slot, 0, int(self._state["pos"][slot]), False, 0))
                task.truncated_by = "cancelled"
                self._finish(task, StopReason.CANCEL.value)
        if rows:
            self._apply_slot_updates(rows)
        return None  # the chunk in flight was drained above

    # -- pause / weights --------------------------------------------------
    def pause_generation(self, mode: str = "abort", timeout: float = 10.0) -> None:
        """Stop the decode loop until ``continue_generation``: in-flight
        requests complete with stop_reason "abort" and their partial tokens,
        and their full pages go into the radix tree, so the client's resubmit
        of prompt + emitted prefills only its suffix. Returns once the running
        loop has ended them (at most ``timeout`` seconds), so a version set
        right after the pause tags only later tokens. The hold fence of the
        JAX engine (``mode="hold"``) waits for ROADMAP Queue A 1b."""
        if mode != "abort":
            raise NotImplementedError(f"pause mode {mode!r} (the hold fence): ROADMAP Queue A 1b")
        self._paused.set()
        self._wakeup.set()
        if self._thread is not None and self._thread.is_alive():
            self._pause_ack.wait(timeout)

    def continue_generation(self) -> None:
        self._paused.clear()
        self._pause_ack.clear()
        self._wakeup.set()

    @property
    def is_paused(self) -> bool:
        return self._paused.is_set()

    def update_weights_from_params(self, params, version: int | None = None) -> None:
        """Swap in new weights (a ``QwenModel`` or a state dict) between
        chunks; tokens of later chunks carry ``version``. Blocks until the
        decode loop has applied them."""
        with self._weight_lock:
            self._pending_weight_update = (params, version)
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
            params, version = upd
            try:
                # in place: the copy is ordered on the stream after the
                # chunk in flight, which keeps reading the old weights
                load_params(self.model, params)
                if version is not None:
                    self._version = version
                # KV cached under the old weights is stale: the default policy
                # drops the tree (pages aliased by live slots survive until
                # those slots free them); "keep" retains it
                if self._radix is not None and self.config.prefix_cache.across_updates == "flush":
                    self._radix.flush()
            except Exception as e:  # noqa: BLE001 — a bad payload fails that
                # update (the waiter re-raises), not the decode loop
                self._weight_update_error = e
                logger.error(f"weight update failed: {type(e).__name__}: {e}")
            self._pending_weight_update = None

    def set_version(self, v: int) -> None:
        self._version = v

    def get_version(self) -> int:
        return self._version

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
        number of live slots holding it plus one if the radix tree holds it,
        and free + allocated == total. ``ok`` is that check."""
        holders: dict[int, int] = {}
        for pages in self._slot_pages:
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
            "radix_pages": len(radix_pages),
            "ok": ok,
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
    def _free_slots(self) -> list[int]:
        return [i for i, t in enumerate(self._slot_task) if t is None]

    def _admit_pending(self) -> list[np.ndarray]:
        """Admit backlog + queue into free slots (``decode_engine.py:2492``):
        identical prompts of this pass prefill once and alias (duplicates);
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
            if not free:
                self._backlog.appendleft(task)  # all slots busy
                break
            to_prefill.append((task, free.pop(0)))

        # identical prompts (a GRPO group's samples): the first prefills,
        # the others alias its pages after it
        primaries: list[tuple[_Task, int]] = []
        dup_pairs: list[tuple[_Task, int, int]] = []  # (task, slot, src_slot)
        first_slot: dict[tuple, int] = {}
        for task, slot in to_prefill:
            key = tuple(task.req.input_ids)
            if key in first_slot:
                dup_pairs.append((task, slot, first_slot[key]))
            else:
                first_slot[key] = slot
                primaries.append((task, slot))

        cold: list[tuple[_Task, int]] = []
        warm: list[tuple[_Task, int, list[int], list[int]]] = []
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
        batched(by_bucket, self._prefill_group)
        # warm admissions group by SUFFIX bucket, the only tokens prefilled
        warm_by_bucket: dict[int, list] = {}
        for w in warm:
            sfx = len(w[0].req.input_ids) - len(w[2]) * psz
            warm_by_bucket.setdefault(min(T, round_up_to_bucket(sfx, 256)), []).append(w)
        batched(warm_by_bucket, self._prefill_group_prefixed)
        if dup_pairs:
            rows.extend(self._admit_duplicates(dup_pairs))
        return rows

    def _reclaim_pages(self, n: int) -> bool:
        """Below the free pool: radix LRU leaves (any published page can be
        re-created by a prefill). True when anything was freed."""
        return self._radix is not None and self._radix.evict(n) > 0

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
        there, and aliased pages are immutable."""
        if self._radix is None:
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
        for task, slot, mpages, _ in admitted:
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
            self._radix.insert(full_ids[: n_pub * psz], pages[:n_pub], versions[:n_pub])

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
        e0 = self._event_pair_start()
        ids_t = self._to_device(ids_np)
        plens_t = self._to_device(plens)
        positions = torch.arange(P, device=self.device)[None].expand(A, P)
        seg = (positions < plens_t[:, None]).to(torch.int64)
        _, ks, vs = qwen.forward_prefill(self.model, ids_t, positions, seg)
        paged_kv.scatter_prefill(
            self.cache, ks, vs, self._to_device(flat_pages.reshape(-1)), psz
        )
        del ks, vs
        n_tok = int(plens.sum())
        self._event_pair_end(e0, self._prefill_events, n_tok)
        rows = []
        for j, (task, slot) in enumerate(admitted):
            P_len = int(plens[j])
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
        st["stop_ids"][slot] = stops
        return np.asarray(
            [slot, last_id, pos, active, remaining, top_k, greedy, temp, top_p, min_rem, *stops],
            np.float32,
        )

    def _slot_update_row(
        self, task: _Task, slot: int, last_id: int, pos: int, remaining: int
    ) -> np.ndarray:
        g = task.req.gconfig
        if g.frequency_penalty and not getattr(self, "_freq_pen_warned", False):
            self._freq_pen_warned = True
            logger.warning(
                "frequency_penalty requested but ServerConfig.enable_frequency_penalty "
                "is off — ignoring"
            )
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
        )

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
        st["stop_ids"][sl] = upd[:, 10 : 10 + _MAX_STOP].long()

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
        self._finish(self._slot_task[slot], StopReason.ABORT.value)
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
        e0 = self._event_pair_start()
        packed = self._run_chunk(n_steps, self._to_device(self._pt_host[:, :wp]), capped, greedy_any)
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
            "version": self._version,
            "was_active": active.copy(),
            # task identity per slot at dispatch: a slot can turn over
            # before the drain, and its results belong to the OLD task
            "tasks": list(self._slot_task),
        }

    def _run_chunk(self, n_steps: int, page_table: torch.Tensor, capped: bool, greedy_any: bool):
        """n_steps of decode for all slots (the body of the JAX
        ``_chunk_fn``). Updates the device state and returns the packed
        int32 [2*n_steps + 3, S] result, still on the device."""
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
            u_full = torch.rand((S, 1), generator=self._gen, device=self.device)
            u_cap = None
            if capped:
                u_cap = torch.rand((S, K), generator=self._gen, device=self.device).clamp_(min=tiny)
            next_ids, logp = _sample_step(logits, u_full, u_cap, st, capped, greedy_any)
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

    def _spec_round(self) -> int:
        """One synchronous speculative round (``decode_engine.py:3285``): the
        host drafter proposes, one verify + accept call scores and commits,
        the packed result drains through the normal bookkeeping, and pages
        allocated past the accepted tokens roll back. Synchronous because
        the accept decision gates the next round's drafts. Returns the
        credited token count."""
        cfg = self.config
        st = self._state
        if not st["active"].any():
            return 0
        psz, T = cfg.page_size, cfg.max_seq_len
        B = self._spec_cfg.max_nodes()
        # exact coverage of this round's writes (rows pos..pos+B-1) plus the
        # next pending row; host pos is authoritative (no chunk in flight)
        self._ensure_pages(ahead=B)
        active = st["active"]
        if not active.any():
            return 0
        contexts = {
            int(slot): list(self._slot_task[slot].req.input_ids) + self._slot_task[slot].out_tokens
            for slot in np.nonzero(active)[0]
            if self._slot_task[slot] is not None
        }
        bundle = spec_mod.draft_batch(self._drafter, contexts, len(active), B - 1)
        max_pos = int(st["pos"][active].max())
        window = min(T, round_up_to_bucket(max_pos + 1 + B, cfg.attn_window_step))
        wp = min(self._maxp, -(-window // psz))
        capped = bool(((st["top_k"] > 0) | (st["top_p"] < 1.0))[active].any())
        greedy_any = bool(st["greedy"][active].any())
        e0 = self._event_pair_start()
        packed = self._run_spec(B, self._to_device(self._pt_host[:, :wp]), capped, greedy_any, bundle)
        self._event_pair_end(e0, self._spec_events, B)
        pending = {
            "packed": packed.cpu(),  # the round's one (blocking) download
            "ready": None,
            "n_steps": B,
            "version": self._version,
            "was_active": active.copy(),
            "tasks": list(self._slot_task),
        }
        # acceptance accounting before _drain changes slot ownership
        emit_count = pending["packed"][2 * B].numpy()
        n_accepted = sum(
            max(0, int(emit_count[s]) - 1)
            for s, task in enumerate(pending["tasks"])
            if task is not None and active[s] and bundle.n_draft[s]
        )
        self.stats["spec_rounds"] += 1
        self.stats["spec_draft_tokens"] += int(bundle.n_draft.sum())
        self.stats["spec_accepted_tokens"] += n_accepted
        credited = self._drain(pending)
        self.stats["spec_rollback_pages"] += self._rollback_spec_pages()
        return credited

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
        if pending["ready"] is not None:
            pending["ready"].synchronize()
        packed = pending["packed"].numpy()
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
        credited = 0
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
                task.out_tokens.extend(toks[:c, slot].tolist())
                task.out_logprobs.extend(logps[:c, slot].tolist())
                task.out_versions.extend([version] * c)
                self.stats["generated_tokens"] += c
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
            rid=task.req.rid,
            metadata=dict(task.req.metadata),
        )
        if reason == StopReason.ABORT.value:
            self.stats["aborted"] += 1
        elif reason == StopReason.CANCEL.value:
            self.stats["cancelled"] += 1
        else:
            self.stats["completed"] += 1
        try:
            task.callback(resp)
        except Exception:  # noqa: BLE001 — one caller's callback must not
            # take the decode loop down
            logger.exception("generation callback failed")

    def _abort_all(self) -> None:
        """Finish every in-flight request with stop_reason "abort" and
        deactivate its slot on the device. A decoding request's full pages
        are published first, as the JAX engine does when it parks one
        (``decode_engine.py:3045``): its resubmit hits the radix tree."""
        deact = []
        for slot, task in enumerate(self._slot_task):
            if task is not None:
                if self._state["active"][slot]:
                    deact.append(slot)
                    self._publish_prefix(
                        list(task.req.input_ids) + list(task.out_tokens),
                        self._slot_pages[slot],
                        self._slot_page_versions[slot],
                        int(self._state["pos"][slot]),
                    )
                self._finish(task, StopReason.ABORT.value)
        if deact:
            self._apply_slot_updates(
                [self._pack_row(s, 0, int(self._state["pos"][s]), False, 0) for s in deact]
            )

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
                    self._apply_weight_update()
                    self._service_radix_flush()
                    pending = self._reap_aborts(pending)
                    if self._paused.is_set():
                        self._drain(pending)
                        pending = None
                        self._abort_all()
                        self._pause_ack.set()
                        self._wakeup.wait(timeout=0.05)
                        self._wakeup.clear()
                        continue
                    self._apply_slot_updates(self._admit_pending())
                    if self._spec_cfg is not None and self._drafter is not None:
                        # synchronous speculative pass: drain the pipelined
                        # chunk first (the spec-off -> on switch), then one
                        # round; a weight update applies only at the top of
                        # a pass, so draft and verify share one version
                        self._drain(pending)
                        pending = None
                        self._spec_round()
                        if not any(t is not None for t in self._slot_task):
                            self._wakeup.wait(timeout=0.05)
                            self._wakeup.clear()
                        continue
                    # dispatch the next chunk, then read the previous one
                    # while it computes
                    dispatched = self._dispatch_chunk()
                    self._drain(pending)
                    pending = dispatched
                    if pending is None and not any(t is not None for t in self._slot_task):
                        self._wakeup.wait(timeout=0.05)
                        self._wakeup.clear()
                # shutdown: every submitted request gets its terminal response
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
