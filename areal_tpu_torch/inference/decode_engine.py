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
  ``stop_reason="abort"`` and its partial tokens; the client resubmits.

Not ported yet (raise ``NotImplementedError``, see ``_check_supported``):
the radix prefix cache, speculative decoding, int8 weights, frequency
penalty, image inputs, multi-device meshes and loading HF checkpoints.
Also not ported: KV parking across an abort (resubmits re-prefill), GRPO
duplicate-prompt page aliasing (duplicates prefill like any prompt), the
hold fence, deadlines and the watchdog, and the observability surfaces.

Eager PyTorch compiles nothing, so admission does not pad prefill groups to
compiled sizes: a group pads to its longest prompt.
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
    place, casting to the model's dtype. Every parameter must be present."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise ValueError(f"weight update mismatch: missing {missing[:4]}, unexpected {extra[:4]}")
    with torch.no_grad():
        for name, p in own.items():
            src = params[name]
            if not isinstance(src, torch.Tensor):
                src = torch.as_tensor(np.asarray(src))
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(p.shape)}")
            p.copy_(src)


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
            "chunks": 0,
            "decode_steps": 0,
            "prefills": 0,
            "prefill_batches": 0,
            "prefill_tokens": 0,
            "preempted": 0,
        }
        # device-stream time of prefill batches and decode chunks, as CUDA
        # event pairs read after the fact (never a sync on the hot loop)
        self._prefill_events: list[tuple] = []
        self._chunk_events: list[tuple] = []

    @staticmethod
    def _check_supported(cfg: ServerConfig) -> None:
        """Refuse the options whose code paths are later slices of the port
        (ROADMAP.md Queue A)."""
        if cfg.enable_prefix_caching and cfg.prefix_cache.enabled:
            raise NotImplementedError(
                "radix prefix cache: ROADMAP Queue A slice 3 (set "
                "enable_prefix_caching=False)"
            )
        if cfg.speculative.enabled:
            raise NotImplementedError("speculative decoding: ROADMAP Queue A slice 3")
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
        self._pt_host = np.zeros((S, self._maxp), np.int32)

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

    # -- pause / weights --------------------------------------------------
    def pause_generation(self, mode: str = "abort") -> None:
        """Stop the decode loop until ``continue_generation``: in-flight
        requests complete with stop_reason "abort" and their partial tokens;
        the client resubmits prompt + emitted after the pause. (The hold
        fence of the JAX engine is not ported.)"""
        if mode != "abort":
            raise NotImplementedError(f"pause mode {mode!r}: only 'abort' is ported")
        self._paused.set()
        self._wakeup.set()

    def continue_generation(self) -> None:
        self._paused.clear()
        self._wakeup.set()

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
            except Exception as e:  # noqa: BLE001 — a bad payload fails that
                # update (the waiter re-raises), not the decode loop
                self._weight_update_error = e
                logger.error(f"weight update failed: {type(e).__name__}: {e}")
            self._pending_weight_update = None

    def set_version(self, v: int) -> None:
        self._version = v

    def get_version(self) -> int:
        return self._version

    # -- timing (device stream) -------------------------------------------
    def device_seconds(self) -> dict:
        """Summed device-stream seconds of prefill batches and decode chunks
        recorded so far (CUDA only; synchronizes on the recorded events)."""
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
        """Admit backlog + queue into free slots; group prompts by length
        bucket and batch-prefill them. Returns the slot-update rows."""
        T = self.config.max_seq_len
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
        by_bucket: dict[int, list[tuple[_Task, int]]] = {}
        for task, slot in to_prefill:
            bucket = min(T, round_up_to_bucket(len(task.req.input_ids), 256))
            by_bucket.setdefault(bucket, []).append((task, slot))
        for _, group in sorted(by_bucket.items()):
            i = 0
            while i < len(group):
                A = next(a for a in _PREFILL_SIZES if a <= len(group) - i)
                rows.extend(self._prefill_group(group[i : i + A]))
                i += A
        return rows

    def _prefill_group(self, group: list[tuple[_Task, int]]) -> list[np.ndarray]:
        """Allocate pages, run one batched prefill (padded to the longest
        prompt) and scatter its KV into the pages."""
        psz = self.config.page_size
        admitted: list[tuple[_Task, int]] = []
        for task, slot in group:
            need = -(-len(task.req.input_ids) // psz)
            pages = self.pool.alloc(need)
            if pages is None:
                self._backlog.append(task)  # pool pressure: retry later
                continue
            self._slot_pages[slot] = pages
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
    def _ensure_pages(self) -> None:
        """Allocation-ahead: every active slot gets pages covering
        ``pos + 2*n_steps`` writes (host pos can be one in-flight chunk
        stale). On pool exhaustion, preempt the active slot with the most
        remaining budget (it aborts with its partial tokens); a slot that
        cannot grow but whose pages cover one more chunk has its budget
        clamped to that coverage instead."""
        st = self._state
        psz = self.config.page_size
        n_steps = self.config.decode_steps_per_call
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
            # zeroing the block-table row steers any in-flight chunk's
            # stale write for this slot to the trash page
            self.pool.free(self._slot_pages[task.slot])
            self._slot_pages[task.slot] = []
            self._pt_host[task.slot] = 0
        now = time.monotonic()
        resp = ModelResponse(
            input_tokens=list(task.req.input_ids),
            output_tokens=task.out_tokens,
            output_logprobs=task.out_logprobs,
            output_versions=task.out_versions,
            stop_reason=reason,
            latency=now - task.submit_time,
            ttft=(task.first_token_time or now) - task.submit_time,
            rid=task.req.rid,
            metadata=dict(task.req.metadata),
        )
        if reason == StopReason.ABORT.value:
            self.stats["aborted"] += 1
        else:
            self.stats["completed"] += 1
        try:
            task.callback(resp)
        except Exception:  # noqa: BLE001 — one caller's callback must not
            # take the decode loop down
            logger.exception("generation callback failed")

    def _abort_all(self) -> None:
        """Finish every in-flight request with stop_reason "abort" and
        deactivate its slot on the device."""
        deact = []
        for slot, task in enumerate(self._slot_task):
            if task is not None:
                if self._state["active"][slot]:
                    deact.append(slot)
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
                    if self._paused.is_set():
                        self._drain(pending)
                        pending = None
                        self._abort_all()
                        self._wakeup.wait(timeout=0.05)
                        self._wakeup.clear()
                        continue
                    self._apply_slot_updates(self._admit_pending())
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
