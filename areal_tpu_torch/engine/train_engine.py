"""The train engine for one CUDA device — the port of
``areal_tpu/engine/train_engine.py`` (``JaxTrainEngine``).

What is kept from the JAX engine:

- A microbatch is a packed [G, L] grid of FFD rows (``utils/grid.py``); L is
  the longest sequence rounded up to a ``bucket_step`` bucket.
- ``train_batch(input_, loss_fn, loss_weight_fn)`` keeps the packed-loss
  protocol: each microbatch's loss is scaled by ``loss_weight_fn(mb) /
  total_weight`` and its gradients accumulate; then one optimizer step.
  In PyTorch the single-microbatch and the accumulate paths are one loop
  (gradients accumulate in ``.grad``); the reported stats follow the JAX
  engine's two paths, including the per-microbatch ``loss`` being the
  scaled loss when there are several.
- Master parameters in ``param_dtype`` (f32); the forward and backward run
  on a ``compute dtype`` cast of them (``qwen.ParamView``, the JAX
  ``_outputs_fn``), so the gradients arrive in f32.
- The optimizer is optax's ``chain(clip_by_global_norm, adamw)`` written out
  (``_OptaxAdamW``): the clip scales by ``max_norm / g_norm`` only when
  ``g_norm >= max_norm`` (no epsilon), the reported ``grad_norm`` is the
  norm before clipping, ``eps`` sits outside the square root, weight decay
  applies to every parameter, and the LR schedule is indexed by optax's
  count, so the first step has LR 0 and moves nothing.
- ``loss_fn(outputs, batch) -> (loss, {stat: scalar})``; ``outputs`` has
  label-aligned ``logprobs`` / ``entropy`` grids.

Not ported (``_check_supported`` raises ``NotImplementedError``): tree
training, LoRA, the vision tower, a critic / value head, multi-device
meshes and ``weight_update_mode="disk"``; also saving, loading, offloading
and the observability surfaces (per-sequence loss attribution, phases).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable

import numpy as np
import torch

from areal_tpu_torch.api.config import MicroBatchSpec, OptimizerConfig, TrainEngineConfig
from areal_tpu_torch.api.io_struct import FinetuneSpec, WeightUpdateMeta
from areal_tpu_torch.device import resolve_device
from areal_tpu_torch.models import qwen
from areal_tpu_torch.ops.attention import resolve_impl
from areal_tpu_torch.utils.data import TensorDict, round_up_to_bucket, seqlens_of
from areal_tpu_torch.utils.grid import Grid, pack_grid

# per-token keys that ship to device grids (everything else stays on host)
_GRID_KEYS = (
    "input_ids",
    "loss_mask",
    "advantages",
    "old_logprobs",
    "prox_logprobs",
    "prox_alpha",
    "ref_logprobs",
    "logprobs",
    "versions",
    "version_lag",
    "values",
    "target_values",
    "old_values",
    "labels",
    "label_valid",
)


def _np_device_dtype(v: np.ndarray) -> np.ndarray:
    """Host arrays ship in 32 bits: f64/i64 are loader artifacts."""
    if v.dtype == np.float64:
        return v.astype(np.float32)
    if v.dtype == np.int64:
        return v.astype(np.int32)
    return v


def _fold_weighted_stats(
    agg: dict[str, float], mb_host: list[dict], weights: list[float], total_w: float
) -> None:
    """Fold per-microbatch stat dicts into the step aggregate, weighted by
    each microbatch's loss weight."""
    for s, w in zip(mb_host, weights):
        for k, v in s.items():
            agg[k] = agg.get(k, 0.0) + float(v) * (w / total_w)


def make_lr_schedule(cfg: OptimizerConfig, total_steps: int) -> Callable[[int], float]:
    """Linear warmup from 0 over ``max(1, proportion * total_steps)`` steps,
    then constant / linear / cosine: optax's ``join_schedules`` of
    ``linear_schedule`` and the main schedule, as formulas of the count."""
    warmup = max(1, int(cfg.warmup_steps_proportion * total_steps))
    peak, floor = cfg.lr, cfg.lr * cfg.min_lr_ratio
    n = max(1, total_steps - warmup)
    if cfg.lr_scheduler_type == "constant":

        def main(c: int) -> float:
            return peak

    elif cfg.lr_scheduler_type == "linear":

        def main(c: int) -> float:
            return (peak - floor) * (1 - min(max(c, 0), n) / n) + floor

    elif cfg.lr_scheduler_type == "cosine":

        def main(c: int) -> float:
            cosine = 0.5 * (1 + math.cos(math.pi * min(c, n) / n))
            return peak * ((1 - cfg.min_lr_ratio) * cosine + cfg.min_lr_ratio)

    else:
        raise ValueError(cfg.lr_scheduler_type)

    def schedule(count: int) -> float:
        if count < warmup:
            return (0.0 - peak) * (1 - min(max(count, 0), warmup) / warmup) + peak
        return main(count - warmup)

    return schedule


class _OptaxAdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2,
    eps, weight_decay))`` over a list of f32 parameters, in place. The
    moments start at zero; ``count`` is optax's step count."""

    def __init__(self, params: list[torch.Tensor], cfg: OptimizerConfig, schedule):
        self.params = params
        self.cfg = cfg
        self.schedule = schedule
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @staticmethod
    def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
        sq = [torch.dot(g.reshape(-1).float(), g.reshape(-1).float()) for g in grads]
        return torch.stack(sq).sum().sqrt()

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor], gnorm: torch.Tensor | None = None) -> torch.Tensor:
        """One update; returns the global gradient norm before clipping (a
        device scalar: no host sync here). ``gnorm``, when given, is that
        norm already computed over ``grads``."""
        cfg = self.cfg
        b1, b2 = cfg.beta1, cfg.beta2
        if gnorm is None:
            gnorm = self.global_norm(grads)
        trigger = gnorm < cfg.gradient_clipping
        lr = self.schedule(self.count)
        t = np.float32(self.count + 1)
        # bias corrections in f32, as optax computes decay**count
        bc1 = float(np.float32(1) - np.power(np.float32(b1), t))
        bc2 = float(np.float32(1) - np.power(np.float32(b2), t))
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            g = torch.where(trigger, g, (g / gnorm) * cfg.gradient_clipping)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if cfg.weight_decay:
                upd.add_(p, alpha=cfg.weight_decay)
            p.add_(upd, alpha=-lr)
        self.count += 1
        return gnorm


class TorchTrainEngine:
    """Train engine over one model replica on one device (``JaxTrainEngine``
    on a one-device mesh)."""

    def __init__(
        self,
        config: TrainEngineConfig,
        value_head: bool = False,
        model_config: qwen.ModelConfig | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self._check_supported(config, value_head)
        self.config = config
        self._model_config = model_config
        self._version = 0
        self._version_lock = threading.Lock()
        self.model: qwen.QwenModel | None = None  # master parameters
        self.model_cfg: qwen.ModelConfig | None = None  # compute config
        self._opt: _OptaxAdamW | None = None
        self._lr_schedule = None
        self._inference_engine = None
        self._weight_update_meta: WeightUpdateMeta | None = None

    @staticmethod
    def _check_supported(cfg: TrainEngineConfig, value_head: bool) -> None:
        """Refuse the options whose code paths are later slices of the port
        (ROADMAP.md Queue A)."""
        if cfg.path:
            raise NotImplementedError(
                "loading an HF checkpoint (TrainEngineConfig.path) waits for a checkpoint in "
                "the repository (ROADMAP Queue A); pass model_config"
            )
        if cfg.tree_training:
            raise NotImplementedError("tree training: ROADMAP Queue A, tree training (kernels #4-#6)")
        if cfg.lora_rank > 0:
            raise NotImplementedError("LoRA: ROADMAP Queue A, LoRA and int8 weight serving")
        if cfg.train_vision_tower:
            raise NotImplementedError("vision tower: ROADMAP Queue A, vision")
        if value_head:
            raise NotImplementedError("critic / value head: ROADMAP Queue A, trainer (critic)")
        m = cfg.mesh
        if max(m.data, m.fsdp, m.seq, m.model, m.expert, m.pipe) > 1:
            raise NotImplementedError("multi-device mesh: ROADMAP Queue A, multi-GPU")
        if cfg.weight_update_mode != "mem":
            raise NotImplementedError(
                f"weight_update_mode={cfg.weight_update_mode!r}: only 'mem' is ported "
                "(disk updates: ROADMAP Queue A, trainer)"
            )
        if cfg.optimizer.type != "adamw":
            raise ValueError(f"optimizer {cfg.optimizer.type!r}: only adamw")
        resolve_impl(cfg.attn_impl)  # raises on "ring" and unknown names

    # -- lifecycle --------------------------------------------------------
    def initialize(self, ft_spec: FinetuneSpec | None = None, seed: int = 0) -> None:
        """Random f32 master parameters from ``seed`` (loading an HF
        checkpoint waits for a checkpoint in the repository) and zeroed
        optimizer state."""
        cfg = self.config
        if self._model_config is None:
            raise ValueError("model_config is required (loading a checkpoint is not ported)")
        # logit temperature of the logprob / entropy heads (PPOActorConfig's;
        # 1.0 for a plain TrainEngineConfig)
        self._logit_temperature = float(getattr(cfg, "temperature", 1.0))
        self.model_cfg = dataclasses.replace(
            self._model_config,
            dtype=cfg.dtype,
            remat=cfg.gradient_checkpointing,
            remat_policy=cfg.remat_policy,
            attn_impl=cfg.attn_impl,
        )
        master_cfg = dataclasses.replace(self.model_cfg, dtype=cfg.param_dtype)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.model = qwen.init_params(master_cfg, gen, device=self.device)
        self.model.requires_grad_(True)
        total_steps = ft_spec.total_train_steps if ft_spec else 10_000
        self._lr_schedule = make_lr_schedule(cfg.optimizer, total_steps)
        self._opt = _OptaxAdamW(list(self.model.parameters()), cfg.optimizer, self._lr_schedule)

    # -- versioning -------------------------------------------------------
    def set_version(self, version: int) -> None:
        with self._version_lock:
            self._version = version

    def get_version(self) -> int:
        with self._version_lock:
            return self._version

    # -- grid construction ------------------------------------------------
    def _make_grids(self, input_: TensorDict, mb_spec: MicroBatchSpec | None = None) -> list[Grid]:
        """Padded batch -> microbatch grids (FFD rows, bucketed L)."""
        if "pixel_values" in input_ or "image_embeds" in input_:
            raise NotImplementedError("image inputs: ROADMAP Queue A, vision")
        cfg = self.config
        lens = seqlens_of(input_)
        row_len = round_up_to_bucket(int(lens.max()), cfg.bucket_step)
        grid = pack_grid(input_, row_len)
        max_tok = (mb_spec or cfg.mb_spec).max_tokens_per_mb
        rows_per_mb = max(1, max_tok // row_len) if max_tok else grid.n_rows
        if rows_per_mb >= grid.n_rows:
            return [grid]
        # re-pack per microbatch: chunk sequences by their assigned row
        n_mbs = -(-grid.n_rows // rows_per_mb)
        mb_seqs: list[list[int]] = [[] for _ in range(n_mbs)]
        for local, r in enumerate(grid.row_of_seq):
            mb_seqs[r // rows_per_mb].append(grid.seq_index[local])
        out = []
        for seqs in mb_seqs:
            if not seqs:
                continue
            sub = {k: np.asarray(v)[seqs] for k, v in input_.items()}
            out.append(pack_grid(sub, row_len))
        return out

    def _grid_to_device(self, grid: Grid) -> dict[str, torch.Tensor]:
        """Per-token grid arrays (plus the causal labels) as device tensors."""
        seg = grid.data["segment_ids"]
        labels, label_valid = qwen.make_causal_inputs(grid.data["input_ids"], seg)
        batch: dict[str, np.ndarray] = {
            "segment_ids": seg,
            "positions": grid.data["positions"],
            "labels": labels,
            "label_valid": label_valid,
        }
        for k in _GRID_KEYS:
            if k in grid.data and k not in batch:
                batch[k] = grid.data[k]
        return {
            k: torch.from_numpy(np.ascontiguousarray(_np_device_dtype(np.asarray(v)))).to(self.device)
            for k, v in batch.items()
        }

    # -- model ------------------------------------------------------------
    def _outputs_fn(self, batch: dict[str, torch.Tensor], no_grad: bool = False) -> dict:
        """Label-aligned ``logprobs`` / ``entropy`` [G, L] of one grid, from
        the compute-dtype view of the master parameters."""
        view = qwen.ParamView(self.model, self.model_cfg)
        hidden = qwen.forward(
            view, batch["input_ids"], batch["segment_ids"], batch["positions"], no_grad=no_grad
        )
        logp, ent = qwen.chunked_logprobs_entropy(
            view,
            hidden,
            batch["labels"],
            chunk_size=self.config.logprob_chunk_size,
            temperature=self._logit_temperature,
        )
        return {"logprobs": logp, "entropy": ent}

    # -- TrainEngine API --------------------------------------------------
    def compute_grads(
        self,
        input_: TensorDict,
        loss_fn: Callable,
        loss_weight_fn: Callable[[TensorDict], float],
        mb_spec: MicroBatchSpec | None = None,
    ) -> dict[str, float]:
        """Forward and backward of every microbatch, each loss scaled by its
        share of the total loss weight; the gradients accumulate in the
        master parameters' ``.grad``. Returns the folded stats and
        ``grad_norm`` (before clipping); no optimizer step."""
        return self._compute_grads(input_, loss_fn, loss_weight_fn, mb_spec)[0]

    def _compute_grads(self, input_, loss_fn, loss_weight_fn, mb_spec):
        """``compute_grads``, also returning the gradient norm as a device
        scalar for the optimizer step."""
        if self.model is None:
            raise RuntimeError("engine not initialized")
        grids = self._make_grids(input_, mb_spec=mb_spec)
        weights = [float(loss_weight_fn(g.data)) for g in grids]
        total_w = sum(weights) or 1.0
        pending: list[dict[str, torch.Tensor]] = []
        for g, w in zip(grids, weights):
            batch = self._grid_to_device(g)
            loss, stats = loss_fn(self._outputs_fn(batch), batch)
            loss = loss * (w / total_w)
            loss.backward()
            pending.append({**{k: v.detach() for k, v in stats.items()}, "loss": loss.detach()})
        gnorm = _OptaxAdamW.global_norm(self._grads())
        keys = [list(s) for s in pending]
        # one device -> host transfer for every stat of every microbatch
        flat = torch.stack([s[k].float() for s in pending for k in s] + [gnorm]).tolist()
        mb_host, i = [], 0
        for ks in keys:
            mb_host.append(dict(zip(ks, flat[i : i + len(ks)])))
            i += len(ks)
        if len(grids) == 1:
            agg = dict(mb_host[0])
        else:
            agg = {}
            _fold_weighted_stats(agg, mb_host, weights, total_w)
        agg["grad_norm"] = flat[-1]
        agg["n_microbatches"] = float(len(grids))
        return agg, gnorm

    def _grads(self) -> list[torch.Tensor]:
        return [
            p.grad if p.grad is not None else torch.zeros_like(p) for p in self.model.parameters()
        ]

    def zero_grad(self) -> None:
        for p in self.model.parameters():
            p.grad = None

    def train_batch(
        self,
        input_: TensorDict,
        loss_fn: Callable,
        loss_weight_fn: Callable[[TensorDict], float],
        mb_spec: MicroBatchSpec | None = None,
    ) -> dict[str, float]:
        """Gradients of the whole batch, then one optimizer step. Returns
        the stats, ``loss``, ``grad_norm``, ``lr`` (of this step),
        ``n_microbatches`` and ``train_batch_secs``."""
        if self._opt is None:
            raise RuntimeError("engine not initialized")
        t0 = time.monotonic()
        step_before = self._opt.count
        self.zero_grad()
        agg, gnorm = self._compute_grads(input_, loss_fn, loss_weight_fn, mb_spec)
        self._opt.step(self._grads(), gnorm)
        self.zero_grad()
        agg["lr"] = float(self._lr_schedule(step_before))
        agg["train_batch_secs"] = time.monotonic() - t0
        return agg

    @torch.no_grad()
    def eval_batch(
        self,
        input_: TensorDict,
        loss_fn: Callable,
        loss_weight_fn: Callable[[TensorDict], float],
    ) -> dict[str, float]:
        grids = self._make_grids(input_)
        weights = [float(loss_weight_fn(g.data)) for g in grids]
        total_w = sum(weights) or 1.0
        pending = []
        for g in grids:
            batch = self._grid_to_device(g)
            loss, stats = loss_fn(self._outputs_fn(batch, no_grad=True), batch)
            pending.append({**stats, "loss": loss})
        mb_host = [{k: float(v) for k, v in s.items()} for s in pending]
        agg: dict[str, float] = {}
        _fold_weighted_stats(agg, mb_host, weights, total_w)
        return agg

    @torch.no_grad()
    def forward_batch(self, input_: TensorDict, output_key: str = "logprobs") -> np.ndarray:
        """Forward only. Returns [B, L] f32 aligned with the input padded
        batch: out[b, t] = log p(token t | prefix), out[b, 0] = 0."""
        B, L = np.asarray(input_["attention_mask"]).shape
        out = np.zeros((B, L), dtype=np.float32)
        grids = self._make_grids(input_)
        pending = [self._outputs_fn(self._grid_to_device(g), no_grad=True)[output_key] for g in grids]
        for vals, g in zip(pending, grids):
            vals = vals.float().cpu().numpy()
            # label-aligned output shifts right one: token t's logp was
            # computed at position t-1, so out[src, 1:n] = row[:n-1]
            lens = np.asarray(g.seq_lens, np.int64)
            n_eff = np.maximum(lens - 1, 0)
            seq_of = np.repeat(np.arange(len(lens)), n_eff)
            within = np.arange(n_eff.sum()) - np.repeat(np.cumsum(n_eff) - n_eff, n_eff)
            src_r = np.asarray(g.row_of_seq)[seq_of]
            src_c = np.asarray(g.col_of_seq)[seq_of] + within
            dst_r = np.asarray(g.seq_index)[seq_of]
            out[dst_r, within + 1] = vals[src_r, src_c]
        return out

    # -- weights ----------------------------------------------------------
    def connect_engine(self, engine, meta: WeightUpdateMeta | None = None) -> None:
        """Connect the decode engine that ``update_weights`` pushes to (the
        port's ``DecodeEngine``, in process)."""
        self._inference_engine = engine
        self._weight_update_meta = meta

    def update_weights(self, meta: WeightUpdateMeta | None = None) -> None:
        """Push the current weights into the connected decode engine (mem
        mode: the exported state dict goes to
        ``DecodeEngine.update_weights_from_params``, which casts them into
        its own weights). The version rule is the rollout client's: the
        engine's version + 1 when ``meta.with_version``."""
        meta = meta or self._weight_update_meta
        if meta is None:
            raise ValueError("no WeightUpdateMeta configured")
        if meta.type != "mem":
            raise NotImplementedError(
                f"weight update type {meta.type!r}: only 'mem' is ported (ROADMAP Queue A, trainer)"
            )
        if meta.lora_only:
            raise NotImplementedError("LoRA weight updates: ROADMAP Queue A, LoRA")
        eng = self._inference_engine
        if eng is None:
            raise RuntimeError("no decode engine connected (connect_engine)")
        version = eng.get_version() + 1 if meta.with_version else eng.get_version()
        eng.update_weights_from_params(self._export_params(), version=version)

    def _export_params(self) -> dict[str, torch.Tensor]:
        """The master parameters as a state dict (detached views, no copy)."""
        return {name: p.detach() for name, p in self.model.named_parameters()}
