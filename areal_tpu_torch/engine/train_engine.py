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
- Tree training (``tree_training=True``): ``train_batch`` and
  ``compute_grads`` chunk the batch into forests under
  ``tree_node_budget`` nodes (``_make_tree_batches``), one microbatch per
  forest, whose forward and backward run once per unique trie node through
  the tree kernels; the loss sees the same label-aligned [B, T] outputs,
  gathered from the trie's edges. ``forward_batch`` and ``eval_batch``
  stay on the packed grids, as in the JAX engine.

- MoE models (the qwen3_moe family): the forward returns the router's
  load-balance aux, which ``outputs["moe_aux"]`` carries on both paths
  (packed: over every grid token; tree: over the unique nodes), as the JAX
  engine puts it. No loss function here adds it: a caller's loss adds
  ``router_aux_coef * outputs["moe_aux"]``. The grouped matmuls' backward
  runs through the hand-written dLHS and tgmm kernels (``ops/gmm.py``).

- The rollout plumbing (``train_engine.py:1405-1481``): ``connect_engine``
  takes an ``InferenceEngine`` (the port's ``RemoteTorchEngine``), to which
  ``update_weights`` hands the exported master weights
  (``engine.update_weights(meta, params=...)``) and ``prepare_batch`` /
  ``rollout_batch`` delegate; or, in process, a ``DecodeEngine``, into which
  ``update_weights`` copies them. Host prep, forward / backward and the
  optimizer step report their spans to the trainer's step timeline
  (``observability/step_timeline.engine_phase``), and ``hbm_ledger``
  itemizes the parameters and optimizer state beside the card's memory.

Not ported (``_check_supported`` raises ``NotImplementedError``): LoRA,
the vision tower, a critic / value head, multi-device meshes and
``weight_update_mode="disk"``; ``save`` and ``load`` raise (ROADMAP Queue A
item 3); also offloading and per-sequence loss attribution.
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
from areal_tpu_torch.api.engine_api import TrainEngine
from areal_tpu_torch.api.io_struct import FinetuneSpec, WeightUpdateMeta
from areal_tpu_torch.device import resolve_device
from areal_tpu_torch.models import qwen
from areal_tpu_torch.observability import step_timeline
from areal_tpu_torch.observability.step_timeline import engine_phase
from areal_tpu_torch.models import tree as tree_lib
from areal_tpu_torch.ops.attention import resolve_impl
from areal_tpu_torch.ops.tree_attention import BLOCK, forest_hidden, pack_ancestor_bits
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

    def state_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.mu + self.nu)

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


class TorchTrainEngine(TrainEngine):
    """Train engine over one model replica on one device (``JaxTrainEngine``
    on a one-device mesh)."""

    def __init__(
        self,
        config: TrainEngineConfig,
        value_head: bool = False,
        model_config: qwen.ModelConfig | None = None,
        device=None,
        need_optimizer: bool = True,
    ):
        self.device = resolve_device(device)
        self._check_supported(config, value_head, model_config)
        self.config = config
        # False for a frozen policy (the reference of the KL term): no
        # optimizer state
        self.need_optimizer = need_optimizer
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
    def _check_supported(
        cfg: TrainEngineConfig, value_head: bool, model_config: qwen.ModelConfig | None = None
    ) -> None:
        """Refuse the options whose code paths are later slices of the port
        (ROADMAP.md Queue A)."""
        if cfg.path:
            raise NotImplementedError(
                "loading an HF checkpoint (TrainEngineConfig.path) waits for a checkpoint in "
                "the repository (ROADMAP Queue A); pass model_config"
            )
        if cfg.tree_training and value_head:
            raise NotImplementedError(
                "tree training is a policy-only path, as in the JAX engine (critics: ROADMAP "
                "Queue A, trainer (critic))"
            )
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
        if self.need_optimizer:
            self._opt = _OptaxAdamW(list(self.model.parameters()), cfg.optimizer, self._lr_schedule)
        else:
            self.model.requires_grad_(False)

    # -- versioning -------------------------------------------------------
    def set_version(self, version: int) -> None:
        with self._version_lock:
            self._version = version

    def get_version(self) -> int:
        with self._version_lock:
            return self._version

    # -- grid construction ------------------------------------------------
    @staticmethod
    def _refuse_images(input_: TensorDict) -> None:
        if "pixel_values" in input_ or "image_embeds" in input_:
            raise NotImplementedError("image inputs: ROADMAP Queue A, vision")

    def _make_grids(self, input_: TensorDict, mb_spec: MicroBatchSpec | None = None) -> list[Grid]:
        """Padded batch -> microbatch grids (FFD rows, bucketed L)."""
        self._refuse_images(input_)
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

    # -- tree training ----------------------------------------------------
    def _make_tree_batches(self, input_: TensorDict) -> tuple[list[dict], dict[str, float]]:
        """Padded [B, T] batch -> host forest microbatches + dedup stats
        (``train_engine.py:996``). Sequences chunk into forests under
        ``tree_node_budget`` unique nodes, GRPO groups kept whole
        (``tree.pack_forest``); each forest's ancestor relation packs into
        mask words, and every label-aligned loss key is sliced to the
        forest's rows. The node axis pads to a ``tree_node_bucket`` bucket
        (a multiple of BLOCK), the time axis to a ``bucket_step`` bucket
        capped at T, and the rows to a bucket of 8 with inert dummy rows
        (label_valid False, zero loss keys)."""
        self._refuse_images(input_)
        cfg = self.config
        lens = seqlens_of(input_)
        ids = np.asarray(input_["input_ids"])
        T_orig = ids.shape[1]
        seqs = [ids[b, : lens[b]] for b in range(len(lens))]
        packs = tree_lib.pack_forest(seqs, cfg.tree_node_budget, getattr(cfg, "group_size", 1))
        batches: list[dict] = []
        for pack, rows in packs:
            N = pack.n_nodes
            n_pad = round_up_to_bucket(N, max(cfg.tree_node_bucket, BLOCK))
            n_pad = -(-n_pad // BLOCK) * BLOCK
            words, block_any = pack_ancestor_bits(pack.parent, n_pad)
            node_ids = np.zeros(n_pad, np.int32)
            node_ids[:N] = pack.tokens
            node_pos = np.zeros(n_pad, np.int32)
            node_pos[:N] = pack.depth
            # edge j (every non-root node): score row parent(j) against
            # token(j); roots clamp to row 0 and are never gathered
            edge_rows = np.zeros(n_pad, np.int32)
            edge_rows[:N] = np.maximum(pack.parent, 0)
            edge_labels = np.zeros(n_pad, np.int32)
            edge_labels[:N] = pack.tokens
            Tp = min(T_orig, round_up_to_bucket(int(max(lens[r] for r in rows)), cfg.bucket_step))
            B = len(rows)
            B_pad = round_up_to_bucket(B, 8)
            gather = np.zeros((B_pad, Tp), np.int32)
            label_valid = np.zeros((B_pad, Tp), bool)
            for i in range(B):
                nodes = pack.seq_nodes[i]
                gather[i, : len(nodes) - 1] = nodes[1:]
                label_valid[i, : len(nodes) - 1] = True
            batch = {
                "node_ids": node_ids,
                "node_pos": node_pos,
                "mask_words": words,
                "block_any": block_any,
                "edge_rows": edge_rows,
                "edge_labels": edge_labels,
                "gather_idx": gather,
                "label_valid": label_valid,
            }
            for k in _GRID_KEYS:
                if k in ("labels", "label_valid") or k not in input_:
                    continue
                v = np.asarray(input_[k])[rows]
                if v.ndim >= 2 and v.shape[1] == T_orig:
                    v = v[:, :Tp]
                if B_pad > B:
                    v = np.concatenate([v, np.zeros((B_pad - B, *v.shape[1:]), v.dtype)], axis=0)
                batch[k] = v
            batches.append(batch)
        total_tokens = int(lens.sum())
        total_nodes = sum(p.n_nodes for p, _ in packs)
        stats = {
            "tree_tokens": float(total_tokens),
            "tree_nodes": float(total_nodes),
            # forward / backward FLOPs scale with nodes, not tokens
            "tree_dedup_ratio": float(total_tokens) / max(total_nodes, 1),
        }
        return batches, stats

    def _tree_batch_to_device(self, batch: dict) -> dict[str, torch.Tensor]:
        """Host forest arrays as device tensors; the uint32 mask words go as
        their int32 bits (``ops/tree_attention.py``)."""
        out = {}
        for k, v in batch.items():
            v = np.asarray(v)
            v = v.view(np.int32) if v.dtype == np.uint32 else _np_device_dtype(v)
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
        return out

    def _tree_outputs_fn(self, batch: dict[str, torch.Tensor]) -> dict:
        """Label-aligned ``logprobs`` / ``entropy`` [B, T] of one forest
        (``train_engine.py:852``): the decoder runs once per trie node, the
        chunked vocab pass once per edge (row parent(j) against token(j)),
        and ``gather_idx`` maps each sequence's token t+1 to its edge."""
        view = qwen.ParamView(self.model, self.model_cfg)
        moe = self.model_cfg.num_experts > 0
        out = forest_hidden(
            view, batch["node_ids"], batch["node_pos"], batch["mask_words"], batch["block_any"], with_aux=moe
        )
        hidden, aux = out if moe else (out, None)
        logp, ent = qwen.chunked_logprobs_entropy(
            view,
            hidden[batch["edge_rows"].long()][None],
            batch["edge_labels"][None],
            chunk_size=self.config.logprob_chunk_size,
            temperature=self._logit_temperature,
        )
        gather = batch["gather_idx"].long()
        outputs = {"logprobs": logp[0][gather], "entropy": ent[0][gather]}
        if aux is not None:  # over the unique nodes (train_engine.py:896)
            outputs["moe_aux"] = aux
        return outputs

    # -- model ------------------------------------------------------------
    def _outputs_fn(self, batch: dict[str, torch.Tensor], no_grad: bool = False) -> dict:
        """Label-aligned ``logprobs`` / ``entropy`` [G, L] of one grid, from
        the compute-dtype view of the master parameters."""
        view = qwen.ParamView(self.model, self.model_cfg)
        moe = self.model_cfg.num_experts > 0
        out = qwen.forward(
            view, batch["input_ids"], batch["segment_ids"], batch["positions"], no_grad=no_grad, with_aux=moe
        )
        hidden, aux = out if moe else (out, None)
        logp, ent = qwen.chunked_logprobs_entropy(
            view,
            hidden,
            batch["labels"],
            chunk_size=self.config.logprob_chunk_size,
            temperature=self._logit_temperature,
        )
        outputs = {"logprobs": logp, "entropy": ent}
        if aux is not None:  # the router load-balance aux (train_engine.py:762)
            outputs["moe_aux"] = aux
        return outputs

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
        extra: dict[str, float] = {}
        with engine_phase("host_prep"):
            if self.config.tree_training:  # one microbatch per forest
                mbs, extra = self._make_tree_batches(input_)
                weights = [float(loss_weight_fn(b)) for b in mbs]
                to_device, outputs_fn = self._tree_batch_to_device, self._tree_outputs_fn
            else:
                mbs = self._make_grids(input_, mb_spec=mb_spec)
                weights = [float(loss_weight_fn(g.data)) for g in mbs]
                to_device, outputs_fn = self._grid_to_device, self._outputs_fn
        total_w = sum(weights) or 1.0
        pending: list[dict[str, torch.Tensor]] = []
        for mb, w in zip(mbs, weights):
            with engine_phase("host_prep"):
                batch = to_device(mb)
            with engine_phase("forward_backward"):
                loss, stats = loss_fn(outputs_fn(batch), batch)
                loss = loss * (w / total_w)
                loss.backward()
            pending.append({**{k: v.detach() for k, v in stats.items()}, "loss": loss.detach()})
        with engine_phase("forward_backward"):
            gnorm = _OptaxAdamW.global_norm(self._grads())
            keys = [list(s) for s in pending]
            # one device -> host transfer for every stat of every microbatch
            flat = torch.stack([s[k].float() for s in pending for k in s] + [gnorm]).tolist()
        mb_host, i = [], 0
        for ks in keys:
            mb_host.append(dict(zip(ks, flat[i : i + len(ks)])))
            i += len(ks)
        if len(mbs) == 1:
            agg = dict(mb_host[0])
        else:
            agg = {}
            _fold_weighted_stats(agg, mb_host, weights, total_w)
        agg["grad_norm"] = flat[-1]
        agg["n_microbatches"] = float(len(mbs))
        agg.update(extra)
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
        with engine_phase("optimizer"):
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
        with engine_phase("host_prep"):
            grids = self._make_grids(input_)
            dev = [self._grid_to_device(g) for g in grids]
        with engine_phase("forward_backward"):
            pending = [self._outputs_fn(d, no_grad=True)[output_key].float().cpu().numpy() for d in dev]
        del dev
        for vals, g in zip(pending, grids):
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

    # -- rollout plumbing and weights ---------------------------------------
    def connect_engine(self, engine, meta: WeightUpdateMeta | None = None) -> None:
        """Connect the engine that ``update_weights`` pushes to and
        ``prepare_batch`` / ``rollout_batch`` delegate to: an
        ``InferenceEngine`` (``RemoteTorchEngine``), or an in-process
        ``DecodeEngine`` (which has no rollout methods)."""
        self._inference_engine = engine
        self._weight_update_meta = meta

    def prepare_batch(self, *args, **kwargs) -> TensorDict:
        """The connected engine's ``prepare_batch`` (one process; the
        multi-host rollout coordinator is ROADMAP Queue A item 6)."""
        if self._inference_engine is None:
            raise RuntimeError("no inference engine connected (connect_engine)")
        return self._inference_engine.prepare_batch(*args, **kwargs)

    def rollout_batch(self, *args, **kwargs) -> TensorDict:
        if self._inference_engine is None:
            raise RuntimeError("no inference engine connected (connect_engine)")
        return self._inference_engine.rollout_batch(*args, **kwargs)

    def update_weights(self, meta: WeightUpdateMeta | None = None) -> None:
        """Push the master weights to the connected engine (mem mode). An
        ``InferenceEngine`` gets ``update_weights(meta, params=state dict)``,
        as in ``areal_tpu/engine/train_engine.py:1479``; its client picks
        the version. An in-process ``DecodeEngine`` gets
        ``update_weights_from_params`` at its version + 1 when
        ``meta.with_version``."""
        meta = meta or self._weight_update_meta
        if meta is None:
            raise ValueError("no WeightUpdateMeta configured")
        if meta.type != "mem":
            raise NotImplementedError(
                f"weight update type {meta.type!r}: only 'mem' is ported (ROADMAP Queue A item 3)"
            )
        if meta.lora_only:
            raise NotImplementedError("LoRA weight updates: ROADMAP Queue A item 4")
        eng = self._inference_engine
        if eng is None:
            raise RuntimeError("no engine connected (connect_engine)")
        if hasattr(eng, "update_weights_from_params"):  # the in-process join
            version = eng.get_version() + 1 if meta.with_version else eng.get_version()
            eng.update_weights_from_params(self._export_params(), version=version)
        else:
            eng.update_weights(meta, params=self._export_params())

    def _export_params(self) -> dict[str, torch.Tensor]:
        """The master parameters as a state dict (detached views, no copy)."""
        return {name: p.detach() for name, p in self.model.named_parameters()}

    def save(self, meta) -> None:
        raise NotImplementedError("saving checkpoints: ROADMAP Queue A item 3")

    def load(self, meta) -> None:
        raise NotImplementedError("loading checkpoints: ROADMAP Queue A item 3")

    def hbm_ledger(self, override_hbm_gb: float | None = None) -> dict:
        """Itemized device memory of this engine: the parameters and the
        optimizer state beside the card's use and size."""
        params = sum(p.numel() * p.element_size() for p in self.model.parameters())
        opt = self._opt.state_bytes() if self._opt is not None else 0
        return step_timeline.build_hbm_ledger(
            {"params": params, "opt_state": opt}, device=self.device, override_hbm_gb=override_hbm_gb
        )
