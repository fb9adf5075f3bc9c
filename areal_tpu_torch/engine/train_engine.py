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
  applies to every trainable parameter, and the LR schedule is indexed by optax's
  count, so the first step has LR 0 and moves nothing.
- ``loss_fn(outputs, batch) -> (loss, {stat: scalar})``; ``outputs`` has
  label-aligned ``logprobs`` / ``entropy`` grids, or, for an engine built
  with ``value_head=True`` (a critic or a reward model), token-aligned
  ``values`` grids and no logprobs. When the batch carries
  ``lineage_id`` (the rollout executor stamps one per trajectory), the
  training grids also carry the segment map ``seq_slot`` / ``seq_slots``,
  and a loss may return per-slot ``seq__*`` arrays beside its scalars:
  they leave the card in the same single transfer per optimizer step as
  the scalars and land in ``last_seq_stats`` in the input's order
  (``train_engine.py:641-684``, ``:1175-1276``).
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

- Durable state (``train_engine.py:1430-1588``): ``initialize`` loads
  ``TrainEngineConfig.path`` (an HF checkpoint, ``models/hf.py``) at
  ``param_dtype`` unless ``init_from_scratch``; ``save`` / ``load`` take
  ``weight_format="hf"`` (the exported weights) or ``"state"``, the port's
  recover format in place of JAX's Orbax one: the master parameters, the
  AdamW moments and the step count as safetensors files under
  ``<path>/state/`` beside a JSON manifest written last (all in
  ``state.tmp/``, renamed into place). ``snapshot_for_save``
  / ``write_snapshot`` split an asynchronous save (``Saver.save_async``):
  the snapshot copies the state into pinned host buffers (allocated once) on
  a side stream and returns without waiting, and the next optimizer step
  waits for that stream's event on the device before it mutates anything,
  so the snapshot is the state of one step even though torch updates in
  place. ``update_weights`` of type "disk" exports the weights as HF
  safetensors (``v<N>`` directories under ``with_version``) and has the
  connected engine reload them. ``offload`` / ``onload`` move the
  parameters and moments to pinned host memory and back.

- The value head (``train_engine.py:284-288``, ``:766-769``): a zero
  ``[hidden_size]`` parameter at ``param_dtype``, added after the body is
  built or loaded and registered on the model as ``value_head``, so the
  optimizer (weight decay included), the recover state and ``offload``
  carry it. ``values`` = the f32 product of the final hidden states with
  the head (a plain matvec: no Pallas kernel computes it in JAX).
  ``forward_batch(output_key="values")`` returns them token-aligned. The
  HF export and the weight update to a server leave the head out (it has
  no HF name), and an HF ``load`` keeps the engine's head. Tree training
  with a value head raises ``ValueError``: the JAX engine asserts that
  tree training is a policy-only path.

- LoRA (``lora_rank > 0``; ``train_engine.py:295-370``, ``:1430-1490``):
  the model carries rank-r adapters on ``lora_targets`` (``qwen._proj``),
  and only they (and a value head) train. The base stays frozen: it has no
  gradient and no AdamW moments, and the global norm, its clip and the
  decoupled weight decay see only the trainable leaves, as JAX's
  ``optax.multi_transform(..., set_to_zero)`` does. The HF export, ``save``
  in "hf" and a full weight update carry the merged weights
  (``qwen.merge_lora``); a load from HF adds fresh adapters again (seed
  0), as JAX's does. ``update_weights`` with ``meta.lora_only`` sends only
  the adapters, stacked in the JAX layout (``layers/<t>_lora_a`` [n, in,
  r], ``layers/<t>_lora_b`` [n, r, out]), with ``lora_scale`` = alpha / r;
  on a model without adapters it warns and sends a full update.

- A VLM (``train_engine.py:305-335``, ``:485-745``): a batch with
  ``pixel_values`` (``[B, P, patch_dim]``, ``pixel_counts``,
  ``pixel_pos_ids``) has its tower embeddings placed at the image-pad
  tokens. By default the tower is frozen: no gradient, no AdamW state, and
  no weight decay reaches it, and ``_attach_image_embeds`` runs it once per
  batch, memoised by the identity of the batch's arrays and the version (a
  ``forward_batch`` and a ``train_batch`` of one batch share one run), and
  scatters its embeddings into a per-token ``image_embeds`` key that the
  grids carry. It runs on the compute-dtype view of the master weights,
  the precision of the server's tower and of the trainable path (JAX runs
  it on the param-dtype master: ROADMAP Queue C, PR 24). With ``train_vision_tower``
  it trains with the LM: the padded pixels ride with each grid (the
  sequence count bucketed to 8), the tower runs on the compute-dtype view
  inside ``_outputs_fn``'s autograd, and an ``image_slot`` map gathers its
  embeddings per token; LoRA with it is refused, as JAX refuses it. An HF
  load without ``visual.*`` initializes the tower afresh, as JAX does.
  Tree training refuses images.

- Across GPUs (``train_engine.py:206-220``, ``:600-663``): when
  ``torch.distributed`` is up (``torchrun``, ``parallel/mesh.py
  init_distributed``) the engine lays the world out as ``config.mesh`` and
  places the model by ``qwen.shard_model`` (FSDP2 over data x fsdp, tensor
  parallelism over ``model``, an MoE model's experts split over
  ``expert``), whatever the world's size: a world of one runs the same
  code. The ranks of an ``expert`` group hold the same rows and run the
  same attention; each computes its experts' share of every MoE FFN,
  summed over the group (``models/moe.py``), and the router aux loss in
  ``outputs["moe_aux"]`` is counted once a grid (JAX's mean over the row
  blocks). ``train_batch`` / ``forward_batch`` keep JAX's
  contract: every rank gets the same global batch and packs the same
  grids, their rows rounded up to the data-parallel degree, and each rank
  computes its block of rows of each grid (``mesh.dp_rank``). A
  microbatch's loss on a block is weighted by the block's share of the
  whole batch's loss weight, so the gradients, summed over data x fsdp in
  f32, are those of the whole grid; the scalar stats combine over the
  blocks by the same weights, and ``forward_batch`` returns every row in
  global order on every rank. AdamW steps on each rank's shards, its
  global norm summed over the mesh (the leaves replicated over ``model``
  or ``expert`` counted once). ``update_weights`` gathers the weights on every rank and
  rank 0 alone streams them; ``save`` gathers and rank 0 writes the files
  the unsharded engine writes (byte for byte), and ``load`` reads them on
  every rank and keeps the rank's shards, so a trainer resumes on another
  mesh shape. The asynchronous snapshot holds the gathered leaves, in rank
  0's pinned buffers. ``prepare_batch`` / ``rollout_batch`` go through
  ``infra/dist_rollout.DistRolloutCoordinator``: rank 0 pulls and every
  rank gets the global batch.

Not ported (``NotImplementedError`` naming its ROADMAP Queue A item): the
``seq`` and ``pipe`` axes above 1 (6b-3, 6b-4), on a mesh tree training,
LoRA and a vision tower (6b-2b), and the M2PO loss (``use_m2po_loss``)
over data x fsdp above 1 (6b): its mask drops the whole grid's largest
squared logp gaps and its token mean divides by the whole grid's
surviving tokens, neither of which a block of rows sees.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import shutil
import threading
import time
from typing import Callable

import numpy as np
import torch

from areal_tpu_torch.api.config import MicroBatchSpec, OptimizerConfig, TrainEngineConfig
from areal_tpu_torch.api.engine_api import TrainEngine
from areal_tpu_torch.api.io_struct import (RECOVER_FORMAT, RECOVER_MANIFEST, RECOVER_STATE_DIR, FinetuneSpec,
                                           SaveLoadMeta, WeightUpdateMeta)
from areal_tpu_torch.device import resolve_device
from areal_tpu_torch.models import qwen, vision as vis
from areal_tpu_torch.models.hf import load_params_from_hf, save_params_to_hf
from areal_tpu_torch.observability import step_timeline
from areal_tpu_torch.observability.step_timeline import engine_phase
from areal_tpu_torch.models import tree as tree_lib
from areal_tpu_torch.ops.attention import resolve_impl
from areal_tpu_torch.ops.tree_attention import BLOCK, forest_hidden, pack_ancestor_bits
from areal_tpu_torch.parallel import mesh as mesh_lib
from areal_tpu_torch.utils import atomic_io
from areal_tpu_torch.utils.data import TensorDict, round_up_to_bucket, seqlens_of
from areal_tpu_torch.utils.grid import Grid, pack_grid
from areal_tpu_torch.utils.offload import offload_storages, onload_storages
from areal_tpu_torch.utils.safetensors_io import SafetensorsFile, save_file

logger = logging.getLogger("areal_tpu_torch.train_engine")


def _check_recover_format(fmt: str) -> None:
    if fmt == "orbax":
        raise ValueError(f"the port keeps its recover state in the {RECOVER_FORMAT!r} format, not 'orbax'")
    if fmt != RECOVER_FORMAT:
        raise ValueError(f"unknown weight_format {fmt!r}; valid: hf|{RECOVER_FORMAT}")

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
    # the reward model's pairs (trainer/sft_trainer.py RWEngine)
    "rw_pair_id",
    "rw_sign",
    "rw_last_mask",
    # a VLM's frozen-tower embeddings, [.., D] per token
    "image_embeds",
)


def _np_device_dtype(v: np.ndarray) -> np.ndarray:
    """Host arrays ship in 32 bits: f64/i64 are loader artifacts."""
    if v.dtype == np.float64:
        return v.astype(np.float32)
    if v.dtype == np.int64:
        return v.astype(np.int32)
    return v


def _local(t: torch.Tensor) -> torch.Tensor:
    """A leaf's tensor on this rank: a DTensor's local shard (the storage
    that FSDP2 gathers from, so an in-place update of it is the update of
    the leaf), else the tensor itself."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        with torch.no_grad():
            return t.to_local()
    return t


def _fold_weighted_stats(
    agg: dict[str, float], mb_host: list[dict], weights: list[float], total_w: float
) -> None:
    """Fold per-microbatch stat dicts into the step aggregate, weighted by
    each microbatch's loss weight (array-valued stats are split off first,
    ``_split_seq_stats``)."""
    for s, w in zip(mb_host, weights):
        for k, v in s.items():
            agg[k] = agg.get(k, 0.0) + float(v) * (w / total_w)


def _split_seq_stats(host: dict) -> dict[str, np.ndarray]:
    """Pop the array-valued (per-sequence) stats out of one microbatch's
    host stat dict, leaving only scalars for the weighted fold."""
    arrays = {k: np.asarray(v) for k, v in host.items() if getattr(v, "ndim", 0)}
    for k in arrays:
        host.pop(k)
    return arrays


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
        self.value_head = value_head
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
        self._rollout_coord = None  # connect_engine's: rank 0 pulls, every rank gets the batch
        self._weight_update_meta: WeightUpdateMeta | None = None
        # the asynchronous save: pinned host buffers of the snapshot (reused),
        # the side stream that fills them and its event, and a flag that is
        # clear while a snapshot waits to be written
        self._snap_bufs: dict[str, dict[str, torch.Tensor]] | None = None
        self._save_stream = None
        self._save_event = None
        self._snap_free = threading.Event()
        self._snap_free.set()
        self._offload_mode: str | None = None
        self._offloaded_storages = None
        # the world's layout when torch.distributed is up (``initialize``),
        # and the shapes this rank computes with (``qwen.local_config``)
        self.mesh = None
        self._local_cfg: qwen.ModelConfig | None = None
        # the last training call's per-sequence loss stats (``seq__*``), in
        # the input batch's order, when it carried ``lineage_id``
        self.last_seq_stats: dict[str, np.ndarray] | None = None

    @staticmethod
    def _check_supported(
        cfg: TrainEngineConfig, value_head: bool, model_config: qwen.ModelConfig | None = None
    ) -> None:
        """Refuse the options whose code paths are later slices of the port
        (ROADMAP.md Queue A), and what the JAX engine refuses too."""
        if cfg.tree_training and value_head:
            raise ValueError("tree training is a policy-only path, as in the JAX engine: no value head")
        m = cfg.mesh
        if max(m.seq, m.pipe) > 1:
            raise NotImplementedError(
                f"mesh seq={m.seq} pipe={m.pipe}: sequence and pipeline parallelism are ROADMAP Queue A items 6b-3 "
                "and 6b-4")
        if cfg.weight_update_mode not in ("disk", "mem"):
            raise ValueError(f"weight_update_mode={cfg.weight_update_mode!r}; valid: disk|mem")
        if cfg.optimizer.type != "adamw":
            raise ValueError(f"optimizer {cfg.optimizer.type!r}: only adamw")
        resolve_impl(cfg.attn_impl)  # raises on "ring" and unknown names

    # -- lifecycle --------------------------------------------------------
    def initialize(self, ft_spec: FinetuneSpec | None = None, seed: int = 0) -> None:
        """Master parameters at ``param_dtype``: loaded from the HF checkpoint
        at ``config.path``, or random from ``seed`` when there is no path
        or ``init_from_scratch``, then a zero value head when the engine has
        one; and zeroed optimizer state. The model config is
        ``model_config``, else the checkpoint's ``config.json``."""
        cfg = self.config
        if self._model_config is None:
            if not cfg.path:
                raise ValueError("TrainEngineConfig.path or model_config is required")
            self._model_config = qwen.ModelConfig.from_hf_path(cfg.path)
        # logit temperature of the logprob / entropy heads (PPOActorConfig's;
        # 1.0 for a plain TrainEngineConfig)
        self._logit_temperature = float(getattr(cfg, "temperature", 1.0))
        self.model_cfg = dataclasses.replace(
            self._model_config,
            dtype=cfg.dtype,
            remat=cfg.gradient_checkpointing,
            remat_policy=cfg.remat_policy,
            attn_impl=cfg.attn_impl,
            lora_rank=cfg.lora_rank,
            lora_alpha=cfg.lora_alpha,
            lora_targets=tuple(cfg.lora_targets),
        )
        master_cfg = dataclasses.replace(self.model_cfg, dtype=cfg.param_dtype)
        if cfg.train_vision_tower:
            if master_cfg.vision is None:
                raise ValueError("train_vision_tower set but the model has no vision tower")
            if master_cfg.lora_rank > 0:
                raise ValueError("train_vision_tower with LoRA is unsupported: LoRA freezes every non-adapter leaf")
        if mesh_lib.init_distributed(self.device):
            self.mesh = mesh_lib.make_mesh(cfg.mesh, self.device)
            if cfg.tree_training or master_cfg.lora_rank > 0 or master_cfg.vision is not None:
                raise NotImplementedError("tree training, LoRA and vision models on a mesh: ROADMAP Queue A item "
                                          "6b-2b")
            if getattr(cfg, "use_m2po_loss", False) and mesh_lib.dp_size(self.mesh) > 1:
                # M2PO's mask and its token count are the whole grid's; a
                # rank computes one block of its rows
                raise NotImplementedError(f"use_m2po_loss over {mesh_lib.dp_size(self.mesh)} data-parallel ranks: "
                                          "ROADMAP Queue A item 6b")
            self._local_cfg = qwen.local_config(self.model_cfg, mesh_lib.axis_size(self.mesh, "model"),
                                                mesh_lib.ep_size(self.mesh))
        else:
            mesh_lib.mesh_sizes(cfg.mesh, 1)  # a mesh of more devices than this process raises: no fallback
        if cfg.init_from_scratch or not cfg.path:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.model = qwen.init_params(master_cfg, gen, device=self.device)
        else:
            t0 = time.monotonic()
            self.model, _ = load_params_from_hf(cfg.path, master_cfg, device=self.device, vision_seed=seed)
            logger.info(f"loaded HF weights from {cfg.path} in {time.monotonic() - t0:.1f}s")
            self._add_lora_adapters(seed)
        if self.value_head:
            self.model.value_head = torch.nn.Parameter(
                torch.zeros(master_cfg.hidden_size, dtype=master_cfg.torch_dtype, device=self.device)
            )
        lora = master_cfg.lora_rank > 0
        frozen_tower = not cfg.train_vision_tower
        # what trains: everything but a frozen vision tower, or under LoRA
        # the adapters and a value head
        self._train_names = [n for n, _ in self.model.named_parameters()
                             if (not lora or "_lora_" in n or n == "value_head")
                             and not (frozen_tower and n.startswith("vision."))]
        self._image_embed_memo = None
        self.model.requires_grad_(False)
        total_steps = ft_spec.total_train_steps if ft_spec else 10_000
        self._lr_schedule = make_lr_schedule(cfg.optimizer, total_steps)
        if self.need_optimizer:
            params = dict(self.model.named_parameters())
            for n in self._train_names:
                params[n].requires_grad_(True)
        if self.mesh is not None:
            qwen.shard_model(self.model, self.mesh, self.model_cfg.torch_dtype)
        if self.need_optimizer:
            self._opt = _OptaxAdamW([_local(p) for p in self._trainable()], cfg.optimizer, self._lr_schedule)

    def _add_lora_adapters(self, seed: int = 0) -> None:
        """Fresh adapters over a loaded base: HF checkpoints never carry
        them, the export merges them away (``train_engine.py:354``)."""
        if self.model.cfg.lora_rank > 0:
            qwen.init_lora_params(self.model, torch.Generator(device=self.device).manual_seed(seed))

    def _trainable(self) -> list[torch.Tensor]:
        params = dict(self.model.named_parameters())
        return [params[n] for n in self._train_names]

    # -- versioning -------------------------------------------------------
    def set_version(self, version: int) -> None:
        with self._version_lock:
            self._version = version

    def get_version(self) -> int:
        with self._version_lock:
            return self._version

    # -- grid construction ------------------------------------------------
    def _attach_image_embeds(self, input_: TensorDict) -> TensorDict:
        """A VLM batch's data boundary (``train_engine.py:485``). Frozen
        tower: run it once over the batch's pixel patches (on the
        compute-dtype view of the master weights, memoised by the identity
        of the batch's arrays and the version) and put a per-token [B, L,
        D] f32 ``image_embeds`` key, the k-th image-pad token of a row
        taking its k-th merged embedding, in place of the pixel keys. ``train_vision_tower``: keep the pixel
        keys, padded to ``pad_patch_bucket``, and add the per-token ordinal
        ``image_k`` of each image-pad token (-1 elsewhere), from which
        ``_grid_to_device`` builds the gather map. Image-pad tokens beyond
        a row's embeddings (warned) take zeros."""
        if "pixel_values" not in input_:
            return input_
        mcfg = self.model_cfg
        if mcfg.vision is None or mcfg.image_token_id < 0:
            raise ValueError("the batch has pixel_values but the model is not a VLM")
        input_ = dict(input_)
        pv_obj = input_.pop("pixel_values")
        counts_obj = input_.pop("pixel_counts", None)
        ids_obj = input_["input_ids"]
        pv = np.asarray(pv_obj, np.float32)  # [B, P, pd]
        B, P_raw, _ = pv.shape
        counts = np.asarray(np.full(B, P_raw) if counts_obj is None else counts_obj, np.int32)
        if "pixel_pos_ids" not in input_:
            logger.warning("VLM batch has pixel_values but no pixel_pos_ids; vision rope positions default to "
                           "(0,0) per patch")
        pos_ids = np.asarray(input_.pop("pixel_pos_ids", np.zeros((B, P_raw, 2))), np.int32)
        ids = np.asarray(ids_obj)
        trainable = self.config.train_vision_tower
        if not trainable:
            # a forward_batch and a train_batch of one batch run the tower
            # once: keyed by the identity of the caller's arrays (the memo
            # pins them, so their ids cannot be reused while it lives)
            memo_key = (id(pv_obj), None if counts_obj is None else id(counts_obj), id(ids_obj), pv.shape,
                        self.get_version())
            if self._image_embed_memo is not None and self._image_embed_memo[0] == memo_key:
                input_["image_embeds"] = self._image_embed_memo[1]
                return input_
        merge2 = mcfg.vision.spatial_merge**2
        Ppad = vis.pad_patch_bucket(P_raw, merge2)
        if Ppad != P_raw:
            pv = np.pad(pv, ((0, 0), (0, Ppad - P_raw), (0, 0)))
            pos_ids = np.pad(pos_ids, ((0, 0), (0, Ppad - P_raw), (0, 0)))
        pad_mask = ids == mcfg.image_token_id  # [B, L]
        n_emb = counts // merge2
        n_pos = pad_mask.sum(axis=1)
        for b in np.nonzero(n_pos != n_emb)[0]:
            logger.warning(f"VLM mismatch row {b}: {int(n_pos[b])} image-pad tokens vs {int(n_emb[b])} merged "
                           "patch embeddings; extra positions get zero embeddings")
        k = np.cumsum(pad_mask, axis=1) - 1  # ordinal of each pad token
        take = pad_mask & (k < n_emb[:, None])
        if trainable:
            input_["image_k"] = np.where(take, k, -1).astype(np.int32)
            input_["pixel_values"] = pv
            input_["pixel_counts"] = counts
            input_["pixel_pos_ids"] = pos_ids
            return input_
        with torch.no_grad():
            out = vis.vision_forward_batch(
                vis.vision_view(self.model.vision, mcfg.torch_dtype),
                mcfg.vision,
                torch.from_numpy(pv).to(self.device),
                torch.from_numpy(counts).to(self.device),
                torch.from_numpy(pos_ids).to(self.device),
            ).float().cpu().numpy()  # [B, Ppad / merge^2, D]
        embeds = np.zeros((B, ids.shape[1], mcfg.hidden_size), np.float32)
        rows, cols = np.nonzero(take)
        embeds[rows, cols] = out[rows, k[rows, cols]]
        input_["image_embeds"] = embeds
        self._image_embed_memo = (memo_key, embeds, (pv_obj, counts_obj, ids_obj))
        return input_

    def _dp(self) -> int:
        return mesh_lib.dp_size(self.mesh) if self.mesh is not None else 1

    def _make_grids(self, input_: TensorDict, mb_spec: MicroBatchSpec | None = None) -> list[Grid]:
        """Padded batch -> microbatch grids (FFD rows, bucketed L, G padded
        to the data-parallel degree, ``train_engine.py:600``)."""
        input_ = self._attach_image_embeds(input_)
        cfg = self.config
        lens = seqlens_of(input_)
        row_len = round_up_to_bucket(int(lens.max()), cfg.bucket_step)
        grid = pack_grid(input_, row_len)
        max_tok = (mb_spec or cfg.mb_spec).max_tokens_per_mb
        dp = self._dp()
        rows_per_mb = max(1, max_tok // row_len) if max_tok else grid.n_rows
        if dp > 1:
            rows_per_mb = max(dp, -(-rows_per_mb // dp) * dp)
        if rows_per_mb >= grid.n_rows and grid.n_rows % dp == 0:
            grid.source_index = list(grid.seq_index)
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
            g = pack_grid(sub, row_len, pad_rows_to=dp)
            # g.seq_index points into ``sub``; the attribution needs input_'s
            g.source_index = [seqs[i] for i in g.seq_index]
            out.append(g)
        return out

    def _grid_block(self, grid: Grid, b: int | None = None) -> Grid:
        """Rank block ``b``'s rows of a grid (default this rank's): the
        [G / dp, L] rows a data x fsdp rank computes, as a grid of their
        own whose sequences keep their index in the engine's input."""
        dp = self._dp()
        if dp == 1:
            return grid
        b = mesh_lib.dp_rank(self.mesh) if b is None else b
        n = grid.n_rows // dp
        r0 = b * n
        G, L = grid.n_rows, grid.row_len
        data = {k: (np.asarray(v)[r0 : r0 + n] if np.ndim(v) >= 2 and np.shape(v)[:2] == (G, L) else v)
                for k, v in grid.data.items()}
        keep = [i for i, r in enumerate(grid.row_of_seq) if r0 <= r < r0 + n]
        src = grid.source_index if grid.source_index is not None else grid.seq_index
        return Grid(data=data, n_rows=n, row_len=L, seq_index=[grid.seq_index[i] for i in keep],
                    row_of_seq=[grid.row_of_seq[i] - r0 for i in keep], col_of_seq=[grid.col_of_seq[i] for i in keep],
                    seq_lens=[grid.seq_lens[i] for i in keep], source_index=[src[i] for i in keep])

    def _grid_to_device(self, grid: Grid, seq_attribution: bool = False) -> dict[str, torch.Tensor]:
        """Per-token grid arrays (plus the causal labels) as device tensors.

        ``seq_attribution`` (the training path, when the batch carries
        ``lineage_id``) adds the packed grid's segment map for the
        per-sequence loss stats (``trainer/ppo.py _per_sequence_stats``):
        ``seq_slot`` tags each cell with its grid-local sequence slot (-1 =
        padding), and ``seq_slots`` is a device tensor whose length, the
        slot count bucketed to 8, sizes the reduction (few shapes)."""
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
        if seq_attribution and "lineage_id" in grid.data:
            slot = np.full(seg.shape, -1, np.int32)
            for local, (r, c, n) in enumerate(zip(grid.row_of_seq, grid.col_of_seq, grid.seq_lens)):
                slot[r, c : c + n] = local
            batch["seq_slot"] = slot
        dev = {
            k: torch.from_numpy(np.ascontiguousarray(_np_device_dtype(np.asarray(v)))).to(self.device)
            for k, v in batch.items()
        }
        if "seq_slot" in dev:
            n_slots = round_up_to_bucket(max(len(grid.seq_index), 1), 8)
            dev["seq_slots"] = torch.empty(n_slots, dtype=torch.int32, device=self.device)  # its length only
        if "pixel_values" in grid.data and "image_k" in grid.data:
            # the trainable tower: the grid's pixel rows (their count
            # bucketed to 8, padding rows of count 0) and ``image_slot``, the
            # flat index of each image-pad token's embedding in the tower's
            # [n_rows * Pm, D] output (-1 elsewhere), ``train_engine.py:683``
            merge2 = self.model_cfg.vision.spatial_merge**2
            pv = np.asarray(grid.data["pixel_values"], np.float32)
            counts = np.asarray(grid.data["pixel_counts"], np.int32)
            pos_ids = np.asarray(grid.data["pixel_pos_ids"], np.int32)
            extra = round_up_to_bucket(pv.shape[0], 8) - pv.shape[0]
            if extra:
                pv = np.pad(pv, ((0, extra), (0, 0), (0, 0)))
                counts = np.pad(counts, (0, extra))
                pos_ids = np.pad(pos_ids, ((0, extra), (0, 0), (0, 0)))
            Pm = pv.shape[1] // merge2
            ik = np.asarray(grid.data["image_k"])
            slot = np.full_like(ik, -1)
            for local, (r, c, n) in enumerate(zip(grid.row_of_seq, grid.col_of_seq, grid.seq_lens)):
                seg_k = ik[r, c : c + n]
                slot[r, c : c + n] = np.where(seg_k >= 0, local * Pm + seg_k, -1)
            for k, v in (("image_slot", slot), ("pixel_values", pv), ("pixel_counts", counts),
                         ("pixel_pos_ids", pos_ids)):
                dev[k] = torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
        return dev

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
        (label_valid False, zero loss keys). Vision inputs are refused, as
        in JAX."""
        if "pixel_values" in input_ or "image_embeds" in input_:
            raise ValueError("tree training does not support vision inputs")
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
        the compute-dtype view of the master parameters; with a value head,
        token-aligned ``values`` [G, L] instead. A VLM grid's image-pad
        tokens take the frozen tower's ``image_embeds``, or with the
        trainable tower the embeddings of a tower run here, inside the
        autograd, on the compute-dtype view (``train_engine.py:727``). On a
        mesh the whole of it runs inside the root's call, on the rank's
        ``ShardedView``."""
        if self.mesh is not None:
            return self.model(lambda m: self._outputs_of(qwen.ShardedView(m, self._local_cfg), batch, no_grad))
        return self._outputs_of(qwen.ParamView(self.model, self.model_cfg), batch, no_grad)

    def _outputs_of(self, view, batch: dict[str, torch.Tensor], no_grad: bool) -> dict:
        moe = self.model_cfg.num_experts > 0
        image_embeds = batch.get("image_embeds")
        if "pixel_values" in batch:
            vcfg = self.model_cfg.vision
            emb = vis.vision_forward_batch(
                vis.vision_view(self.model.vision, self.model_cfg.torch_dtype), vcfg, batch["pixel_values"],
                batch["pixel_counts"], batch["pixel_pos_ids"],
            )  # [n_rows, Pm, D]
            flat = emb.reshape(-1, emb.shape[-1])
            slot = batch["image_slot"].long()
            image_embeds = torch.where((slot >= 0)[..., None], flat[slot.clamp(min=0)], 0.0)
        out = qwen.forward(
            view, batch["input_ids"], batch["segment_ids"], batch["positions"], no_grad=no_grad, with_aux=moe,
            image_embeds=image_embeds,
        )
        hidden, aux = out if moe else (out, None)
        outputs = {}
        if aux is not None:  # the router load-balance aux (train_engine.py:762)
            outputs["moe_aux"] = aux
        if self.value_head:  # both operands in f32, the head from its compute-dtype cast
            head = self.model.value_head.to(self.model_cfg.torch_dtype).float()
            outputs["values"] = torch.einsum("gld,d->gl", hidden.float(), head)
            return outputs
        logp, ent = qwen.chunked_logprobs_entropy(
            view,
            hidden,
            batch["labels"],
            chunk_size=self.config.logprob_chunk_size,
            temperature=self._logit_temperature,
        )
        outputs["logprobs"] = logp
        outputs["entropy"] = ent
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
        self.last_seq_stats = None
        extra: dict[str, float] = {}
        with engine_phase("host_prep"):
            if self.config.tree_training:  # one microbatch per forest
                mbs, extra = self._make_tree_batches(input_)
                weights = [float(loss_weight_fn(b)) for b in mbs]
                to_device, outputs_fn = self._tree_batch_to_device, self._tree_outputs_fn
            else:
                grids = self._make_grids(input_, mb_spec=mb_spec)
                mbs = [self._grid_block(g) for g in grids]
                weights = [float(loss_weight_fn(g.data)) for g in mbs]

                def to_device(g):
                    return self._grid_to_device(g, seq_attribution=True)

                outputs_fn = self._outputs_fn
        # each grid's weight, all its blocks' (one block on one device)
        mb_weights = self._grid_weights(grids, loss_weight_fn) if self._dp() > 1 else weights
        total_w = sum(mb_weights) or 1.0
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
            if self._dp() > 1:
                self._combine_block_stats(pending, weights, mb_weights)
            gnorm = self._grad_norm(self._grads())
            # one device -> host transfer for every stat of every microbatch,
            # the per-sequence arrays included (their sizes are host-known)
            shapes = [[(k, tuple(v.shape)) for k, v in s.items()] for s in pending]
            flat = torch.cat(
                [s[k].float().reshape(-1) for s in pending for k in s] + [gnorm.float().reshape(1)]
            ).tolist()
        mb_host, i = [], 0
        for ks in shapes:
            host: dict = {}
            for k, shape in ks:
                n = int(np.prod(shape))
                host[k] = np.asarray(flat[i : i + n], np.float64) if shape else flat[i]
                i += n
            mb_host.append(host)
        seq_pairs = [(g, _split_seq_stats(s)) for g, s in zip(mbs, mb_host)]
        if any(arrs for _, arrs in seq_pairs):
            self._collect_seq_stats(seq_pairs, int(np.asarray(input_["attention_mask"]).shape[0]))
        if len(mbs) == 1:
            agg = dict(mb_host[0])
        else:
            agg = {}
            _fold_weighted_stats(agg, mb_host, mb_weights, total_w)
        agg["grad_norm"] = flat[-1]
        agg["n_microbatches"] = float(len(mbs))
        agg.update(extra)
        return agg, gnorm

    def _grid_weights(self, grids: list[Grid], loss_weight_fn) -> list[float]:
        """The loss weight of each whole grid: the sum of its blocks'."""
        return [sum(float(loss_weight_fn(self._grid_block(g, b).data)) for b in range(self._dp())) for g in grids]

    def _combine_block_stats(self, pending: list[dict], weights: list[float], mb_weights: list[float]) -> None:
        """Each grid's scalar stats over its blocks, in place: the blocks'
        values weighted by their loss weights and summed over data x fsdp,
        so a token mean comes out the whole grid's; the scaled ``loss`` and
        the counts (``n_*``, such as ``n_valid_tokens``) are sums. One
        all-reduce for every scalar of every microbatch; the per-sequence
        arrays stay the rank's (``_collect_seq_stats``)."""
        keys = [(i, k) for i, st in enumerate(pending) for k, v in st.items() if v.dim() == 0]
        summed = [k == "loss" or k.startswith("n_") for _, k in keys]
        vec = torch.stack([pending[i][k].float() * (1.0 if add else weights[i]) for (i, k), add in zip(keys, summed)])
        mesh_lib.all_reduce(vec, self.mesh, mesh_lib.BATCH_AXES)
        for j, ((i, k), add) in enumerate(zip(keys, summed)):
            pending[i][k] = vec[j] if add else vec[j] / (mb_weights[i] or 1.0)

    def _grad_norm(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """The global gradient norm; on a mesh, each leaf's sum of squares
        over the rank's shard, summed over fsdp x model x expert, a leaf
        replicated over ``model`` or ``expert`` counted on that axis's rank
        0 only (the squares in the unsharded engine's order, so a world of
        one gives its bits)."""
        if self.mesh is None:
            return _OptaxAdamW.global_norm(grads)
        sq = torch.stack([torch.dot(g.reshape(-1).float(), g.reshape(-1).float()) for g in grads])
        tp, ep = self.model.tp, self.model.ep
        if tp.rank > 0 or ep.rank > 0:
            keep = [(tp.rank == 0 or qwen.mesh_dim(self.model_cfg, n, "model") is not None)
                    and (ep.rank == 0 or qwen.mesh_dim(self.model_cfg, n, "expert") is not None)
                    for n in self._train_names]
            sq = sq * torch.tensor(keep, dtype=sq.dtype, device=sq.device)
        mesh_lib.all_reduce(sq, self.mesh, ("fsdp", "model", "expert"))
        return sq.sum().sqrt()

    def _collect_seq_stats(self, pairs: list[tuple[Grid, dict[str, np.ndarray]]], n_input: int) -> None:
        """Map the per-slot ``seq__*`` loss stats back to the input
        sequences' order through each grid's ``source_index`` (the bucket's
        padding slots drop). Host bookkeeping only: the arrays came in the
        step's one transfer. On a mesh each rank holds its blocks'
        sequences, and the arrays sum over data x fsdp."""
        out: dict[str, np.ndarray] = {}
        for g, arrs in pairs:
            src = g.source_index if g.source_index is not None else g.seq_index
            for k, arr in arrs.items():
                dest = out.setdefault(k, np.zeros(n_input, np.float64))
                for local, s in enumerate(src):
                    if local < len(arr) and 0 <= s < n_input:
                        dest[s] = arr[local]
        if self._dp() > 1:
            for k, arr in out.items():
                t = torch.from_numpy(arr).to(self.device)
                mesh_lib.all_reduce(t, self.mesh, mesh_lib.BATCH_AXES)
                out[k] = t.cpu().numpy()
        self.last_seq_stats = out or None

    def _grads(self) -> list[torch.Tensor]:
        """The trainable parameters' gradients, the rank's shards on a mesh
        (zeros where none arrived)."""
        return [_local(p.grad) if p.grad is not None else torch.zeros_like(_local(p)) for p in self._trainable()]

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
            self._order_after_snapshot()
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
        blocks = [self._grid_block(g) for g in grids]
        weights = [float(loss_weight_fn(g.data)) for g in blocks]
        mb_weights = self._grid_weights(grids, loss_weight_fn) if self._dp() > 1 else weights
        total_w = sum(mb_weights) or 1.0
        pending = []
        for g in blocks:
            batch = self._grid_to_device(g)
            loss, stats = loss_fn(self._outputs_fn(batch, no_grad=True), batch)
            pending.append({**stats, "loss": loss})
        if self._dp() > 1:
            for st, w, mw in zip(pending, weights, mb_weights):
                st["loss"] = st["loss"] * (w / (mw or 1.0))  # the grid's loss is its blocks' weighted sum
            self._combine_block_stats(pending, weights, mb_weights)
        mb_host = [{k: float(v) for k, v in s.items()} for s in pending]
        agg: dict[str, float] = {}
        _fold_weighted_stats(agg, mb_host, mb_weights, total_w)
        return agg

    @torch.no_grad()
    def forward_batch(self, input_: TensorDict, output_key: str = "logprobs") -> np.ndarray:
        """Forward only. Returns [B, L] f32 aligned with the input padded
        batch: out[b, t] = log p(token t | prefix), out[b, 0] = 0; for
        ``output_key="values"``, out[b, t] = V(prefix up to and including
        token t)."""
        B, L = np.asarray(input_["attention_mask"]).shape
        out = np.zeros((B, L), dtype=np.float32)
        with engine_phase("host_prep"):
            grids = self._make_grids(input_)
            dev = [self._grid_to_device(self._grid_block(g)) for g in grids]
        with engine_phase("forward_backward"):
            pending = []
            for d in dev:
                vals = self._outputs_fn(d, no_grad=True)[output_key].float()
                if self._dp() > 1:  # every block, in global row order, on every rank
                    vals = mesh_lib.gather_rows(vals, self.mesh)
                pending.append(vals.cpu().numpy())
        del dev
        token_aligned = output_key == "values"
        for vals, g in zip(pending, grids):
            # label-aligned output shifts right one: token t's logp was
            # computed at position t-1, so out[src, 1:n] = row[:n-1]; values
            # are token-aligned and copy as they are
            lens = np.asarray(g.seq_lens, np.int64)
            n_eff = lens if token_aligned else np.maximum(lens - 1, 0)
            seq_of = np.repeat(np.arange(len(lens)), n_eff)
            within = np.arange(n_eff.sum()) - np.repeat(np.cumsum(n_eff) - n_eff, n_eff)
            src_r = np.asarray(g.row_of_seq)[seq_of]
            src_c = np.asarray(g.col_of_seq)[seq_of] + within
            # a re-packed grid's seq_index points into its sub-batch; the
            # input's rows are its source_index (JAX scatters by seq_index:
            # ROADMAP Queue C, C-ref 11)
            dst = g.source_index if g.source_index is not None else g.seq_index
            dst_r = np.asarray(dst)[seq_of]
            out[dst_r, within if token_aligned else within + 1] = vals[src_r, src_c]
        return out

    # -- rollout plumbing and weights ---------------------------------------
    def connect_engine(self, engine, meta: WeightUpdateMeta | None = None) -> None:
        """Connect the engine that ``update_weights`` pushes to and
        ``prepare_batch`` / ``rollout_batch`` delegate to: an
        ``InferenceEngine`` (``RemoteTorchEngine``), or an in-process
        ``DecodeEngine`` (which has no rollout methods). In a world of
        several ranks only rank 0 has one (the others pass None). The
        rollout calls go through ``DistRolloutCoordinator``, which in a
        world of one calls the engine."""
        from areal_tpu_torch.infra.dist_rollout import DistRolloutCoordinator

        self._inference_engine = engine
        self._weight_update_meta = meta
        self._rollout_coord = DistRolloutCoordinator(engine)

    def _rollout_source(self):
        if self._rollout_coord is None:
            raise RuntimeError("no inference engine connected (connect_engine)")
        return self._rollout_coord

    def prepare_batch(self, *args, **kwargs) -> TensorDict:
        """The connected engine's ``prepare_batch``; in a world of several
        ranks, rank 0's, handed to every rank."""
        return self._rollout_source().prepare_batch(*args, **kwargs)

    def rollout_batch(self, *args, **kwargs) -> TensorDict:
        return self._rollout_source().rollout_batch(*args, **kwargs)

    def update_weights(self, meta: WeightUpdateMeta | None = None) -> None:
        """Push the master weights to the connected engine. On a mesh every
        rank joins the gather of the weights (``_export_params``) and rank
        0 alone pushes them; the others wait at a barrier until it has.

        "mem": an ``InferenceEngine`` gets ``update_weights(meta, params=state
        dict)``, as in ``areal_tpu/engine/train_engine.py:1479``, and its
        client picks the version; an in-process ``DecodeEngine`` gets
        ``update_weights_from_params`` at its version + 1 when
        ``meta.with_version``. "disk" (``train_engine.py:1468``): the weights
        go to ``meta.path`` as an HF checkpoint (under ``v<version>`` when
        ``meta.with_version``), then an ``InferenceEngine`` gets
        ``update_weights`` with that path, or an in-process engine
        ``update_weights_from_disk``."""
        if self.mesh is None:
            return self._update_weights(meta)
        if mesh_lib.is_lead():
            self._update_weights(meta)
        else:
            self._export_params()
        torch.distributed.barrier()

    def _update_weights(self, meta: WeightUpdateMeta | None) -> None:
        meta = meta or self._weight_update_meta
        if meta is None:
            raise ValueError("no WeightUpdateMeta configured")
        if meta.type not in ("mem", "disk"):
            raise NotImplementedError(f"weight update type {meta.type!r}")
        mcfg = self.model_cfg
        if meta.lora_only and mcfg.lora_rank <= 0:
            # it must not reach the client's adapter branch with the whole tree
            logger.warning("lora_only weight update on a non-LoRA model; using a full update")
            meta = dataclasses.replace(meta, lora_only=False)
        eng = self._inference_engine
        if meta.type == "mem" and meta.lora_only:
            if eng is None:
                raise RuntimeError("no engine connected (connect_engine)")
            scale = mcfg.lora_alpha / mcfg.lora_rank
            if hasattr(eng, "update_weights_from_params"):  # the in-process join
                version = eng.get_version() + 1 if meta.with_version else eng.get_version()
                eng.update_weights_lora(self._lora_leaves(), scale, version=version)
            else:
                eng.update_weights(dataclasses.replace(meta, lora_scale=scale), params=self._lora_leaves())
            return
        if meta.type == "disk":
            if not meta.path:
                raise ValueError("a disk weight update needs meta.path")
            path = os.path.join(meta.path, f"v{self.get_version()}") if meta.with_version else meta.path
            save_params_to_hf(self._export_params(), self.model_cfg, path, base_model_path=self.config.path)
            if eng is None:
                return
            if hasattr(eng, "update_weights_from_disk"):  # the in-process join
                version = eng.get_version() + 1 if meta.with_version else eng.get_version()
                eng.update_weights_from_disk(path, version=version)
            else:
                eng.update_weights(dataclasses.replace(meta, path=path))
            return
        if eng is None:
            raise RuntimeError("no engine connected (connect_engine)")
        if hasattr(eng, "update_weights_from_params"):  # the in-process join
            version = eng.get_version() + 1 if meta.with_version else eng.get_version()
            eng.update_weights_from_params(self._export_params(), version=version)
        else:
            # the wire is bf16 (q8 quantizes from the master's precision): on
            # a mesh each gathered leaf is cast on the card, so half the bytes
            # reach rank 0's host and the client casts nothing
            wire = torch.bfloat16 if self.mesh is not None and meta.wire_format != "q8" else None
            eng.update_weights(meta, params=self._export_params(wire))

    def _export_params(self, mesh_dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
        """The master parameters as a state dict (detached views, no copy),
        without the value head: no server or HF checkpoint holds one. Under
        LoRA the adapters are merged into their targets (new tensors). On a
        mesh every rank must call it: the leaves are gathered whole, one at
        a time, and rank 0 keeps them in host memory (cast to
        ``mesh_dtype`` on the card first, when given; the others get an
        empty dict), so its card holds one whole leaf at a time beside its
        shards."""
        if self.mesh is not None:
            return self._gather({n: p for n, p in self.model.named_parameters() if n != "value_head"},
                                dtype=mesh_dtype)
        state = {name: p.detach() for name, p in self.model.named_parameters() if name != "value_head"}
        return qwen.merge_lora(state, self.model_cfg)

    # -- leaves on a mesh ---------------------------------------------------
    def _full_leaf(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf ``name`` from this rank's part ``t``: the
        parameter itself (a DTensor) or a tensor laid out as its local
        shard (an AdamW moment). FSDP2's all-gather over fsdp, then the
        ``model`` blocks concatenated along the leaf's TP dim and the
        ``expert`` blocks along its expert dim."""
        from torch.distributed.tensor import DTensor

        p = self.model.get_parameter(name)
        with torch.no_grad():
            if not isinstance(t, DTensor):
                t = DTensor.from_local(t, p.device_mesh, p.placements, shape=p.shape, stride=p.stride())
            full = t.full_tensor()
            for info, axis in ((self.model.tp, "model"), (self.model.ep, "expert")):
                d = qwen.mesh_dim(self.model_cfg, name, axis)
                if info.size > 1 and d is not None:
                    parts = [torch.empty_like(full) for _ in range(info.size)]
                    torch.distributed.all_gather(parts, full.contiguous(), group=info.group)
                    full = torch.cat(parts, dim=d)
        return full

    def _gather(self, leaves: dict[str, torch.Tensor], out=None, dtype=None) -> dict[str, torch.Tensor]:
        """``_full_leaf`` of each of ``leaves`` on every rank, in order; rank
        0 copies each to host memory (as ``dtype`` when given) before the
        next is gathered — into ``out[name]`` when given (pinned buffers) —
        and the other ranks drop them."""
        kept = {}
        for n, t in leaves.items():
            full = self._full_leaf(n, t)
            if mesh_lib.is_lead():
                full = full if dtype is None else full.to(dtype)
                kept[n] = full.cpu() if out is None else out[n].copy_(full)
        return kept

    def _shard_of(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole leaf (the inverse of ``_full_leaf``):
        its ``model`` and ``expert`` block (``qwen.tp_slice``), then its
        FSDP2 shard, without communication."""
        from torch.distributed.tensor import distribute_tensor

        p = self.model.get_parameter(name)
        tp, ep = self.model.tp, self.model.ep
        full = qwen.tp_slice(full, qwen.leaf_spec(qwen.param_partition_specs(self.model_cfg), name), tp.size, tp.rank,
                             ep.size, ep.rank)
        full = full.to(device=self.device, dtype=p.dtype).contiguous()
        return distribute_tensor(full, p.device_mesh, p.placements, src_data_rank=None).to_local()

    def _full_shape(self, name: str) -> list[int]:
        shape = list(self.model.get_parameter(name).shape)
        for info, axis in ((self.model.tp, "model"), (self.model.ep, "expert")):
            d = qwen.mesh_dim(self.model_cfg, name, axis)
            if d is not None:
                shape[d] *= info.size
        return shape

    def _lora_leaves(self) -> dict[str, torch.Tensor]:
        """The adapters as the JAX engine sends them: ``layers/<t>_lora_a``
        [n, in, r] and ``layers/<t>_lora_b`` [n, r, out] (copies)."""
        layers = self.model.layers
        return {
            f"layers/{t}_lora_{s}": torch.stack([getattr(layer, f"{t}_lora_{s}").detach().t() for layer in layers])
            for t in self.model_cfg.lora_targets
            for s in ("a", "b")
        }

    # -- durable state ------------------------------------------------------
    def _state_groups(self, with_optim: bool) -> dict[str, dict[str, torch.Tensor]]:
        """The recover state by file: the master parameters (the value head
        and the adapters among them), and with ``with_optim`` the AdamW
        moments under the names of the parameters that train."""
        params = {n: p.detach() for n, p in self.model.named_parameters()}  # DTensors on a mesh
        groups = {"params": params}
        if with_optim and self._opt is not None:
            groups["mu"] = dict(zip(self._train_names, self._opt.mu))
            groups["nu"] = dict(zip(self._train_names, self._opt.nu))
        return groups

    def _write_state(self, path: str, groups: dict, step_count: int) -> int:
        """The "state" format under ``<path>/state/``: one safetensors file a
        group, fsynced, then the manifest, all in ``state.tmp/``, which is
        then renamed into place. A write cut short leaves the old state
        whole; only a cut between the two renames of a rewrite leaves no
        manifest, which no load accepts. Returns the bytes written."""
        d = os.path.join(path, RECOVER_STATE_DIR)
        tmp, old = d + ".tmp", d + ".old"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        nbytes = 0
        for group, tensors in groups.items():
            entries = [(n, t.dtype, list(t.shape), t) for n, t in tensors.items()]
            nbytes += save_file(entries, os.path.join(tmp, f"{group}.safetensors"), do_fsync=True)
        manifest = {
            "format": RECOVER_FORMAT,
            "version": 1,
            "step_count": int(step_count),
            "groups": sorted(groups),
        }
        atomic_io.atomic_write_text(os.path.join(tmp, os.path.basename(RECOVER_MANIFEST)), json.dumps(manifest))
        if os.path.exists(d):
            shutil.rmtree(old, ignore_errors=True)
            os.replace(d, old)
            os.replace(tmp, d)
            shutil.rmtree(old)
        else:
            os.replace(tmp, d)
        atomic_io.fsync_dir(path)
        return nbytes

    def snapshot_for_save(self, with_optim: bool = True) -> dict:
        """The step-loop part of an asynchronous save: copy the state into
        pinned host buffers (allocated at the first snapshot, reused after)
        on a side stream ordered after the work queued so far, and return
        without waiting for the copies. The next optimizer step waits for
        them on the device (``_order_after_snapshot``); ``write_snapshot``
        waits for them on the host. A snapshot's buffers are busy until it
        is written, so the next snapshot waits for that write."""
        if not self._snap_free.wait(timeout=3600):
            raise RuntimeError("the previous snapshot was never written (write_snapshot)")
        if self.mesh is not None:
            return self._snapshot_sharded(with_optim)
        groups = self._state_groups(with_optim)
        cuda = self.device.type == "cuda"
        if self._snap_bufs is None or any(
            g not in self._snap_bufs or self._snap_bufs[g].keys() != ts.keys() for g, ts in groups.items()
        ):
            self._snap_bufs = {
                g: {n: torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda) for n, t in ts.items()}
                for g, ts in groups.items()
            }
        bufs = {g: self._snap_bufs[g] for g in groups}
        event = None
        if cuda:
            if self._save_stream is None:
                self._save_stream = torch.cuda.Stream(self.device)
            self._save_stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.no_grad(), torch.cuda.stream(self._save_stream):
                for g, ts in groups.items():
                    for n, t in ts.items():
                        bufs[g][n].copy_(t, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._save_stream)
            self._save_event = event
        else:
            with torch.no_grad():
                for g, ts in groups.items():
                    for n, t in ts.items():
                        bufs[g][n].copy_(t)
        self._snap_free.clear()
        count = self._opt.count if self._opt is not None else 0
        return {"groups": bufs, "step_count": count, "event": event}

    def _snapshot_sharded(self, with_optim: bool) -> dict:
        """The snapshot on a mesh: every leaf of the state gathered whole (a
        collective: every rank calls it) and copied into rank 0's pinned
        buffers before this returns, so the next step needs no wait; the
        other ranks hold no buffers and write nothing."""
        groups = self._state_groups(with_optim)
        lead = mesh_lib.is_lead()
        if lead and (self._snap_bufs is None or any(
            g not in self._snap_bufs or self._snap_bufs[g].keys() != ts.keys() for g, ts in groups.items()
        )):
            cuda = self.device.type == "cuda"
            self._snap_bufs = {
                g: {n: torch.empty(self._full_shape(n), dtype=t.dtype, pin_memory=cuda) for n, t in ts.items()}
                for g, ts in groups.items()
            }
        bufs = {g: self._gather(ts, out=self._snap_bufs[g] if lead else None) for g, ts in groups.items()}
        self._snap_free.clear()
        count = self._opt.count if self._opt is not None else 0
        return {"groups": bufs if lead else None, "step_count": count, "event": None}

    def write_snapshot(self, snapshot: dict, path: str) -> int:
        """Write a ``snapshot_for_save`` in the "state" format ``load``
        restores; runs on the saver's thread and touches no engine state
        but the snapshot's buffers, which it frees for the next snapshot."""
        try:
            if snapshot["groups"] is None:  # a rank of a mesh other than 0
                return 0
            if snapshot["event"] is not None:
                snapshot["event"].synchronize()
            return self._write_state(path, snapshot["groups"], snapshot["step_count"])
        finally:
            self._snap_free.set()

    def _order_after_snapshot(self) -> None:
        """Make the device's next in-place update wait for a snapshot's
        copies (a stream wait: the host does not block)."""
        ev = self._save_event
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)
            self._save_event = None

    def wait_for_save(self) -> None:
        """Block until a snapshot's copies have landed in host memory."""
        ev, self._save_event = self._save_event, None
        if ev is not None:
            ev.synchronize()

    def save(self, meta: SaveLoadMeta) -> None:
        """``weight_format="hf"``: the weights as an HF checkpoint (config and
        tokenizer files from ``meta.base_model_path`` or ``config.path``).
        ``"state"``: the recover format, a snapshot written before this
        returns (the asynchronous save's two halves back to back)."""
        if meta.weight_format == "hf":
            params = self._export_params()
            if mesh_lib.is_lead():
                save_params_to_hf(params, self.model_cfg, meta.path,
                                  base_model_path=meta.base_model_path or self.config.path)
        else:
            _check_recover_format(meta.weight_format)
            self.write_snapshot(self.snapshot_for_save(meta.with_optim), meta.path)
        if self.mesh is not None:
            torch.distributed.barrier()  # the files are whole before any rank goes on

    def load(self, meta: SaveLoadMeta) -> None:
        """Load ``save``'s output in place. "state" restores the master
        parameters and, with ``meta.with_optim``, the moments and the step
        count, so the LR schedule and Adam's bias correction go on where
        they stopped. Every name and shape is checked before the first
        copy."""
        self.wait_for_save()
        if meta.weight_format == "hf":
            if self.mesh is not None:  # read whole on every rank, each keeps its shards
                full, _ = load_params_from_hf(meta.path, cfg=self.model_cfg, dtype=self.config.param_dtype,
                                              device="cpu")
                with torch.no_grad():
                    for n, t in full.named_parameters():
                        _local(self.model.get_parameter(n)).copy_(self._shard_of(n, t))
                return
            # the checkpoint is merged and has no tower (the export writes
            # none): fresh adapters and, as in JAX, a fresh tower (seed 0)
            load_params_from_hf(meta.path, model=self.model, vision_seed=0)
            self._add_lora_adapters()
            return
        _check_recover_format(meta.weight_format)
        d = os.path.join(meta.path, RECOVER_STATE_DIR)
        with open(os.path.join(meta.path, RECOVER_MANIFEST)) as f:
            manifest = json.load(f)
        if manifest.get("format") != RECOVER_FORMAT:
            raise ValueError(f"{d}: manifest format {manifest.get('format')!r}")
        want = ["params"] + (["mu", "nu"] if meta.with_optim and self._opt is not None else [])
        missing = [g for g in want if g not in manifest["groups"]]
        if missing:
            raise ValueError(f"{d} holds no {missing}")
        groups = self._state_groups(meta.with_optim)
        files = {g: SafetensorsFile(os.path.join(d, f"{g}.safetensors")) for g in want}
        for g in want:
            f = files[g]
            if set(f.keys()) != set(groups[g]):
                raise ValueError(f"{d}/{g}: names differ from the model's")
            for n, t in groups[g].items():
                shape = self._full_shape(n) if self.mesh is not None else list(t.shape)
                if f.info(n) != (t.dtype, shape):
                    raise ValueError(f"{d}/{g}: {n} is {f.info(n)}, the model's {t.dtype}{shape}")
        with torch.no_grad():
            for g in want:
                for n, t in groups[g].items():
                    if self.mesh is not None:  # every rank reads the whole leaf and keeps its shard
                        _local(t).copy_(self._shard_of(n, files[g].get(n)))
                    else:
                        t.copy_(files[g].get(n))
        if meta.with_optim and self._opt is not None:
            self._opt.count = int(manifest["step_count"])

    def offload(self) -> None:
        """Move the master parameters and the optimizer moments to pinned
        host memory (``train_engine.py:436``); ``onload`` brings them back.
        Their storages move, so every view of them stays valid, FSDP2's
        padded flat shard behind a leaf on a mesh included. On the CPU
        there is nothing to free."""
        if self.model is None or self._offload_mode is not None:
            return
        self.wait_for_save()
        t0 = time.monotonic()
        self._offload_mode, self._offloaded_storages = offload_storages(self._offload_targets())
        logger.info(f"offloaded params + optimizer state ({self._offload_mode}) in {time.monotonic() - t0:.2f}s")

    def onload(self) -> None:
        if self._offload_mode is None:
            return
        t0 = time.monotonic()
        onload_storages(self._offloaded_storages)
        self._offloaded_storages = None
        self._offload_mode = None
        logger.info(f"onloaded params + optimizer state in {time.monotonic() - t0:.2f}s")

    def _offload_targets(self) -> list[torch.Tensor]:
        ts = [_local(p) for p in self.model.parameters()]
        if self._opt is not None:
            ts += self._opt.mu + self._opt.nu
        return ts

    def hbm_ledger(self, override_hbm_gb: float | None = None) -> dict:
        """Itemized device memory of this engine: the parameters and the
        optimizer state beside the card's use and size."""
        params = sum(_local(p).numel() * p.element_size() for p in self.model.parameters())
        opt = self._opt.state_bytes() if self._opt is not None else 0
        return step_timeline.build_hbm_ledger(
            {"params": params, "opt_state": opt}, device=self.device, override_hbm_gb=override_hbm_gb
        )
