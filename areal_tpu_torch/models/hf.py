"""HF checkpoint interop: safetensors <-> the port's ``QwenModel`` (the port
of ``areal_tpu/models/hf.py``).

The files are read and written by the port's own ``utils/safetensors_io``.
Loading maps each file and copies one HF tensor at a time into the model's
parameter (on the card when the model is there), cast to the model's dtype
on the way: the host never holds a second copy of the weights. Saving
streams one tensor at a time as well. ``models/qwen.hf_name_map`` names
every leaf; its transpose flags follow the port's layout.

The export writes every floating leaf as F32 (bf16 leaves up-cast, which is
exact), as the JAX export does: a server that loads it at bf16 then rounds
the trainer's f32 master weights once, as the streamed update does, so the
two paths serve the same bits.

A VLM's tower loads from the checkpoint's ``visual.*`` tensors when it has
them (``areal_tpu/models/hf.py:105``); the Conv3d patch kernel [D, C, T, p,
p] is flattened to [D, patch_dim] and transposed. The export writes the
decoder only, as the JAX export does (``hf_name_map`` names no tower leaf),
and ``write_hf_config`` refuses a VLM: export one with ``base_model_path``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil

import torch

from areal_tpu_torch.models.qwen import EXPERT_LEAVES, ModelConfig, QwenModel, hf_name_map
from areal_tpu_torch.models.vision import hf_vision_name_map, init_vision_params
from areal_tpu_torch.utils.safetensors_io import SafetensorsFile, save_file

logger = logging.getLogger("areal_tpu_torch.hf")

_PATCH_KERNEL = "visual.patch_embed.proj.weight"

# files copied from the base model directory beside an export
_BASE_FILES = (
    "config.json",
    "tokenizer.json",
    "tokenizer_config.json",
    "generation_config.json",
    "vocab.json",
    "merges.txt",
    "special_tokens_map.json",
)


def _open_shards(path: str) -> dict[str, SafetensorsFile]:
    """HF tensor name -> its (mapped) file; handles sharded checkpoints."""
    index_path = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            weight_map = json.load(f)["weight_map"]
        files = {fn: SafetensorsFile(os.path.join(path, fn)) for fn in sorted(set(weight_map.values()))}
        return {name: files[fn] for name, fn in weight_map.items()}
    single = SafetensorsFile(os.path.join(path, "model.safetensors"))
    return {name: single for name in single.keys()}


def _leaf(key: str) -> tuple[str, int | None]:
    """A map key -> (parameter name, expert index or None)."""
    parts = key.split(".")
    if parts[0] == "layers" and parts[2] in EXPERT_LEAVES:
        return ".".join(parts[:3]), int(parts[3])
    return key, None


def checkpoint_has_vision(path: str) -> bool:
    """Whether the checkpoint at ``path`` holds a ``visual.*`` tower."""
    return _PATCH_KERNEL in _open_shards(path)


def _vision_plan(cfg: ModelConfig, shards: dict, params: dict, path: str) -> list:
    """(dest, HF name, transpose, flatten) of every tower leaf (a slice of a
    stacked leaf per layer), each shape checked."""
    plan = []
    for key, (hf_name, transpose) in hf_vision_name_map(cfg.vision).items():
        parts = key.split("/")
        if hf_name not in shards:
            raise KeyError(f"{path}: no tensor {hf_name} (for vision/{key})")
        dest = params[f"vision.layers.{parts[2]}"][int(parts[1])] if parts[0] == "layers" else params[f"vision.{key}"]
        shape = list(shards[hf_name].info(hf_name)[1])
        flatten = hf_name == _PATCH_KERNEL
        if flatten:  # the Conv3d kernel [D, C, T, p, p] is a [D, patch_dim] matmul
            shape = [shape[0], int(torch.Size(shape[1:]).numel())]
        want = list(dest.shape)[::-1] if transpose else list(dest.shape)
        if shape != want:
            raise ValueError(f"{path}: {hf_name} has shape {shape}, vision/{key} needs {want}")
        plan.append((dest, hf_name, transpose, flatten))
    return plan


def load_params_from_hf(
    path: str,
    cfg: ModelConfig | None = None,
    dtype: str | None = None,
    device=None,
    model: QwenModel | None = None,
    vision_seed: int | None = 0,
) -> tuple[QwenModel, ModelConfig]:
    """Load an HF Qwen2 / Qwen3 / qwen3_moe checkpoint directory.

    Into ``model`` when given (in place, at its dtype and device), else into
    a new ``QwenModel`` of ``cfg`` (default ``ModelConfig.from_hf_path``) at
    ``dtype`` (default the config's) on ``device`` (the card unless
    ``device="cpu"``). Every name and shape is checked against the files'
    headers before the first copy, so a checkpoint that does not fit raises
    and changes no weight. An untied model whose checkpoint has no
    ``lm_head.weight`` takes ``embed_tokens`` as its head, as the JAX loader
    does. A VLM whose checkpoint has no ``visual.*`` tower gets a fresh one
    from ``vision_seed`` (with a warning, as the JAX engines initialize
    theirs, ``train_engine.py:372``, ``decode_engine.py:366``), or, with
    ``vision_seed=None``, keeps the tower it has (a new model's is then
    uninitialized)."""
    if model is not None:
        cfg = model.cfg
    else:
        cfg = cfg or ModelConfig.from_hf_path(path)
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
    shards = _open_shards(path)
    name_map = hf_name_map(cfg)
    if not cfg.tie_word_embeddings and "lm_head.weight" not in shards:
        name_map["lm_head"] = ("model.embed_tokens.weight", False)  # an export that ties silently
    if model is None:
        model = QwenModel(cfg, device)
    params = dict(model.named_parameters())
    plan = []
    for key, (hf_name, transpose) in name_map.items():
        pname, expert = _leaf(key)
        if hf_name not in shards:
            raise KeyError(f"{path}: no tensor {hf_name} (for {key})")
        dest = params[pname] if expert is None else params[pname][expert]
        shape = list(shards[hf_name].info(hf_name)[1])
        want = list(dest.shape)[::-1] if transpose else list(dest.shape)
        if shape != want:
            raise ValueError(f"{path}: {hf_name} has shape {shape}, {key} needs {want}")
        plan.append((dest, hf_name, transpose, False))
    with_tower = cfg.vision is not None and _PATCH_KERNEL in shards
    if with_tower:
        plan += _vision_plan(cfg, shards, params, path)
    with torch.no_grad():
        for dest, hf_name, transpose, flatten in plan:
            src = shards[hf_name].get(hf_name)
            if flatten:
                src = src.reshape(src.shape[0], -1)
            dest.copy_(src.t() if transpose else src)
        if cfg.vision is not None and not with_tower and vision_seed is not None:
            logger.warning(f"{path}: the checkpoint has no visual.* weights; the vision tower initializes from scratch")
            init_vision_params(model.vision, torch.Generator(device=model.device).manual_seed(vision_seed))
    return model, cfg


def write_hf_config(cfg: ModelConfig, path: str) -> None:
    """A loadable ``config.json`` for ``cfg`` (the inverse of
    ``ModelConfig.from_hf_dict``), the same JSON as the JAX function
    writes, so a saved checkpoint directory is self-contained. A VLM's
    ``vision_config`` cannot be rebuilt: it raises, as the JAX function
    does."""
    if cfg.vision is not None:
        raise ValueError("write_hf_config cannot reconstruct a vision_config: export a VLM checkpoint with "
                         "base_model_path pointing at the source model directory")
    base = "qwen3" if cfg.qk_norm else "qwen2"
    # an MoE export is always qwen3_moe (qwen2_moe implies shared experts this
    # family does not have); the explicit qk_norm key keeps a no-qk-norm MoE
    # export round-trippable through from_hf_dict
    mt = "qwen3_moe" if cfg.num_experts > 0 else base
    d = {
        "model_type": mt,
        "qk_norm": cfg.qk_norm,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "attention_bias": cfg.attention_bias,
    }
    if cfg.num_experts > 0:
        d.update(
            num_experts=cfg.num_experts,
            num_experts_per_tok=cfg.num_experts_per_tok,
            moe_intermediate_size=cfg.moe_intermediate_size,
            norm_topk_prob=cfg.norm_topk_prob,
        )
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(d, f, indent=2)


def save_params_to_hf(
    params: QwenModel | dict[str, torch.Tensor],
    cfg: ModelConfig,
    path: str,
    base_model_path: str | None = None,
) -> int:
    """Export ``params`` (a ``QwenModel`` or its state dict, on any device) as
    an HF-layout ``model.safetensors``, one tensor at a time, and copy the
    config and tokenizer files from ``base_model_path`` (``write_hf_config``
    when there is none). Returns the safetensors file's bytes."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    os.makedirs(path, exist_ok=True)
    entries = []
    for key, (hf_name, transpose) in hf_name_map(cfg).items():
        pname, expert = _leaf(key)
        leaf = params[pname].detach()
        view = leaf if expert is None else leaf[expert]
        dtype = torch.float32 if view.dtype == torch.bfloat16 else view.dtype
        shape = list(view.shape)[::-1] if transpose else list(view.shape)

        def produce(view=view, transpose=transpose, dtype=dtype):
            t = view.t() if transpose else view
            return t.to(dtype).contiguous()

        entries.append((hf_name, dtype, shape, produce))
    nbytes = save_file(entries, os.path.join(path, "model.safetensors"), metadata={"format": "pt"})
    # "" (a from-scratch engine's config.path) behaves like None: an export
    # without config.json is not loadable as an HF checkpoint
    if not base_model_path and not os.path.exists(os.path.join(path, "config.json")):
        write_hf_config(cfg, path)
    if base_model_path:
        for fname in _BASE_FILES:
            src = os.path.join(base_model_path, fname)
            if os.path.exists(src) and os.path.abspath(src) != os.path.abspath(os.path.join(path, fname)):
                shutil.copyfile(src, os.path.join(path, fname))
    return nbytes
