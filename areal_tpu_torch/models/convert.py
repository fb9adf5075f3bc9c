"""Weights across the two packages.

``from_jax_params`` takes the JAX ``init_params`` pytree as numpy arrays
(``{"embed", "layers": {name: [n_layers, ...]}, "final_norm"[, "lm_head"]}``)
and returns the port's state dict: the stacked layer leaves split into
``layers.<i>.<name>`` tensors, the JAX ``[in, out]`` dense matrices
transposed to PyTorch's ``[out, in]``, the MoE leaves (``w_router`` [D, E],
the ``we_*`` expert stacks [E, in, out]) kept in JAX's layout, and the tied
``embed`` kept as the LM head, and a critic's ``value_head`` [hidden]
(``TorchTrainEngine(value_head=True)``) carried as it is.
LoRA adapters (``<t>_lora_a`` [n, in, r], ``<t>_lora_b`` [n, r, out] in
JAX) cross transposed like the dense matrices; the int8 serving form
(``<t>_q8`` [n, in, out] int8 and ``<t>_scale`` [n, 1, out] f32 in JAX, the
output of ``quantize_params_int8``) crosses as ``<t>_q8`` [out, in] and
``<t>_scale`` [out] per layer. ``to_jax_params`` is the reverse; a round
trip is exact.

numpy has no bfloat16 of its own: a bf16 array (whatever package made its
dtype) crosses as its 16 raw bits, and ``to_jax_params`` hands bf16 tensors
back as float32, which holds every bf16 value exactly.

Both directions serve the train engine's f32 master parameters too:
``from_jax_params`` gives the state dict ``TorchTrainEngine.model`` loads
(f32 leaves stay f32), and ``to_jax_params`` of its state dict copies every
leaf, so the result does not move with later optimizer steps.
"""

from __future__ import annotations

import numpy as np
import torch

from areal_tpu_torch.models.qwen import DENSE_MATRICES, QUANT_TARGETS, ModelConfig, _layer_shapes, _lora_shapes

# JAX [in, out] dense matrices, adapters and int8 tables cross transposed,
# an int8 scale [1, out] as [out]; every other leaf (norms, biases, the MoE
# router and expert stacks) keeps its layout
_Q8 = frozenset(f"{t}_q8" for t in QUANT_TARGETS)
_SCALES = frozenset(f"{t}_scale" for t in QUANT_TARGETS)


def _transposed(name: str) -> bool:
    return name in DENSE_MATRICES or name in _Q8 or name.endswith(("_lora_a", "_lora_b"))


def _layer_names(cfg: ModelConfig, present) -> list[str]:
    """The layer leaves to carry: the base leaves (each target projection in
    its int8 form where ``present`` holds that instead) and the config's
    adapters where ``present`` holds them (a merged state has none)."""
    names = []
    for name in _layer_shapes(cfg):
        if name not in present and f"{name}_q8" in present:
            names += [f"{name}_q8", f"{name}_scale"]
        else:
            names.append(name)
    if cfg.lora_rank > 0:
        names += [n for n in _lora_shapes(cfg) if n in present]
    return names


def _to_port(name: str, t: torch.Tensor) -> torch.Tensor:
    if name in _SCALES:
        return t[0]
    return t.t().contiguous() if _transposed(name) else t


def _to_jax(name: str, t: torch.Tensor) -> torch.Tensor:
    if name in _SCALES:
        return t[None]
    return t.t() if _transposed(name) else t


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy (jax hands out read-only views)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy: ``.numpy()`` of a CPU tensor shares its storage, so a view of
    a live parameter (the trainer's f32 master weights) would change under
    the caller at the next optimizer step."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return np.array(t.numpy(), copy=True)


def from_jax_params(params: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """JAX pytree (numpy leaves) -> port state dict (CPU tensors)."""
    out = {"embed": _to_tensor(params["embed"]), "final_norm": _to_tensor(params["final_norm"])}
    if not cfg.tie_word_embeddings:
        out["lm_head"] = _to_tensor(params["lm_head"])
    if "value_head" in params:
        out["value_head"] = _to_tensor(params["value_head"])
    layers = params["layers"]
    for name in _layer_names(cfg, layers):
        stacked = np.asarray(layers[name])
        if stacked.shape[0] != cfg.num_layers:
            raise ValueError(f"layers/{name}: leading dim {stacked.shape[0]} != {cfg.num_layers}")
        for i in range(cfg.num_layers):
            out[f"layers.{i}.{name}"] = _to_port(name, _to_tensor(stacked[i]))
    return out


def to_jax_params(state: dict[str, torch.Tensor], cfg: ModelConfig) -> dict:
    """Port state dict -> JAX pytree layout (numpy leaves, layers stacked)."""
    params = {"embed": _to_numpy(state["embed"]), "final_norm": _to_numpy(state["final_norm"])}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _to_numpy(state["lm_head"])
    if "value_head" in state:
        params["value_head"] = _to_numpy(state["value_head"])
    layers = {}
    present = {k.split(".", 2)[2] for k in state if k.startswith("layers.0.")}
    for name in _layer_names(cfg, present):
        layers[name] = np.stack([_to_numpy(_to_jax(name, state[f"layers.{i}.{name}"]))
                                 for i in range(cfg.num_layers)])
    params["layers"] = layers
    return params
