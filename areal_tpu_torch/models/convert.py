"""Weights across the two packages.

``from_jax_params`` takes the JAX ``init_params`` pytree as numpy arrays
(``{"embed", "layers": {name: [n_layers, ...]}, "final_norm"[, "lm_head"]}``)
and returns the port's state dict: the stacked layer leaves split into
``layers.<i>.<name>`` tensors, the JAX ``[in, out]`` dense matrices
transposed to PyTorch's ``[out, in]``, the MoE leaves (``w_router`` [D, E],
the ``we_*`` expert stacks [E, in, out]) kept in JAX's layout, and the tied
``embed`` kept as the LM head, and a critic's ``value_head`` [hidden]
(``TorchTrainEngine(value_head=True)``) carried as it is.
``to_jax_params`` is the reverse; a round trip is exact.

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

from areal_tpu_torch.models.qwen import ModelConfig, _layer_shapes

# JAX [in, out] dense matrices; every other leaf (norms, biases, the MoE
# router and expert stacks) keeps its layout
_MATRICES = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"})


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
    for name in _layer_shapes(cfg):
        stacked = np.asarray(layers[name])
        if stacked.shape[0] != cfg.num_layers:
            raise ValueError(f"layers/{name}: leading dim {stacked.shape[0]} != {cfg.num_layers}")
        for i in range(cfg.num_layers):
            t = _to_tensor(stacked[i])
            out[f"layers.{i}.{name}"] = t.t().contiguous() if name in _MATRICES else t
    return out


def to_jax_params(state: dict[str, torch.Tensor], cfg: ModelConfig) -> dict:
    """Port state dict -> JAX pytree layout (numpy leaves, layers stacked)."""
    params = {"embed": _to_numpy(state["embed"]), "final_norm": _to_numpy(state["final_norm"])}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _to_numpy(state["lm_head"])
    if "value_head" in state:
        params["value_head"] = _to_numpy(state["value_head"])
    layers = {}
    for name in _layer_shapes(cfg):
        per = []
        for i in range(cfg.num_layers):
            t = state[f"layers.{i}.{name}"]
            per.append(_to_numpy(t.t() if name in _MATRICES else t))
        layers[name] = np.stack(per)
    params["layers"] = layers
    return params
