"""Qwen2 / Qwen2.5 / Qwen3 decoders, dense and MoE (qwen3_moe) — the
serving half of ``areal_tpu/models/qwen.py`` in PyTorch.

The JAX model keeps one stacked pytree scanned over layers; here the layers
are an ``nn.ModuleList`` of ``DecoderLayer`` modules whose parameter names
are the JAX leaf names (``wq``, ``bq``, ``q_norm``, ``w_gate``, ...).
The dense projections (``wq``, ``wk``, ``wv``, ``wo``, ``w_gate``, ``w_up``,
``w_down``) use PyTorch's ``[out, in]`` layout (``F.linear``), the JAX
``[in, out]`` arrays transposed by ``models/convert.py``; so do the LoRA
adapters (``wq_lora_a`` [r, in], ``wq_lora_b`` [out, r], the JAX [in, r] /
[r, out] transposed) and the int8 serving form (``wq_q8`` [out, in] int8,
``wq_scale`` [out] f32, JAX's [in, out] / [1, out]). The MoE leaves
keep JAX's layout: the router ``w_router`` [D, E] (an f32 product ``h @
w_router``) and the expert stacks ``we_gate`` / ``we_up`` [E, D, Fm] and
``we_down`` [E, Fm, D], which are the grouped matmul's ``rhs[g] = [k, n]``
with n contiguous, as the kernel reads them (``models/moe.py``).

Forward functions take the model and mirror the JAX functions of the same
name, including where bf16 rounds: ``_rms_norm`` casts to the input dtype
before the weight multiply, ``_rope`` computes in f32 and casts at the end,
``compute_logits`` returns f32 (the serving logits: a bf16 product with an
f32 result), while ``chunked_logprobs_entropy`` rounds the training logits
to bf16 before the f32 cast, as the JAX einsum does.

Training: the train engine keeps f32 master parameters in a ``QwenModel``
and runs ``forward`` on ``ParamView(model, compute_dtype)``, a differentiable
cast of them (``_outputs_fn`` of the JAX engine).

Across GPUs (``shard_model``): each leaf is placed by
``param_partition_specs`` — its ``model`` and ``expert`` dims sliced to the
rank's part (tensor parallelism on local tensors,
``parallel/tensor_parallel.py``; an MoE model's experts over ``expert``,
``models/moe.py``) and
its ``fsdp`` dim sharded by FSDP2 ``fully_shard`` per ``DecoderLayer`` and
at the root, replicated over ``data``. The decoder then runs inside the
root's call (``QwenModel.forward``) on a ``ShardedView``, and each layer
through its own call (``DecoderLayer.forward``), where FSDP2 gathers it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from areal_tpu_torch.device import resolve_device
from areal_tpu_torch.inference import paged_kv
from areal_tpu_torch.models import moe, remat as remat_lib
from areal_tpu_torch.models.vision import VisionConfig, VisionTower, init_vision_params
from areal_tpu_torch.ops.attention import (
    attention_mask as _attention_mask,
    flash_fwd,
    flash_train,
    resolve_impl,
    sdpa_plain,
)
from areal_tpu_torch.ops.paged_attention import paged_attention_stacked
from areal_tpu_torch.ops.paged_suffix_attention import paged_suffix_attention
from areal_tpu_torch.ops.tree_attention import tree_attention
from areal_tpu_torch.parallel import tensor_parallel as tp_lib

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 151936
    hidden_size: int = 896
    intermediate_size: int = 4864
    num_layers: int = 24
    num_heads: int = 14
    num_kv_heads: int = 2
    head_dim: int | None = None  # default hidden_size // num_heads
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    qk_norm: bool = False  # Qwen3
    attention_bias: bool = True  # Qwen2 has q/k/v bias
    dtype: str = "bfloat16"
    # training: per-layer recompute in the backward ("nothing" saved), the
    # projections saved and the rest recomputed ("dots_nobatch"), or no
    # recompute ("everything" saved); the train engine sets these three
    # from TrainEngineConfig
    remat: bool = True
    remat_policy: str = "nothing"
    attn_impl: str = "xla"  # "pallas": flash kernels; "xla": sdpa_plain
    # MoE (qwen3_moe family; 0 experts = dense FFN), models/moe.py
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: int | None = None
    capacity_factor: float = 1.25
    norm_topk_prob: bool = True
    # sort-based grouped dispatch computing every routed token; False =
    # capacity-bounded einsum dispatch (drops overflow)
    moe_dropless: bool = True
    router_aux_coef: float = 0.0  # load-balance aux loss weight
    # LoRA: adapters "<t>_lora_a" [r, in] and "<t>_lora_b" [out, r] on each
    # target projection of every layer (0 = none); the train engine sets
    # these from TrainEngineConfig
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: tuple = ("wq", "wk", "wv", "wo")
    # a VLM: the model carries a vision tower (``models/vision.py``) as
    # ``QwenModel.vision``, and the forwards take the tower's embeddings at
    # the <|image_pad|> positions (``image_token_id``)
    image_token_id: int = -1
    vision: VisionConfig | None = None

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim_

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @classmethod
    def from_hf_dict(cls, d: dict) -> "ModelConfig":
        """Build from an HF ``config.json`` dict (qwen2 / qwen3 / qwen3_moe
        model types, and qwen2-vl-style VLMs whose text fields may nest
        under ``text_config`` and whose tower is ``vision_config``), as
        ``areal_tpu/models/qwen.py:108`` does."""
        mt = d.get("model_type", "qwen2")
        if mt == "qwen2_moe":
            raise ValueError(
                "qwen2_moe checkpoints use always-active SHARED experts, "
                "which this model family does not implement — loading one "
                "would silently drop those weights. Supported MoE family: "
                "qwen3_moe."
            )
        td = {**d, **d.get("text_config", {})}
        vision = None
        if "vision_config" in d:
            vd = d["vision_config"]
            patch = vd.get("patch_size", 14)
            vision = VisionConfig(
                patch_dim=vd.get("in_channels", 3) * vd.get("temporal_patch_size", 2) * patch * patch,
                hidden_size=vd.get("embed_dim", vd.get("hidden_size", 1280)),
                intermediate_size=vd.get("intermediate_size", 4 * vd.get("embed_dim", 1280)),
                num_layers=vd.get("depth", vd.get("num_hidden_layers", 32)),
                num_heads=vd.get("num_heads", vd.get("num_attention_heads", 16)),
                out_hidden_size=td["hidden_size"],
                spatial_merge=vd.get("spatial_merge_size", 2),
            )
        return cls(
            vocab_size=td["vocab_size"],
            hidden_size=td["hidden_size"],
            intermediate_size=td["intermediate_size"],
            num_layers=td["num_hidden_layers"],
            num_heads=td["num_attention_heads"],
            num_kv_heads=td.get("num_key_value_heads", td["num_attention_heads"]),
            head_dim=td.get("head_dim"),
            rope_theta=td.get("rope_theta", 1e6),
            rms_norm_eps=td.get("rms_norm_eps", 1e-6),
            tie_word_embeddings=td.get("tie_word_embeddings", False),
            # an explicit key wins; else the qwen3-family heuristic
            qk_norm=d.get("qk_norm", mt.startswith("qwen3")),
            attention_bias=td.get("attention_bias", mt.startswith("qwen2")),
            num_experts=td.get("num_experts", 0),
            num_experts_per_tok=td.get("num_experts_per_tok", 2),
            moe_intermediate_size=td.get("moe_intermediate_size"),
            norm_topk_prob=td.get("norm_topk_prob", True),
            image_token_id=d.get("image_token_id", -1),
            vision=vision,
        )

    @classmethod
    def from_hf_path(cls, path: str) -> "ModelConfig":
        """``from_hf_dict`` of ``<path>/config.json``."""
        with open(os.path.join(path, "config.json")) as f:
            return cls.from_hf_dict(json.load(f))


def _layer_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Per-layer parameter shapes in the port's layout ([out, in] dense
    matrices; the MoE leaves as in JAX); names as in the JAX
    ``_layer_shapes`` (models/qwen.py:177)."""
    D, Q, KV, Fd, hd = (
        cfg.hidden_size,
        cfg.q_dim,
        cfg.kv_dim,
        cfg.intermediate_size,
        cfg.head_dim_,
    )
    shapes = {
        "wq": (Q, D),
        "wk": (KV, D),
        "wv": (KV, D),
        "wo": (D, Q),
        "input_norm": (D,),
        "post_attn_norm": (D,),
    }
    if cfg.num_experts > 0:
        # a rank's config (``local_config``) holds its own experts and the
        # router's columns for all of them
        E, Fm = cfg.num_experts, cfg.moe_intermediate_size or Fd
        shapes.update(w_router=(D, getattr(cfg, "router_experts", 0) or E), we_gate=(E, D, Fm), we_up=(E, D, Fm),
                      we_down=(E, Fm, D))
    else:
        shapes.update(w_gate=(Fd, D), w_up=(Fd, D), w_down=(D, Fd))
    if cfg.attention_bias:
        shapes.update(bq=(Q,), bk=(KV,), bv=(KV,))
    if cfg.qk_norm:
        shapes.update(q_norm=(hd,), k_norm=(hd,))
    return shapes


# the dense projections, in F.linear's [out, in] layout (every other layer
# leaf keeps JAX's layout)
DENSE_MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _lora_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """a: [r, in], b: [out, r] per target projection (JAX's [in, r] / [r,
    out] transposed, ``models/qwen.py:211``), from the base shapes."""
    base = _layer_shapes(cfg)
    r = cfg.lora_rank
    out = {}
    for t in cfg.lora_targets:
        if t not in base or len(base[t]) != 2:
            raise ValueError(f"LoRA target {t!r} is not a 2-D layer projection")
        d_out, d_in = base[t] if t in DENSE_MATRICES else base[t][::-1]
        out[f"{t}_lora_a"] = (r, d_in)
        out[f"{t}_lora_b"] = (d_out, r)
    return out


# layer parameter -> (HF suffix, transpose). The flags describe the port's
# layout: its dense [out, in] matrices are HF's own layout, while the MoE
# router [D, E] and the expert stacks' [in, out] slices are HF's transposed
_HF_LAYER_MAP = {
    "wq": ("self_attn.q_proj.weight", False),
    "wk": ("self_attn.k_proj.weight", False),
    "wv": ("self_attn.v_proj.weight", False),
    "wo": ("self_attn.o_proj.weight", False),
    "bq": ("self_attn.q_proj.bias", False),
    "bk": ("self_attn.k_proj.bias", False),
    "bv": ("self_attn.v_proj.bias", False),
    "q_norm": ("self_attn.q_norm.weight", False),
    "k_norm": ("self_attn.k_norm.weight", False),
    "w_gate": ("mlp.gate_proj.weight", False),
    "w_up": ("mlp.up_proj.weight", False),
    "w_down": ("mlp.down_proj.weight", False),
    "input_norm": ("input_layernorm.weight", False),
    "post_attn_norm": ("post_attention_layernorm.weight", False),
    "w_router": ("mlp.gate.weight", True),
    "we_gate": ("mlp.experts.{e}.gate_proj.weight", True),
    "we_up": ("mlp.experts.{e}.up_proj.weight", True),
    "we_down": ("mlp.experts.{e}.down_proj.weight", True),
}
EXPERT_LEAVES = ("we_gate", "we_up", "we_down")


def hf_name_map(cfg: ModelConfig) -> dict[str, tuple[str, bool]]:
    """Flat map: the port's parameter name -> (HF name, transpose), as
    ``areal_tpu/models/qwen.py:833`` maps the JAX paths. Dense leaves map as
    ``layers.<l>.<name>``; an MoE expert stack [E, ...] maps one HF tensor
    per (layer, expert) as ``layers.<l>.<name>.<e>``. ``transpose`` says
    that the HF tensor is the transpose of the port's (slice of the) leaf."""
    out: dict[str, tuple[str, bool]] = {
        "embed": ("model.embed_tokens.weight", False),
        "final_norm": ("model.norm.weight", False),
    }
    if not cfg.tie_word_embeddings:
        out["lm_head"] = ("lm_head.weight", False)
    for name in _layer_shapes(cfg):
        suffix, transpose = _HF_LAYER_MAP[name]
        for i in range(cfg.num_layers):
            if name in EXPERT_LEAVES:
                for e in range(cfg.num_experts):
                    out[f"layers.{i}.{name}.{e}"] = (f"model.layers.{i}.{suffix.format(e=e)}", transpose)
            else:
                out[f"layers.{i}.{name}"] = (f"model.layers.{i}.{suffix}", transpose)
    return out


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


class DecoderLayer(nn.Module):
    """One transformer block's parameters (dense SwiGLU or MoE FFN). The
    forward functions below read them as attributes; ``forward`` is the
    block of a layer placed by ``shard_model``."""

    tp: tp_lib.TPInfo | None = None  # set by shard_model
    ep: tp_lib.EPInfo | None = None

    def __init__(self, cfg: ModelConfig, device: torch.device, dtype: torch.dtype):
        super().__init__()
        shapes = _layer_shapes(cfg)
        if cfg.lora_rank > 0:
            shapes.update(_lora_shapes(cfg))
        for name, shape in shapes.items():
            setattr(self, name, _param(shape, device, dtype))

    def forward(self, cfg: ModelConfig, x, mask, rope, impl: str, no_grad: bool, with_aux: bool, recompute: bool,
                selective: dict):
        """``_decoder_layer`` on this layer's own leaves cast to the compute
        dtype, under the recompute ``forward_masked`` chose. The call is
        where FSDP2 gathers the layer (and, in the backward, gathers it
        again before the recompute), so the cast reads whole leaves; the
        recompute casts again from the leaves gathered for the backward."""

        def body(x):
            view = SimpleNamespace(**{n: p.to(cfg.torch_dtype) for n, p in self.named_parameters()}, tp=self.tp,
                                   ep=self.ep)
            return _decoder_layer(cfg, view, x, mask, rope, impl, no_grad, with_aux)

        if recompute:
            return checkpoint(body, x, use_reentrant=False, **selective)
        return body(x)


class QwenModel(nn.Module):
    """Parameters of the decoder: ``embed`` [V, D], ``layers``,
    ``final_norm`` [D], when embeddings are untied ``lm_head`` [V, D], and
    for a VLM the tower ``vision`` (``models/vision.VisionTower``).
    Parameters are allocated uninitialized on ``device`` (CUDA unless
    ``device="cpu"``); fill them with ``init_params`` or ``load_state_dict``."""

    tp: tp_lib.TPInfo | None = None  # set by shard_model
    ep: tp_lib.EPInfo | None = None

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        dt = cfg.torch_dtype
        self.embed = _param((cfg.vocab_size, cfg.hidden_size), self.device, dt)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, self.device, dt) for _ in range(cfg.num_layers)
        )
        self.final_norm = _param((cfg.hidden_size,), self.device, dt)
        if not cfg.tie_word_embeddings:
            self.lm_head = _param((cfg.vocab_size, cfg.hidden_size), self.device, dt)
        if cfg.vision is not None:
            self.vision = VisionTower(cfg.vision, self.device, dt)

    @property
    def lm_head_weight(self) -> torch.Tensor:
        return self.embed if self.cfg.tie_word_embeddings else self.lm_head

    def forward(self, fn, *args, **kwargs):
        """``fn(self, *args, **kwargs)`` inside the module's call: for a
        model placed by ``shard_model`` the call is where FSDP2 gathers the
        root's leaves (embed, final_norm, lm_head, a value head) and, after
        the backward, reduces their gradients."""
        return fn(self, *args, **kwargs)


def _init_leaf(p: torch.Tensor, leaf: str, generator: torch.Generator) -> None:
    if leaf.endswith("norm"):
        p.fill_(1.0)
    elif leaf in ("bq", "bk", "bv") or leaf.endswith("_lora_b"):
        p.zero_()
    else:
        w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
        nn.init.trunc_normal_(w, std=0.02, a=-0.04, b=0.04, generator=generator)
        p.copy_(w)


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> QwenModel:
    """Random init (truncated-normal 0.02 in f32, cast to the model dtype;
    norms 1, biases 0, LoRA B 0) from a seeded ``torch.Generator`` that
    lives on the model's device (models/qwen.py:348); the decoder first,
    then a VLM's tower (``vision.init_vision_params``)."""
    model = QwenModel(cfg, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.startswith("vision."):
                _init_leaf(p, name.rsplit(".", 1)[-1], generator)
    if cfg.vision is not None:
        init_vision_params(model.vision, generator)
    return model


def init_lora_params(model: QwenModel, generator: torch.Generator) -> None:
    """Fresh adapters in place (models/qwen.py:225): every A from N(0, 0.02)
    truncated at 2 sigma (drawn in f32, cast), every B 0, so the adapted
    model starts exactly at the base model."""
    if model.cfg.lora_rank <= 0:
        raise ValueError("init_lora_params needs lora_rank > 0")
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if "_lora_" in leaf:
                _init_leaf(p, leaf, generator)


def merge_lora(state: dict[str, torch.Tensor], cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """W' = W + (alpha / r) A@B per target, computed in f32 and cast back to
    W's dtype, without the adapter leaves (models/qwen.py:258); ``state``
    maps the port's names to tensors. Other entries pass through (the same
    tensors). The merged tree is what the HF export and a full weight update
    carry."""
    if cfg.lora_rank <= 0:
        return state
    scale = cfg.lora_alpha / cfg.lora_rank
    out = {n: t for n, t in state.items() if "_lora_" not in n}
    for i in range(cfg.num_layers):
        for t in cfg.lora_targets:
            key = f"layers.{i}.{t}"
            a, b = state[f"{key}_lora_a"].float(), state[f"{key}_lora_b"].float()
            w = state[key]
            delta = b @ a if t in DENSE_MATRICES else (b @ a).t()
            out[key] = (w.float() + scale * delta).to(w.dtype)
    return out


# int8 weight-only serving (models/qwen.py:301): the dense projections only;
# embed / lm_head, norms, biases and MoE experts stay as they are
QUANT_TARGETS = DENSE_MATRICES


def quantize_dense_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """W[..., out, in] -> (q8 int8 [..., out, in], scale f32 [..., out]) with
    W ~ q8 * scale per output channel: s = max|W| / 127 over the input dim
    (at least 1e-12), q8 = round(W / s) (half to even) clipped to +-127, all
    in f32 (models/qwen.py:311). The one transform of server-side
    quantization and the client's q8 wire."""
    w32 = w.float()
    amax = w32.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: torch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the same f32 quotient
    s = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    return torch.round(w32 / s).clamp(-127, 127).to(torch.int8), s[..., 0]


def quantize_params_int8(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``quantize_dense_int8`` of every ``layers.<i>.<target>`` of a state
    dict: each becomes ``<target>_q8`` and ``<target>_scale``; every other
    entry passes through (models/qwen.py:323)."""
    out = {}
    for name, t in state.items():
        parts = name.split(".")
        if parts[0] == "layers" and len(parts) == 3 and parts[2] in QUANT_TARGETS:
            out[f"{name}_q8"], out[f"{name}_scale"] = quantize_dense_int8(t)
        else:
            out[name] = t
    return out


def quantize_model_int8(model: QwenModel) -> None:
    """Replace, in place, each layer's target projections by their int8
    serving form (``<target>_q8`` int8, ``<target>_scale`` f32 parameters),
    one tensor at a time; ``_proj`` then reads them."""
    with torch.no_grad():
        for layer in model.layers:
            for name in QUANT_TARGETS:
                w = layer._parameters.get(name)
                if w is None:
                    continue
                q8, s = quantize_dense_int8(w)
                del layer._parameters[name]
                setattr(layer, f"{name}_q8", nn.Parameter(q8, requires_grad=False))
                setattr(layer, f"{name}_scale", nn.Parameter(s, requires_grad=False))


# ---------------------------------------------------------------------------
# placement across GPUs
# ---------------------------------------------------------------------------


def param_partition_specs(cfg: ModelConfig) -> dict[str, tuple]:
    """The mesh axis of each dim of each leaf, by leaf name (a layer's
    leaves without the layer index): ``areal_tpu/models/qwen.py:382``'s
    ``param_partition_specs`` in the port's layout. The projections are
    ``[out, in]``, so JAX's ``(fsdp, model)`` of a column-parallel ``[in,
    out]`` leaf is ``("model", "fsdp")`` here and a row-parallel leaf's
    ``(model, fsdp)`` is ``("fsdp", "model")``. The expert stacks keep JAX's
    layout and spec: ``we_gate`` / ``we_up`` [E, D, F] ``("expert", "fsdp",
    "model")``, ``we_down`` [E, F, D] ``("expert", "model", "fsdp")``; the
    router is replicated. The vocabulary of embed / lm_head splits over both
    axes, in contiguous ``model`` blocks each sharded over ``fsdp`` (JAX
    orders the blocks fsdp-major). The norms, the router and a value head
    are ``None`` (replicated) in JAX; FSDP2 shards every leaf it manages, so
    they shard over ``fsdp`` along dim 0. LoRA adapters and a vision tower
    are ROADMAP Queue A item 6b-2b."""
    if cfg.lora_rank > 0 or cfg.vision is not None:
        raise NotImplementedError("LoRA and vision leaves on a mesh: ROADMAP Queue A item 6b-2b")
    col, row = ("model", "fsdp"), ("fsdp", "model")
    specs = {
        "wq": col, "wk": col, "wv": col, "wo": row,
        "w_gate": col, "w_up": col, "w_down": row,
        "input_norm": (None,), "post_attn_norm": (None,),
        "embed": (("model", "fsdp"), None),
        "final_norm": (None,),
        "value_head": (None,),
    }
    if cfg.num_experts > 0:
        specs.update(w_router=(None, None), we_gate=("expert", "fsdp", "model"), we_up=("expert", "fsdp", "model"),
                     we_down=("expert", "model", "fsdp"))
    if cfg.attention_bias:
        specs.update(bq=("model",), bk=("model",), bv=("model",))
    if cfg.qk_norm:
        specs.update(q_norm=(None,), k_norm=(None,))
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = specs["embed"]
    return specs


def quant_partition_specs(cfg: ModelConfig) -> dict[str, tuple]:
    """``param_partition_specs`` of the int8 serving form
    (``areal_tpu/models/qwen.py:333``): each ``<t>_q8`` inherits its base
    leaf's spec, each ``<t>_scale`` [out] keeps only the output dim's
    split (a row-parallel ``wo`` / ``w_down`` scale is whole on every rank:
    it is the max over the whole input dim). The expert stacks stay bf16,
    as in JAX (``QUANT_TARGETS``), under their own specs."""
    specs = param_partition_specs(cfg)
    for t in QUANT_TARGETS:
        spec = specs.pop(t, None)
        if spec is not None:
            specs[f"{t}_q8"] = spec
            specs[f"{t}_scale"] = spec[:1]
    return specs


def _axis_dim(spec: tuple, axis: str) -> int | None:
    """The dim of ``spec`` that ``axis`` splits (None: replicated over it)."""
    for d, s in enumerate(spec):
        if s == axis or (isinstance(s, tuple) and axis in s):
            return d
    return None


def mesh_dim(cfg: ModelConfig, name: str, axis: str) -> int | None:
    """The dim of the leaf ``name`` (``layers.<i>.<leaf>`` or a root leaf)
    that ``axis`` splits, None for a leaf replicated over it."""
    return _axis_dim(param_partition_specs(cfg)[name.rsplit(".", 1)[-1]], axis)


def tp_slice(t: torch.Tensor, spec: tuple, tp_size: int, rank: int, ep_size: int = 1,
             ep_rank: int = 0) -> torch.Tensor:
    """The part of a leaf placed by ``spec`` that the rank at ``rank`` on a
    ``model`` axis of ``tp_size`` and ``ep_rank`` on an ``expert`` axis of
    ``ep_size`` holds: its contiguous block along the dim each axis splits
    (an expert stack: the rank's experts, then its FFN columns), the leaf
    itself where neither does. The one slicing rule of the trainer's
    placement (``shard_model``), the server's placement and the server's
    weight updates."""
    for axis, n, r in (("expert", ep_size, ep_rank), ("model", tp_size, rank)):
        d = _axis_dim(spec, axis)
        if n > 1 and d is not None:
            t = t.chunk(n, dim=d)[r]
    return t


def leaf_spec(specs: dict, name: str) -> tuple:
    """The spec of a parameter ``layers.<i>.<leaf>`` or a root leaf."""
    return specs[name.rsplit(".", 1)[-1]]


@dataclasses.dataclass(frozen=True)
class RankConfig(ModelConfig):
    """``local_config`` of an MoE model on an ``expert`` axis: ``num_experts``
    is the rank's own experts, ``router_experts`` the whole model's (the
    router's columns)."""

    router_experts: int = 0


def local_config(cfg: ModelConfig, tp_size: int, ep_size: int = 1) -> ModelConfig:
    """The shapes one rank of a ``model`` axis of ``tp_size`` and an
    ``expert`` axis of ``ep_size`` computes with: its heads, its FFN columns
    (the experts' too), its vocabulary block and its experts. ``tp_size``
    must divide each of the first three (a head never splits) and
    ``ep_size`` the experts."""
    parts = {"num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
             "intermediate_size": cfg.intermediate_size, "vocab_size": cfg.vocab_size}
    if cfg.num_experts and cfg.moe_intermediate_size:
        parts["moe_intermediate_size"] = cfg.moe_intermediate_size
    bad = [f"{k}={v}" for k, v in parts.items() if v % tp_size]
    if bad:
        raise NotImplementedError(f"model={tp_size} does not divide {', '.join(bad)}: uneven tensor parallelism "
                                  "is ROADMAP Queue A item 6b")
    local = dataclasses.replace(cfg, head_dim=cfg.head_dim_, **{k: v // tp_size for k, v in parts.items()})
    if ep_size == 1 or not cfg.num_experts:
        return local
    if cfg.num_experts % ep_size:
        raise ValueError(f"expert={ep_size} does not divide num_experts={cfg.num_experts}")
    fields = {f.name: getattr(local, f.name) for f in dataclasses.fields(ModelConfig)}
    return RankConfig(**{**fields, "num_experts": cfg.num_experts // ep_size}, router_experts=cfg.num_experts)


def shard_model(model: QwenModel, mesh, compute_dtype: torch.dtype) -> ModelConfig:
    """Place ``model``'s leaves on ``mesh`` (``parallel/mesh.py``) by
    ``param_partition_specs``, in place: each leaf's ``model`` and
    ``expert`` dims become the rank's slice (``tp_slice``, a plain local
    tensor), then FSDP2 ``fully_shard``s each ``DecoderLayer`` and the root
    over the mesh's (data, fsdp) axes, every leaf along its ``fsdp`` dim.
    Leaves without an ``expert`` dim are replicated over ``expert``; their
    gradients come out equal on every rank of it (the MoE conjugates,
    ``models/moe.py``), so nothing reduces over it. FSDP2 gathers a layer's
    leaves in ``compute_dtype`` (the master's one rounding) and
    reduce-scatters their gradients in f32, summed over data x fsdp (no
    division: the engine's loss weights are the whole grid's). Returns the
    rank's ``local_config``."""
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
    from torch.distributed.tensor import Shard

    from areal_tpu_torch.parallel.mesh import BATCH_AXES, axis_size, dp_size

    cfg = model.cfg
    specs = param_partition_specs(cfg)
    m, e = axis_size(mesh, "model"), axis_size(mesh, "expert")
    local_cfg = local_config(cfg, m, e)
    rank, ep_rank = mesh.get_local_rank("model"), mesh.get_local_rank("expert")
    tp = tp_lib.TPInfo(group=mesh.get_group("model") if m > 1 else None, rank=rank, size=m,
                       vocab_start=rank * local_cfg.vocab_size)
    ep = tp_lib.EPInfo(group=mesh.get_group("expert") if e > 1 else None, rank=ep_rank, size=e,
                       dp_groups=tuple(mesh.get_group(a) for a in BATCH_AXES if axis_size(mesh, a) > 1),
                       dp_size=dp_size(mesh))
    placement = {}
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        spec = specs[leaf]
        if any(n > 1 and _axis_dim(spec, a) is not None for a, n in (("model", m), ("expert", e))):
            p = nn.Parameter(tp_slice(p.detach(), spec, m, rank, e, ep_rank).clone(), requires_grad=p.requires_grad)
            setattr(mod, leaf, p)
        placement[p] = Shard(_axis_dim(spec, "fsdp") or 0)
    model.tp, model.ep = tp, ep
    for layer in model.layers:
        layer.tp, layer.ep = tp, ep
    mp = MixedPrecisionPolicy(
        param_dtype=None if compute_dtype == cfg.torch_dtype else compute_dtype,
        reduce_dtype=torch.float32,
        cast_forward_inputs=False,
    )
    dp_mesh = mesh["data", "fsdp"]
    for mod in [*model.layers, model]:
        fully_shard(mod, mesh=dp_mesh, mp_policy=mp, shard_placement_fn=placement.get)
        mod.set_gradient_divide_factor(1.0)
        mod.set_force_sum_reduction_for_comms(True)
    return local_cfg


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------


def _embed_lookup(embed: torch.Tensor, ids: torch.Tensor, dtype, tp: tp_lib.TPInfo | None = None) -> torch.Tensor:
    """Row gather from the [V, D] table; the vocab-parallel lookup when the
    ``model`` axis splits the table (``models/qwen.py:445``)."""
    if tp is not None and tp.size > 1:
        return tp_lib.embed_lookup(embed, ids, dtype, tp)
    return F.embedding(ids.long(), embed).to(dtype)


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin [..., L, 1, head_dim/2] in f32 for ``_rope``. They depend only
    on the positions, so a forward computes them once for all layers."""
    half = head_dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    angles = positions[..., None].float() * freq  # [..., L, half]
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Neox-style rotary embedding of x [..., L, n_heads, head_dim], computed
    in f32 and cast back to x's dtype at the end."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _dot(x: torch.Tensor, w: torch.Tensor, saved: bool) -> torch.Tensor:
    """x @ W^T, a dot whose output ``remat_policy="dots_nobatch"`` saves
    unless ``saved`` is False (``models/remat.py``)."""
    return remat_lib.saved_dot(F.linear, x, w) if saved else F.linear(x, w)


def _proj(cfg: ModelConfig, layer, name: str, x: torch.Tensor, saved: bool = True) -> torch.Tensor:
    """x @ W for the layer's projection ``name`` (models/qwen.py:276). An int8
    weight (``<name>_q8`` + ``<name>_scale``) multiplies as
    ``(x @ q8.to(x.dtype)).float() * scale`` cast to x's dtype: the scale
    applies to the product, and the cast of |q8| <= 127 is exact. A layer
    with adapters adds ``((x @ A) @ B) * (alpha / r)`` in x's dtype; x @ A
    is always a saved dot (the backward reads it for B's gradient), the
    outer product one as ``saved`` says."""
    q8 = getattr(layer, f"{name}_q8", None)
    if q8 is not None:
        y = _dot(x, q8.to(x.dtype), saved)
        out = (y.float() * getattr(layer, f"{name}_scale")).to(x.dtype)
    else:
        out = _dot(x, getattr(layer, name), saved)
    a = getattr(layer, f"{name}_lora_a", None)
    if a is not None:
        xa = _dot(x, a, True)
        out = out + _dot(xa, getattr(layer, f"{name}_lora_b"), saved) * (cfg.lora_alpha / cfg.lora_rank)
    return out


def _ffn(cfg: ModelConfig, h: torch.Tensor, layer) -> torch.Tensor:
    """Feed-forward of [..., D] for the serving paths (models/qwen.py:577):
    dense SwiGLU, or the MoE FFN, which takes [G, L, D] (a decode step's
    [S, D] goes as [S, 1, D]); its aux loss is not needed here. Under
    tensor parallelism gate / up are column-parallel and down row-parallel."""
    if cfg.num_experts > 0:
        squeeze = h.dim() == 2
        out, _ = moe.moe_ffn(h[:, None] if squeeze else h, layer, cfg)
        return out[:, 0] if squeeze else out
    tp = getattr(layer, "tp", None)
    h = tp_lib.copy_to_model(h, tp)
    # the down projection's output is read by no backward: not saved
    ff = F.silu(_proj(cfg, layer, "w_gate", h)) * _proj(cfg, layer, "w_up", h)
    return tp_lib.reduce_from_model(_proj(cfg, layer, "w_down", ff, saved=False), tp)


def _qkv(cfg: ModelConfig, layer: DecoderLayer, x: torch.Tensor, rope: tuple):
    """Attention inputs of one layer. x [A, P, D] -> q [A, P, H, hd],
    k/v [A, P, KH, hd] (post-norm, post-bias, post-rope; pre-GQA-repeat).
    ``rope`` is ``_rope_angles`` of the positions."""
    A, P, _ = x.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    h = tp_lib.copy_to_model(_rms_norm(x, layer.input_norm, cfg.rms_norm_eps), getattr(layer, "tp", None))
    q, k, v = (_proj(cfg, layer, n, h) for n in ("wq", "wk", "wv"))
    if cfg.attention_bias:
        q, k, v = q + layer.bq, k + layer.bk, v + layer.bv
    q = q.reshape(A, P, H, hd)
    k = k.reshape(A, P, KH, hd)
    v = v.reshape(A, P, KH, hd)
    if cfg.qk_norm:
        q = _rms_norm(q, layer.q_norm, cfg.rms_norm_eps)
        k = _rms_norm(k, layer.k_norm, cfg.rms_norm_eps)
    return _rope(q, *rope), _rope(k, *rope), v


def compute_logits(model: QwenModel, hidden: torch.Tensor) -> torch.Tensor:
    """[..., D] -> [..., V] logits in f32: the product runs in the weight
    dtype with an f32 result. On CUDA that is ``torch.mm(..., out_dtype=
    torch.float32)`` (no second copy of the [V, D] table), which has no
    derivative; where a gradient is needed (the tree path's node logprobs),
    and on the CPU, which has no such operator, both operands are up-cast to
    f32 explicitly: the same exact products, summed in f32.

    Under tensor parallelism (``model.tp``, a served model's vocab-parallel
    head) each rank's product is its vocabulary block; the blocks, each
    placed in a zero f32 [..., V], sum over ``model``: one block and zeros,
    so every rank holds the whole logits, exactly."""
    w = model.lm_head_weight
    lead = hidden.shape[:-1]
    h = hidden.to(w.dtype).reshape(-1, w.shape[1])
    grad = torch.is_grad_enabled() and (h.requires_grad or w.requires_grad)
    if w.dtype == torch.float32:
        out = h @ w.t()
    elif h.is_cuda and not grad:
        out = torch.mm(h, w.t(), out_dtype=torch.float32)
    else:
        out = h.float() @ w.float().t()
    tp = getattr(model, "tp", None)
    if tp is not None and tp.size > 1:
        full = out.new_zeros((out.shape[0], w.shape[0] * tp.size))
        full[:, tp.vocab_start : tp.vocab_start + w.shape[0]] = out
        out = tp_lib.reduce_from_model(full, tp)
    return out.reshape(*lead, out.shape[-1])


# ---------------------------------------------------------------------------
# training forward over packed [G, L] grids
# ---------------------------------------------------------------------------


class ParamView:
    """The parameters of a ``QwenModel`` cast to ``cfg.dtype`` (the compute
    dtype), with the attribute layout the forward functions read (``cfg``,
    ``embed``, ``layers[i].<name>``, ``final_norm``, ``lm_head_weight``).
    The casts are differentiable, so gradients reach the (f32 master)
    parameters; a cast to the parameters' own dtype is the parameter
    itself. ``cfg`` also carries the training switches (``attn_impl``,
    ``remat``)."""

    def __init__(self, model: QwenModel, cfg: ModelConfig):
        dt = cfg.torch_dtype
        self.cfg = cfg
        self.embed = model.embed.to(dt)
        self.layers = [
            SimpleNamespace(**{n: p.to(dt) for n, p in layer.named_parameters()})
            for layer in model.layers
        ]
        self.final_norm = model.final_norm.to(dt)
        self.lm_head_weight = (
            self.embed if model.cfg.tie_word_embeddings else model.lm_head.to(dt)
        )


class ShardedView:
    """``ParamView`` of a model placed by ``shard_model``, built inside the
    root's call (``QwenModel.forward``), where the root's leaves are whole
    and already in the compute dtype. ``cfg`` is the rank's
    ``local_config``; ``layers`` are the layer modules themselves, which
    ``forward_masked`` calls; ``tp`` the rank's place on ``model``."""

    def __init__(self, model: QwenModel, cfg: ModelConfig):
        dt = cfg.torch_dtype
        self.cfg = cfg
        self.tp = model.tp
        self.embed = model.embed.to(dt)
        self.layers = list(model.layers)
        self.final_norm = model.final_norm.to(dt)
        self.lm_head_weight = self.embed if model.cfg.tie_word_embeddings else model.lm_head.to(dt)


def _decoder_layer(cfg: ModelConfig, layer, x, mask, rope, impl: str, no_grad: bool, with_aux: bool = False):
    """One transformer block over x [G, L, D] (models/qwen.py:595) -> (x,
    aux): the MoE router's load-balance aux of this layer when ``with_aux``
    and the FFN is MoE, else None. ``mask`` is the segment ids for the flash
    kernels ("pallas"), the [G, 1, L, L] bool mask for ``sdpa_plain``
    ("xla"), or the (words, block_any) of one packed forest for the tree
    kernels ("tree", G = 1)."""
    G, L, _ = x.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q, k, v = _qkv(cfg, layer, x, rope)
    if KH != H:
        k = k.repeat_interleave(H // KH, dim=2)
        v = v.repeat_interleave(H // KH, dim=2)
    if impl == "pallas":
        attn_fn = flash_fwd if no_grad else flash_train
        attn = attn_fn(q, k, v, mask)
    elif impl == "tree":
        attn = tree_attention(q[0], k[0], v[0], *mask)[None]
    else:
        attn = sdpa_plain(q, k, v, mask, hd)
    x = x + tp_lib.reduce_from_model(_proj(cfg, layer, "wo", attn.reshape(G, L, H * hd)), getattr(layer, "tp", None))
    h = _rms_norm(x, layer.post_attn_norm, cfg.rms_norm_eps)
    if cfg.num_experts > 0:
        ff, aux = moe.moe_ffn(h, layer, cfg, with_aux)
        return x + ff, aux
    return x + _ffn(cfg, h, layer), None


def forward(
    model,  # QwenModel or ParamView
    input_ids: torch.Tensor,  # [G, L]
    segment_ids: torch.Tensor,  # [G, L] int32, 0 = padding
    positions: torch.Tensor,  # [G, L], restarting per segment
    no_grad: bool = False,
    with_aux: bool = False,  # also return the summed MoE router aux loss
    image_embeds: torch.Tensor | None = None,  # [G, L, D] a VLM's tower output, positioned
):
    """Decoder body -> final hidden states [G, L, D] (models/qwen.py:679),
    and with ``with_aux`` the pair (hidden, sum of the layers' router aux
    losses as an f32 scalar; 0 for a dense model), as the JAX ``forward``
    returns them. ``cfg.attn_impl`` picks the attention: "pallas" runs
    ``flash_train`` (``flash_fwd`` when ``no_grad``), "xla" the plain masked
    softmax."""
    impl = resolve_impl(model.cfg.attn_impl)
    mask = segment_ids.to(torch.int32).contiguous() if impl == "pallas" else _attention_mask(segment_ids)
    return forward_masked(model, input_ids, positions, mask, impl, no_grad, with_aux, image_embeds)


def _embed_inputs(model, input_ids: torch.Tensor, image_embeds: torch.Tensor | None) -> torch.Tensor:
    """Token embeddings in the compute dtype; for a VLM given
    ``image_embeds`` (positioned like ``input_ids``), the <|image_pad|>
    positions take those instead, cast to the compute dtype
    (models/qwen.py:692)."""
    cfg = model.cfg
    x = _embed_lookup(model.embed, input_ids, cfg.torch_dtype, getattr(model, "tp", None))
    if image_embeds is not None and cfg.image_token_id >= 0:
        img_pos = (input_ids == cfg.image_token_id)[..., None]
        x = torch.where(img_pos, image_embeds.to(cfg.torch_dtype), x)
    return x


def forward_masked(model, input_ids, positions, mask, impl: str, no_grad: bool = False, with_aux: bool = False,
                   image_embeds: torch.Tensor | None = None):
    """The decoder body under an attention given by ``impl`` and its
    ``mask`` (``_decoder_layer``) -> final hidden states [G, L, D], or
    (hidden, summed aux) with ``with_aux``. With ``cfg.remat`` and policy
    "nothing" each layer runs under ``torch.utils.checkpoint`` while
    gradients are on; under "dots_nobatch" the same, with the selective
    policy of ``models/remat.py`` (the projections' and the router's
    outputs saved, the rest, kernels included, recomputed). The aux rides
    out of the checkpoint with the hidden states (the recompute routes as
    the first pass did: the router and the grouped matmuls are
    deterministic)."""
    cfg = model.cfg
    if cfg.remat and cfg.remat_policy not in ("nothing", "dots_nobatch", "everything"):
        raise ValueError(f"remat_policy={cfg.remat_policy!r}; valid: dots_nobatch, everything, nothing")
    x = _embed_inputs(model, input_ids, image_embeds)
    rope = _rope_angles(positions, cfg.head_dim_, cfg.rope_theta)
    recompute = (
        cfg.remat and cfg.remat_policy != "everything" and not no_grad and torch.is_grad_enabled()
    )
    selective = {"context_fn": remat_lib.context_fn} if cfg.remat_policy == "dots_nobatch" else {}
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in model.layers:
        if isinstance(layer, DecoderLayer):  # a placed layer: its call gathers it
            x, aux = layer(cfg, x, mask, rope, impl, no_grad, with_aux, recompute, selective)
        elif recompute:
            x, aux = checkpoint(
                _decoder_layer, cfg, layer, x, mask, rope, impl, no_grad, with_aux, use_reentrant=False, **selective
            )
        else:
            x, aux = _decoder_layer(cfg, layer, x, mask, rope, impl, no_grad, with_aux)
        if aux is not None:
            aux_sum = aux_sum + aux
    hidden = _rms_norm(x, model.final_norm, cfg.rms_norm_eps)
    return (hidden, aux_sum) if with_aux else hidden


def _logprob_entropy_chunk(h, y, w, temperature: float):
    """One chunk of ``chunked_logprobs_entropy``: the logits round to the
    weight dtype (a bf16 product with a bf16 result, then f32, as
    ``jnp.einsum("td,vd->tv", h, w).astype(f32)``), then log p(label) and
    the entropy."""
    logits = (h @ w.t()).float()
    if temperature != 1.0:
        logits = logits / temperature
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(1, y[:, None].long())[:, 0]
    probs = torch.softmax(logits, dim=-1)
    ent = lse - (probs * logits).sum(dim=-1)
    return label_logit - lse, ent


def chunked_logprobs_entropy(
    model,  # QwenModel or ParamView
    hidden: torch.Tensor,  # [G, L, D]
    labels: torch.Tensor,  # [G, L] next-token ids
    chunk_size: int = 1024,
    temperature: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """log p(label) and entropy per position [G, L] without holding [T, V]
    logits: tokens go in chunks, each recomputed in the backward
    (models/qwen.py:762). Vocab-parallel when the ``model`` axis splits the
    LM head (``tensor_parallel.logprob_entropy``)."""
    G, L, D = hidden.shape
    w = model.lm_head_weight
    T = G * L
    flat_h = hidden.reshape(T, D).to(w.dtype)
    flat_y = labels.reshape(T)
    tp = getattr(model, "tp", None)
    chunk_fn = _logprob_entropy_chunk
    extra = ()
    if tp is not None and tp.size > 1:
        flat_h = tp_lib.copy_to_model(flat_h, tp)
        chunk_fn, extra = tp_lib.logprob_entropy, (tp,)
    grad = torch.is_grad_enabled() and (flat_h.requires_grad or w.requires_grad)
    logps, ents = [], []
    for s in range(0, T, chunk_size):
        h, y = flat_h[s : s + chunk_size], flat_y[s : s + chunk_size]
        if grad:
            lp, ent = checkpoint(chunk_fn, h, y, w, temperature, *extra, use_reentrant=False)
        else:
            lp, ent = chunk_fn(h, y, w, temperature, *extra)
        logps.append(lp)
        ents.append(ent)
    return torch.cat(logps).reshape(G, L), torch.cat(ents).reshape(G, L)


def make_causal_inputs(
    input_ids: np.ndarray, segment_ids: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Labels and label validity for next-token prediction on packed rows:
    position t predicts token t+1 of the same segment; the last token of
    each segment (and padding) is masked out (models/qwen.py:866)."""
    labels = np.roll(input_ids, -1, axis=-1)
    next_seg = np.roll(segment_ids, -1, axis=-1)
    next_seg[..., -1] = 0
    valid = (segment_ids != 0) & (segment_ids == next_seg)
    return labels, valid


# ---------------------------------------------------------------------------
# incremental decoding (inference server path)
# ---------------------------------------------------------------------------


def forward_prefill(
    model: QwenModel,
    input_ids: torch.Tensor,  # [A, P]
    positions: torch.Tensor,  # [A, P]
    seg: torch.Tensor | None = None,  # [A, P] 1 = valid, 0 = pad
    image_embeds: torch.Tensor | None = None,  # [A, P, D] a VLM's tower output, positioned
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched prompt pass (models/qwen.py:887): returns (hidden [A, P, D],
    ks, vs) with ks/vs [n_layers, A, P, KH, hd] (post-rope, pre-GQA-repeat)
    for the cache fill. Attention is the plain masked einsum + softmax."""
    cfg = model.cfg
    if seg is None:
        seg = torch.ones_like(input_ids)
    x = _embed_inputs(model, input_ids, image_embeds)
    mask = _attention_mask(seg)
    A, P = input_ids.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    rope = _rope_angles(positions, hd, cfg.rope_theta)
    ks, vs = [], []
    for layer in model.layers:
        q, k, v = _qkv(cfg, layer, x, rope)
        ks.append(k)
        vs.append(v)
        if KH != H:
            k = k.repeat_interleave(H // KH, dim=2)
            v = v.repeat_interleave(H // KH, dim=2)
        attn = sdpa_plain(q, k, v, mask, hd).reshape(A, P, H * hd)
        x = x + tp_lib.reduce_from_model(_proj(cfg, layer, "wo", attn), getattr(layer, "tp", None))
        h = _rms_norm(x, layer.post_attn_norm, cfg.rms_norm_eps)
        x = x + _ffn(cfg, h, layer)
    hidden = _rms_norm(x, model.final_norm, cfg.rms_norm_eps)
    return hidden, torch.stack(ks), torch.stack(vs)


def _forward_suffix_paged(model, input_ids, positions, mask, cache, page_table, prefix_lens, kind):
    """The body shared by ``forward_prefill_paged`` and
    ``forward_verify_paged``: B rows per slot attend the slot's cached
    pages plus each other under ``mask`` through ``paged_suffix_attention``.
    Returns (hidden, ks, vs) with ks/vs [n_layers, S, B, KH, hd]; the cache
    is read, never written."""
    cfg = model.cfg
    S, B = input_ids.shape
    H, hd = cfg.num_heads, cfg.head_dim_
    x = _embed_lookup(model.embed, input_ids, cfg.torch_dtype, getattr(model, "tp", None))
    rope = _rope_angles(positions, hd, cfg.rope_theta)
    if page_table.is_cuda:  # the kernel's index types; the plain path takes any
        prefix_lens = prefix_lens.to(torch.int32)
        page_table = page_table.to(torch.int32)
    ks, vs = [], []
    for li, layer in enumerate(model.layers):
        q, k, v = _qkv(cfg, layer, x, rope)
        ks.append(k)
        vs.append(v)
        attn = paged_suffix_attention(
            q,
            k,
            v,
            cache["k"],
            cache["v"],
            li,
            prefix_lens,
            page_table,
            mask,
            k_scales=cache.get("k_scale"),
            v_scales=cache.get("v_scale"),
            kind=kind,
        )
        wo = _proj(cfg, layer, "wo", attn.reshape(S, B, H * hd).to(x.dtype))
        x = x + tp_lib.reduce_from_model(wo, getattr(layer, "tp", None))
        h = _rms_norm(x, layer.post_attn_norm, cfg.rms_norm_eps)
        x = x + _ffn(cfg, h, layer)
    hidden = _rms_norm(x, model.final_norm, cfg.rms_norm_eps)
    return hidden, torch.stack(ks), torch.stack(vs)


def forward_prefill_paged(
    model: QwenModel,
    input_ids: torch.Tensor,  # [A, B] suffix tokens (page-aligned start)
    positions: torch.Tensor,  # [A, B] absolute rope positions (prefix_len + i)
    seg: torch.Tensor,  # [A, B] 1 = valid, 0 = pad
    cache: dict,  # k/v [n_layers, KH, n_pages, psz, hd] (+ scales)
    page_table: torch.Tensor,  # [A, wp] pages holding the cached prefix
    prefix_lens: torch.Tensor,  # [A] tokens cached (page-aligned; 0 = none)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Suffix-only prefill over a radix-cached prefix
    (``models/qwen.py:944``): the queries of each row's suffix attend its
    cached prefix pages and the causal suffix (the chain-mask launch of
    kernel #3), so only the suffix pays prefill work. Returns (hidden, ks,
    vs) for the suffix positions; the caller scatters them into fresh pages.
    Padded rows (seg 0) have no valid mask bit and attend nothing: their
    attention output is zeros (the JAX gather path's is a discarded
    average) and their KV goes to the trash page either way."""
    mask = _attention_mask(seg)[:, 0]  # [A, B, B] causal, row/column validity
    return _forward_suffix_paged(
        model, input_ids, positions, mask, cache, page_table, prefix_lens, "chain"
    )


def forward_verify_paged(
    model: QwenModel,
    input_ids: torch.Tensor,  # [S, B] pending token (root) + draft tree nodes
    positions: torch.Tensor,  # [S, B] absolute rope positions (root pos + depth)
    tree_mask: torch.Tensor,  # [S, B, B] bool: node row attends node column
    cache: dict,
    page_table: torch.Tensor,  # [S, wp] pages holding the committed context
    prefix_lens: torch.Tensor,  # [S] tokens already in pages (= root position)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Speculative verify (``models/qwen.py:1070``): every slot's draft tree
    of B nodes in one pass over the paged cache, under the drafter's
    ancestor-or-self mask (the tree-mask launch of kernel #3). The drafter
    sets every node's self bit, so every node attends the whole committed
    context. Returns (hidden [S, B, D], ks, vs [n_layers, S, B, KH, hd]); KV
    is not written here — the caller routes accepted-path rows into pages
    (``paged_kv.scatter_token_rows``)."""
    return _forward_suffix_paged(
        model, input_ids, positions, tree_mask, cache, page_table, prefix_lens, "tree"
    )


def forward_decode_paged(
    model: QwenModel,
    ids: torch.Tensor,  # [S] current tokens
    positions: torch.Tensor,  # [S] rope positions of these tokens
    cache: dict,  # k/v [n_layers, KH, n_pages, page_size, hd] (+ scales)
    page_table: torch.Tensor,  # [S, wp] int32 page ids covering the window
    *,
    page_size: int,
) -> tuple[torch.Tensor, dict]:
    """One incremental step for all S slots over the paged KV cache
    (models/qwen.py:1191). The step's k/v lands at page
    ``page_table[s, pos // psz]`` row ``pos % psz`` — written into the cache
    in place — and attention reads each slot's pages through
    ``paged_attention_stacked`` (the CUDA kernel on a card, its plain twin
    on the CPU)."""
    cfg = model.cfg
    S = ids.shape[0]
    H, hd = cfg.num_heads, cfg.head_dim_
    x = _embed_lookup(model.embed, ids, cfg.torch_dtype, getattr(model, "tp", None))  # [S, D]
    rope = _rope_angles(positions[:, None], hd, cfg.rope_theta)
    lengths = (positions + 1).to(torch.int32)
    slot = torch.arange(S, device=ids.device)
    # stale positions of inactive slots may point past the window: clamp the
    # column like JAX's out-of-range gather does (their rows hold page 0)
    col = torch.clamp(positions // page_size, max=page_table.shape[1] - 1).long()
    write_page = page_table[slot, col].long()  # [S]
    write_off = (positions % page_size).long()  # [S]
    kv_quant = "k_scale" in cache
    for li, layer in enumerate(model.layers):
        q, k, v = _qkv(cfg, layer, x[:, None], rope)
        q, k, v = q[:, 0], k[:, 0], v[:, 0]  # [S, H, hd], [S, KH, hd]
        if kv_quant:
            kq, ksc = paged_kv.quantize_kv(k, dtype=cache["k"].dtype)
            vq, vsc = paged_kv.quantize_kv(v, dtype=cache["v"].dtype)
            writes = (("k", kq), ("k_scale", ksc), ("v", vq), ("v_scale", vsc))
        else:
            writes = (("k", k), ("v", v))
        for name, val in writes:
            # cache[name][li] is a [KH, N, psz, d] view; the two index
            # tensors select [KH, S, d] — hence the transpose of [S, KH, d]
            cache[name][li][:, write_page, write_off] = val.transpose(0, 1).to(
                cache[name].dtype
            )
        attn = paged_attention_stacked(
            q,
            cache["k"],
            cache["v"],
            li,
            lengths,
            page_table,
            k_scales=cache.get("k_scale"),
            v_scales=cache.get("v_scale"),
        )
        attn = attn.reshape(S, H * hd).to(x.dtype)
        x = x + tp_lib.reduce_from_model(_proj(cfg, layer, "wo", attn), getattr(layer, "tp", None))
        h = _rms_norm(x, layer.post_attn_norm, cfg.rms_norm_eps)
        x = x + _ffn(cfg, h, layer)
    hidden = _rms_norm(x, model.final_norm, cfg.rms_norm_eps)
    return hidden, cache
