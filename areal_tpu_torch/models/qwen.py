"""Qwen2 / Qwen2.5 / Qwen3 dense decoder — the serving half of
``areal_tpu/models/qwen.py`` in PyTorch.

The JAX model keeps one stacked pytree scanned over layers; here the layers
are an ``nn.ModuleList`` of ``DecoderLayer`` modules whose parameter names
are the JAX leaf names (``wq``, ``bq``, ``q_norm``, ``w_gate``, ...).
Projection weights use PyTorch's ``[out, in]`` layout (``F.linear``);
``models/convert.py`` maps the JAX ``[in, out]`` arrays across.

Forward functions take the model and mirror the JAX functions of the same
name, including where bf16 rounds: ``_rms_norm`` casts to the input dtype
before the weight multiply, ``_rope`` computes in f32 and casts at the end,
``compute_logits`` returns f32 (the serving logits: a bf16 product with an
f32 result), while ``chunked_logprobs_entropy`` rounds the training logits
to bf16 before the f32 cast, as the JAX einsum does.

Training: the train engine keeps f32 master parameters in a ``QwenModel``
and runs ``forward`` on ``ParamView(model, compute_dtype)``, a differentiable
cast of them (``_outputs_fn`` of the JAX engine).
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from areal_tpu_torch.device import resolve_device
from areal_tpu_torch.inference import paged_kv
from areal_tpu_torch.ops.attention import (
    attention_mask as _attention_mask,
    flash_fwd,
    flash_train,
    resolve_impl,
    sdpa_plain,
)
from areal_tpu_torch.ops.paged_attention import paged_attention_stacked

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
    # training: per-layer recompute in the backward ("nothing" saved) or
    # none ("everything" saved); the train engine sets these three from
    # TrainEngineConfig
    remat: bool = True
    remat_policy: str = "nothing"
    attn_impl: str = "xla"  # "pallas": flash kernels; "xla": sdpa_plain

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


def _layer_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Per-layer parameter shapes in the port's layout ([out, in] matrices);
    names as in the JAX ``_layer_shapes`` (models/qwen.py:177)."""
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
        "w_gate": (Fd, D),
        "w_up": (Fd, D),
        "w_down": (D, Fd),
    }
    if cfg.attention_bias:
        shapes.update(bq=(Q,), bk=(KV,), bv=(KV,))
    if cfg.qk_norm:
        shapes.update(q_norm=(hd,), k_norm=(hd,))
    return shapes


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


class DecoderLayer(nn.Module):
    """One transformer block's parameters (dense SwiGLU FFN)."""

    def __init__(self, cfg: ModelConfig, device: torch.device, dtype: torch.dtype):
        super().__init__()
        for name, shape in _layer_shapes(cfg).items():
            setattr(self, name, _param(shape, device, dtype))


class QwenModel(nn.Module):
    """Parameters of the decoder: ``embed`` [V, D], ``layers``,
    ``final_norm`` [D] and, when embeddings are untied, ``lm_head`` [V, D].
    Parameters are allocated uninitialized on ``device`` (CUDA unless
    ``device="cpu"``); fill them with ``init_params`` or ``load_state_dict``."""

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

    @property
    def lm_head_weight(self) -> torch.Tensor:
        return self.embed if self.cfg.tie_word_embeddings else self.lm_head


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> QwenModel:
    """Random init (truncated-normal 0.02 in f32, cast to the model dtype;
    norms 1, biases 0) from a seeded ``torch.Generator`` that lives on the
    model's device (models/qwen.py:348)."""
    model = QwenModel(cfg, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("norm"):
                p.fill_(1.0)
            elif leaf in ("bq", "bk", "bv"):
                p.zero_()
            else:
                w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
                nn.init.trunc_normal_(w, std=0.02, a=-0.04, b=0.04, generator=generator)
                p.copy_(w)
    return model


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------


def _embed_lookup(embed: torch.Tensor, ids: torch.Tensor, dtype) -> torch.Tensor:
    """Row gather from the [V, D] table (one device: no vocab sharding)."""
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


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ W for a dense [out, in] weight (LoRA / int8 weights: later)."""
    return F.linear(x, w)


def _ffn(h: torch.Tensor, layer: DecoderLayer) -> torch.Tensor:
    return _proj(F.silu(_proj(h, layer.w_gate)) * _proj(h, layer.w_up), layer.w_down)


def _qkv(cfg: ModelConfig, layer: DecoderLayer, x: torch.Tensor, rope: tuple):
    """Attention inputs of one layer. x [A, P, D] -> q [A, P, H, hd],
    k/v [A, P, KH, hd] (post-norm, post-bias, post-rope; pre-GQA-repeat).
    ``rope`` is ``_rope_angles`` of the positions."""
    A, P, _ = x.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    h = _rms_norm(x, layer.input_norm, cfg.rms_norm_eps)
    q, k, v = _proj(h, layer.wq), _proj(h, layer.wk), _proj(h, layer.wv)
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
    torch.float32)`` (no second copy of the [V, D] table); the CPU has no
    such operator, so there both operands are up-cast to f32 explicitly."""
    w = model.lm_head_weight
    lead = hidden.shape[:-1]
    h = hidden.to(w.dtype).reshape(-1, w.shape[1])
    if w.dtype == torch.float32:
        out = h @ w.t()
    elif h.is_cuda:
        out = torch.mm(h, w.t(), out_dtype=torch.float32)
    else:
        out = h.float() @ w.float().t()
    return out.reshape(*lead, w.shape[0])


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


def _decoder_layer(cfg: ModelConfig, layer, x, mask, rope, impl: str, no_grad: bool):
    """One transformer block over x [G, L, D] (models/qwen.py:595). ``mask``
    is the segment ids for the flash kernels, the [G, 1, L, L] bool mask for
    ``sdpa_plain``."""
    G, L, _ = x.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q, k, v = _qkv(cfg, layer, x, rope)
    if KH != H:
        k = k.repeat_interleave(H // KH, dim=2)
        v = v.repeat_interleave(H // KH, dim=2)
    if impl == "pallas":
        attn_fn = flash_fwd if no_grad else flash_train
        attn = attn_fn(q, k, v, mask)
    else:
        attn = sdpa_plain(q, k, v, mask, hd)
    x = x + _proj(attn.reshape(G, L, H * hd), layer.wo)
    h = _rms_norm(x, layer.post_attn_norm, cfg.rms_norm_eps)
    return x + _ffn(h, layer)


def forward(
    model,  # QwenModel or ParamView
    input_ids: torch.Tensor,  # [G, L]
    segment_ids: torch.Tensor,  # [G, L] int32, 0 = padding
    positions: torch.Tensor,  # [G, L], restarting per segment
    no_grad: bool = False,
) -> torch.Tensor:
    """Decoder body -> final hidden states [G, L, D] (models/qwen.py:679).
    ``cfg.attn_impl`` picks the attention: "pallas" runs ``flash_train``
    (``flash_fwd`` when ``no_grad``), "xla" the plain masked softmax. With
    ``cfg.remat`` and policy "nothing" each layer runs under
    ``torch.utils.checkpoint`` while gradients are on."""
    cfg = model.cfg
    impl = resolve_impl(cfg.attn_impl)
    if cfg.remat and cfg.remat_policy not in ("nothing", "everything"):
        if cfg.remat_policy == "dots_nobatch":
            raise NotImplementedError("remat_policy='dots_nobatch': ROADMAP Queue A, trainer")
        raise ValueError(f"remat_policy={cfg.remat_policy!r}; valid: nothing, everything")
    x = _embed_lookup(model.embed, input_ids, cfg.torch_dtype)
    mask = segment_ids.to(torch.int32).contiguous() if impl == "pallas" else _attention_mask(segment_ids)
    rope = _rope_angles(positions, cfg.head_dim_, cfg.rope_theta)
    recompute = (
        cfg.remat and cfg.remat_policy == "nothing" and not no_grad and torch.is_grad_enabled()
    )
    for layer in model.layers:
        if recompute:
            x = checkpoint(
                _decoder_layer, cfg, layer, x, mask, rope, impl, no_grad, use_reentrant=False
            )
        else:
            x = _decoder_layer(cfg, layer, x, mask, rope, impl, no_grad)
    return _rms_norm(x, model.final_norm, cfg.rms_norm_eps)


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
    (models/qwen.py:762)."""
    G, L, D = hidden.shape
    w = model.lm_head_weight
    T = G * L
    flat_h = hidden.reshape(T, D).to(w.dtype)
    flat_y = labels.reshape(T)
    grad = torch.is_grad_enabled() and (flat_h.requires_grad or w.requires_grad)
    logps, ents = [], []
    for s in range(0, T, chunk_size):
        h, y = flat_h[s : s + chunk_size], flat_y[s : s + chunk_size]
        if grad:
            lp, ent = checkpoint(_logprob_entropy_chunk, h, y, w, temperature, use_reentrant=False)
        else:
            lp, ent = _logprob_entropy_chunk(h, y, w, temperature)
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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched prompt pass (models/qwen.py:887): returns (hidden [A, P, D],
    ks, vs) with ks/vs [n_layers, A, P, KH, hd] (post-rope, pre-GQA-repeat)
    for the cache fill. Attention is the plain masked einsum + softmax."""
    cfg = model.cfg
    if seg is None:
        seg = torch.ones_like(input_ids)
    x = _embed_lookup(model.embed, input_ids, cfg.torch_dtype)
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
        x = x + _proj(attn, layer.wo)
        h = _rms_norm(x, layer.post_attn_norm, cfg.rms_norm_eps)
        x = x + _ffn(h, layer)
    hidden = _rms_norm(x, model.final_norm, cfg.rms_norm_eps)
    return hidden, torch.stack(ks), torch.stack(vs)


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
    x = _embed_lookup(model.embed, ids, cfg.torch_dtype)  # [S, D]
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
        x = x + _proj(attn, layer.wo)
        h = _rms_norm(x, layer.post_attn_norm, cfg.rms_norm_eps)
        x = x + _ffn(h, layer)
    hidden = _rms_norm(x, model.final_norm, cfg.rms_norm_eps)
    return hidden, cache
