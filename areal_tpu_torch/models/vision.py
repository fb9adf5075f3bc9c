"""The Qwen2-VL vision tower (``areal_tpu/models/vision.py``) in PyTorch.

Pixel patches arrive pre-extracted by the processor as a flat
``[N_patches, patch_dim]`` array (``patch_dim`` = channels x temporal x
patch^2, the Conv3d kernel flattened to a matmul), pass through pre-norm
transformer blocks (dense [N, N] attention) with Qwen2-VL's 2-D rotary
embedding (half the rotary dim turns with the patch's grid row, half with
its column), and a spatial merger MLP folds ``merge**2`` neighbouring
patches into one LLM-space embedding, which the decoder takes at its
``<|image_pad|>`` positions (``qwen.forward(..., image_embeds=)``).

``VisionTower`` keeps the JAX leaves one to one: the same names, the
per-layer leaves stacked on a leading [n_layers] axis, and the JAX
``[in, out]`` layout of every matrix (``x @ W + b``), so the bridge
(``models/convert.py``) copies them as they are.

The forward mirrors the JAX function step by step, including where bf16
rounds: ``_ln`` normalises in f32 and casts to the input dtype before the
affine; ``_rope_2d`` computes in f32 and casts at the end; the attention
logits are a product in the input dtype, then f32, scaled by hd^-0.5, with
padded patches masked to -1e30 (``mask[None, :] & mask[:, None]``); the
softmax is f32, cast back to v's dtype. Blocks use quick-GELU, the merger
exact GELU. The tower's attention is plain PyTorch, as the JAX tower's is
plain jnp (no Pallas kernel computes it).
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from areal_tpu_torch.utils.data import round_up_to_bucket


def pad_patch_bucket(p_raw: int, merge2: int, bucket: int = 256) -> int:
    """Padded per-image patch count: bucketed, and divisible by the
    spatial-merge group (``vision.py:41``). The one formula the serving
    engine and both trainer paths use, so their embeddings agree."""
    return -(-round_up_to_bucket(p_raw, bucket) // merge2) * merge2


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    patch_dim: int = 1176  # 3 ch * 2 temporal * 14 * 14 (Qwen2-VL)
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_layers: int = 32
    num_heads: int = 16
    out_hidden_size: int = 1536  # LLM hidden
    spatial_merge: int = 2  # merge^2 patches -> 1 LLM token
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def merge_dim(self) -> int:
        return self.hidden_size * self.spatial_merge**2


def _layer_shapes(cfg: VisionConfig) -> dict[str, tuple[int, ...]]:
    """The stacked per-layer leaves, [n_layers, ...] in JAX's layout."""
    n, D, F_ = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    return {
        "norm1": (n, D),
        "norm1_b": (n, D),
        "norm2": (n, D),
        "norm2_b": (n, D),
        "wqkv": (n, D, 3 * D),
        "bqkv": (n, 3 * D),
        "wo": (n, D, D),
        "bo": (n, D),
        "w_fc1": (n, D, F_),
        "b_fc1": (n, F_),
        "w_fc2": (n, F_, D),
        "b_fc2": (n, D),
    }


def _top_shapes(cfg: VisionConfig) -> dict[str, tuple[int, ...]]:
    D, M = cfg.hidden_size, cfg.merge_dim
    return {
        "patch_embed": (cfg.patch_dim, D),
        "merger_norm": (D,),
        "merger_norm_b": (D,),
        "merger_fc1": (M, M),
        "merger_b1": (M,),
        "merger_fc2": (M, cfg.out_hidden_size),
        "merger_b2": (cfg.out_hidden_size,),
    }


_MATRICES = ("patch_embed", "merger_fc1", "merger_fc2", "wqkv", "wo", "w_fc1", "w_fc2")


def _empty(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


class VisionLayers(nn.Module):
    """The blocks' parameters, each stacked over the layers."""

    def __init__(self, cfg: VisionConfig, device, dtype):
        super().__init__()
        for name, shape in _layer_shapes(cfg).items():
            setattr(self, name, _empty(shape, device, dtype))


class VisionTower(nn.Module):
    """Parameters of the tower (``patch_embed``, ``layers.<leaf>``,
    ``merger_*``), allocated uninitialized; fill them with
    ``init_vision_params`` or a load."""

    def __init__(self, cfg: VisionConfig, device, dtype):
        super().__init__()
        self.cfg = cfg
        for name, shape in _top_shapes(cfg).items():
            setattr(self, name, _empty(shape, device, dtype))
        self.layers = VisionLayers(cfg, device, dtype)


def init_vision_params(tower: VisionTower, generator: torch.Generator) -> None:
    """Random init in place (``vision.py:84``): every matrix from N(0, 0.02)
    truncated at 2 sigma, drawn in f32 and cast; norms 1, biases 0.
    ``generator`` lives on the tower's device."""
    with torch.no_grad():
        for name, p in tower.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("norm1", "norm2", "merger_norm"):
                p.fill_(1.0)
            elif leaf not in _MATRICES:
                p.zero_()
            else:
                w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
                nn.init.trunc_normal_(w, std=0.02, a=-0.04, b=0.04, generator=generator)
                p.copy_(w)


def vision_view(tower: VisionTower, dtype: torch.dtype) -> SimpleNamespace:
    """The tower's parameters cast to ``dtype`` (the compute dtype) with
    its attribute layout, for ``vision_forward``; the casts are
    differentiable, so gradients reach the master parameters (JAX's
    ``cparams["vision"]``)."""
    top = {n: p.to(dtype) for n, p in tower.named_parameters() if not n.startswith("layers.")}
    layers = SimpleNamespace(**{n: p.to(dtype) for n, p in tower.layers.named_parameters()})
    return SimpleNamespace(**top, layers=layers)


def grid_pos_ids(grid_thw, merge: int) -> np.ndarray:
    """Per-patch (row, col) grid positions for the 2-D rope
    (``vision.py:148``). ``grid_thw``: [n_images, 3] (t, h, w). The
    processor flattens patches merge-block-major, (h/m, w/m, m, m), so the
    positions come in that order. Returns [N_patches, 2] int32."""
    chunks = []
    for t, h, w in np.asarray(grid_thw, np.int64).reshape(-1, 3):
        hh = np.arange(h, dtype=np.int32)[:, None].repeat(w, 1)
        ww = np.arange(w, dtype=np.int32)[None, :].repeat(h, 0)

        def blk(a):
            return a.reshape(h // merge, merge, w // merge, merge).transpose(0, 2, 1, 3).reshape(-1)

        pos = np.stack([blk(hh), blk(ww)], axis=-1)  # [h*w, 2]
        chunks.append(np.tile(pos, (int(t), 1)))
    return np.concatenate(chunks, axis=0)


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm as JAX's ``_ln`` (``vision.py:168``): normalised in f32
    (mean and biased variance), cast to x's dtype, then ``* w + b``."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=eps).to(x.dtype) * w + b


def _rope_2d_angles(pos_ids: torch.Tensor, hd: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos / sin [..., N, 1, hd/2] in f32 of the positions [..., N, 2]
    (row, col): row angles for the first hd/4 frequencies, column angles
    for the next hd/4. They depend on the positions only, so a forward
    computes them once for all layers."""
    quarter = hd // 4
    inv = theta ** (-torch.arange(0, quarter, dtype=torch.float32, device=pos_ids.device) / quarter)
    ang = torch.cat([pos_ids[..., 0:1].float() * inv, pos_ids[..., 1:2].float() * inv], dim=-1)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def _rope_2d(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The vision rope of x [..., N, H, hd] (``vision.py:175``):
    rotate-half over hd/2 with ``_rope_2d_angles``, in f32, cast back to
    x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def vision_forward(
    tower,  # VisionTower or a view with its attribute layout (``vision_view``)
    cfg: VisionConfig,
    pixel_values: torch.Tensor,  # [..., N_patches, patch_dim] (N divisible by merge^2)
    patch_mask: torch.Tensor | None = None,  # [..., N] bool; False = padding
    pos_ids: torch.Tensor | None = None,  # [..., N, 2] grid (row, col)
) -> torch.Tensor:
    """-> [..., N / merge^2, out_hidden] image embeddings
    (``vision.py:196``). Leading dims are images, each under its own mask
    (JAX's vmap in ``vision_forward_batch``); one call launches the
    tower's kernels once for all of them."""
    lead, N = pixel_values.shape[:-2], pixel_values.shape[-2]
    D, H, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    if N % cfg.spatial_merge**2:
        raise ValueError(f"{N} patches do not divide into merge groups of {cfg.spatial_merge**2}")
    x = pixel_values.to(tower.patch_embed.dtype) @ tower.patch_embed
    if pos_ids is None:
        pos_ids = torch.zeros((*lead, N, 2), dtype=torch.int32, device=x.device)
    cos, sin = _rope_2d_angles(pos_ids, hd, cfg.rope_theta)
    # [..., 1, N, N]: both the query and the key patch valid
    attn_ok = None if patch_mask is None else (patch_mask[..., None, :] & patch_mask[..., :, None])[..., None, :, :]
    lw = tower.layers
    for i in range(cfg.num_layers):
        h = _ln(x, lw.norm1[i], lw.norm1_b[i], cfg.rms_norm_eps)
        q, k, v = (h @ lw.wqkv[i] + lw.bqkv[i]).chunk(3, dim=-1)
        q = _rope_2d(q.reshape(*lead, N, H, hd), cos, sin)
        k = _rope_2d(k.reshape(*lead, N, H, hd), cos, sin)
        v = v.reshape(*lead, N, H, hd)
        logits = torch.einsum("...qhd,...khd->...hqk", q, k).float() * hd**-0.5
        if attn_ok is not None:
            logits = torch.where(attn_ok, logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = torch.einsum("...hqk,...khd->...qhd", probs, v).reshape(*lead, N, D)
        x = x + attn @ lw.wo[i] + lw.bo[i]
        h = _ln(x, lw.norm2[i], lw.norm2_b[i], cfg.rms_norm_eps)
        h = _quick_gelu(h @ lw.w_fc1[i] + lw.b_fc1[i])
        x = x + h @ lw.w_fc2[i] + lw.b_fc2[i]
    x = _ln(x, tower.merger_norm, tower.merger_norm_b, cfg.rms_norm_eps)
    x = x.reshape(*lead, N // cfg.spatial_merge**2, cfg.merge_dim)
    x = F.gelu(x @ tower.merger_fc1 + tower.merger_b1, approximate="none")
    return x @ tower.merger_fc2 + tower.merger_b2


def vision_forward_batch(tower, cfg: VisionConfig, pixels: torch.Tensor, counts: torch.Tensor, pos_ids: torch.Tensor):
    """The masked tower over a batch (``vision.py:51``): pixels [B, Ppad,
    pd], counts [B] (valid patches of each row), pos_ids [B, Ppad, 2] ->
    [B, Ppad / merge^2, out_hidden], every row under its patch mask, in one
    ``vision_forward``. A row of count 0 (a text sequence, or a bucket's
    padding row) has every patch masked and no embedding reads it: it is
    left zero instead of computed."""
    B, Ppad, _ = pixels.shape
    rows = [b for b, c in enumerate(counts.tolist()) if c > 0]
    shape = (B, Ppad // cfg.spatial_merge**2, cfg.out_hidden_size)
    if not rows:
        return torch.zeros(shape, dtype=tower.merger_b2.dtype, device=pixels.device)
    idx = torch.tensor(rows, device=pixels.device)
    mask = torch.arange(Ppad, device=pixels.device)[None] < counts[idx][:, None]
    emb = vision_forward(tower, cfg, pixels[idx], mask, pos_ids[idx])
    if len(rows) == B:
        return emb
    return torch.zeros(shape, dtype=emb.dtype, device=emb.device).index_copy(0, idx, emb)


# tower leaf -> (HF suffix under visual.blocks.{i}., transpose)
_HF_VISION_LAYER_MAP = {
    "norm1": ("norm1.weight", False),
    "norm1_b": ("norm1.bias", False),
    "norm2": ("norm2.weight", False),
    "norm2_b": ("norm2.bias", False),
    "wqkv": ("attn.qkv.weight", True),
    "bqkv": ("attn.qkv.bias", False),
    "wo": ("attn.proj.weight", True),
    "bo": ("attn.proj.bias", False),
    "w_fc1": ("mlp.fc1.weight", True),
    "b_fc1": ("mlp.fc1.bias", False),
    "w_fc2": ("mlp.fc2.weight", True),
    "b_fc2": ("mlp.fc2.bias", False),
}


def hf_vision_name_map(cfg: VisionConfig) -> dict[str, tuple[str, bool]]:
    """Flat map: tower path -> (HF name, transpose), as ``vision.py:262``
    (``layers/<i>/<leaf>`` for a slice of a stacked leaf). The Conv3d
    ``patch_embed`` kernel [D, C, T, p, p] is flattened to [D, patch_dim]
    and transposed by the loader."""
    out: dict[str, tuple[str, bool]] = {
        "patch_embed": ("visual.patch_embed.proj.weight", True),
        "merger_norm": ("visual.merger.ln_q.weight", False),
        "merger_norm_b": ("visual.merger.ln_q.bias", False),
        "merger_fc1": ("visual.merger.mlp.0.weight", True),
        "merger_b1": ("visual.merger.mlp.0.bias", False),
        "merger_fc2": ("visual.merger.mlp.2.weight", True),
        "merger_b2": ("visual.merger.mlp.2.bias", False),
    }
    for name, (suffix, transpose) in _HF_VISION_LAYER_MAP.items():
        for i in range(cfg.num_layers):
            out[f"layers/{i}/{name}"] = (f"visual.blocks.{i}.{suffix}", transpose)
    return out
