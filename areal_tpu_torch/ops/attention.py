"""Plain attention over packed [G, L] grids: the twin of
``areal_tpu/ops/attention.py:sdpa_xla``. Cold prefill uses it; it is the
masked einsum + softmax that the JAX package leaves to XLA, not a kernel.
"""

from __future__ import annotations

import torch


def sdpa_plain(q, k, v, mask, head_dim: int):
    """q, k, v: [G, L, H, hd] (KV heads already repeated); mask [G, 1, L, L]
    bool. Masked logits are -1e30 (not -inf), so fully masked rows average
    their window as the JAX twin does."""
    scale = head_dim**-0.5
    logits = torch.einsum("gqhd,gkhd->ghqk", q, k).float() * scale
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("ghqk,gkhd->gqhd", probs, v)
