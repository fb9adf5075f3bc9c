"""Tensor parallelism over the mesh's ``model`` axis, on local shards.

The port's projections are plain ``[out, in]`` tensors read by free
functions (``models/qwen.py``), so the leaves a rank holds are its local
slices (``qwen.shard_model``) and the two Megatron conjugates carry the
arithmetic: ``copy_to_model`` at the input of a column-parallel product
(identity forward, all-reduce of the gradient backward) and
``reduce_from_model`` after a row-parallel one (all-reduce forward,
identity backward). The activations between them are replicated over
``model``; every rank computes the same loss from them, and the gradients
of the replicated leaves come out whole and equal on every rank.

The embedding and the LM head are vocab-parallel: ``embed_lookup`` takes
the rows of the rank's vocabulary block and sums the blocks, and
``logprob_entropy`` reduces the max, the sum of exponentials, the target
logit and the entropy's sum over the blocks in f32, so no rank holds the
[T, V] logits.

The attention and the flash kernels see plain local tensors: the rank's
heads.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class TPInfo:
    """This rank's place on the ``model`` axis: the group (None when the
    axis has size 1), the rank's index on it, the axis size, and the first
    vocabulary row of the rank's block."""

    group: object
    rank: int
    size: int
    vocab_start: int


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, tp: TPInfo | None) -> torch.Tensor:
    return x if tp is None or tp.size == 1 else _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: TPInfo | None) -> torch.Tensor:
    return x if tp is None or tp.size == 1 else _ReduceFromModel.apply(x, tp.group)


def embed_lookup(embed: torch.Tensor, ids: torch.Tensor, dtype, tp: TPInfo) -> torch.Tensor:
    """Rows of the vocab-parallel table: each rank takes the ids in its
    block (others read zeros) and the blocks sum over ``model`` in f32 —
    one rank's row and zeros, so the sum is the row itself."""
    v_local = embed.shape[0]
    local = ids.long() - tp.vocab_start
    mine = (local >= 0) & (local < v_local)
    rows = torch.nn.functional.embedding(local.clamp(0, v_local - 1), embed)
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return reduce_from_model(rows.float(), tp).to(dtype)


def logprob_entropy(h: torch.Tensor, y: torch.Tensor, w: torch.Tensor, temperature: float, tp: TPInfo):
    """log p(y) and the entropy of one chunk of tokens ``h`` [t, D] (already
    through ``copy_to_model``) against the rank's LM-head rows ``w`` [V/m,
    D]. The logits round to w's dtype, as the unsharded chunk's do; the
    reductions over the vocabulary run in f32 across the blocks."""
    logits = (h @ w.t()).float()
    if temperature != 1.0:
        logits = logits / temperature
    m = logits.detach().amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
    e = torch.exp(logits - m[:, None])
    lse = m + torch.log(reduce_from_model(e.sum(dim=-1), tp))
    v_local = w.shape[0]
    local = y.long() - tp.vocab_start
    mine = (local >= 0) & (local < v_local)
    picked = logits.gather(1, local.clamp(0, v_local - 1)[:, None])[:, 0]
    label_logit = reduce_from_model(torch.where(mine, picked, torch.zeros_like(picked)), tp)
    # the replicated lse enters a per-block sum that is summed over the
    # blocks: its gradient from each block must be summed too
    probs = torch.exp(logits - copy_to_model(lse, tp)[:, None])
    ent = lse - reduce_from_model((probs * logits).sum(dim=-1), tp)
    return label_logit - lse, ent
