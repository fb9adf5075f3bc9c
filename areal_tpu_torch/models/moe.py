"""Mixture-of-Experts FFN (qwen3_moe family), on one device or over the
mesh's ``expert`` axis — the port of ``areal_tpu/models/moe.py``.

Two dispatch strategies, picked by ``cfg.moe_dropless`` as in JAX:

- **dropless (default)**: every (token, k) assignment is sorted by expert id
  (stable) and run through three grouped matmuls (``ops/gmm.py``: the
  hand-written kernel in place of megablox ``gmm``), then each token sums
  its K expert outputs weighted by the router gates.
- **capacity**: the dense one-hot dispatch / combine einsums of JAX's
  ``_moe_ffn_capacity``; tokens past an expert's ``capacity_factor``
  buffer are dropped. Routing depends on the [G, L] layout.

Expert parallelism (``layer.ep``, ``parallel/tensor_parallel.EPInfo``):
rank r of an ``expert`` axis of e holds the ``E_loc = E / e`` experts from
``e0 = r * E_loc`` (the leaves' first dim), and every rank holds the same
tokens (JAX's ``shard_map`` block over the expert axis). Each rank routes
every token in f32 from the replicated router; the dropless path sorts the
rows of its own experts first by local expert id and the others last, past
``sum(group_sizes)``, where the three kernels write zero rows (in the
forward, dLHS and tgmm alike), so they need no phantom row or mask; the
capacity path keeps its experts' columns of the dispatch / combine
tensors. Each rank's gated sum is a partial result, summed over the
``expert`` group in f32 (JAX's ``psum``). When ``model`` also splits the
experts' FFN columns (``layer.tp``, ``qwen.param_partition_specs``), gate /
up are column-parallel and down row-parallel: the partial sums over
``model`` go into the same f32 sum (the gate is a per-row scalar). The
gradient follows the Megatron conjugates of ``parallel/tensor_parallel.py``:
``copy_to`` at the expert input and at the gates, ``reduce_from`` at the
output, so the replicated router's gradient, and the aux loss's, come out
whole and equal on every rank and count once. The aux loss is JAX's: on
the dropless path each row block's (data x fsdp) mean over the blocks
(``pmean``), on the capacity path the whole grid's (GSPMD).

The rounding points are JAX's: the router runs in f32 (TF32 stays off), the
grouped matmuls return f32, ``silu(g1) * u1`` is computed in f32 and cast
to the activation dtype, the down projection stays f32 and is multiplied by
the f32 gates, the combine is f32, and the result is cast to ``h.dtype``
once.

The dropless dispatch never synchronizes the host with a card: the group
sizes come from a ``scatter_add_`` and the tokens are un-sorted by a gather
with the inverse permutation (``bincount``, boolean masks, ``nonzero`` and
``.item()`` would each wait for the device). The gather also keeps the
combine free of atomics, so the forward is deterministic and a checkpointed
recompute routes every token as the first pass did.

Training: both paths are differentiable. The dropless path's grouped
matmuls carry megablox's VJP (``ops/gmm.py`` ``GroupedMatmul``: the dLHS
and tgmm kernels); the router gates and the aux loss differentiate through
the f32 router, as in JAX. The backward of the token gather
(``index_select``) scatter-adds each token's K rows, which may use atomics;
the capacity path trains through autograd of its einsums, as JAX's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from areal_tpu_torch.models.remat import saved_dot
from areal_tpu_torch.ops.gmm import gmm
from areal_tpu_torch.parallel import tensor_parallel as tp_lib


def moe_ffn(h: torch.Tensor, layer, cfg, with_aux: bool = False):
    """MoE feed-forward of h [G, L, D] (post-attention-norm hidden states)
    -> (out [G, L, D], aux). ``aux`` is the switch-style load-balance loss
    E * sum_e(frac_e * mean_prob_e) (callers weight it with
    ``cfg.router_aux_coef``) when ``with_aux``, else None: the serving paths
    discard it, so they skip the work. The expert counts come from the
    leaves: E from the router's columns, a rank's E_loc from its expert
    stacks."""
    if cfg.moe_dropless:
        return moe_ffn_dropless(h, layer, cfg, with_aux)
    return _moe_ffn_capacity(h, layer, cfg, with_aux)


def _placement(layer) -> tuple:
    """(ep, groups, partial): the layer's ``EPInfo`` (None off a mesh), the
    groups over which its experts' partial results sum (``model`` above 1:
    the experts' FFN columns split there; ``expert`` above 1), and whether
    the result stays a partial one. A place with no group
    (``EPInfo(group=None, rank=r, size=e)``) leaves rank r's partial result
    unreduced and in f32, as the sum over ``expert`` would take it, for a
    caller that sums the ranks itself in one process and rounds once
    (chip_smoke.py's moe_ep)."""
    tp, ep = getattr(layer, "tp", None), getattr(layer, "ep", None)
    groups = tuple(i.group for i in (tp, ep) if i is not None and i.size > 1 and i.group is not None)
    return ep, groups, ep is not None and ep.size > 1 and ep.group is None


def _router(h32: torch.Tensor, w_router: torch.Tensor, K: int, norm_topk: bool):
    """f32 routing: -> (probs [T, E], top_p [T, K], top_e [T, K]). The
    router's product is a dot that ``remat_policy="dots_nobatch"`` saves."""
    probs = torch.softmax(saved_dot(torch.matmul, h32, w_router.float()), dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)
    if norm_topk:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_e


def _aux(probs: torch.Tensor, top_e: torch.Tensor, E: int, ep=None, whole_grid: bool = False) -> torch.Tensor:
    """Switch-transformer load balance: E * sum_e(routed fraction_e *
    mean probability_e), over every token of the call. On a trainer's mesh
    (``ep.dp_groups``) the rank's rows are one block of the grid: the
    dropless path averages the blocks' losses (JAX's ``pmean``), the
    capacity path averages the fractions and probabilities over the blocks
    first, the whole grid's loss (``whole_grid``)."""
    frac = F.one_hot(top_e.reshape(-1), E).float().mean(0)
    mean_prob = probs.reshape(-1, E).mean(0)
    if ep is None or not ep.dp_groups:
        return (frac * mean_prob).sum() * E
    if whole_grid:
        frac = tp_lib.mean_over(frac, ep.dp_groups, ep.dp_size)
        mean_prob = tp_lib.mean_over(mean_prob, ep.dp_groups, ep.dp_size)
        return (frac * mean_prob).sum() * E
    return tp_lib.mean_over((frac * mean_prob).sum() * E, ep.dp_groups, ep.dp_size)


def moe_ffn_dropless(h: torch.Tensor, layer, cfg, with_aux: bool = False):
    """Sort-based dropless dispatch (``moe.py:131``), the rank's experts'
    share of it on an ``expert`` axis (the module docstring).

    Routing trace: when ``layer.moe_trace`` is a list, the call appends
    (top_e [T, K], gap [T]) as device tensors, the experts each token chose
    and the margin between its K-th and (K+1)-th router probability (how
    near a tie its route was). chip_smoke.py's serve_moe sets one list on
    every layer of its model and reads the experts a decode step touches
    and the route flips between two passes. Unset (the default) costs one
    attribute lookup per call."""
    G, L, D = h.shape
    E, E_loc, K = layer.w_router.shape[-1], layer.we_gate.shape[0], cfg.num_experts_per_tok
    T = G * L
    ep, groups, partial = _placement(layer)
    x = h.reshape(T, D)
    probs, top_p, top_e = _router(x.float(), layer.w_router, K, cfg.norm_topk_prob)
    trace = getattr(layer, "moe_trace", None)
    if trace is not None:
        p_k = torch.topk(probs, min(K + 1, E), dim=-1).values
        trace.append((top_e, p_k[:, K - 1] - p_k[:, -1]))
    ek = top_e.reshape(T * K)
    if E_loc != E:  # the rank's experts by local id, the others last (key E_loc)
        ek = ek - ep.rank * E_loc
        ek = torch.where((ek >= 0) & (ek < E_loc), ek, E_loc)
    order = torch.argsort(ek, stable=True)  # (token, k) rows grouped by expert
    sizes = torch.zeros(E_loc + 1, dtype=torch.int32, device=h.device)
    sizes.scatter_add_(0, ek, torch.ones_like(ek, dtype=torch.int32))
    sizes = sizes[:E_loc]
    xs = tp_lib.copy_to(x, groups).index_select(0, order // K)  # [T*K, D]
    g1 = gmm(xs, layer.we_gate, sizes)
    u1 = gmm(xs, layer.we_up, sizes)
    y = (F.silu(g1) * u1).to(x.dtype)
    yd = gmm(y, layer.we_down, sizes)  # [T*K, D] f32, sorted; zero rows past the groups
    # back to (token, k) order by the inverse permutation, then the gated sum
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(T * K, device=h.device))
    contrib = yd.index_select(0, inv).view(T, K, D) * tp_lib.copy_to(top_p, groups)[:, :, None]
    out = tp_lib.reduce_from(contrib.sum(1), groups).reshape(G, L, D)
    return (out if partial else out.to(h.dtype)), (_aux(probs, top_e, E, ep) if with_aux else None)


def _moe_ffn_capacity(h: torch.Tensor, layer, cfg, with_aux: bool = False):
    """Capacity-bounded dense dispatch (``moe.py:71``): one-hot dispatch and
    combine einsums; an assignment past its expert's C slots is dropped. On
    an ``expert`` axis the rank keeps its experts' columns of the dispatch
    and combine tensors and the partial outputs sum in f32 (JAX shards the
    same buffers over ``expert`` by sharding constraints)."""
    G, L, D = h.shape
    E, E_loc, K = layer.w_router.shape[-1], layer.we_gate.shape[0], cfg.num_experts_per_tok
    C = min(int(max(K, round(cfg.capacity_factor * K * L / E))), L)
    dt = h.dtype
    ep, groups, partial = _placement(layer)
    probs, top_p, top_e = _router(h.float().reshape(G * L, D), layer.w_router, K, cfg.norm_topk_prob)
    probs, top_p, top_e = probs.view(G, L, E), top_p.view(G, L, K), top_e.view(G, L, K)
    onehot = F.one_hot(top_e, E).float()  # [G, L, K, E]
    # each assignment's slot in its expert's buffer: earlier tokens' primary
    # choices win, in the flattened (L, K) order
    flat = onehot.reshape(G, L * K, E)
    pos = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(-1).reshape(G, L, K).to(torch.int32)
    gate = tp_lib.copy_to(top_p, groups) * (pos < C)
    slot_oh = (pos[..., None] == torch.arange(C, device=h.device)).to(dt)  # [G, L, K, C]; none past C
    if E_loc != E:
        onehot_loc = onehot[..., ep.rank * E_loc : (ep.rank + 1) * E_loc]
    else:
        onehot_loc = onehot
    disp = torch.einsum("glke,glkc->glec", onehot_loc.to(dt), slot_oh)
    comb = torch.einsum("glke,glkc,glk->glec", onehot_loc.to(dt), slot_oh, gate.to(dt))
    xs = torch.einsum("glec,gld->gecd", disp, tp_lib.copy_to(h, groups))
    g1 = torch.einsum("gecd,edf->gecf", xs, layer.we_gate)
    u1 = torch.einsum("gecd,edf->gecf", xs, layer.we_up)
    y = torch.einsum("gecf,efd->gecd", F.silu(g1) * u1, layer.we_down)
    if groups or partial:  # each rank's share in f32, summed over the groups, one rounding
        out = tp_lib.reduce_from(torch.einsum("glec,gecd->gld", comb.float(), y.float()), groups)
        out = out if partial else out.to(dt)
    else:
        out = torch.einsum("glec,gecd->gld", comb, y).to(dt)
    return out, (_aux(probs, top_e, E, ep, whole_grid=True) if with_aux else None)
