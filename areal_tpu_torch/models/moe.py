"""Mixture-of-Experts FFN (qwen3_moe family) on one device — the port of
``areal_tpu/models/moe.py``.

Two dispatch strategies, picked by ``cfg.moe_dropless`` as in JAX:

- **dropless (default)**: every (token, k) assignment is sorted by expert id
  (stable) and run through three grouped matmuls (``ops/gmm.py``: the
  hand-written kernel in place of megablox ``gmm``), then each token sums
  its K expert outputs weighted by the router gates. One device holds every
  expert, so every row is local and computed (JAX's ``e0 = 0``, no
  ``psum``, no phantom row).
- **capacity**: the dense one-hot dispatch / combine einsums of JAX's
  ``_moe_ffn_capacity``; tokens past an expert's ``capacity_factor``
  buffer are dropped. Routing depends on the [G, L] layout.

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


def moe_ffn(h: torch.Tensor, layer, cfg, with_aux: bool = False):
    """MoE feed-forward of h [G, L, D] (post-attention-norm hidden states)
    -> (out [G, L, D], aux). ``aux`` is the switch-style load-balance loss
    E * sum_e(frac_e * mean_prob_e) (callers weight it with
    ``cfg.router_aux_coef``) when ``with_aux``, else None: the serving paths
    discard it, so they skip the work."""
    if cfg.moe_dropless:
        return moe_ffn_dropless(h, layer, cfg, with_aux)
    return _moe_ffn_capacity(h, layer, cfg, with_aux)


def _router(h32: torch.Tensor, w_router: torch.Tensor, K: int, norm_topk: bool):
    """f32 routing: -> (probs [T, E], top_p [T, K], top_e [T, K]). The
    router's product is a dot that ``remat_policy="dots_nobatch"`` saves."""
    probs = torch.softmax(saved_dot(torch.matmul, h32, w_router.float()), dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)
    if norm_topk:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_e


def _aux(probs: torch.Tensor, top_e: torch.Tensor, E: int) -> torch.Tensor:
    """Switch-transformer load balance: E * sum_e(routed fraction_e *
    mean probability_e), over every token of the call."""
    frac = F.one_hot(top_e.reshape(-1), E).float().mean(0)
    return (frac * probs.reshape(-1, E).mean(0)).sum() * E


def moe_ffn_dropless(h: torch.Tensor, layer, cfg, with_aux: bool = False):
    """Sort-based dropless dispatch (``moe.py:131``) on one device.

    Routing trace: when ``layer.moe_trace`` is a list, the call appends
    (top_e [T, K], gap [T]) as device tensors, the experts each token chose
    and the margin between its K-th and (K+1)-th router probability (how
    near a tie its route was). chip_smoke.py's serve_moe sets one list on
    every layer of its model and reads the experts a decode step touches
    and the route flips between two passes. Unset (the default) costs one
    attribute lookup per call."""
    G, L, D = h.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = G * L
    x = h.reshape(T, D)
    probs, top_p, top_e = _router(x.float(), layer.w_router, K, cfg.norm_topk_prob)
    trace = getattr(layer, "moe_trace", None)
    if trace is not None:
        p_k = torch.topk(probs, min(K + 1, E), dim=-1).values
        trace.append((top_e, p_k[:, K - 1] - p_k[:, -1]))
    ek = top_e.reshape(T * K)
    order = torch.argsort(ek, stable=True)  # (token, k) rows grouped by expert
    sizes = torch.zeros(E, dtype=torch.int32, device=h.device)
    sizes.scatter_add_(0, ek, torch.ones_like(ek, dtype=torch.int32))
    xs = x.index_select(0, order // K)  # [T*K, D]
    g1 = gmm(xs, layer.we_gate, sizes)
    u1 = gmm(xs, layer.we_up, sizes)
    y = (F.silu(g1) * u1).to(x.dtype)
    yd = gmm(y, layer.we_down, sizes)  # [T*K, D] f32, sorted
    # back to (token, k) order by the inverse permutation, then the gated sum
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(T * K, device=h.device))
    contrib = yd.index_select(0, inv).view(T, K, D) * top_p[:, :, None]
    out = contrib.sum(1).reshape(G, L, D).to(h.dtype)
    return out, (_aux(probs, top_e, E) if with_aux else None)


def _moe_ffn_capacity(h: torch.Tensor, layer, cfg, with_aux: bool = False):
    """Capacity-bounded dense dispatch (``moe.py:71``): one-hot dispatch and
    combine einsums; an assignment past its expert's C slots is dropped."""
    G, L, D = h.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    C = min(int(max(K, round(cfg.capacity_factor * K * L / E))), L)
    dt = h.dtype
    probs, top_p, top_e = _router(h.float().reshape(G * L, D), layer.w_router, K, cfg.norm_topk_prob)
    probs, top_p, top_e = probs.view(G, L, E), top_p.view(G, L, K), top_e.view(G, L, K)
    onehot = F.one_hot(top_e, E).float()  # [G, L, K, E]
    # each assignment's slot in its expert's buffer: earlier tokens' primary
    # choices win, in the flattened (L, K) order
    flat = onehot.reshape(G, L * K, E)
    pos = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(-1).reshape(G, L, K).to(torch.int32)
    gate = top_p * (pos < C)
    slot_oh = (pos[..., None] == torch.arange(C, device=h.device)).to(dt)  # [G, L, K, C]; none past C
    disp = torch.einsum("glke,glkc->glec", onehot.to(dt), slot_oh)
    comb = torch.einsum("glke,glkc,glk->glec", onehot.to(dt), slot_oh, gate.to(dt))
    xs = torch.einsum("glec,gld->gecd", disp, h)
    g1 = torch.einsum("gecd,edf->gecf", xs, layer.we_gate)
    u1 = torch.einsum("gecd,edf->gecf", xs, layer.we_up)
    y = torch.einsum("gecf,efd->gecd", F.silu(g1) * u1, layer.we_down)
    out = torch.einsum("glec,gecd->gld", comb, y).to(dt)
    return out, (_aux(probs, top_e, E) if with_aux else None)
