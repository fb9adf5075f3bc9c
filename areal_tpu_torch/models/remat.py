"""``remat_policy="dots_nobatch"``: the port of JAX's
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
(``areal_tpu/models/qwen.py:720-730``) for a layer run under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False,
context_fn=context_fn)``.

JAX's policy saves the outputs of the ``dot_general`` calls that have no
batch dimensions and recomputes everything else; a Pallas or megablox
``custom_vjp`` is not a dot, so the flash and grouped-matmul kernels are
recomputed too. In the port those dots are the dense projections
(``qwen._proj``, ``F.linear``) and the MoE router's f32 product
(``moe._router``); below autograd they reach ``aten.mm`` (or ``aten.addmm``
when a bias is fused). Selective checkpointing decides per aten op, and an
``mm`` is not always such a dot: the plain versions of the kernels that a
CPU tensor takes multiply with ``mm`` too (``ops/gmm.py gmm_plain``). So
the call sites mark their product (``saved_dot``) and the policy saves an
``mm`` / ``addmm`` only inside a mark. The "xla" attention's batched
einsums (``aten.bmm``) and every kernel launch are recomputed.

One difference in mechanism: JAX saves a dot's output only when the
backward reads it, while torch caches every output the policy saves. The
dense FFN's down projection feeds only the residual add, whose backward
reads nothing, so JAX neither saves nor recomputes it; ``qwen._ffn`` leaves
it unmarked, and the recompute, which stops after the last tensor the
backward needs, never reaches it. The saved outputs of a layer are then
JAX's: q, k, v, o, gate and up of a dense layer; q, k, v, o and the router
logits of an MoE layer. A LoRA target adds its two adapter products,
x @ A and (x @ A) @ B, both dots without batch dimensions; on the down
projection only x @ A, which B's gradient reads.
"""

from __future__ import annotations

import threading

import torch
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

_aten = torch.ops.aten
# the ops an unbatched product reaches below autograd
SAVED_OPS = (_aten.mm.default, _aten.addmm.default)

_mark = threading.local()  # the backward's recompute runs on the autograd engine's thread


def saved_dot(fn, *args):
    """``fn(*args)``, its matmul marked as a dot whose output the policy
    saves."""
    _mark.on = True
    try:
        return fn(*args)
    finally:
        _mark.on = False


def policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op in SAVED_OPS and getattr(_mark, "on", False):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def context_fn():
    """The ``context_fn`` of ``torch.utils.checkpoint.checkpoint``."""
    return create_selective_checkpoint_contexts(policy)
