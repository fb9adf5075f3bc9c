"""``remat_policy="dots_nobatch"`` (``models/remat.py``) against the JAX
package's ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` on
the CPU: the gradients under the three policies and JAX's, which ops the
backward recomputes (a dispatch-mode count), and which dot outputs a layer
saves, against ``jax.ad_checkpoint.print_saved_residuals`` of the JAX
``_decoder_layer``; for a dense layer and an MoE layer."""

import collections
import contextlib
import dataclasses
import io
import re

import jax
import jax.ad_checkpoint
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from areal_tpu.models import qwen as jq
from areal_tpu_torch.models import convert, remat
from areal_tpu_torch.models import qwen as tq
from areal_tpu_torch.ops import attention as tattn
from areal_tpu_torch.ops import gmm as tgmm

from test_torch_moe import MOE_CFG
from test_torch_qwen import jax_params, port_cfg, port_model
from tpu_testing import TINY_QWEN2

POLICIES = ("nothing", "dots_nobatch", "everything")
# f32 gradients against JAX's: each element within this share of its leaf's
# largest entry (the same arithmetic summed in other orders; measured at
# most 9.4e-7, the margin for other CPUs' summation orders)
GRAD_REL = 2e-6
_aten = torch.ops.aten


def _grid(G: int = 2, L: int = 64, seed: int = 3):
    """Two segments a row and a padded tail."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (G, L)).astype(np.int32)
    seg = np.zeros((G, L), np.int32)
    pos = np.zeros((G, L), np.int32)
    for g, cuts in enumerate(((0, 23, 50), (0, 37, 64))[:G]):
        for s, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
            seg[g, a:b] = s + 1
            pos[g, a:b] = np.arange(b - a)
    return ids, seg, pos


class _OpCount(TorchDispatchMode):
    """Counts the aten ops that run below autograd while it is on."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))

    def dots(self) -> int:
        return self.ops[_aten.mm.default] + self.ops[_aten.addmm.default]


def _probe(jcfg, seed: int = 5) -> np.ndarray:
    """A random projection of the hidden states, zero on padding (whose
    hidden states differ between attention paths)."""
    _, seg, _ = _grid()
    p = np.random.default_rng(seed).standard_normal((*seg.shape, jcfg.hidden_size)).astype(np.float32)
    return 0.1 * p * (seg > 0)[..., None]


def _port_backward(jcfg, params, policy: str, impl: str, probe: np.ndarray):
    """The port's hidden-state loss under ``policy``: -> (loss, grads by JAX
    leaf path, the backward's op counts)."""
    cfg = port_cfg(jcfg, remat=True, remat_policy=policy, attn_impl=impl)
    model = port_model(jcfg, params)
    model.cfg = cfg
    model.requires_grad_(True)
    ids, seg, pos = _grid()
    hidden = tq.forward(tq.ParamView(model, cfg), *map(torch.from_numpy, (ids, seg, pos)))
    loss = (hidden.float() * torch.from_numpy(probe)).sum()
    count = _OpCount()
    with count:
        loss.backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in model.named_parameters()}
    flat = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(convert.to_jax_params(grads, cfg))}
    return float(loss), flat, count


def _jax_grads(jcfg, params, policy: str, probe: np.ndarray):
    cfg = dataclasses.replace(jcfg, remat=True, remat_policy=policy, attn_impl="xla")
    ids, seg, pos = map(jnp.asarray, _grid())

    def loss(p):
        return (jq.forward(p, cfg, ids, seg, pos).astype(jnp.float32) * probe).sum()

    val, grads = jax.value_and_grad(loss)(jax.tree.map(jnp.asarray, params))
    return float(val), {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(grads)}


def _moe_cfg():
    return dataclasses.replace(MOE_CFG, dtype="float32")


CONFIGS = {"dense": TINY_QWEN2, "moe": None}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("model", ["dense", "moe"])
def test_gradients_equal_across_policies_and_jax(model, impl):
    """The three policies give the port the same gradients bit for bit, and
    JAX's under "dots_nobatch" within ``GRAD_REL`` ("pallas": the plain
    K2-K4 on the CPU; JAX's attention off a TPU is its XLA path)."""
    jcfg = CONFIGS[model] or _moe_cfg()
    params = jax_params(jcfg, seed=4)
    probe = _probe(jcfg)
    got = {p: _port_backward(jcfg, params, p, impl, probe) for p in POLICIES}
    jl, jgrads = _jax_grads(jcfg, params, "dots_nobatch", probe)
    _, base, _ = got["nothing"]
    for policy in ("dots_nobatch", "everything"):
        loss, grads, _ = got[policy]
        assert loss == got["nothing"][0]
        for key in base:
            assert np.array_equal(grads[key], base[key]), (policy, key)
    loss, grads, _ = got["dots_nobatch"]
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    assert grads.keys() == jgrads.keys()
    for key, want in jgrads.items():
        scale = np.abs(want).max()
        assert scale > 0 or "lm_head" in key, key
        np.testing.assert_allclose(grads[key], want, atol=GRAD_REL * scale, rtol=0, err_msg=key)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_dots_nobatch_recomputes_no_projection(impl, monkeypatch):
    """A dispatch-mode count of the backward: under "dots_nobatch" it runs
    the same ``mm`` / ``addmm`` as "everything" (the gradients' own), so it
    recomputes no projection, where "nothing" recomputes the six whose
    outputs the backward reads in every layer (the down projection's is
    read by none, and no policy recomputes it); the attention (the "xla"
    batched einsums, or K2 counted through its plain forward) runs again
    under both recomputing policies."""
    calls = collections.Counter()
    fwd = tattn.flash_attention_fwd

    def counted(*a, **k):
        calls["k2"] += 1
        return fwd(*a, **k)

    monkeypatch.setattr(tattn, "flash_attention_fwd", counted)
    jcfg = TINY_QWEN2
    params = jax_params(jcfg, seed=4)
    probe = _probe(jcfg)
    counts, k2 = {}, {}
    for p in POLICIES:
        calls.clear()
        counts[p] = _port_backward(jcfg, params, p, impl, probe)[2]
        k2[p] = calls["k2"]
    n_layers = jcfg.num_layers
    assert counts["nothing"].dots() - counts["everything"].dots() == 6 * n_layers
    assert counts["dots_nobatch"].dots() == counts["everything"].dots()
    if impl == "xla":
        bmm = {p: c.ops[_aten.bmm.default] for p, c in counts.items()}
        assert bmm["dots_nobatch"] == bmm["nothing"] > bmm["everything"]
    else:
        # the forward's launch is counted here too: one a layer, then one a
        # layer again in a recomputing backward
        assert k2 == {"nothing": 2 * n_layers, "dots_nobatch": 2 * n_layers, "everything": n_layers}


def test_linear_reaches_mm_or_addmm():
    """What ``F.linear`` of a 3-D input reaches below autograd on the
    installed torch, with and without a bias: one of the ops the policy
    saves, once (``_proj`` passes no bias)."""
    x = torch.randn(2, 5, 8, requires_grad=True)
    w, b = torch.randn(4, 8), torch.randn(4)
    for bias in (None, b):
        count = _OpCount()
        with count:
            F.linear(x, w, bias)
        assert count.dots() == 1, dict(count.ops)
        assert set(count.ops) & set(remat.SAVED_OPS)


def _saved_by_port(jcfg, monkeypatch) -> list[tuple[int, int]]:
    """The (rows, columns) of the outputs the policy marks MUST_SAVE in one
    layer's forward."""
    saved = []
    real = remat.policy

    def recording(ctx, op, *args, **kwargs):
        out = real(ctx, op, *args, **kwargs)
        if out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            a, b = args[-2], args[-1]
            saved.append((a.shape[0], b.shape[1]))
        return out

    monkeypatch.setattr(remat, "policy", recording)
    one = dataclasses.replace(jcfg, num_layers=1)
    params = jax_params(one, seed=4)
    probe = _probe(one)
    _port_backward(one, params, "dots_nobatch", "xla", probe)
    return sorted(saved)


def _saved_by_jax(jcfg) -> list[tuple[int, int]]:
    """The computed residuals (not arguments, not constants) of one JAX
    ``_decoder_layer`` under ``dots_with_no_batch_dims_saveable``, as
    (rows, last dim)."""
    cfg = dataclasses.replace(jcfg, num_layers=1, attn_impl="xla")
    params = jax.tree.map(jnp.asarray, jax_params(cfg, seed=4))
    layer = jax.tree.map(lambda a: a[0], params["layers"])
    ids, seg, pos = map(jnp.asarray, _grid())
    x = jq._embed_lookup(params["embed"], ids, cfg.jax_dtype)
    mask = jq._attention_mask(seg)

    def f(x, layer):
        out, aux = jq._decoder_layer(cfg, x, layer, mask, pos, impl="xla")
        return out.sum() + aux

    f = jax.checkpoint(f, policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax.ad_checkpoint.print_saved_residuals(f, x, layer)
    saved = []
    for line in out.getvalue().splitlines():  # "f32[2,64,64] output of ... (_proj)"
        m = re.match(r"\w+\[([\d,]*)\] (.*)", line)
        if m and "argument" not in m.group(2) and "constant" not in m.group(2):
            shape = [int(d) for d in m.group(1).split(",")]
            saved.append((int(np.prod(shape[:-1])), shape[-1]))
    return sorted(saved)


@pytest.mark.parametrize("model", ["dense", "moe"])
def test_saved_dots_match_jax(model, monkeypatch):
    """The outputs a layer saves under "dots_nobatch", with their shapes,
    are JAX's saved residuals: q, k, v, o, gate and up of a dense layer
    (JAX lists gate's through silu); q, k, v, o and the router's logits of
    an MoE layer (the grouped matmuls recomputed)."""
    jcfg = CONFIGS[model] or _moe_cfg()
    got = _saved_by_port(jcfg, monkeypatch)
    want = _saved_by_jax(jcfg)
    T, D = 2 * 64, jcfg.hidden_size
    if model == "dense":
        assert len(got) == 6 and (T, jcfg.intermediate_size) in got
    else:
        assert len(got) == 5 and (T, jcfg.num_experts) in got
    assert (T, D) in got
    assert got == want


def test_moe_grouped_matmuls_recomputed(monkeypatch):
    """The grouped matmul's forward runs 3 times a layer (gate, up, down) in
    the forward, and 3 more in the backward under "dots_nobatch", as under
    "nothing"; "everything" does not run it again."""
    calls = collections.Counter()
    real = tgmm._gmm_forward

    def counted(*a, **k):
        calls["gmm"] += 1
        return real(*a, **k)

    monkeypatch.setattr(tgmm, "_gmm_forward", counted)
    jcfg = dataclasses.replace(_moe_cfg(), num_layers=1)
    params = jax_params(jcfg, seed=4)
    probe = _probe(jcfg)
    seen = {}
    for p in POLICIES:
        calls.clear()
        _port_backward(jcfg, params, p, "xla", probe)
        seen[p] = calls["gmm"]
    assert seen == {"nothing": 6, "dots_nobatch": 6, "everything": 3}
