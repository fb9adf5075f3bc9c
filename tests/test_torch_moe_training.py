"""MoE training in the port against the JAX package on the CPU, on the tiny
qwen3_moe config of ``test_torch_moe.py`` (8 experts, top-2, qk-norm, no
bias, untied head, H * hd = 64 != D = 32):

- the gradient of ``qwen.forward(..., with_aux=True)`` under the loss
  ``__graft_entry__.py:389-395`` takes (mean of hidden^2 + 0.01 aux), on the
  dropless and the capacity dispatch, f32 and bf16, against
  ``jax.value_and_grad`` (megablox in interpret mode on the JAX side, the
  plain backward of ``GroupedMatmul`` on the port's);
- ``TorchTrainEngine.train_batch`` against a one-device ``JaxTrainEngine``,
  packed and tree, with a loss that adds ``0.01 * outputs["moe_aux"]`` as
  ``tests/test_moe.py:153`` does: losses, aux, grad norm and the weights;
- MoE ``forest_hidden`` against JAX's;
- a weight update whose last leaf is bad changes nothing in a running
  ``DecodeEngine``: not a weight, not the version, not the radix cache, not
  the greedy tokens.

Inputs are made with numpy from a seed and handed to both sides."""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.config import MeshConfig as JMeshConfig
from areal_tpu.api.config import NormConfig as JNormConfig
from areal_tpu.api.config import OptimizerConfig as JOptimizerConfig
from areal_tpu.api.config import PPOActorConfig as JPPOActorConfig
from areal_tpu.api.io_struct import FinetuneSpec as JFinetuneSpec
from areal_tpu.engine import train_engine as jte
from areal_tpu.models import qwen as jq
from areal_tpu.ops import tree_attention as jta
from areal_tpu.parallel import mesh as mesh_lib
from areal_tpu.trainer import ppo as jppo
from areal_tpu.utils import data as jdata
from areal_tpu_torch.api.config import NormConfig, OptimizerConfig, PPOActorConfig, ServerConfig
from areal_tpu_torch.api.io_struct import FinetuneSpec, GenerationHyperparameters, ModelRequest
from areal_tpu_torch.engine import train_engine as tte
from areal_tpu_torch.inference.decode_engine import DecodeEngine
from areal_tpu_torch.models import convert
from areal_tpu_torch.models import qwen as tq
from areal_tpu_torch.ops import tree_attention as tta
from areal_tpu_torch.trainer import ppo as tppo

from test_torch_moe import MOE_CFG
from test_torch_qwen import jax_params, port_cfg, port_model
from test_torch_train_engine import _trajs
from test_torch_tree_training import _grpo_trajs

AUX_COEF = 0.01
LR = 1e-3
# f32: the same arithmetic summed in other orders (routing identical): the
# loss to 1e-5 relative, each gradient leaf to 1e-5 of its largest entry
# (measured: ~8e-7)
F32_LOSS_RTOL = 1e-5
F32_GRAD_REL = 1e-5
# bf16 weights and activations: both sides round at the same points, but
# f32 sums in other orders straddle bf16 rounding boundaries, and those
# one-step differences (2^-8 relative) travel through two layers forward and
# back (measured: up to 2^-5.7 of a leaf's largest entry, the loss 2e-4
# relative); each gradient leaf to 2^-5 of its largest entry, the loss to
# 2^-10
BF16_LOSS_RTOL = 2**-10
BF16_GRAD_REL = 2**-5
# engine stats and losses: sums over every parameter, f32 (the dense twins')
STAT_RTOL = 2e-4


def _cfg(dropless: bool, dtype: str = "float32", **kw):
    return dataclasses.replace(MOE_CFG, moe_dropless=dropless, dtype=dtype, capacity_factor=1.0, **kw)


def _grid(seed, G=2, L=24):
    """Token ids with two segments per row and a padded tail."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, MOE_CFG.vocab_size, (G, L)).astype(np.int32)
    seg = np.zeros((G, L), np.int32)
    pos = np.zeros((G, L), np.int32)
    for g, cuts in enumerate(((0, 9, 20), (0, 14, 24))):
        for s, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
            seg[g, a:b] = s + 1
            pos[g, a:b] = np.arange(b - a)
    return ids, seg, pos


def _leaf_items(tree):
    return {jax.tree_util.keystr(k): np.asarray(jnp.asarray(v).astype(jnp.float32))
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropless", [True, False], ids=["dropless", "capacity"])
def test_forward_gradient_matches_jax(dropless, dtype):
    jcfg = _cfg(dropless, dtype)
    params = jax_params(jcfg, seed=7)
    ids, seg, pos = _grid(8)
    valid = seg > 0

    def jloss(p):
        hidden, aux = jq.forward(p, jcfg, *map(jnp.asarray, (ids, seg, pos)), with_aux=True)
        h = jnp.where(jnp.asarray(valid)[..., None], hidden.astype(jnp.float32), 0.0)
        return (h**2).mean() + AUX_COEF * aux, aux

    (jl, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(jax.tree.map(jnp.asarray, params))

    model = port_model(jcfg, params)
    model.requires_grad_(True)
    hidden, aux = tq.forward(model, *map(torch.from_numpy, (ids, seg, pos)), with_aux=True)
    h = torch.where(torch.from_numpy(valid)[..., None], hidden.float(), 0.0)
    loss = (h**2).mean() + AUX_COEF * aux
    loss.backward()
    assert aux.dtype == torch.float32 and aux.requires_grad and aux.item() > 0
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5 if dtype == "float32" else 1e-3)
    rtol, grad_rel = (F32_LOSS_RTOL, F32_GRAD_REL) if dtype == "float32" else (BF16_LOSS_RTOL, BF16_GRAD_REL)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=rtol)
    assert model.lm_head.grad is None  # the loss reads the hidden states, not the head
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in model.named_parameters()}
    got = _leaf_items(convert.to_jax_params(grads, port_cfg(jcfg)))
    want = _leaf_items(jgrads)
    assert got.keys() == want.keys()
    for key, w in want.items():
        scale = np.abs(w).max()
        if "lm_head" in key:
            assert scale == 0
            continue
        assert scale > 0, key  # every other leaf gets a gradient: the router through the gates and the aux
        assert np.abs(got[key] - w).max() <= grad_rel * scale, (key, np.abs(got[key] - w).max() / scale)


def test_aux_gradient_reaches_the_router():
    """With the hidden-state term off, only the aux loss has a gradient: it
    reaches the router (and, through it, the layers below), not the experts."""
    jcfg = _cfg(True)
    model = port_model(jcfg, jax_params(jcfg, seed=9))
    model.requires_grad_(True)
    ids, seg, pos = _grid(10)
    _, aux = tq.forward(model, *map(torch.from_numpy, (ids, seg, pos)), with_aux=True)
    aux.backward()
    last = model.layers[-1]
    assert last.w_router.grad.abs().max() > 0
    assert last.we_gate.grad is None or last.we_gate.grad.abs().max() == 0
    _, zero = tq.forward(port_model(dataclasses.replace(jcfg, num_experts=0), jax_params(
        dataclasses.replace(jcfg, num_experts=0), seed=9)), *map(torch.from_numpy, (ids, seg, pos)), with_aux=True)
    assert zero.item() == 0.0  # a dense model's aux is 0, as in JAX


# ---------------------------------------------------------------------------
# TorchTrainEngine against a one-device JaxTrainEngine, MoE model
# ---------------------------------------------------------------------------

COMMON = dict(
    dtype="float32",
    param_dtype="float32",
    bucket_step=32,
    logprob_chunk_size=48,
    group_size=4,
    ppo_n_minibatches=1,
    use_decoupled_loss=True,
    prox_logp_mode="recompute",
)


def _engines(seed=0, **kw):
    jcfg = JPPOActorConfig(
        init_from_scratch=True,
        mesh=JMeshConfig(data=1),
        optimizer=JOptimizerConfig(lr=LR),
        adv_norm=JNormConfig(mean_level="group", std_level="batch", group_size=4),
        **{**COMMON, **kw},
    )
    jeng = jte.JaxTrainEngine(jcfg, model_config=MOE_CFG)
    jeng.initialize(JFinetuneSpec(1, 128, 16), mesh=mesh_lib.make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    params = jax_params(MOE_CFG, seed=seed)
    jeng.params = jax.tree.map(lambda old, new: jax.device_put(jnp.asarray(new), old.sharding), jeng.params, params)
    tcfg = PPOActorConfig(
        optimizer=OptimizerConfig(lr=LR),
        adv_norm=NormConfig(mean_level="group", std_level="batch", group_size=4),
        **{**COMMON, **kw},
    )
    teng = tte.TorchTrainEngine(tcfg, model_config=port_cfg(MOE_CFG), device="cpu")
    teng.initialize(FinetuneSpec(1, 128, 16))
    teng.model.load_state_dict(convert.from_jax_params(params, port_cfg(MOE_CFG)))
    return jcfg, jeng, tcfg, teng


def _wfn(d):
    return float((np.asarray(d["loss_mask"]) > 0).sum())


def _with_aux(loss_fn, cfg, coef=AUX_COEF):
    """The caller's loss: the PPO loss plus router_aux_coef * moe_aux."""

    def fn(outputs, b):
        loss, stats = loss_fn(outputs, b, cfg)
        return loss + coef * outputs["moe_aux"], {**stats, "moe_aux": outputs["moe_aux"]}

    return fn


# The packed grid's aux counts its padding tokens too, as JAX's does, and a
# padding row's hidden state is whatever its attention gives: JAX off a TPU
# (and the port's "xla" path) averages the row's window, the port's flash
# path ("pallas") zeroes the row, JAX's TPU flash kernel attends the padding
# segment. So the port's "pallas" aux matches JAX's to the padding tokens'
# share (here ~4% of the grid's tokens moved the aux by 0.4%): 2e-2; and its
# loss leaves the aux out, so the gradient holds the tight tolerance.
PAD_AUX_RTOL = 2e-2


@pytest.mark.parametrize("path", ["packed-xla", "packed-pallas", "tree"])
def test_train_batch_matches_jax(path):
    """Two optimizer steps (LR 0, then LR): loss, moe_aux, grad norm and
    stats of each, then every master weight, router and experts included."""
    tree = path == "tree"
    impl = "pallas" if path == "packed-pallas" else "xla"
    jcfg, jeng, tcfg, teng = _engines(seed=3, tree_training=tree, attn_impl=impl)
    trajs = _grpo_trajs(3, seed=4, vocab=MOE_CFG.vocab_size) if tree else _trajs(8, seed=4, vocab=MOE_CFG.vocab_size)
    batch = jdata.pad_sequences_to_tensors(trajs)
    batch["prox_logp"] = jeng.forward_batch(batch)
    np.testing.assert_allclose(teng.forward_batch(batch), batch["prox_logp"], atol=5e-5, rtol=5e-5)
    adv = jppo.PPOActor(jcfg, SimpleNamespace(get_version=lambda: 0)).compute_advantages(batch)
    init = convert.to_jax_params(teng.model.state_dict(), port_cfg(MOE_CFG))
    coef = 0.0 if impl == "pallas" else AUX_COEF
    for step in range(2):
        want = jeng.train_batch(adv, _with_aux(jppo.grpo_loss_fn, jcfg, coef), _wfn)
        got = teng.train_batch(adv, _with_aux(tppo.grpo_loss_fn, tcfg, coef), _wfn)
        assert got["n_microbatches"] == want["n_microbatches"]
        if tree:
            assert got["tree_nodes"] == want["tree_nodes"] < got["tree_tokens"]
        assert got["moe_aux"] > 0
        np.testing.assert_allclose(got["moe_aux"], want["moe_aux"], rtol=PAD_AUX_RTOL if impl == "pallas" else STAT_RTOL)
        for k in ("loss", "grad_norm", "actor_loss", "importance_weight", "entropy", "n_valid_tokens"):
            np.testing.assert_allclose(got[k], want[k], rtol=STAT_RTOL, atol=1e-6, err_msg=f"step {step}: {k}")
    # Adam's update is sign-like where gradients are tiny: f32 noise there can
    # move a weight by up to ~lr; everywhere else the weights agree to f32 noise
    flat_g = dict(jax.tree_util.tree_leaves_with_path(convert.to_jax_params(teng.model.state_dict(), port_cfg(MOE_CFG))))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jeng.params)))
    flat_0 = dict(jax.tree_util.tree_leaves_with_path(init))
    for key in flat_j:
        diff = np.abs(flat_g[key] - flat_j[key])
        assert diff.max() <= 2 * LR, (key, diff.max())
        assert np.mean(diff <= 1e-6) > 0.99, (key, np.mean(diff <= 1e-6))
        assert np.abs(flat_j[key] - flat_0[key]).max() > LR / 2, key  # the second step moved it


def test_forest_hidden_moe_matches_jax():
    """MoE ``forest_hidden`` (every layer's FFN routes all n_pad nodes,
    padding included) and its summed aux against JAX's, with JAX's tree
    kernel in interpret mode."""
    jcfg = _cfg(True)
    params = jax_params(jcfg, seed=11)
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, jcfg.vocab_size, 40).tolist()
    seqs = [prompt + rng.integers(0, jcfg.vocab_size, int(rng.integers(5, 30))).tolist() for _ in range(4)]
    from areal_tpu.models import tree as jtree

    pack = jtree.build_tree(seqs)
    n_pad = -(-pack.n_nodes // jta.BLOCK) * jta.BLOCK
    words, block_any = jta.pack_ancestor_bits(pack.parent, n_pad)
    ids = np.zeros(n_pad, np.int32)
    ids[: pack.n_nodes] = pack.tokens
    pos = np.zeros(n_pad, np.int32)
    pos[: pack.n_nodes] = pack.depth
    want, want_aux = jta.forest_hidden(jax.tree.map(jnp.asarray, params), jcfg,
                                      *map(jnp.asarray, (ids, pos, words, block_any)), remat=False, with_aux=True)
    model = port_model(dataclasses.replace(jcfg, remat=False), params)
    with torch.no_grad():
        args = map(torch.from_numpy, (ids.astype(np.int64), pos.astype(np.int64), words.view(np.int32), block_any))
        got, got_aux = tta.forest_hidden(model, *args, with_aux=True)
    n = pack.n_nodes
    np.testing.assert_allclose(got.numpy()[:n], np.asarray(want)[:n], atol=1e-4)
    np.testing.assert_allclose(got_aux.item(), float(want_aux), rtol=1e-5)


# ---------------------------------------------------------------------------
# the weight-update repair: all or nothing
# ---------------------------------------------------------------------------


def _greedy(engine, prompts, n_new=8):
    return [
        engine.generate_sync(
            ModelRequest(input_ids=p, gconfig=GenerationHyperparameters(max_new_tokens=n_new, greedy=True)),
            timeout=300,
        ).output_tokens
        for p in prompts
    ]


@pytest.mark.parametrize("fault", ["shape", "dtype", "not-an-array"])
def test_bad_last_leaf_changes_nothing(fault):
    """A payload whose last leaf fails a check raises from
    ``update_weights_from_params`` and leaves every weight, the version, the
    radix cache and the greedy tokens as they were."""
    cfg = port_cfg(MOE_CFG)
    model = port_model(MOE_CFG, jax_params(MOE_CFG, seed=13))
    eng = DecodeEngine(ServerConfig(max_batch_size=4, max_seq_len=128, page_size=8, decode_steps_per_call=4, seed=0),
                       params=model, device="cpu")
    eng.start()
    try:
        rng = np.random.default_rng(14)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (9, 20)]
        before = _greedy(eng, prompts)
        held = eng.prefix_cache_stats()["pages_held"]
        assert held > 0
        snap = {n: p.detach().clone() for n, p in eng.model.named_parameters()}
        new = {n: v + 0.01 for n, v in convert.from_jax_params(jax_params(MOE_CFG, seed=15), cfg).items()}
        last = list(new)[-1]
        good = new[last]
        if fault == "shape":
            new[last] = torch.zeros((new[last].shape[0] + 1, *new[last].shape[1:]))
        elif fault == "dtype":
            new[last] = new[last].to(torch.complex64)
        else:
            new[last] = np.array(["not", "a", "weight"], dtype=object)
        with pytest.raises((ValueError, TypeError)):
            eng.update_weights_from_params(new, version=1)
        assert eng.get_version() == 0
        assert eng.prefix_cache_stats()["pages_held"] == held
        for n, p in eng.model.named_parameters():
            assert torch.equal(p, snap[n]), n
        assert _greedy(eng, prompts) == before
        # the same payload with the last leaf repaired lands whole
        new[last] = good
        eng.update_weights_from_params(new, version=1)
        assert eng.get_version() == 1
        assert all(torch.equal(p, new[n].to(p.dtype)) for n, p in eng.model.named_parameters())
    finally:
        eng.stop()
