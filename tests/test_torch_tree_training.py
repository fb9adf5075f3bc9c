"""Tree training in the port against the JAX package on the CPU: forest
packing and the engine's tree microbatches (identical arrays),
``TorchTrainEngine.train_batch`` with ``tree_training=True`` against a
one-device ``JaxTrainEngine`` (one forest and several), the port's tree path
against its own packed path, and ``PPOActor.ppo_update`` through the tree
path against the JAX actor's, all at f32 on the same weights and batch."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from areal_tpu.api.config import MeshConfig as JMeshConfig
from areal_tpu.api.config import NormConfig as JNormConfig
from areal_tpu.api.config import OptimizerConfig as JOptimizerConfig
from areal_tpu.api.config import PPOActorConfig as JPPOActorConfig
from areal_tpu.api.io_struct import FinetuneSpec as JFinetuneSpec
from areal_tpu.engine import train_engine as jte
from areal_tpu.models import tree as jtree
from areal_tpu.parallel import mesh as mesh_lib
from areal_tpu.trainer import ppo as jppo
from areal_tpu.utils import data as jdata
from areal_tpu_torch.api.config import NormConfig, OptimizerConfig, PPOActorConfig
from areal_tpu_torch.api.io_struct import FinetuneSpec
from areal_tpu_torch.engine import train_engine as tte
from areal_tpu_torch.models import convert
from areal_tpu_torch.models import tree as ttree
from areal_tpu_torch.trainer import ppo as tppo

from test_torch_qwen import jax_params, port_cfg
from tpu_testing import TINY_QWEN2

GROUP = 4
LR = 1e-3
# loss, gradient norm and stats: sums over every parameter, f32
STAT_RTOL = 2e-4
COMMON = dict(
    dtype="float32",
    param_dtype="float32",
    bucket_step=64,
    logprob_chunk_size=48,
    group_size=GROUP,
    ppo_n_minibatches=1,
    use_decoupled_loss=True,
    prox_logp_mode="recompute",
    tree_training=True,
)
MULTI = dict(tree_node_budget=192, tree_node_bucket=128)  # several forests per batch


def _grpo_trajs(n_groups=3, seed=0, vocab=256):
    """GRPO-shaped trajectories: each group's samples share a prompt."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_groups):
        prompt = rng.integers(0, vocab, int(rng.integers(20, 40))).tolist()
        for _ in range(GROUP):
            o = int(rng.integers(4, 24))
            p = len(prompt)
            out.append({
                "input_ids": np.asarray(prompt + rng.integers(0, vocab, o).tolist(), np.int32),
                "loss_mask": np.r_[np.zeros(p), np.ones(o)].astype(np.float32),
                "logprobs": np.r_[np.zeros(p), rng.normal(-5.0, 0.3, o)].astype(np.float32),
                "versions": np.r_[np.full(p, -1), np.zeros(o)].astype(np.int32),
                "rewards": np.float32(rng.uniform(0, 1)),
                "seq_no_eos_mask": np.bool_(rng.uniform() < 0.3),
            })
    return out


def _batch(seed=0, n_groups=3):
    return jdata.pad_sequences_to_tensors(_grpo_trajs(n_groups, seed))


# ---------------------------------------------------------------------------
# host packing: identical arrays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget,group", [(10_000, 4), (120, 4), (60, 2), (50, 1)])
def test_pack_forest_identical(budget, group):
    batch = _batch(seed=1, n_groups=4)
    lens = batch["attention_mask"].sum(-1)
    seqs = [batch["input_ids"][b, : lens[b]] for b in range(len(lens))]
    want = jtree.pack_forest(seqs, budget, group)
    got = ttree.pack_forest(seqs, budget, group)
    assert [r for _, r in got] == [r for _, r in want]
    for (gp, _), (wp, _) in zip(got, want):
        for f in ("tokens", "parent", "depth"):
            np.testing.assert_array_equal(getattr(gp, f), getattr(wp, f))
        for a, b in zip(gp.seq_nodes, wp.seq_nodes):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(gp.traversal_count(), wp.traversal_count())
        per_seq = [np.arange(len(n), dtype=np.float32) for n in gp.seq_nodes]
        for reduce in ("sum", "mean", "any"):
            np.testing.assert_array_equal(gp.aggregate(per_seq, reduce), wp.aggregate(per_seq, reduce))
        node_vals = np.arange(gp.n_nodes)
        for a, b in zip(gp.scatter_to_sequences(node_vals), wp.scatter_to_sequences(node_vals)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ttree.edge_logprob_index(gp), jtree.edge_logprob_index(wp)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ttree.non_root_nodes(gp), jtree.non_root_nodes(wp))
    assert len(got) > 1 or budget == 10_000


@pytest.mark.parametrize("kw", [{}, MULTI], ids=["one-forest", "several-forests"])
def test_make_tree_batches_identical(kw):
    """The engine's host microbatches, array for array and the dedup stats,
    from each engine's method on its own config."""
    batch = _batch(seed=2)
    batch["prox_logp"] = batch["logprobs"]
    adv = jppo.PPOActor(_jcfg(**kw), SimpleNamespace(get_version=lambda: 0)).compute_advantages(batch)
    want, wstats = jte.JaxTrainEngine._make_tree_batches(SimpleNamespace(config=_jcfg(**kw)), adv)
    teng = tte.TorchTrainEngine(_tcfg(**kw), model_config=port_cfg(TINY_QWEN2), device="cpu")
    got, gstats = teng._make_tree_batches(adv)
    assert gstats == wstats and wstats["tree_dedup_ratio"] > 1.3
    assert len(got) == len(want) and (len(got) > 1) == bool(kw)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert g["gather_idx"].shape[0] % 8 == 0  # rows padded to a bucket of 8


# ---------------------------------------------------------------------------
# TorchTrainEngine against a one-device JaxTrainEngine, tree path
# ---------------------------------------------------------------------------


def _jcfg(**kw):
    return JPPOActorConfig(
        init_from_scratch=True,
        mesh=JMeshConfig(data=1),
        optimizer=JOptimizerConfig(lr=LR),
        adv_norm=JNormConfig(mean_level="group", std_level="batch", group_size=GROUP),
        **{**COMMON, **kw},
    )


def _tcfg(**kw):
    return PPOActorConfig(
        optimizer=OptimizerConfig(lr=LR),
        adv_norm=NormConfig(mean_level="group", std_level="batch", group_size=GROUP),
        **{**COMMON, **kw},
    )


def _engines(seed=0, **kw):
    """A JAX engine on one CPU device and the port's engine on the CPU, both
    with tree training, the port loaded with the JAX engine's weights."""
    jcfg = _jcfg(**kw)
    jeng = jte.JaxTrainEngine(jcfg, model_config=TINY_QWEN2)
    jeng.initialize(JFinetuneSpec(1, 128, 16), mesh=mesh_lib.make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    params = jax_params(TINY_QWEN2, seed=seed)
    jeng.params = jax.tree.map(lambda old, new: jax.device_put(jnp.asarray(new), old.sharding), jeng.params, params)
    tcfg = _tcfg(**kw)
    teng = tte.TorchTrainEngine(tcfg, model_config=port_cfg(TINY_QWEN2), device="cpu")
    teng.initialize(FinetuneSpec(1, 128, 16))
    teng.model.load_state_dict(convert.from_jax_params(params, port_cfg(TINY_QWEN2)))
    return jcfg, jeng, tcfg, teng


def _wfn(d):
    return float((np.asarray(d["loss_mask"]) > 0).sum())


def _advantages(jcfg, jeng, seed):
    batch = _batch(seed)
    batch["prox_logp"] = jeng.forward_batch(batch)
    return jppo.PPOActor(jcfg, SimpleNamespace(get_version=lambda: 0)).compute_advantages(batch)


@pytest.mark.parametrize("kw", [{}, MULTI], ids=["one-forest", "several-forests"])
def test_tree_train_batch_matches_jax(kw):
    """Two optimizer steps through the tree path: loss, grad_norm and the
    stats of each, then every master weight (the first step has LR 0)."""
    jcfg, jeng, tcfg, teng = _engines(**kw)
    adv = _advantages(jcfg, jeng, seed=3)
    init = convert.to_jax_params(teng.model.state_dict(), port_cfg(TINY_QWEN2))
    for step in range(2):
        want = jeng.train_batch(adv, lambda o, b: jppo.grpo_loss_fn(o, b, jcfg), _wfn)
        got = teng.train_batch(adv, lambda o, b: tppo.grpo_loss_fn(o, b, tcfg), _wfn)
        assert got["n_microbatches"] == want["n_microbatches"]
        assert (got["n_microbatches"] > 1) == bool(kw)
        for k in ("tree_tokens", "tree_nodes", "tree_dedup_ratio", "lr"):
            assert got[k] == pytest.approx(want[k], rel=1e-6), k
        for k in ("loss", "grad_norm", "actor_loss", "importance_weight", "entropy", "n_valid_tokens"):
            np.testing.assert_allclose(got[k], want[k], rtol=STAT_RTOL, atol=1e-6, err_msg=f"step {step}: {k}")
    # Adam's update is sign-like where gradients are tiny: f32 noise there can
    # move a weight by up to ~lr; everywhere else the weights agree to f32 noise
    flat_g = dict(jax.tree_util.tree_leaves_with_path(convert.to_jax_params(teng.model.state_dict(), port_cfg(TINY_QWEN2))))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jeng.params)))
    flat_0 = dict(jax.tree_util.tree_leaves_with_path(init))
    for key in flat_j:
        diff = np.abs(flat_g[key] - flat_j[key])
        assert diff.max() <= 2 * LR, (key, diff.max())
        assert np.mean(diff <= 1e-6) > 0.99, (key, np.mean(diff <= 1e-6))
        assert np.abs(flat_j[key] - flat_0[key]).max() > LR / 2, key  # the second step moved it


def test_tree_path_matches_packed_path():
    """The port's tree path against its own packed path on one batch: the
    same per-token logprobs, loss and gradient (one computation per node
    against one per token)."""
    jcfg, jeng, tcfg, teng = _engines(seed=1)
    adv = _advantages(jcfg, jeng, seed=4)
    res = {}
    for tree in (True, False):
        teng.config = PPOActorConfig(**{**tcfg.__dict__, "tree_training": tree})
        teng.zero_grad()
        res[tree] = teng.compute_grads(adv, lambda o, b: tppo.grpo_loss_fn(o, b, tcfg), _wfn)
    teng.zero_grad()
    assert res[True]["tree_nodes"] < res[True]["tree_tokens"] and "tree_nodes" not in res[False]
    for k in ("loss", "grad_norm", "actor_loss", "entropy", "n_valid_tokens"):
        np.testing.assert_allclose(res[True][k], res[False][k], rtol=STAT_RTOL, atol=1e-6, err_msg=k)


def test_ppo_update_through_tree_path_matches_jax():
    jcfg, jeng, tcfg, teng = _engines(seed=2, **MULTI)
    batch = _batch(seed=5)
    batch["prox_logp"] = jeng.forward_batch(batch)
    jactor, tactor = jppo.PPOActor(jcfg, jeng), tppo.PPOActor(tcfg, teng)
    want = jactor.ppo_update(jactor.compute_advantages(batch))
    got = tactor.ppo_update(tactor.compute_advantages(batch))
    assert len(got) == len(want) == 1
    assert got[0]["tree_dedup_ratio"] == pytest.approx(want[0]["tree_dedup_ratio"]) and got[0]["tree_dedup_ratio"] > 1.3
    for k in ("loss", "grad_norm", "actor_loss", "n_microbatches"):
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=STAT_RTOL, atol=1e-6, err_msg=k)
