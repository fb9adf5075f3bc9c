"""The port's trainer side against the JAX package on the CPU: the data
helpers (identical results), the LR schedule and optimizer against optax,
``TorchTrainEngine`` against a one-device ``JaxTrainEngine`` at f32 on the
same weights and batch, ``__graft_entry__.entry()`` in bf16, and the
trainer -> decode-engine weight update."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__
from areal_tpu.api.config import MeshConfig as JMeshConfig
from areal_tpu.api.config import MicroBatchSpec as JMicroBatchSpec
from areal_tpu.api.config import NormConfig as JNormConfig
from areal_tpu.api.config import OptimizerConfig as JOptimizerConfig
from areal_tpu.api.config import PPOActorConfig as JPPOActorConfig
from areal_tpu.api.io_struct import FinetuneSpec as JFinetuneSpec
from areal_tpu.engine import train_engine as jte
from areal_tpu.models import qwen as jq
from areal_tpu.parallel import mesh as mesh_lib
from areal_tpu.trainer import ppo as jppo
from areal_tpu.utils import data as jdata
from areal_tpu.utils import datapack as jdatapack
from areal_tpu.utils import grid as jgrid
from areal_tpu_torch.api.config import MicroBatchSpec, NormConfig, OptimizerConfig, PPOActorConfig, ServerConfig
from areal_tpu_torch.api.io_struct import (
    FinetuneSpec,
    GenerationHyperparameters,
    ModelRequest,
    WeightUpdateMeta,
)
from areal_tpu_torch.engine import train_engine as tte
from areal_tpu_torch.inference.decode_engine import DecodeEngine
from areal_tpu_torch.models import convert
from areal_tpu_torch.models import qwen as tq
from areal_tpu_torch.trainer import ppo as tppo
from areal_tpu_torch.utils import data as tdata
from areal_tpu_torch.utils import datapack as tdatapack
from areal_tpu_torch.utils import grid as tgrid

from test_torch_qwen import jax_params, port_cfg
from tpu_testing import TINY_QWEN2

# f32 forward of a 2-layer model on the CPU: other summation orders
LOGP_TOL = dict(atol=5e-5, rtol=5e-5)
# loss and gradient norm: sums over every parameter, f32
STAT_RTOL = 2e-4


def _trajs(n=8, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p, o = int(rng.integers(5, 30)), int(rng.integers(3, 25))
        out.append(
            {
                "input_ids": rng.integers(0, vocab, p + o).astype(np.int32),
                "loss_mask": np.r_[np.zeros(p), np.ones(o)].astype(np.float32),
                "logprobs": np.r_[np.zeros(p), rng.normal(-5.0, 0.3, o)].astype(np.float32),
                "versions": np.r_[np.full(p, -1), np.zeros(o)].astype(np.int32),
                "rewards": np.float32(rng.uniform(0, 1)),
                "seq_no_eos_mask": np.bool_(rng.uniform() < 0.3),
            }
        )
    return out


# ---------------------------------------------------------------------------
# data helpers: identical results
# ---------------------------------------------------------------------------


def _assert_dicts_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_pad_sequences_and_seqlens_identical():
    trajs = _trajs(6, seed=1)
    _assert_dicts_equal(tdata.pad_sequences_to_tensors(trajs), jdata.pad_sequences_to_tensors(trajs))


@pytest.mark.parametrize("row_len", [64, 96, 128])
def test_pack_grid_identical(row_len):
    batch = jdata.pad_sequences_to_tensors(_trajs(9, seed=2))
    want = jgrid.pack_grid(batch, row_len=row_len)
    got = tgrid.pack_grid(batch, row_len)
    _assert_dicts_equal(got.data, want.data)
    for f in ("n_rows", "row_len", "seq_index", "row_of_seq", "col_of_seq", "seq_lens"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize(
    "spec",
    [dict(n_mbs=2), dict(n_mbs=3), dict(n_mbs=1, max_tokens_per_mb=80), dict(n_mbs=4, max_tokens_per_mb=200), dict(n_mbs=2, granularity=2)],
    ids=["n2", "n3", "ffd80", "ffd200-min4", "gran2"],
)
def test_split_into_microbatches_identical(spec):
    batch = jdata.pad_sequences_to_tensors(_trajs(8, seed=3))
    want = jdata.split_padded_tensor_dict_into_mb_list(batch, jdata.MicroBatchSpec(**spec))
    got = tdata.split_padded_tensor_dict_into_mb_list(batch, tdata.MicroBatchSpec(**spec))
    assert got.group_indices == want.group_indices
    for a, b in zip(got.mbs, want.mbs):
        _assert_dicts_equal(a, b)


def test_bucketing_and_partitions_identical():
    for n in list(range(1, 700, 7)) + [4096, 5000, 12345]:
        for step in (64, 256, 512):
            assert tdata.round_up_to_bucket(n, step) == jdata.round_up_to_bucket(n, step)
    rng = np.random.default_rng(4)
    for _ in range(20):
        sizes = rng.integers(1, 100, int(rng.integers(1, 40))).tolist()
        for cap, mg in ((100, 1), (150, 3), (400, 2)):
            assert tdatapack.ffd_allocate(sizes, cap, mg) == jdatapack.ffd_allocate(sizes, cap, mg)
        for k in (1, 2, 5):
            assert tdatapack.balanced_greedy_partition(sizes, k) == jdatapack.balanced_greedy_partition(sizes, k)
    with pytest.raises(ValueError):
        tdatapack.ffd_allocate([5, 200], 100)


@pytest.mark.parametrize(
    "kw",
    [
        dict(mean_level="group", std_level="batch", group_size=4),
        dict(mean_level="group", std_level="group", group_size=2),
        dict(mean_level="batch", std_level="batch"),
        dict(mean_level="group", std_level="none", group_size=4, mean_leave1out=True),
        dict(mean_level="none", std_level="batch", std_unbiased=True),
    ],
    ids=["grpo", "group-group", "batch", "rloo", "rms-unbiased"],
)
def test_normalization_identical(kw):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 2, (8, 12)).astype(np.float32)
    mask = rng.uniform(size=(8, 12)) < 0.7
    np.testing.assert_array_equal(tdata.Normalization(**kw)(x, mask), jdata.Normalization(**kw)(x, mask))


def test_make_causal_inputs_identical():
    grid = jgrid.pack_grid(jdata.pad_sequences_to_tensors(_trajs(7, seed=6)), bucket_step=64)
    ids, seg = grid.data["input_ids"], grid.data["segment_ids"]
    for a, b in zip(tq.make_causal_inputs(ids, seg), jq.make_causal_inputs(ids, seg)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# LR schedule and optimizer against optax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["constant", "linear", "cosine"])
@pytest.mark.parametrize("warmup", [0.0, 0.1])
def test_lr_schedule_matches_optax(kind, warmup):
    kw = dict(lr=3e-4, lr_scheduler_type=kind, warmup_steps_proportion=warmup, min_lr_ratio=0.1)
    want = jte.make_lr_schedule(JOptimizerConfig(**kw), 50)
    got = tte.make_lr_schedule(OptimizerConfig(**kw), 50)
    assert got(0) == 0.0 == float(want(0))  # the first step moves nothing
    for c in range(0, 60):
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("clip", [1e-3, 100.0], ids=["clipped", "unclipped"])
def test_optimizer_matches_optax_chain(clip):
    """Three steps of clip_by_global_norm + adamw with a warmup schedule,
    weight decay on every leaf (f32: the same formulas, rounding apart)."""
    rng = np.random.default_rng(7)
    shapes = [(5, 7), (7,), (3, 4, 2)]
    params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 1, s).astype(np.float32) for s in shapes] for _ in range(3)]
    ocfg = dict(lr=1e-2, weight_decay=0.05, beta1=0.9, beta2=0.95, eps=1e-8, gradient_clipping=clip, warmup_steps_proportion=0.2)
    sched = jte.make_lr_schedule(JOptimizerConfig(**ocfg), 10)
    tx = optax.chain(optax.clip_by_global_norm(clip), optax.adamw(sched, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.05))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = tte._OptaxAdamW(tp, OptimizerConfig(**ocfg), tte.make_lr_schedule(OptimizerConfig(**ocfg), 10))
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        gn = opt.step([torch.from_numpy(x) for x in g])
        np.testing.assert_allclose(gn.item(), float(optax.global_norm([jnp.asarray(x) for x in g])), rtol=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(tp[0].numpy() != params[0], True)


# ---------------------------------------------------------------------------
# TorchTrainEngine against a one-device JaxTrainEngine
# ---------------------------------------------------------------------------

LR = 1e-3
COMMON = dict(
    dtype="float32",
    param_dtype="float32",
    bucket_step=64,
    logprob_chunk_size=48,
    group_size=4,
    ppo_n_minibatches=2,
    use_decoupled_loss=True,
    prox_logp_mode="recompute",
)


def _engines(mb_tokens=None, attn_impl="pallas", seed=0):
    """A JAX engine on one CPU device and the port's engine on the CPU, the
    port loaded with the JAX engine's weights (random biases and norms)."""
    jcfg = JPPOActorConfig(
        init_from_scratch=True,
        mesh=JMeshConfig(data=1),
        optimizer=JOptimizerConfig(lr=LR),
        mb_spec=JMicroBatchSpec(max_tokens_per_mb=mb_tokens),
        adv_norm=JNormConfig(mean_level="group", std_level="batch", group_size=4),
        **COMMON,
    )
    jeng = jte.JaxTrainEngine(jcfg, model_config=TINY_QWEN2)
    jeng.initialize(
        JFinetuneSpec(1, 128, 16), mesh=mesh_lib.make_mesh(jcfg.mesh, devices=jax.devices()[:1])
    )
    params = jax_params(TINY_QWEN2, seed=seed)
    jeng.params = jax.tree.map(lambda old, new: jax.device_put(jnp.asarray(new), old.sharding), jeng.params, params)
    tcfg = PPOActorConfig(
        attn_impl=attn_impl,
        optimizer=OptimizerConfig(lr=LR),
        mb_spec=MicroBatchSpec(max_tokens_per_mb=mb_tokens),
        adv_norm=NormConfig(mean_level="group", std_level="batch", group_size=4),
        **COMMON,
    )
    teng = tte.TorchTrainEngine(tcfg, model_config=port_cfg(TINY_QWEN2), device="cpu")
    teng.initialize(FinetuneSpec(1, 128, 16))
    teng.model.load_state_dict(convert.from_jax_params(params, port_cfg(TINY_QWEN2)))
    return jcfg, jeng, tcfg, teng


def _rl_batch(seed=0):
    return jdata.pad_sequences_to_tensors(_trajs(8, seed=seed))


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_forward_batch_matches_jax(attn_impl):
    _, jeng, _, teng = _engines(attn_impl=attn_impl)
    batch = _rl_batch(10)
    want = jeng.forward_batch(batch)
    got = teng.forward_batch(batch)
    assert got.shape == want.shape and np.all(got[:, 0] == 0)
    np.testing.assert_allclose(got, want, **LOGP_TOL)


class _Version:
    def get_version(self):
        return 0


@pytest.mark.parametrize("mb_tokens", [None, 128], ids=["one-microbatch", "accumulate"])
def test_grpo_train_steps_match_jax(mb_tokens):
    """Two optimizer steps through grpo_loss_fn: loss, grad_norm and stats
    of each, then every master weight (the first step has LR 0)."""
    jcfg, jeng, tcfg, teng = _engines(mb_tokens=mb_tokens)
    batch = _rl_batch(11)
    batch["prox_logp"] = jeng.forward_batch(batch)
    adv = jppo.PPOActor(jcfg, _Version()).compute_advantages(batch)

    def jloss(o, b):
        return jppo.grpo_loss_fn(o, b, jcfg)

    def tloss(o, b):
        return tppo.grpo_loss_fn(o, b, tcfg)

    def wfn(d):
        return float((np.asarray(d["loss_mask"]) > 0).sum())

    init = convert.to_jax_params(teng.model.state_dict(), port_cfg(TINY_QWEN2))
    for step in range(2):
        want = jeng.train_batch(adv, jloss, wfn)
        got = teng.train_batch(adv, tloss, wfn)
        assert got["n_microbatches"] == want["n_microbatches"]
        if mb_tokens:
            assert got["n_microbatches"] > 1
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
        for k in ("loss", "grad_norm", "actor_loss", "importance_weight", "behave_imp_weight", "entropy", "n_valid_tokens"):
            np.testing.assert_allclose(got[k], want[k], rtol=STAT_RTOL, atol=1e-6, err_msg=f"step {step}: {k}")
    assert want["grad_norm"] > 0
    # after two steps (LR 0, then LR): Adam's update is lr * m / (sqrt(v) + eps),
    # sign-like where gradients are tiny, so f32 noise in a near-zero gradient
    # can move a weight by up to ~lr; everywhere else the weights agree to f32
    # noise
    flat_g = dict(jax.tree_util.tree_leaves_with_path(convert.to_jax_params(teng.model.state_dict(), port_cfg(TINY_QWEN2))))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jeng.params)))
    flat_0 = dict(jax.tree_util.tree_leaves_with_path(init))
    for key in flat_j:
        diff = np.abs(flat_g[key] - flat_j[key])
        assert diff.max() <= 2 * LR, (key, diff.max())
        assert np.mean(diff <= 1e-6) > 0.99, (key, np.mean(diff <= 1e-6))
        assert np.abs(flat_j[key] - flat_0[key]).max() > LR / 2, key  # the second step moved it


def test_eval_batch_matches_jax():
    jcfg, jeng, tcfg, teng = _engines()
    batch = _rl_batch(12)
    batch["prox_logp"] = jeng.forward_batch(batch)
    adv = jppo.PPOActor(jcfg, _Version()).compute_advantages(batch)

    def wfn(d):
        return float((np.asarray(d["loss_mask"]) > 0).sum())

    want = jeng.eval_batch(adv, lambda o, b: jppo.grpo_loss_fn(o, b, jcfg), wfn)
    got = teng.eval_batch(adv, lambda o, b: tppo.grpo_loss_fn(o, b, tcfg), wfn)
    for k in ("loss", "actor_loss", "new_logp", "entropy"):
        np.testing.assert_allclose(got[k], want[k], rtol=STAT_RTOL, atol=1e-6, err_msg=k)


def test_graft_entry_forward_and_logprobs_bf16():
    """``__graft_entry__.entry()``: the packed-grid forward plus the chunked
    logprobs at entry's config, bf16 weights and compute on both sides."""
    fn, (params, ids, seg, pos) = __graft_entry__.entry()
    want = jax.jit(fn)(params, ids, seg, pos)
    cfg = port_cfg(__graft_entry__._flagship_config())
    assert cfg.dtype == "bfloat16"
    model = tq.QwenModel(cfg, device="cpu")
    model.load_state_dict(convert.from_jax_params(jax.tree.map(np.asarray, params), cfg))
    labels, valid = tq.make_causal_inputs(np.asarray(ids), np.asarray(seg))
    with torch.no_grad():
        hidden = tq.forward(model, *(torch.from_numpy(np.array(x)) for x in (ids, seg, pos)))
        logp, ent = tq.chunked_logprobs_entropy(model, hidden, torch.from_numpy(labels))
    assert logp.dtype == torch.float32 and logp.shape == tuple(ids.shape)
    # bf16 rounds the activations of 4 layers and the logits at different
    # points in XLA and in PyTorch: per-token logprobs (~ -7) agree to a few
    # bf16 steps; the mean NLL, an average of 1020 of them, much closer
    jl, je = np.asarray(want["logprobs"]), np.asarray(want["entropy"])
    np.testing.assert_allclose(logp.numpy()[valid], jl[valid], atol=0.15)
    np.testing.assert_allclose(ent.numpy()[valid], je[valid], atol=0.15)
    nll = -(logp.numpy() * valid).sum() / valid.sum()
    np.testing.assert_allclose(nll, float(want["mean_nll"]), rtol=2e-3)


# ---------------------------------------------------------------------------
# the join: update_weights(mem) into a DecodeEngine
# ---------------------------------------------------------------------------


def _generate(engine, prompts, n_new=12):
    return [
        engine.generate_sync(
            ModelRequest(input_ids=p, gconfig=GenerationHyperparameters(max_new_tokens=n_new, greedy=True)),
            timeout=300,
        )
        for p in prompts
    ]


def test_update_weights_mem_into_decode_engine():
    cfg = port_cfg(TINY_QWEN2)
    tcfg = PPOActorConfig(dtype="float32", param_dtype="float32", bucket_step=64)
    teng = tte.TorchTrainEngine(tcfg, model_config=cfg, device="cpu")
    teng.initialize(FinetuneSpec(1, 16, 4), seed=3)
    scfg = ServerConfig(max_batch_size=4, max_seq_len=128, page_size=16, decode_steps_per_call=4, enable_prefix_caching=False, seed=0)
    other = tq.QwenModel(cfg, device="cpu")
    other.load_state_dict(convert.from_jax_params(jax_params(TINY_QWEN2, seed=5), cfg))
    dec = DecodeEngine(scfg, params=other, device="cpu")
    dec.start()
    ref = DecodeEngine(scfg, params=teng._export_params(), model_cfg=cfg, device="cpu")
    ref.start()
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            teng.connect_engine(dec, WeightUpdateMeta(type="disk"))
            teng.update_weights()
        teng.connect_engine(dec, WeightUpdateMeta(type="mem"))
        rng = np.random.default_rng(13)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (4, 9, 17)]
        before = _generate(dec, prompts)
        assert all(r.output_versions == [0] * 12 for r in before)
        teng.update_weights()
        teng.set_version(1)
        assert dec.get_version() == 1 == teng.get_version()
        got = _generate(dec, prompts)
        want = _generate(ref, prompts)
        for g, w in zip(got, want):
            assert g.output_tokens == w.output_tokens
            np.testing.assert_allclose(g.output_logprobs, w.output_logprobs, atol=1e-5)
            assert g.output_versions == [1] * 12
        assert any(b.output_tokens != g.output_tokens for b, g in zip(before, got))
        # with_version=False re-pushes under the same version
        teng.update_weights(WeightUpdateMeta(type="mem", with_version=False))
        assert dec.get_version() == 1
    finally:
        dec.stop()
        ref.stop()


def test_trainer_weights_round_trip_through_convert():
    """convert.py carries the trainer's f32 master weights both ways."""
    cfg = port_cfg(TINY_QWEN2)
    teng = tte.TorchTrainEngine(PPOActorConfig(dtype="float32"), model_config=cfg, device="cpu")
    teng.initialize(seed=1)
    params = jax_params(TINY_QWEN2, seed=2)
    teng.model.load_state_dict(convert.from_jax_params(params, cfg))
    assert all(p.dtype == torch.float32 and p.requires_grad for p in teng.model.parameters())
    back = convert.to_jax_params(teng._export_params(), cfg)
    with torch.no_grad():  # a later optimizer step must not reach the export
        for p in teng.model.parameters():
            p.add_(1.0)
    for (ka, a), (kb, b) in zip(jax.tree_util.tree_leaves_with_path(params), jax.tree_util.tree_leaves_with_path(back)):
        assert ka == kb
        np.testing.assert_array_equal(a, b)
