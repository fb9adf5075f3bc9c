"""The trainer half of the GRPO loop: the port's ``PPOTrainer`` against the
JAX package's.

1. Both trainers on the same weights (``models/convert.py``), each with a
   stub rollout engine that hands out the same fixed batches and records
   its calls: the same call sequence over 3 global steps, the same
   parameters pushed at each step (every element of every leaf within the
   stated tolerance), the same stats keys committed.
2. Every unported option of the loop raises ``NotImplementedError`` naming
   its ROADMAP item; the durable-state options (preemption, disk updates,
   recovery) are accepted, and ``PPOConfig()`` as it comes constructs.
3. The whole loop over HTTP on the CPU: the port's server, ``RemoteTorchEngine``,
   ``TorchTrainEngine`` and ``PPOTrainer.train`` for 3 global steps.
4. The port's twin of ``tests/test_rl_e2e.py::test_rl_learns_target_token``
   (``slow``, as the JAX test is).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api import config as jc
from areal_tpu.api.io_struct import FinetuneSpec as JFinetuneSpec
from areal_tpu.engine.train_engine import JaxTrainEngine
from areal_tpu.parallel import mesh as mesh_lib
from areal_tpu.trainer.rl_trainer import PPOTrainer as JPPOTrainer
from areal_tpu.utils import data as jdata
from areal_tpu_torch.api import config as tc
from areal_tpu_torch.api.io_struct import FinetuneSpec, GenerationHyperparameters, ModelRequest, SaveLoadMeta
from areal_tpu_torch.engine.train_engine import TorchTrainEngine
from areal_tpu_torch.inference.client import RemoteTorchEngine
from areal_tpu_torch.inference.decode_engine import DecodeEngine
from areal_tpu_torch.inference.server import ServerThread
from areal_tpu_torch.models import convert
from areal_tpu_torch.trainer.rl_trainer import PPOTrainer
from areal_tpu_torch.utils.saver import Saver
from areal_tpu_torch.workflow.rlvr import RLVRWorkflow

from test_torch_qwen import jax_params, port_cfg
from test_torch_train_engine import _trajs
from tpu_testing import TINY_QWEN2

LR = 1e-3
# Adam's eps: with optax's 1e-8, an element whose gradient is near zero
# takes a sign-like step, and f32 summation order moves it by up to ~LR
# (ROADMAP Queue C item 1). At 1e-5 the step is smooth in the gradient, so
# every element of every leaf is held to f32 noise.
ADAM_EPS = 1e-5
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
N_STEPS = 3
ACTOR = dict(
    dtype="float32",
    param_dtype="float32",
    bucket_step=64,
    group_size=4,
    ppo_n_minibatches=2,
    use_decoupled_loss=True,
    prox_logp_mode="recompute",
)


class _StubRollout:
    """A rollout engine that hands out fixed batches and records its calls;
    the version rule of ``update_weights`` is the rollout client's."""

    def __init__(self, batches, to_jax_layout):
        self.batches = batches
        self.to_jax_layout = to_jax_layout
        self.version = 0
        self.calls = []
        self.pushed = []

    def prepare_batch(self, dataloader, workflow=None, should_accept_fn=None):
        self.calls.append(("prepare_batch",))
        return {k: np.array(v, copy=True) for k, v in self.batches[len(self.pushed)].items()}

    def pause(self):
        self.calls.append(("pause",))

    def resume(self):
        self.calls.append(("resume",))

    def update_weights(self, meta, params=None):
        self.calls.append(("update_weights", self.version + 1))
        self.pushed.append(self.to_jax_layout(params))

    def set_version(self, v):
        self.calls.append(("set_version", v))
        self.version = v

    def get_version(self):
        return self.version

    def export_stats(self):
        self.calls.append(("export_stats",))
        return {}

    def destroy(self):
        self.calls.append(("destroy",))


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _run_jax(params, batches, root):
    jcfg = jc.PPOActorConfig(
        init_from_scratch=True,
        mesh=jc.MeshConfig(data=1),
        optimizer=jc.OptimizerConfig(lr=LR, eps=ADAM_EPS),
        adv_norm=jc.NormConfig(mean_level="group", std_level="batch", group_size=4),
        **ACTOR,
    )
    eng = JaxTrainEngine(jcfg, model_config=TINY_QWEN2)
    eng.initialize(JFinetuneSpec(1, 16, 4), mesh=mesh_lib.make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    eng.params = jax.tree.map(lambda old, new: jax.device_put(jnp.asarray(new), old.sharding), eng.params, params)
    cfg = jc.PPOConfig(
        total_train_steps=N_STEPS,
        weight_update_mode="mem",
        train_dataset=jc.DatasetConfig(batch_size=4),
        actor=jcfg,
        preemption=jc.PreemptionConfig(enabled=False),
        saver=jc.SaverConfig(fileroot=root),
        checkpointer=jc.SaverConfig(fileroot=root),
        evaluator=jc.EvaluatorConfig(fileroot=root),
        recover=jc.RecoverConfig(fileroot=root),
        stats_logger=jc.StatsLoggerConfig(fileroot=root),
    )
    cfg.cluster.fileroot = root
    stub = _StubRollout(batches, lambda p: _flat(jax.tree.map(np.asarray, p)))
    trainer = JPPOTrainer(cfg, [{"prompt_ids": [1, 2, 3]}] * 16, rollout=stub, actor_engine=eng)
    committed = []
    trainer.stats_logger.commit = lambda epoch, step, gstep, stats: committed.append(stats)
    trainer.train()
    trainer.close()
    return stub, committed, eng.get_version()


def _run_port(params, batches, root):
    tcfg = tc.PPOActorConfig(
        optimizer=tc.OptimizerConfig(lr=LR, eps=ADAM_EPS),
        adv_norm=tc.NormConfig(mean_level="group", std_level="batch", group_size=4),
        **ACTOR,
    )
    mcfg = port_cfg(TINY_QWEN2)
    eng = TorchTrainEngine(tcfg, model_config=mcfg, device="cpu")
    eng.initialize(FinetuneSpec(1, 16, 4))
    eng.model.load_state_dict(convert.from_jax_params(params, mcfg))
    cfg = tc.PPOConfig(
        total_train_steps=N_STEPS,
        weight_update_mode="mem",
        train_dataset=tc.DatasetConfig(batch_size=4),
        actor=tcfg,
        preemption=tc.PreemptionConfig(enabled=False),
        saver=tc.SaverConfig(fileroot=root),
        checkpointer=tc.SaverConfig(fileroot=root),
        evaluator=tc.EvaluatorConfig(fileroot=root),
        recover=tc.RecoverConfig(fileroot=root),
        stats_logger=tc.StatsLoggerConfig(fileroot=root),
    )
    cfg.cluster.fileroot = root
    stub = _StubRollout(batches, lambda p: _flat(convert.to_jax_params(p, mcfg)))
    trainer = PPOTrainer(cfg, [{"prompt_ids": [1, 2, 3]}] * 16, rollout=stub, actor_engine=eng)
    committed = []
    trainer.stats_logger.commit = lambda epoch, step, gstep, stats: committed.append(stats)
    trainer.train()
    trainer.close()
    return stub, committed, eng.get_version()


def test_ppo_trainer_matches_jax(tmp_path):
    from areal_tpu.utils import stats_tracker as j_stats
    from areal_tpu_torch.utils import stats_tracker as t_stats

    # the trackers are process-wide: drop what earlier tests in this worker
    # recorded, so each trainer commits only its own steps' stats
    j_stats.export_all()
    t_stats.export_all()
    params = jax_params(TINY_QWEN2, seed=5)
    batches = [jdata.pad_sequences_to_tensors(_trajs(8, seed=20 + s)) for s in range(N_STEPS)]
    jstub, jstats, jversion = _run_jax(params, batches, str(tmp_path / "jax"))
    tstub, tstats, tversion = _run_port(params, batches, str(tmp_path / "port"))

    assert tstub.calls == jstub.calls
    assert [c for c in tstub.calls if c[0] in ("update_weights", "set_version")] == [
        (name, k) for k in range(1, N_STEPS + 1) for name in ("update_weights", "set_version")
    ]
    assert tversion == jversion == N_STEPS
    assert len(tstub.pushed) == len(jstub.pushed) == N_STEPS
    init = _flat(params)
    for step, (got, want) in enumerate(zip(tstub.pushed, jstub.pushed)):
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_allclose(got[key], want[key], **PARAM_TOL, err_msg=f"step {step}: {key}")
    # the pushes moved (the first step has LR 0; the later two do not)
    assert all(np.abs(jstub.pushed[-1][k] - init[k]).max() > LR / 2 for k in init)

    # the same stats keys every step, the per-version-lag learning-health
    # stats included (the memory ledger has no limit on the CPU without
    # TelemetryConfig.chip_hbm_gb, as the JAX one)
    assert len(tstats) == len(jstats) == N_STEPS
    for t, j in zip(tstats, jstats):
        assert set(t) == set(j) and any(k.startswith("ppo_actor/lag_") for k in t)
        assert t["version"] == j["version"]
        np.testing.assert_allclose(t["ppo_actor/loss"], j["ppo_actor/loss"], rtol=2e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# 2. refusals
# ---------------------------------------------------------------------------


def _port_engine():
    eng = TorchTrainEngine(
        tc.PPOActorConfig(**ACTOR), model_config=port_cfg(TINY_QWEN2), device="cpu"
    )
    eng.initialize(FinetuneSpec(1, 16, 4))
    return eng


def _cfg(**over):
    base = dict(weight_update_mode="mem", preemption=tc.PreemptionConfig(enabled=False),
                train_dataset=tc.DatasetConfig(batch_size=4), actor=tc.PPOActorConfig(**ACTOR))
    return tc.PPOConfig(**{**base, **over})


@pytest.mark.parametrize(
    "over, error, match",
    [
        # allocation_mode is live (item 6a), TP serving too (6b-1); a gen
        # half's sequence parallelism waits for 6b
        (dict(allocation_mode="sglang:d1c2+fsdp:d1"), NotImplementedError, "item 6"),
        (dict(cluster=tc.ClusterSpecConfig(name_resolve=tc.NameResolveConfig(type="nfs"))), NotImplementedError,
         "item 8"),
        # the q8 wire is ported (item 4); to a fleet that is not int8 it is
        # refused, as in JAX
        (dict(weight_update_wire="q8"), ValueError, "int8-serving fleet"),
        (dict(server=tc.ServerConfig(quantization="int8")), None, "q8"),
    ],
    ids=["allocation_mode", "name_resolve", "q8", "int8-auto"],
)
def test_unported_trainer_options_refused(over, error, match, tmp_path):
    """Options of later slices raise naming their item before the loop
    touches the rollout engine; "auto" against an int8 fleet resolves to
    the q8 wire."""
    stub = _StubRollout([], lambda p: p)
    if error is None:
        over = {**over, "cluster": tc.ClusterSpecConfig(fileroot=str(tmp_path))}
        trainer = PPOTrainer(_cfg(**over), [{"prompt_ids": [1]}] * 8, rollout=stub, actor_engine=_port_engine())
        try:
            assert trainer.weight_update_meta.wire_format == match
        finally:
            trainer.close()
        return
    with pytest.raises(error, match=match):
        PPOTrainer(_cfg(**over), [{"prompt_ids": [1]}] * 8, rollout=stub, actor_engine=object())
    assert stub.calls == []  # refused before the loop touched the rollout engine


@pytest.mark.parametrize(
    "over",
    [dict(preemption=tc.PreemptionConfig()), dict(weight_update_mode="disk"), dict(recover="auto")],
    ids=["preemption", "disk", "recover"],
)
def test_durable_state_options_accepted(over, tmp_path):
    """The options of the trainer's durable state construct (they were
    refused until the recover dump, the disk update and the drain were
    ported): nothing to recover from yet, so the trainer starts fresh."""
    over = {**over, "cluster": tc.ClusterSpecConfig(fileroot=str(tmp_path))}
    if "recover" in over:
        over["recover"] = tc.RecoverConfig(mode=over["recover"], fileroot=str(tmp_path))
    stub = _StubRollout([], lambda p: p)
    trainer = PPOTrainer(_cfg(**over), [{"prompt_ids": [1]}] * 8, rollout=stub, actor_engine=_port_engine())
    try:
        assert trainer.recover_info is None and stub.calls == []
        assert (trainer.preemption is not None) == ("preemption" in over)
        assert trainer.weight_update_meta.type == over.get("weight_update_mode", "mem")
    finally:
        trainer.close()


def test_defaults_construct_and_a_due_save_raises(tmp_path):
    """``PPOConfig()`` as it comes (disk updates, preemption on) constructs;
    a due save writes an HF checkpoint that loads back; an engine asked
    for the JAX package's "orbax" format raises, naming the port's."""
    assert tc.PPOConfig().weight_update_mode == "disk" and tc.PPOConfig().preemption.enabled
    cfg = tc.PPOConfig(cluster=tc.ClusterSpecConfig(fileroot=str(tmp_path)))
    trainer = PPOTrainer(cfg, [{"prompt_ids": [1]}] * 8, rollout=_StubRollout([], lambda p: p),
                         actor_engine=_port_engine())
    try:
        assert trainer.weight_update_meta.type == "disk" and trainer.weight_update_meta.wire_format == "bf16"
        assert trainer.preemption is not None and trainer.preemption.state == "running"
        assert trainer.saver.maybe_save(trainer.actor_engine, 0, 0, 0) is None  # nothing due at the defaults
        saver = Saver(tc.SaverConfig(freq_steps=1, fileroot=str(tmp_path)), trainer.ft_spec)
        path = saver.maybe_save(trainer.actor_engine, 0, 0, 0)
        assert path.endswith("checkpoints/epoch0epochstep0globalstep0")
        other = _port_engine()
        other.load(SaveLoadMeta(path=path, weight_format="hf"))
        for (n, a), b in zip(trainer.actor_engine.model.named_parameters(), other.model.parameters()):
            assert torch.equal(a, b), n
        with pytest.raises(ValueError, match="'state'"):
            trainer.actor_engine.save(SaveLoadMeta(path=str(tmp_path / "o"), weight_format="orbax"))
    finally:
        trainer.close()


def test_reference_policy_feeds_the_kl_term():
    """``config.ref``: a frozen engine without optimizer state computes
    ``ref_logp`` each step; it never moves while the actor does."""
    mcfg = port_cfg(TINY_QWEN2)
    params = jax_params(TINY_QWEN2, seed=5)
    ref = TorchTrainEngine(tc.TrainEngineConfig(dtype="float32", param_dtype="float32", bucket_step=64),
                           model_config=mcfg, device="cpu", need_optimizer=False)
    ref.initialize(FinetuneSpec(1, 16, 4))
    ref.model.load_state_dict(convert.from_jax_params(params, mcfg))
    actor = _port_engine()
    actor.model.load_state_dict(convert.from_jax_params(params, mcfg))
    cfg = _cfg(total_train_steps=2, ref=tc.TrainEngineConfig(),
               actor=tc.PPOActorConfig(**ACTOR, kl_ctl=0.1, optimizer=tc.OptimizerConfig(lr=LR)))
    batches = [jdata.pad_sequences_to_tensors(_trajs(8, seed=30 + s)) for s in range(2)]
    trainer = PPOTrainer(cfg, [{"prompt_ids": [1]}] * 8, rollout=_StubRollout(batches, lambda p: p),
                         actor_engine=actor, ref_engine=ref)
    seen = []
    compute_logp = trainer.ref.compute_logp
    trainer.ref.compute_logp = lambda b: seen.append(1) or compute_logp(b)
    trainer.train()
    trainer.close()
    assert ref._opt is None and len(seen) == 2
    want = convert.from_jax_params(params, mcfg)
    assert all(torch.equal(p.detach(), want[n]) for n, p in ref.model.named_parameters())
    assert any(not torch.equal(p.detach(), want[n]) for n, p in actor.model.named_parameters())


def test_close_releases_the_trainer():
    """``train`` installs a SIGUSR2 handler (a bound method); ``close`` puts
    the previous one back, so nothing global keeps the trainer and its
    engines alive afterwards."""
    import gc
    import signal
    import weakref

    before = signal.getsignal(signal.SIGUSR2)
    batches = [jdata.pad_sequences_to_tensors(_trajs(8, seed=40))]
    trainer = PPOTrainer(_cfg(total_train_steps=1), [{"prompt_ids": [1]}] * 8,
                         rollout=_StubRollout(batches, lambda p: None), actor_engine=_port_engine())
    trainer.train()
    trainer.close()
    assert signal.getsignal(signal.SIGUSR2) == before
    ref = weakref.ref(trainer.actor_engine)
    del trainer
    gc.collect()
    assert ref() is None


# ---------------------------------------------------------------------------
# 3. the whole loop over HTTP
# ---------------------------------------------------------------------------


def _drain(client, engine, timeout=60.0):
    """Stop submissions and let the episodes in flight finish, so closing
    the client cancels nothing."""
    import time

    client.pause()
    deadline = time.monotonic() + timeout
    while (client.executor.staleness.stat.running or any(t is not None for t in engine._slot_task)) and (
        time.monotonic() < deadline
    ):
        time.sleep(0.01)


def _even_share(prompt, completions, prompt_ids, completion_ids, **kw):
    return float(np.mean(np.asarray(completion_ids) % 2 == 0))


def test_ppo_trainer_over_http(tmp_path):
    """3 global steps of ``PPOTrainer.train`` against the port's server:
    after every step the server's, the client's and the trainer's versions
    are global_step + 1 and the served weights equal the trainer's master
    weights cast to bf16; every batch is within the staleness bound; no
    request ends with "abort"; every hold answered fenced."""
    mcfg = port_cfg(TINY_QWEN2)
    acfg = tc.PPOActorConfig(optimizer=tc.OptimizerConfig(lr=LR), **{**ACTOR, "ppo_n_minibatches": 1},
                             adv_norm=tc.NormConfig(mean_level="group", std_level="group", group_size=4))
    eng = TorchTrainEngine(acfg, model_config=mcfg, device="cpu")
    eng.initialize(FinetuneSpec(1, 16, 4))
    eng.model.load_state_dict(convert.from_jax_params(jax_params(TINY_QWEN2, seed=7), mcfg))
    scfg = tc.ServerConfig(max_batch_size=8, max_seq_len=128, decode_steps_per_call=4, seed=0, host="127.0.0.1")
    srv = ServerThread(scfg, engine=DecodeEngine(scfg, params=eng.model.state_dict(), model_cfg=mcfg, device="cpu"))
    fences = []
    h_pause = srv.server.h_pause

    def h_pause_logged(d):
        status, out = h_pause(d)
        fences.append(out.get("fenced"))
        return status, out

    srv.server.h_pause = h_pause_logged
    srv.start()
    eta = 1
    client = RemoteTorchEngine(
        tc.InferenceEngineConfig(max_concurrent_rollouts=8, consumer_batch_size=4, max_head_offpolicyness=eta,
                                 request_timeout=120),
        addresses=[srv.address],
    )
    client.initialize()
    gconfig = GenerationHyperparameters(n_samples=4, max_new_tokens=8, temperature=1.0)
    cfg = _cfg(total_train_steps=N_STEPS, gconfig=gconfig, actor=acfg,
               stats_logger=tc.StatsLoggerConfig(fileroot=str(tmp_path)))
    rng = np.random.default_rng(0)
    dataset = [{"prompt_ids": rng.integers(20, 200, 4).tolist()} for _ in range(16)]
    trainer = PPOTrainer(cfg, dataset, rollout=client, actor_engine=eng)
    consumed, after_step = [], []
    prepare = client.prepare_batch

    def prepare_logged(*a, **k):
        b = prepare(*a, **k)
        consumed.append((b, client.get_version()))
        return b

    client.prepare_batch = prepare_logged
    commit = trainer.stats_logger.commit

    def commit_checked(epoch, step, gstep, stats):
        served = dict(srv.engine.model.named_parameters())
        same = all(torch.equal(p.detach().to(torch.bfloat16).float(), served[n].detach())
                   for n, p in eng.model.named_parameters())
        after_step.append((gstep, srv.engine.get_version(), client.get_version(), eng.get_version(), same))
        commit(epoch, step, gstep, stats)

    trainer.stats_logger.commit = commit_checked
    try:
        trainer.train(workflow=RLVRWorkflow(_even_share, gconfig))
        _drain(client, srv.engine)
        aborted = srv.engine.stats["aborted"]
    finally:
        trainer.close()
        srv.stop()
    assert after_step == [(s, s + 1, s + 1, s + 1, True) for s in range(N_STEPS)]
    assert aborted == 0 and fences == [True] * N_STEPS
    assert len(consumed) == N_STEPS
    for b, v in consumed:
        gen = np.asarray(b["loss_mask"]) > 0
        assert b["input_ids"].shape[0] == 16
        assert v - int(np.asarray(b["versions"])[gen].min()) <= eta
        for row, m in zip(np.asarray(b["versions"]), gen):
            assert (np.diff(row[m]) >= 0).all()


# ---------------------------------------------------------------------------
# 4. the learning twin (tests/test_rl_e2e.py)
# ---------------------------------------------------------------------------

TARGET = 7
GROUP = 4


def _target_reward(prompt, completions, prompt_ids, completion_ids, **kw):
    return 1.0 if TARGET in completion_ids else 0.0


def _first_token_hit_rate(client, dataset, n=16):
    import asyncio

    async def probe():
        reqs = [
            ModelRequest(input_ids=row["prompt_ids"],
                         gconfig=GenerationHyperparameters(n_samples=1, max_new_tokens=4, greedy=True))
            for row in dataset[:n]
        ]
        out = await asyncio.gather(*[client.agenerate(r) for r in reqs])
        await client.close_loop_connections()
        return float(np.mean([TARGET in r.output_tokens for r in out]))

    return asyncio.run(probe())


@pytest.mark.slow  # as tests/test_rl_e2e.py:157
def test_rl_learns_target_token(tmp_path):
    """The config, reward and bar of the JAX test, on the bf16 serving mode."""
    _learns_target_token(tmp_path, "bf16")


@pytest.mark.slow  # as tests/test_rl_e2e.py:157
def test_rl_learns_target_token_int8_serving(tmp_path):
    """The JAX test's int8 serving mode: int8 weights and KV pages, the
    updates on the q8 wire; the behaviour logprobs are the quantized
    server's own, which the decoupled loss corrects."""
    _learns_target_token(tmp_path, "int8")


def _learns_target_token(tmp_path, quant: str):
    mcfg = port_cfg(TINY_QWEN2)
    actor_cfg = tc.PPOActorConfig(
        dtype="float32",
        param_dtype="float32",
        optimizer=tc.OptimizerConfig(lr=2e-2, lr_scheduler_type="constant"),
        mb_spec=tc.MicroBatchSpec(max_tokens_per_mb=100_000),
        bucket_step=64,
        group_size=GROUP,
        ppo_n_minibatches=1,
        adv_norm=tc.NormConfig(mean_level="group", std_level="group", group_size=GROUP),
        kl_ctl=0.0,
        use_decoupled_loss=True,
        prox_logp_mode="recompute",
        eps_clip=0.4,
        temperature=1.0,
    )
    engine = TorchTrainEngine(actor_cfg, model_config=mcfg, device="cpu")
    engine.initialize(FinetuneSpec(1, 32, 8))
    q = "int8" if quant == "int8" else "none"
    scfg = tc.ServerConfig(max_batch_size=8, max_seq_len=64, decode_steps_per_call=4, seed=0, host="127.0.0.1",
                           quantization=q, kv_quantization=q)
    server = ServerThread(
        scfg, engine=DecodeEngine(scfg, params=engine.model.state_dict(), model_cfg=mcfg, device="cpu")
    )
    server.start()
    rollout = RemoteTorchEngine(
        tc.InferenceEngineConfig(max_concurrent_rollouts=8, consumer_batch_size=4, max_head_offpolicyness=2,
                                 request_timeout=300),
        addresses=[server.address],
    )
    rollout.initialize()
    cfg = tc.PPOConfig(
        experiment_name="e2e",
        trial_name="t0",
        total_train_epochs=12,
        weight_update_mode="mem",
        preemption=tc.PreemptionConfig(enabled=False),
        gconfig=GenerationHyperparameters(n_samples=GROUP, max_new_tokens=4, temperature=1.0),
        train_dataset=tc.DatasetConfig(batch_size=4, shuffle=True),
        actor=actor_cfg,
        server=scfg,
        stats_logger=tc.StatsLoggerConfig(fileroot=str(tmp_path)),
    )
    rng = np.random.default_rng(0)
    dataset = [{"prompt_ids": rng.integers(20, 200, 4).tolist()} for _ in range(32)]
    trainer = PPOTrainer(cfg, dataset, rollout=rollout, actor_engine=engine)
    assert trainer.weight_update_meta.wire_format == ("q8" if quant == "int8" else "bf16")
    try:
        before = _first_token_hit_rate(rollout, dataset)
        trainer.train(workflow=RLVRWorkflow(_target_reward, cfg.gconfig))
        _drain(rollout, server.engine)
        after = _first_token_hit_rate(rollout, dataset)
        assert after > max(0.5, before + 0.3), (before, after)
        assert engine.get_version() > 0
        assert server.engine.get_version() == engine.get_version()
    finally:
        trainer.close()
        server.stop()


def test_stateful_dataloader_matches_jax():
    """The same batches in the same order for the same seed, and the same
    state_dict, across two epochs and a resume."""
    from areal_tpu.utils.data import StatefulDataLoader as JLoader
    from areal_tpu_torch.utils.data import StatefulDataLoader as TLoader

    rows = [{"i": i} for i in range(10)]
    for kw in (dict(batch_size=3, shuffle=True, seed=4), dict(batch_size=4, shuffle=False, drop_last=False)):
        j, t = JLoader(rows, **kw), TLoader(rows, **kw)
        assert len(j) == len(t)
        for _ in range(2):
            assert list(j) == list(t)
            assert j.state_dict() == t.state_dict()
        it_j, it_t = iter(j), iter(t)
        assert next(it_j) == next(it_t) and j.state_dict() == t.state_dict()
        j2, t2 = JLoader(rows, **kw), TLoader(rows, **kw)
        j2.load_state_dict(j.state_dict())
        t2.load_state_dict(t.state_dict())
        assert list(j2) == list(t2)


def test_step_timeline_identity():
    """The port's timeline keeps the JAX one's identity: the phases and
    other_s sum to total_s; engine spans are suppressed inside an explicit
    phase; the stat keys are the JAX ones."""
    import time

    from areal_tpu.observability import step_timeline as jst
    from areal_tpu_torch.observability import step_timeline as tst

    rec = tst.StepTimelineRecorder()
    tl = rec.start(0)
    with tst.engine_phase("forward_backward"):
        time.sleep(0.01)
    with tl.phase("ckpt_eval"):
        with tst.engine_phase("forward_backward"):
            time.sleep(0.01)
    bd = rec.complete(tl, tokens=100.0)
    assert sum(bd[f"{p}_s"] for p in tst.PHASES) + bd["other_s"] == pytest.approx(bd["total_s"], abs=1e-12)
    assert 0.01 <= bd["forward_backward_s"] < bd["ckpt_eval_s"] + 0.01
    assert tst.PHASES == jst.PHASES
    assert set(tst.breakdown_stat_keys(bd)) == set(jst.breakdown_stat_keys(bd))
    assert tst.format_phase_line(bd) == jst.format_phase_line(bd)
    assert tst.matmul_params(port_cfg(TINY_QWEN2)) == __import__(
        "areal_tpu.observability.hw_accounting", fromlist=["x"]
    ).transformer_param_counts(TINY_QWEN2)["matmul"]
