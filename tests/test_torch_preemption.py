"""The preemption drain (the twins of ``tests/test_preemption.py:148-189``,
``:281`` and the trainer half of ``:594``): the handler's state machine in
both packages, a real signal that only sets the flag, the drainer thread,
the executor's waits raising on interrupt, and the port's ``PPOTrainer``
over HTTP preempted after step 1, dumping the last completed step and
leaving ``train``, then relaunched to resume at step 2 with the dumped
state bit for bit. With the trajectory journal on, a preemption after the
step's batch was popped and one during its rollout wait: the relaunch
replays what was accepted and not trained on, and its first batch is the
journaled trajectories, bit for bit, not regenerated ones."""

import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from areal_tpu.robustness import preemption as jpre
from areal_tpu_torch.api import config as tc
from areal_tpu_torch.api.io_struct import FinetuneSpec, GenerationHyperparameters
from areal_tpu_torch.engine.train_engine import TorchTrainEngine
from areal_tpu_torch.inference.client import RemoteTorchEngine
from areal_tpu_torch.inference.decode_engine import DecodeEngine
from areal_tpu_torch.inference.server import ServerThread
from areal_tpu_torch.infra.workflow_executor import RolloutInterrupted, WorkflowExecutor
from areal_tpu_torch.models import convert
from areal_tpu_torch.robustness import preemption as tpre
from areal_tpu_torch.trainer.rl_trainer import PPOTrainer
from areal_tpu_torch.workflow.rlvr import RLVRWorkflow

from test_torch_checkpoint import _state
from test_torch_ppo_trainer_loop import ACTOR, LR, _drain, _even_share, _StubRollout
from test_torch_qwen import jax_params, port_cfg
from test_torch_train_engine import _trajs
from tpu_testing import TINY_QWEN2


@pytest.mark.parametrize("pre", [jpre, tpre], ids=["jax", "port"])
def test_handler_state_machine(pre):
    h = pre.PreemptionHandler(role="test", grace_s=5.0)
    assert h.state == pre.RUNNING and h.remaining() == float("inf") and h.deadline() is None
    h.request(signal.SIGTERM)
    assert h.state == pre.DRAINING and h.signum == signal.SIGTERM
    assert 0.0 < h.remaining() <= 5.0
    h.note_draining()
    h.note_draining()  # idempotent: counted once
    h.note_drained(0.1)
    assert h.state == pre.DRAINED


def test_handler_counts_once_and_records_the_signal():
    from areal_tpu_torch.observability import catalog
    from areal_tpu_torch.observability import timeline as tl_mod

    c = catalog.preemption_metrics().preemptions.labels(role="count-test")
    n0 = c.get()
    h = tpre.PreemptionHandler(role="count-test", grace_s=3.0)
    h.request(signal.SIGUSR1)
    h.note_draining()
    h.note_draining()
    assert c.get() == n0 + 1
    ev = [e for e in tl_mod.get_flight_recorder().snapshot()["events"] if e["kind"] == "preempt_signal"]
    assert ev[-1]["data"] == {"role": "count-test", "signum": signal.SIGUSR1, "grace_s": 3.0}


def test_handler_real_signal_sets_flag_only():
    h = tpre.PreemptionHandler(role="test", grace_s=5.0, handle_sigusr1=True)
    prev = signal.getsignal(signal.SIGUSR1)
    assert h.install()
    try:
        signal.raise_signal(signal.SIGUSR1)
        assert h.requested.wait(2.0)
        assert h.signum == signal.SIGUSR1 and h.state == tpre.DRAINING
        assert not h.drained.is_set()  # the handler only set the flag
    finally:
        h.uninstall()
    assert signal.getsignal(signal.SIGUSR1) == prev


def test_handler_install_off_the_main_thread():
    h = tpre.PreemptionHandler(role="test")
    box = []
    t = threading.Thread(target=lambda: box.append(h.install()))
    t.start()
    t.join()
    assert box == [False]
    h.request()
    assert h.state == tpre.DRAINING


def test_handler_drainer_thread_runs_after_request():
    h = tpre.PreemptionHandler(role="test", grace_s=5.0)
    ran = threading.Event()
    h.spawn_drainer(lambda handler: ran.set(), exit_code=None)
    assert not ran.wait(0.05)
    h.request()
    assert ran.wait(5.0)
    assert h.drained.wait(5.0) and h.state == tpre.DRAINED


class _VersionedEngine:
    def __init__(self, version=0):
        self.version = version

    def get_version(self):
        return self.version


def test_executor_wait_raises_on_interrupt():
    """Once the interrupt is set, ``wait`` and ``prepare_batch`` raise
    ``RolloutInterrupted`` instead of waiting out their timeout."""
    ex = WorkflowExecutor(
        tc.InferenceEngineConfig(max_concurrent_rollouts=4, consumer_batch_size=2, max_head_offpolicyness=2),
        engine=_VersionedEngine(),
    )
    ev = threading.Event()
    ex.set_interrupt(ev)
    ev.set()
    with pytest.raises(RolloutInterrupted):
        ex.wait(1, timeout=5.0)
    with pytest.raises(RolloutInterrupted):
        ex.prepare_batch([[{"prompt_ids": [1]}]], workflow=RLVRWorkflow(_even_share, GenerationHyperparameters()))
    ex.set_interrupt(None)
    with pytest.raises(TimeoutError):
        ex.wait(1, timeout=0.05)


# ---------------------------------------------------------------------------
# the trainer: preempted, dumped, relaunched
# ---------------------------------------------------------------------------


def _cfg(root, steps, gconfig=None, actor=None):
    cfg = tc.PPOConfig(
        experiment_name="preempt",
        trial_name="t0",
        total_train_steps=steps,
        weight_update_mode="disk",
        train_dataset=tc.DatasetConfig(batch_size=4),
        actor=actor or tc.PPOActorConfig(optimizer=tc.OptimizerConfig(lr=LR), **ACTOR),
        saver=tc.SaverConfig(fileroot=root),
        checkpointer=tc.SaverConfig(fileroot=root),
        evaluator=tc.EvaluatorConfig(fileroot=root),
        recover=tc.RecoverConfig(mode="auto", freq_steps=1, fileroot=root),
        stats_logger=tc.StatsLoggerConfig(fileroot=root),
        preemption=tc.PreemptionConfig(grace_s=60.0),
        gconfig=gconfig or GenerationHyperparameters(),
    )
    cfg.cluster.fileroot = root
    return cfg


def test_trainer_preempted_after_step_1_resumes_at_step_2(tmp_path):
    """``PPOTrainer.train`` over HTTP, disk weight updates, a recover dump
    every step: a preemption requested after step 1 stops the loop before
    step 2, the emergency dump holds step 1's state, ``train`` returns with
    ``preempted`` set and ``close`` puts SIGTERM back. A relaunch (a fresh
    engine of other weights, a fresh client and trainer) resumes at step 2
    with the dumped parameters, moments and step count bit for bit, pushes
    them to the server first, and its step 2 runs."""
    mcfg = port_cfg(TINY_QWEN2)
    acfg = tc.PPOActorConfig(optimizer=tc.OptimizerConfig(lr=LR), **{**ACTOR, "ppo_n_minibatches": 1},
                             adv_norm=tc.NormConfig(mean_level="group", std_level="group", group_size=4))
    gconfig = GenerationHyperparameters(n_samples=4, max_new_tokens=6, temperature=1.0)
    scfg = tc.ServerConfig(max_batch_size=8, max_seq_len=128, decode_steps_per_call=4, seed=0, host="127.0.0.1")
    srv = ServerThread(scfg, engine=DecodeEngine(scfg, params=convert.from_jax_params(
        jax_params(TINY_QWEN2, seed=7), mcfg), model_cfg=mcfg, device="cpu"))
    srv.start()
    rng = np.random.default_rng(0)
    dataset = [{"prompt_ids": rng.integers(20, 200, 4).tolist()} for _ in range(16)]
    root = str(tmp_path)
    client_cfg = tc.InferenceEngineConfig(max_concurrent_rollouts=8, consumer_batch_size=4, max_head_offpolicyness=1,
                                          request_timeout=120)

    def launch(seed):
        eng = TorchTrainEngine(acfg, model_config=mcfg, device="cpu")
        eng.initialize(FinetuneSpec(1, 16, 4))
        eng.model.load_state_dict(convert.from_jax_params(jax_params(TINY_QWEN2, seed=seed), mcfg))
        client = RemoteTorchEngine(client_cfg, addresses=[srv.address])
        client.initialize()
        trainer = PPOTrainer(_cfg(root, 3, gconfig, acfg), dataset, rollout=client, actor_engine=eng)
        steps = []
        commit = trainer.stats_logger.commit

        def commit_logged(epoch, step, gstep, stats):
            steps.append(gstep)
            commit(epoch, step, gstep, stats)

        trainer.stats_logger.commit = commit_logged
        return eng, client, trainer, steps

    sigterm = signal.getsignal(signal.SIGTERM)
    eng, client, trainer, steps = launch(seed=7)
    assert trainer.recover_info is None
    dumped = {}
    emergency = trainer.recover_handler.dump_emergency

    def dump_recorded(engine, step_info, **kw):
        dumped["state"], dumped["step"] = _state(engine), step_info.global_step
        return emergency(engine, step_info, **kw)

    trainer.recover_handler.dump_emergency = dump_recorded
    commit = trainer.stats_logger.commit

    def preempt_after_step_1(epoch, step, gstep, stats):
        commit(epoch, step, gstep, stats)
        if gstep == 1:
            trainer.preemption.request(signal.SIGTERM)

    trainer.stats_logger.commit = preempt_after_step_1
    try:
        trainer.train(workflow=RLVRWorkflow(_even_share, gconfig))
        assert signal.getsignal(signal.SIGTERM) != sigterm  # installed while training
        assert trainer.preempted and trainer.preemption.state == tpre.DRAINED
        assert steps == [0, 1] and dumped["step"] == 1
        info, ckpt = trainer.recover_handler.read_recover_info()
        assert info.last_step_info.global_step == 1 and os.path.isdir(ckpt)
        _drain(client, srv.engine)
    finally:
        trainer.close()
    assert signal.getsignal(signal.SIGTERM) == sigterm

    eng2, client2, trainer2, steps2 = launch(seed=9)
    try:
        assert trainer2.recover_info.last_step_info.next().global_step == 2
        got = _state(eng2)
        assert got.keys() == dumped["state"].keys()
        assert all(torch.equal(got[k], dumped["state"][k]) for k in got), "restored state differs from the dump"
        assert eng2.get_version() == srv.engine.get_version() == client2.get_version() == 2
        served = dict(srv.engine.model.named_parameters())
        assert all(torch.equal(served[n].detach(), p.detach()) for n, p in eng2.model.named_parameters())
        trainer2.train(workflow=RLVRWorkflow(_even_share, gconfig))
        assert steps2 == [2] and not trainer2.preempted
        assert srv.engine.get_version() == 3 and eng2._opt.count == 3
        _drain(client2, srv.engine)
    finally:
        trainer2.close()
        srv.stop()


def test_preemption_during_the_rollout_wait(tmp_path):
    """A signal that lands while ``prepare_batch`` waits: the executor's
    ``RolloutInterrupted`` aborts the step, the emergency dump holds the
    last completed step (0), and nothing of step 1 is committed."""
    from areal_tpu.utils import data as jdata

    batches = [jdata.pad_sequences_to_tensors(_trajs(8, seed=20 + s)) for s in range(2)]

    class _InterruptedRollout(_StubRollout):
        trainer = None

        def prepare_batch(self, dataloader, workflow=None, should_accept_fn=None):
            if len(self.pushed) == 1:
                self.trainer.preemption.request(signal.SIGTERM)
                raise RolloutInterrupted("rollout wait interrupted (preemption drain in progress)")
            return super().prepare_batch(dataloader, workflow, should_accept_fn)

    mcfg = port_cfg(TINY_QWEN2)
    eng = TorchTrainEngine(tc.PPOActorConfig(optimizer=tc.OptimizerConfig(lr=LR), **ACTOR), model_config=mcfg,
                           device="cpu")
    eng.initialize(FinetuneSpec(1, 16, 4))
    stub = _InterruptedRollout(batches, lambda p: p)
    cfg = _cfg(str(tmp_path), 2)
    cfg.weight_update_mode = "mem"
    trainer = PPOTrainer(cfg, [{"prompt_ids": [1]}] * 8, rollout=stub, actor_engine=eng)
    stub.trainer = trainer
    committed = []
    trainer.stats_logger.commit = lambda e, s, g, st: committed.append(g)
    try:
        trainer.train()
    finally:
        trainer.close()
    assert trainer.preempted and committed == [0]
    assert stub.calls[-2:] == [("pause",), ("destroy",)]  # the drain paused the rollout; close destroyed it
    assert trainer.recover_handler.read_recover_info()[0].last_step_info.global_step == 0


# ---------------------------------------------------------------------------
# the journal across a preemption (the trainer half of test_preemption.py:594)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("point", ["after_pop", "rollout_wait"])
def test_relaunch_first_batch_comes_from_the_journal(tmp_path, monkeypatch, point):
    """``rollout.journal.enabled``: step 0 trains, then the preemption
    lands in step 1, after its batch was popped (``after_pop``: its
    consumption marker post-dates the dump of step 0, so it replays) or
    as its rollout wait begins (``rollout_wait``, once a batch's worth is
    accepted). The journal is sealed and the lineage ring dumped; a
    relaunch replays every accepted trajectory that no checkpointed step
    trained on, none dropped, and its first batch is the first replayed
    trajectories bit for bit (``after_pop``: the very batch popped before
    the preemption), their lineage ids rewritten to fresh records."""
    from areal_tpu_torch.infra.trajectory_journal import TrajectoryJournal, default_journal_dir
    from areal_tpu_torch.observability import lineage
    from areal_tpu_torch.utils.data import concat_padded_tensor_dicts

    monkeypatch.setenv("AREAL_FLIGHT_DIR", str(tmp_path / "flight"))
    mcfg = port_cfg(TINY_QWEN2)
    acfg = tc.PPOActorConfig(optimizer=tc.OptimizerConfig(lr=LR), **{**ACTOR, "ppo_n_minibatches": 1},
                             adv_norm=tc.NormConfig(mean_level="group", std_level="group", group_size=4))
    gconfig = GenerationHyperparameters(n_samples=4, max_new_tokens=6, temperature=1.0)
    scfg = tc.ServerConfig(max_batch_size=8, max_seq_len=128, decode_steps_per_call=4, seed=0, host="127.0.0.1")
    srv = ServerThread(scfg, engine=DecodeEngine(scfg, params=convert.from_jax_params(
        jax_params(TINY_QWEN2, seed=7), mcfg), model_cfg=mcfg, device="cpu"))
    srv.start()
    rng = np.random.default_rng(1)
    dataset = [{"prompt_ids": rng.integers(20, 200, 4).tolist()} for _ in range(16)]
    root = str(tmp_path)
    rollout_cfg = tc.InferenceEngineConfig(max_concurrent_rollouts=8, consumer_batch_size=4, max_head_offpolicyness=1,
                                           request_timeout=120, journal=tc.TrajectoryJournalConfig(enabled=True))

    def launch(steps):
        eng = TorchTrainEngine(acfg, model_config=mcfg, device="cpu")
        eng.initialize(FinetuneSpec(1, 16, 4))
        eng.model.load_state_dict(convert.from_jax_params(jax_params(TINY_QWEN2, seed=7), mcfg))
        client = RemoteTorchEngine(rollout_cfg, addresses=[srv.address])
        client.initialize()
        cfg = _cfg(root, steps, gconfig, acfg)
        cfg.rollout = rollout_cfg
        trainer = PPOTrainer(cfg, dataset, rollout=client, actor_engine=eng)
        batches, committed = [], []
        prepare = client.prepare_batch

        def prepare_recorded(*a, **k):
            batches.append(None)
            out = prepare(*a, **k)
            batches[-1] = out
            return out

        client.prepare_batch = prepare_recorded
        trainer.stats_logger.commit = lambda e, s, g, st: committed.append(g)
        return client, trainer, batches, committed

    client, trainer, batches, committed = launch(3)
    prepare = client.prepare_batch

    def prepare_preempting(*a, **k):
        if len(batches) == 1:  # step 1
            if point == "rollout_wait":
                deadline = time.monotonic() + 120
                while len(client.executor._results) < 4 and time.monotonic() < deadline:
                    time.sleep(0.01)
                trainer.preemption.request(signal.SIGTERM)
                return prepare(*a, **k)  # raises RolloutInterrupted
            out = prepare(*a, **k)
            trainer.preemption.request(signal.SIGTERM)
            return out
        return prepare(*a, **k)

    client.prepare_batch = prepare_preempting
    try:
        trainer.train(workflow=RLVRWorkflow(_even_share, gconfig))
        assert trainer.preempted and committed == [0]
        assert len(batches) == 2 and (batches[1] is None) == (point == "rollout_wait")
        _drain(client, srv.engine)  # the episodes in flight land in the journal too
        # an accepted episode leaves the running count before its append:
        # wait for the last append, not only for the count
        deadline = time.monotonic() + 30
        while (trainer.journal.stats()["appended"] < client.executor.staleness.stat.accepted
               and time.monotonic() < deadline):
            time.sleep(0.01)
        unconsumed = [tid for tid, _, _ in client.executor._results]
        appended = trainer.journal.stats()["appended"]
    finally:
        trainer.close()
    assert list((tmp_path / "flight").glob("lineage_*_preempt.json"))
    jdir = default_journal_dir(root, "preempt", "t0")
    assert all(n.endswith(".jrnl") for n in os.listdir(jdir))  # sealed
    replay, dropped, n_consumed = TrajectoryJournal(jdir, fsync=False).pending_for_replay(1, 1)
    assert not dropped and n_consumed == 4 and appended == 4 + len(replay)
    if point == "after_pop":  # the popped batch is the journal's first unconsumed four, in order
        lids = list(dict.fromkeys(np.asarray(batches[1]["lineage_id"]).tolist()))
        assert lids == [e.lineage["lineage_id"] for e in replay[:4]]
        assert [e.task_id for e in replay[4:]] == unconsumed
    else:
        assert [e.task_id for e in replay] == unconsumed and len(unconsumed) >= 4
    assert len(replay) >= 4

    client2, trainer2, batches2, committed2 = launch(2)
    try:
        assert trainer2.recover_info.last_step_info.global_step == 0
        assert trainer2.last_replay["replayed"] == len(replay) and trainer2.last_replay["dropped"] == 0
        trainer2.train(workflow=RLVRWorkflow(_even_share, gconfig))
        assert committed2 == [1] and not trainer2.preempted
        first = batches2[0]
        want = concat_padded_tensor_dicts([e.traj for e in replay[:4]])
        assert set(first) - {"prox_logp"} == set(want)  # the step adds the recomputed logprobs
        for k in ("input_ids", "attention_mask", "loss_mask", "logprobs", "versions", "rewards"):
            np.testing.assert_array_equal(np.asarray(first[k]), np.asarray(want[k]), err_msg=k)
        ring = lineage.get_lineage()
        new = list(dict.fromkeys(np.asarray(first["lineage_id"]).tolist()))
        assert [ring.get(lid).task_id for lid in new] == [e.task_id for e in replay[:4]]
        assert all(ring.get(lid).journaled and ring.get(lid).trained_version == 1 for lid in new)
        _drain(client2, srv.engine)
    finally:
        trainer2.close()
        srv.stop()
