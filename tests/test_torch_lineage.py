"""The learning-health observatory and the trajectory lineage ring: the port
(``areal_tpu_torch/observability/lineage.py``, ``trainer/ppo.py``'s lag
buckets and per-sequence attribution, the train engine's segment map, the
executor's lineage stamp) against the JAX package on the same seeded numpy
inputs. Twins of ``tests/test_learning_obs.py:151``, ``:160``, ``:191``,
``:208``, ``:214``, ``:279``, ``:295``, ``:326`` and ``:352``, plus
``lineage_to_trace_events`` on one snapshot, ``grpo_loss_fn``'s ``lag_*``
and ``seq__*`` stats on one packed grid (within 1e-6 relative in f32), and
one ``ppo_update``'s ring joins and ``areal_train_lag_*`` samples.

Both lineage rings count ids process-wide: every test that compares ids
resets both rings first (the ``fresh_rings`` fixture)."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.config import InferenceEngineConfig as JInferenceEngineConfig
from areal_tpu.api.config import MeshConfig as JMeshConfig
from areal_tpu.api.config import MicroBatchSpec as JMicroBatchSpec
from areal_tpu.api.config import OptimizerConfig as JOptimizerConfig
from areal_tpu.api.config import PPOActorConfig as JPPOActorConfig
from areal_tpu.api.io_struct import FinetuneSpec as JFinetuneSpec
from areal_tpu.engine.train_engine import JaxTrainEngine
from areal_tpu.infra import staleness_manager as jsm
from areal_tpu.infra.trajectory_journal import TrajectoryJournal as JJournal
from areal_tpu.infra.workflow_executor import WorkflowExecutor as JWorkflowExecutor
from areal_tpu.observability import catalog as jcat
from areal_tpu.observability import lineage as jlin
from areal_tpu.observability import timeline as jtl
from areal_tpu.parallel import mesh as mesh_lib
from areal_tpu.trainer import ppo as jppo
from areal_tpu.utils import grid as jgrid
from areal_tpu_torch.api.config import InferenceEngineConfig, MicroBatchSpec, OptimizerConfig, PPOActorConfig
from areal_tpu_torch.api.io_struct import FinetuneSpec
from areal_tpu_torch.engine.train_engine import TorchTrainEngine
from areal_tpu_torch.infra import staleness_manager as tsm
from areal_tpu_torch.infra.trajectory_journal import TrajectoryJournal as TJournal
from areal_tpu_torch.infra.workflow_executor import WorkflowExecutor
from areal_tpu_torch.models import convert
from areal_tpu_torch.observability import catalog as tcat
from areal_tpu_torch.observability import lineage as tlin
from areal_tpu_torch.observability import timeline as ttl
from areal_tpu_torch.trainer import ppo as tppo

from test_torch_ppo import _batch, _configs, _device_grid, _Engine
from test_torch_qwen import port_cfg
from tpu_testing import TINY_QWEN2

BUCKETS = tsm.LAG_BUCKET_LABELS
# f32 on both sides; the reductions' summation orders differ
REL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture
def fresh_rings(monkeypatch):
    """Both packages' process rings, new: lineage ids count from 0 again."""
    j, t = jlin.TrajectoryLineage(), tlin.TrajectoryLineage()
    monkeypatch.setattr(jlin, "_LINEAGE", j)
    monkeypatch.setattr(tlin, "_LINEAGE", t)
    return j, t


COMMON = dict(
    dtype="float32",
    param_dtype="float32",
    bucket_step=64,
    group_size=1,
    ppo_n_minibatches=1,
    adv_norm=None,
    kl_ctl=0.0,
    use_decoupled_loss=True,
    prox_logp_mode="recompute",
    # wild prox-vs-behave gaps in the synthetic batch: a tight cap makes a
    # non-empty cap-hit tail for the identity to cover
    behav_imp_weight_cap=1.5,
)


def _engines(mb_tokens=None, version=6):
    """The JAX engine on one CPU device and the port's engine on the CPU
    holding its weights (``test_learning_obs.py``'s actor config)."""
    jcfg = JPPOActorConfig(
        init_from_scratch=True, mesh=JMeshConfig(data=1), mb_spec=JMicroBatchSpec(max_tokens_per_mb=mb_tokens),
        optimizer=JOptimizerConfig(lr=5e-3, lr_scheduler_type="constant"), **COMMON,
    )
    jeng = JaxTrainEngine(jcfg, model_config=TINY_QWEN2)
    jeng.initialize(JFinetuneSpec(1, 64, 4), mesh=mesh_lib.make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    jeng.set_version(version)
    tcfg = PPOActorConfig(
        mb_spec=MicroBatchSpec(max_tokens_per_mb=mb_tokens),
        optimizer=OptimizerConfig(lr=5e-3, lr_scheduler_type="constant"), **COMMON,
    )
    teng = TorchTrainEngine(tcfg, model_config=port_cfg(TINY_QWEN2), device="cpu")
    teng.initialize(FinetuneSpec(1, 64, 4))
    teng.model.load_state_dict(convert.from_jax_params(jax.tree.map(np.asarray, jeng.params), port_cfg(TINY_QWEN2)))
    teng.set_version(version)
    return jppo.PPOActor(jcfg, jeng), tppo.PPOActor(tcfg, teng)


def _mixed_version_batch(v_theta: int, n=4, L=24, seed=0):
    """``test_learning_obs.py:64``: per-sequence version tags at lag 0, lag
    1, a zero-pause mid-commit split (v-3 -> v-1 inside one sequence) and a
    lag-5 tail."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 250, (n, L)).astype(np.int32)
    lm = np.zeros((n, L), np.float32)
    lm[:, 4:] = 1.0
    versions = np.zeros((n, L), np.int32)
    versions[0, :] = v_theta
    versions[1, :] = v_theta - 1
    versions[2, : L // 2] = v_theta - 3
    versions[2, L // 2 :] = v_theta - 1
    versions[3:, :] = v_theta - 5
    versions[:, :4] = -1  # prompt tokens are untagged
    return {
        "input_ids": ids,
        "attention_mask": np.ones((n, L), bool),
        "loss_mask": lm,
        "logprobs": rng.normal(-6.5, 1.5, (n, L)).astype(np.float32),
        "versions": versions,
        "rewards": rng.normal(0.5, 1.0, n).astype(np.float32),
        "seq_no_eos_mask": np.zeros((n,), bool),
    }


def _run_update(actor, batch, prox=None):
    batch = dict(batch)
    batch["prox_logp"] = actor.compute_logp(batch) if prox is None else prox
    stats = actor.ppo_update(actor.compute_advantages(batch))
    assert len(stats) == 1  # one minibatch: the identity is exact
    return stats[0]


def _assert_bucket_identity(s):
    share = {b: s[f"lag_{b}/token_share"] for b in BUCKETS}
    assert sum(share.values()) == pytest.approx(1.0, abs=1e-6)
    assert sum(share[b] * s[f"lag_{b}/clip_ratio"] for b in BUCKETS) == pytest.approx(s["clip_ratio"], abs=1e-6)
    assert sum(share[b] * s[f"lag_{b}/approx_kl"] for b in BUCKETS) == pytest.approx(s["approx_kl"], abs=1e-6)
    bshare = {b: s[f"lag_{b}/behave_share"] for b in BUCKETS}
    assert sum(bshare.values()) == pytest.approx(1.0, abs=1e-6)
    assert sum(bshare[b] * s[f"lag_{b}/behave_approx_kl"] for b in BUCKETS) == pytest.approx(
        s["behave_approx_kl"], abs=1e-6
    )
    cap_total = sum(share[b] * s[f"lag_{b}/cap_hit_share"] for b in BUCKETS)
    assert cap_total == pytest.approx(1.0 - s["unclipped_behave_ratio"], abs=1e-6)
    assert cap_total > 0
    return share


def _assert_lag_stats_match(got: dict, want: dict):
    """Every lag_* key on both sides; shares (from the version tags) within
    f32 noise, the loss-dependent ratios to 1e-4 (the two models' logprobs
    differ in f32 summation order, ~1e-6)."""
    lag = sorted(k for k in want if k.startswith("lag_"))
    assert lag and lag == sorted(k for k in got if k.startswith("lag_"))
    for k in lag:
        tol = REL if k.endswith("token_share") else dict(rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


# ---------------------------------------------------------------------------
# the identity, through the real engines (test_learning_obs.py:151-205)
# ---------------------------------------------------------------------------


def test_lag_bucket_stats_recompose_batch_scalars():
    jactor, tactor = _engines()
    batch = _mixed_version_batch(v_theta=6)
    want, got = _run_update(jactor, batch), _run_update(tactor, batch)
    share = _assert_bucket_identity(got)
    _assert_bucket_identity(want)
    # the split row feeds both the lag-3 (bucket "2") and lag-1 populations
    assert share["0"] > 0 and share["1"] > 0 and share["2"] > 0 and share["4+"] > 0
    _assert_lag_stats_match(got, want)


def test_identity_survives_microbatch_split():
    """A ``max_tokens_per_mb`` split whose microbatches carry different
    bucket mixes and uneven token weights: the ratios are taken after the
    engine's fold, so the recombination stays exact."""
    jactor, tactor = _engines(mb_tokens=64)
    batch = _mixed_version_batch(v_theta=6, n=5)
    # both sides on the port's proximal logprobs: JAX's forward_batch puts a
    # re-packed grid's rows on the wrong sequences (ROADMAP Queue C, C-ref 11)
    prox = tactor.compute_logp(batch)
    want, got = _run_update(jactor, batch, prox), _run_update(tactor, batch, prox)
    assert got["n_microbatches"] == want["n_microbatches"] > 1
    _assert_bucket_identity(got)
    _assert_lag_stats_match(got, want)


def test_mid_commit_split_row_spans_two_buckets():
    jactor, tactor = _engines()
    batch = _mixed_version_batch(v_theta=6)
    batch["loss_mask"][0] = batch["loss_mask"][1] = batch["loss_mask"][3] = 0  # only the split row
    want, got = _run_update(jactor, batch), _run_update(tactor, batch)
    assert got["lag_1/token_share"] > 0 and got["lag_2/token_share"] > 0
    assert got["lag_0/token_share"] == pytest.approx(0.0, abs=1e-6)
    assert got["lag_4+/token_share"] == pytest.approx(0.0, abs=1e-6)
    assert got["lag_1/token_share"] + got["lag_2/token_share"] == pytest.approx(1.0, abs=1e-6)
    _assert_lag_stats_match(got, want)


def test_host_bucketing_matches_jit_edges():
    for lag, expect in ((0, 0), (1, 1), (2, 2), (3, 2), (4, 3), (32, 3)):
        assert tsm.lag_bucket_index(lag) == jsm.lag_bucket_index(lag) == expect
    assert tsm.LAG_BUCKET_LABELS == jsm.LAG_BUCKET_LABELS
    assert tsm.LAG_BUCKET_LABELS[tsm.lag_bucket_index(5)] == tsm.HIGH_LAG_BUCKET


def _lag_samples(cat) -> dict:
    m = cat.learning_health_metrics()
    fams = ("clip_ratio", "behave_kl", "approx_kl", "imp_weight", "cap_hit", "token_share",
            "tokens_total", "clipped_total", "capped_total", "behave_kl_sum")
    return {(f, b): getattr(m, f).labels(lag_bucket=b).get() for f in fams for b in BUCKETS}


def test_per_sequence_attribution_joins_lineage(fresh_rings):
    """The seq__* sums map back through the segment map onto the stamped
    lineage ids: per-trajectory token counts equal each sequence's valid
    tokens; both rings join with the same values; the areal_train_lag_*
    samples move alike in both registries."""
    jring, tring = fresh_rings
    jactor, tactor = _engines()
    batch = _mixed_version_batch(v_theta=6, seed=3)
    lids = [(jring.register(task_id=f"t{i}", head_version=6, tail_version=6),
             tring.register(task_id=f"t{i}", head_version=6, tail_version=6)) for i in range(4)]
    assert all(a == b for a, b in lids)
    batch["lineage_id"] = np.asarray([a for a, _ in lids], np.int64)
    j0, t0 = _lag_samples(jcat), _lag_samples(tcat)
    _run_update(jactor, batch)
    _run_update(tactor, batch)
    j1, t1 = _lag_samples(jcat), _lag_samples(tcat)
    seq, jseq = tactor.engine.last_seq_stats, jactor.engine.last_seq_stats
    assert seq is not None and seq.keys() == jseq.keys()
    per_seq_valid = np.roll(np.asarray(batch["loss_mask"]), -1, axis=-1)[:, :-1].sum(-1)
    np.testing.assert_array_equal(seq["seq__tokens"], per_seq_valid)  # sums of 0/1: exact
    np.testing.assert_array_equal(seq["seq__tokens"], jseq["seq__tokens"])
    np.testing.assert_array_equal(seq["seq__behave_tokens"], jseq["seq__behave_tokens"])
    np.testing.assert_allclose(seq["seq__clipped"], jseq["seq__clipped"], atol=1.0)  # a near-tie may flip a token
    np.testing.assert_allclose(seq["seq__behave_kl_sum"], jseq["seq__behave_kl_sum"], rtol=1e-4)
    for lid, _ in lids:
        rec, jrec = tring.get(lid), jring.get(lid)
        assert rec.trained_version == jrec.trained_version == 6
        assert rec.train_tokens == jrec.train_tokens
        assert rec.clip_fraction is not None and 0 <= rec.clip_fraction <= 1
        assert rec.clip_fraction == pytest.approx(jrec.clip_fraction, abs=1.0 / rec.train_tokens)
        assert rec.behave_kl == pytest.approx(jrec.behave_kl, rel=1e-4)
    for key in j1:
        if key[0].endswith("_total") or key[0] == "behave_kl_sum":  # counters: this update's increments
            np.testing.assert_allclose(t1[key] - t0[key], j1[key] - j0[key], rtol=1e-4, atol=1.0 + 1e-6,
                                       err_msg=str(key))
        else:
            np.testing.assert_allclose(t1[key], j1[key], rtol=1e-4, atol=1e-5, err_msg=str(key))
    assert any(t1[("tokens_total", b)] > t0[("tokens_total", b)] for b in BUCKETS)


# ---------------------------------------------------------------------------
# grpo_loss_fn's lag_* and seq__* stats on one grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["grpo-recompute", "loglinear", "coupled"])
def test_grpo_loss_fn_lag_and_seq_stats_match_jax(variant):
    kw = {"loglinear": dict(prox_logp_mode="loglinear"), "coupled": dict(use_decoupled_loss=False)}.get(variant, {})
    jcfg, tcfg = _configs(**kw)
    batch = _batch(23, version=5)
    if variant == "loglinear":
        batch.pop("prox_logp")
    adv = jppo.PPOActor(jcfg, _Engine(5)).compute_advantages(batch)
    assert (adv["version_lag"] >= 2).any() and (adv["version_lag"] < 0).any()
    b, logp, ent = _device_grid(adv)
    grid = jgrid.pack_grid(adv, bucket_step=64)
    slot = np.full(b["segment_ids"].shape, -1, np.int32)
    for local, (r, c, n) in enumerate(zip(grid.row_of_seq, grid.col_of_seq, grid.seq_lens)):
        slot[r, c : c + n] = local
    n_slots = -(-len(grid.seq_lens) // 8) * 8
    b["seq_slot"], b["seq_slots"] = slot, np.zeros(n_slots, np.int32)
    _, jstats = jppo.grpo_loss_fn({"logprobs": jnp.asarray(logp), "entropy": jnp.asarray(ent)},
                                  {k: jnp.asarray(v) for k, v in b.items()}, jcfg)
    _, tstats = tppo.grpo_loss_fn({"logprobs": torch.from_numpy(logp), "entropy": torch.from_numpy(ent)},
                                  {k: torch.from_numpy(v) for k, v in b.items()}, tcfg)
    keys = sorted(k for k in jstats if k.startswith(("lag_", "seq__")))
    assert keys == sorted(k for k in tstats if k.startswith(("lag_", "seq__"))) and "seq__tokens" in keys
    assert any(k.startswith("lag_") for k in keys)
    for k in keys:
        got, want = tstats[k].numpy(), np.asarray(jstats[k])
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, err_msg=k, **REL)
    # the identity on the device stats (before the host finalize)
    fin = tppo._finalize_lag_stats({k: float(v) for k, v in tstats.items() if v.dim() == 0})
    assert sum(fin[f"lag_{x}/token_share"] * fin[f"lag_{x}/clip_ratio"] for x in BUCKETS) == pytest.approx(
        float(tstats["clip_ratio"]), abs=1e-6)
    assert fin == pytest.approx(jppo._finalize_lag_stats({k: float(v) for k, v in jstats.items() if np.ndim(v) == 0}),
                                rel=1e-6, abs=1e-7)


# ---------------------------------------------------------------------------
# the lineage ring, the executor's stamp, the journal's payload
# ---------------------------------------------------------------------------


class _VersionedEngine:
    def __init__(self, version=0):
        self._v = version
        self.addresses = ["fake:1"]

    def get_version(self):
        return self._v


def _traj(version, n=16, B=1):
    return {
        "input_ids": np.ones((B, n), np.int32),
        "attention_mask": np.ones((B, n), bool),
        "loss_mask": np.ones((B, n), np.float32),
        "versions": np.full((B, n), version, np.int32),
        "rewards": np.full((B,), 2.0, np.float32),
    }


SIDES = {
    "jax": (JInferenceEngineConfig, JWorkflowExecutor, JJournal, jlin, jtl),
    "port": (InferenceEngineConfig, WorkflowExecutor, TJournal, tlin, ttl),
}


def _executor(side, d, version=0, eta=2):
    cfg_cls, ex_cls, journal_cls, _, _ = SIDES[side]
    ex = ex_cls(cfg_cls(max_concurrent_rollouts=4, consumer_batch_size=2, max_head_offpolicyness=eta),
                engine=_VersionedEngine(version))
    ex.attach_journal(journal_cls(str(d), fsync=False))
    return ex


def test_version_stats_helper(tmp_path):
    out = []
    for side in SIDES:
        ex = _executor(side, tmp_path / side, version=5)
        t = _traj(3)
        t["versions"][0, :4] = -1
        t["versions"][0, -4:] = 4
        out.append((ex._version_stats(t), ex._version_stats({"input_ids": np.ones((1, 4))})))
    assert out[0] == out[1] == ((3, 4, 2, 1, True), (5, 5, 0, 0, False))


def _journals_lineage(side, d):
    lin = SIDES[side][3]
    ex = _executor(side, d, version=3)
    traj = _traj(3)
    head, tail, _lag, _span, _tagged = ex._version_stats(traj)
    meta = ex._register_lineage(traj, "task-a", head, tail, 16)
    ex._journal_append(traj, "task-a", 16, head, tail, meta)
    rec = lin.get_lineage().get(meta["lineage_id"])
    journaled = (rec.journaled, rec.reward, rec.replica)
    ex._mark_consumed(["task-a"])
    consumed = lin.get_lineage().get(meta["lineage_id"]).consumed_version
    ex.journal.close()
    entry_lineage = ex.journal.scan()[0].lineage
    ex2 = _executor(side, d, version=3)
    replayed = ex2.replay_from_journal()
    tid, traj2, _ = ex2._results[0]
    new_lid = int(np.ravel(traj2["lineage_id"])[0])
    rec2 = lin.get_lineage().get(new_lid)
    return (meta, np.asarray(traj["lineage_id"]).tolist(), journaled, consumed, entry_lineage, replayed, new_lid,
            (rec2.task_id, rec2.journaled, rec2.reward, rec2.replica, rec2.head_version, rec2.n_tokens))


def test_executor_journals_lineage_and_replay_rejoins(tmp_path, fresh_rings):
    """The stamp, the journal's lineage payload and the replay's fresh
    record with its rewritten id: the same in both packages."""
    want = _journals_lineage("jax", tmp_path / "jax")
    got = _journals_lineage("port", tmp_path / "port")
    assert got == want
    meta, stamped, journaled, consumed, entry_lineage, replayed, new_lid, rec2 = got
    assert meta == {"lineage_id": 0, "task_id": "task-a", "replica": "fake:1", "reward": 2.0}
    assert stamped == [0] and journaled == (True, 2.0, "fake:1") and consumed == 3
    assert entry_lineage["task_id"] == "task-a" and replayed == (1, 0)
    assert new_lid == 1 and rec2 == ("task-a", True, 2.0, "fake:1", 3, 16)  # provenance from the frame


def test_replay_drop_leaves_flight_audit(tmp_path):
    evs = {}
    for side in SIDES:
        flight = SIDES[side][4].get_flight_recorder()
        ex = _executor(side, tmp_path / side, version=0, eta=2)
        ex._journal_append(_traj(0), "doomed", 16, 0, 0, {"lineage_id": 1})
        ex.journal.close()
        ex2 = _executor(side, tmp_path / side, version=10, eta=2)
        before = [e for e in flight.snapshot()["events"] if e["kind"] == "journal_drop_stale"]
        assert ex2.replay_from_journal() == (0, 1)
        after = [e for e in flight.snapshot()["events"] if e["kind"] == "journal_drop_stale"]
        assert len(after) == len(before) + 1
        evs[side] = (after[-1]["severity"], after[-1]["data"])
    assert evs["port"] == evs["jax"]
    assert evs["port"][1] == {"task_id": "doomed", "lag": 10, "bound": 2, "n_tokens": 16}


def test_lineage_ring_bounded_and_threadsafe():
    ring = tlin.TrajectoryLineage(capacity=8)
    errs = []

    def writer(k):
        try:
            for i in range(50):
                lid = ring.register(task_id=f"w{k}-{i}")
                ring.mark_consumed([f"w{k}-{i}"], version=i)
                ring.record_train(lid, version=i, tokens=4, clip_fraction=0.1)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert len(ring.recent()) == 8  # bounded: FIFO eviction
    snap = ring.snapshot()
    assert snap["evicted"] == 192 and len(snap["lineage_records"]) == 8


def _ring_script(mod, capacity=3):
    ring = mod.TrajectoryLineage(capacity=capacity)
    lids = [ring.register(task_id=f"t{i}", replica="r:1", head_version=i, tail_version=i + 1, n_tokens=8 * i,
                          reward=0.5 * i) for i in range(5)]
    ring.mark_journaled(lids[3])
    ring.mark_consumed(["t3", "t4", "t0"], version=6)  # t0 was evicted: ignored
    ring.record_train(lids[4], version=6, tokens=30, clip_fraction=0.25, behave_kl=0.1)
    ring.record_train(lids[0], version=6, tokens=1, clip_fraction=0.0)  # evicted: ignored
    recs = [(r.lineage_id, r.task_id, r.journaled, r.consumed_version, r.trained_version, r.clip_fraction,
             r.behave_kl, r.lag_at_consume) for r in ring.recent()]
    return lids, recs, ring.by_task("t2").lineage_id, ring.by_task("t0"), ring.recent(1)[0].task_id, ring


def test_ring_operations_match_jax():
    *want, _ = _ring_script(jlin)
    *got, ring = _ring_script(tlin)
    assert got == want
    assert got[1][-1] == (4, "t4", False, 6, 6, 0.25, 0.1, 2)


def test_lineage_to_trace_events_and_dump_match_jax(tmp_path):
    """One snapshot: the same catapult events from both packages; the
    port's dump is atomic JSON either package's reader takes."""
    ring = tlin.TrajectoryLineage(capacity=16)
    lid = ring.register(task_id="abc123", replica="r:1", head_version=2, tail_version=3, n_tokens=32, reward=1.5,
                        journaled=True)
    ring.register(task_id="pending0", head_version=3)  # no consume yet: no span
    ring.mark_consumed(["abc123"], version=4)
    ring.record_train(lid, version=4, tokens=30, clip_fraction=0.25, behave_kl=0.1)
    path = ring.dump(str(tmp_path / "sub" / "lineage.json"), "test")
    import json

    snap = json.loads(open(path).read())
    assert snap["dump_reason"] == "test" and snap["role"] == "trainer_lineage"
    events = tlin.lineage_to_trace_events(snap)
    assert events == jlin.lineage_to_trace_events(snap)
    names = [e["name"] for e in events]
    assert names == ["traj abc123", "traj_update"]
    assert events[0]["args"]["consumed_version"] == 4 and events[1]["args"]["clip_fraction"] == 0.25
    assert not list((tmp_path / "sub").glob("*.tmp.*"))


def test_default_dump_path_beside_the_flight_recorder(monkeypatch, tmp_path):
    monkeypatch.setenv("AREAL_FLIGHT_DIR", str(tmp_path))
    p = tlin.default_dump_path("preempt")
    assert p.startswith(str(tmp_path)) and p.endswith("_preempt.json") and "lineage_" in p
    assert ttl.default_dump_path("x").startswith(str(tmp_path))


def test_learning_health_catalog_matches_jax():
    from areal_tpu.observability.metrics import Registry as JRegistry
    from areal_tpu_torch.observability.metrics import Registry as TRegistry

    def fams(cat, reg):
        cat.learning_health_metrics(reg)
        return {f.name: (f.type, f.help, f.label_names, f.buckets) for f in reg.families()}

    got, want = fams(tcat, TRegistry()), fams(jcat, JRegistry())
    assert got == want and "areal_lineage_joined_total" in got and "areal_train_lag_clip_ratio" in got
