"""The trajectory journal and trajectory dumps: the port
(``areal_tpu_torch/infra/trajectory_journal.py`` and the executor's
journal hooks) against ``areal_tpu/infra/trajectory_journal.py`` on the
same operations. Twins of ``tests/test_preemption.py:45`` (round trip and
seal), ``:64`` (torn tail), ``:82`` (replay policy), ``:104`` and ``:120``
(GC) and ``:247`` (the executor's append / consume / replay), of
``tests/test_breadth.py:39-59`` (the JSONL dump), and the cross-reads: a
journal either package wrote scans in the other to the same entries, the
payload arrays equal bit for bit. Exact: the formats are one format."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from areal_tpu.api.config import InferenceEngineConfig as JInferenceEngineConfig
from areal_tpu.infra import trajectory_journal as jj
from areal_tpu.infra.workflow_executor import WorkflowExecutor as JWorkflowExecutor
from areal_tpu_torch.api.config import InferenceEngineConfig, TrajectoryJournalConfig
from areal_tpu_torch.infra import trajectory_journal as tj
from areal_tpu_torch.infra.workflow_executor import WorkflowExecutor

SIDES = {"jax": jj, "port": tj}


def _traj(version: int, n: int = 2, L: int = 8, seed: int | None = None):
    if seed is None:
        ids = np.arange(n * L, dtype=np.int32).reshape(n, L)
    else:
        ids = np.random.default_rng(seed).integers(0, 50_000, (n, L)).astype(np.int32)
    return {
        "input_ids": ids,
        "attention_mask": np.ones((n, L), bool),
        "versions": np.full((n, L), version, np.int32),
        "rewards": np.ones((n,), np.float32),
    }


def _entries(entries) -> list[tuple]:
    """A scan's entries as comparable tuples, arrays as (dtype, shape, bytes)."""
    out = []
    for e in entries:
        arrays = {k: (str(v.dtype), v.shape, v.tobytes()) for k, v in sorted(e.traj.items())}
        out.append((e.task_id, e.head_version, e.tail_version, e.n_real_tokens, e.consumed_version, e.lineage, arrays))
    return out


def _files(d) -> dict[str, bytes]:
    return {p: open(os.path.join(d, p), "rb").read() for p in sorted(os.listdir(d))}


# ---------------------------------------------------------------------------
# the journal: twins
# ---------------------------------------------------------------------------


def _roundtrip(mod, d):
    j = mod.TrajectoryJournal(str(d), segment_max_records=2, fsync=False)
    j.append_trajectory(_traj(3), "t1", 3, 3, 16)
    j.append_trajectory(_traj(4), "t2", 4, 4, 16)  # seals segment 0
    j.append_trajectory(_traj(5), "t3", 5, 5, 16, lineage={"lineage_id": 7, "task_id": "t3", "reward": 1.0})
    j.close()  # seals the active segment
    return j.stats(), mod.TrajectoryJournal(str(d), fsync=False).scan()


def test_roundtrip_and_seal_match_jax(tmp_path):
    jstats, jent = _roundtrip(jj, tmp_path / "jax")
    tstats, tent = _roundtrip(tj, tmp_path / "port")
    assert tstats == jstats and tstats["segments_sealed"] == 2 and tstats["segments_open"] == 0
    assert [e.task_id for e in tent] == ["t1", "t2", "t3"]
    assert tent[0].head_version == 3 and tent[2].tail_version == 5 and tent[2].lineage["lineage_id"] == 7
    np.testing.assert_array_equal(tent[1].traj["input_ids"], _traj(4)["input_ids"])
    assert all(e.consumed_version is None for e in tent)
    assert _entries(tent) == _entries(jent)
    # the same operations write the same bytes, segment by segment
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


@pytest.mark.parametrize("side", list(SIDES))
def test_torn_tail_truncated_on_open(tmp_path, side):
    mod = SIDES[side]
    j = mod.TrajectoryJournal(str(tmp_path), fsync=False)
    j.append_trajectory(_traj(1), "a", 1, 1, 16)
    j.append_trajectory(_traj(1), "b", 1, 1, 16)
    # a crash mid-append: garbage after the last intact frame in the .open
    # segment (no close: the writer died)
    open_segs = [p for p in os.listdir(tmp_path) if p.endswith(".open")]
    assert len(open_segs) == 1
    with open(tmp_path / open_segs[0], "ab") as f:
        f.write(b"\x42\x00\x00\x00torn-frame-partial")
    # the other package recovers the torn segment the same way
    other = tj if mod is jj else jj
    entries = other.TrajectoryJournal(str(tmp_path), fsync=False).scan()
    assert [e.task_id for e in entries] == ["a", "b"]
    assert other.TrajectoryJournal(str(tmp_path), fsync=False).stats()["segments_open"] == 0
    assert _entries(mod.TrajectoryJournal(str(tmp_path), fsync=False).scan()) == _entries(entries)


def _replay_policy(mod, d):
    j = mod.TrajectoryJournal(str(d), fsync=False)
    j.append_trajectory(_traj(1), "old_consumed", 1, 1, 16)
    j.append_trajectory(_traj(4), "lost_step", 4, 4, 16)
    j.append_trajectory(_traj(4), "pending", 4, 5, 16)
    j.append_trajectory(_traj(0), "too_stale", 0, 0, 16)
    j.mark_consumed(["old_consumed"], version=2)
    j.mark_consumed(["lost_step"], version=5)  # step 5 never checkpointed
    j.close()
    return mod.TrajectoryJournal(str(d), fsync=False).pending_for_replay(restored_version=5, max_staleness=2)


def test_replay_policy_matches_jax(tmp_path):
    """Consumed below the restored version: skipped; consumed at or above
    it (the step died with the crash): replayed; unconsumed: replayed;
    over-stale: dropped and returned for the flight audit."""
    jrep, jdrop, jn = _replay_policy(jj, tmp_path / "jax")
    trep, tdrop, tn = _replay_policy(tj, tmp_path / "port")
    assert {e.task_id for e in trep} == {"lost_step", "pending"}
    assert [e.task_id for e in tdrop] == ["too_stale"] and tn == jn == 1
    assert _entries(trep) == _entries(jrep) and _entries(tdrop) == _entries(jdrop)


def _gc_drops(mod, d):
    j = mod.TrajectoryJournal(str(d), segment_max_records=2, fsync=False)
    j.append_trajectory(_traj(1), "a", 1, 1, 16)
    j.append_trajectory(_traj(1), "b", 1, 1, 16)  # seals segment 0
    j.append_trajectory(_traj(2), "c", 2, 2, 16)
    j.mark_consumed(["a", "b"], version=2)  # one C frame per task id
    j.close()
    sealed = j.stats()["segments_sealed"]
    removed = j.gc(covered_version=3)
    return sealed, removed, sorted(os.listdir(d)), {e.task_id for e in mod.TrajectoryJournal(str(d), fsync=False).scan()}


def test_gc_drops_fully_consumed_segments_matches_jax(tmp_path):
    # [a,b] [c,Ca] [Cb]: segment 0 drops, the marker-only [Cb] with it;
    # [c, Ca] stays (c is unconsumed)
    want = _gc_drops(jj, tmp_path / "jax")
    got = _gc_drops(tj, tmp_path / "port")
    assert got == want and got[:2] == (3, 2) and got[3] == {"c"}


def _gc_keeps(mod, d):
    j = mod.TrajectoryJournal(str(d), segment_max_records=3, fsync=False)
    j.append_trajectory(_traj(1), "A", 1, 1, 16)
    j.append_trajectory(_traj(1), "Z", 1, 1, 16)
    j.append_trajectory(_traj(1), "B", 1, 1, 16)  # seals seg0 [A,Z,B]
    j.mark_consumed(["A", "B"], version=1)  # seg1 [CA,CB] (sealed on close)
    j.close()
    first = j.gc(covered_version=2)
    j2 = mod.TrajectoryJournal(str(d), fsync=False)
    pend, _, consumed = j2.pending_for_replay(restored_version=2, max_staleness=5)
    j2.mark_consumed(["Z"], version=1)
    j2.close()
    second = j2.gc(covered_version=2)
    return first, {e.task_id for e in pend}, consumed, second, mod.TrajectoryJournal(str(d), fsync=False).scan()


def test_gc_keeps_load_bearing_markers_matches_jax(tmp_path):
    """A consumed-marker segment survives while the segment holding its
    trajectory survives (deleting it would replay a trained trajectory)."""
    want = _gc_keeps(jj, tmp_path / "jax")
    got = _gc_keeps(tj, tmp_path / "port")
    assert got == want and got == (0, {"Z"}, 2, 3, [])


# ---------------------------------------------------------------------------
# cross-reads: each package scans the other's journal
# ---------------------------------------------------------------------------


def _write_mixed(mod, d, torch_values: bool = False):
    j = mod.TrajectoryJournal(str(d), segment_max_records=3, fsync=False)
    for i in range(7):
        t = _traj(i % 3, n=2 + i % 2, L=8 + 4 * i, seed=i)
        t["logprobs"] = np.random.default_rng(100 + i).normal(size=t["input_ids"].shape).astype(np.float32)
        t["lineage_id"] = np.full(t["input_ids"].shape[0], 40 + i, np.int64)
        if torch_values:
            t["logprobs"] = torch.from_numpy(t["logprobs"])  # the port's appends take tensors too
        lin = {"lineage_id": 40 + i, "task_id": f"task{i}", "replica": "127.0.0.1:1", "reward": float(i)}
        j.append_trajectory(t, f"task{i}", i % 3, i % 3 + 1, int(t["attention_mask"].sum()), lineage=lin)
        if i % 3 == 2:
            j.mark_consumed([f"task{i - 1}", f"task{i - 2}"], version=i)
    return j  # the active segment left open: a dead writer's


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
def test_cross_read(tmp_path, writer, reader):
    _write_mixed(SIDES[writer], tmp_path / "w", torch_values=writer == "port")
    # the reader scans the writer's sealed segments and its open one
    got = SIDES[reader].TrajectoryJournal(str(tmp_path / "w"), fsync=False).scan()
    want = SIDES[writer].TrajectoryJournal(str(tmp_path / "w"), fsync=False).scan()
    assert len(got) == 7 and _entries(got) == _entries(want)
    assert all(isinstance(v, np.ndarray) for e in got for v in e.traj.values())
    assert [e.consumed_version for e in got] == [2, 2, None, 5, 5, None, None]
    # and its replay partition agrees
    rs = [SIDES[s].TrajectoryJournal(str(tmp_path / "w"), fsync=False).pending_for_replay(4, 2) for s in (reader, writer)]
    assert [_entries(r[0]) for r in rs] == [_entries(rs[1][0])] * 2 and rs[0][2] == rs[1][2] == 2


def test_port_frames_pickle_host_numpy_only(tmp_path):
    """A tensor value goes into the frame as a host numpy array, so the JAX
    package (without torch in its code) can unpickle it."""
    j = tj.TrajectoryJournal(str(tmp_path), fsync=False)
    t = _traj(1)
    t["logprobs"] = torch.zeros(2, 8)
    j.append_trajectory(t, "x", 1, 1, 16)
    j.close()
    [seg] = os.listdir(tmp_path)
    from areal_tpu.utils import atomic_io

    metas, _ = jj._read_frames(atomic_io.read_checksummed(str(tmp_path / seg)))
    rec = pickle.loads(metas[0].payload)
    assert all(type(v) is np.ndarray for v in rec["traj"].values())


def test_journal_from_config(tmp_path):
    assert tj.journal_from_config(TrajectoryJournalConfig()) is None
    cfg = TrajectoryJournalConfig(enabled=True, segment_max_records=5, fsync=False)
    j = tj.journal_from_config(cfg, fileroot=str(tmp_path), experiment="e", trial="t")
    assert j.dir == tj.default_journal_dir(str(tmp_path), "e", "t") == jj.default_journal_dir(str(tmp_path), "e", "t")
    assert (j.segment_max_records, j.fsync) == (5, False)


# ---------------------------------------------------------------------------
# the executor's append / consume / replay (tests/test_preemption.py:247)
# ---------------------------------------------------------------------------


class _VersionedEngine:
    def __init__(self, version=0):
        self.version = version

    def get_version(self):
        return self.version


def _executor(side, d, version):
    cfg_cls, ex_cls, mod = {
        "jax": (JInferenceEngineConfig, JWorkflowExecutor, jj),
        "port": (InferenceEngineConfig, WorkflowExecutor, tj),
    }[side]
    ex = ex_cls(cfg_cls(max_concurrent_rollouts=4, consumer_batch_size=2, max_head_offpolicyness=2),
                engine=_VersionedEngine(version))
    ex.attach_journal(mod.TrajectoryJournal(str(d), fsync=False))
    return ex


def _executor_script(side, d):
    ex = _executor(side, d, 3)
    ex._journal_append(_traj(3), "keep", 16, 3, 3)
    ex._journal_append(_traj(3), "eaten", 16, 3, 3)
    ex._mark_consumed(["eaten"])  # consumed at version 3
    ex.journal.close()
    out = []
    for version in (3, 4, 10):  # the crashed step re-runs; durable; over-stale
        ex2 = _executor(side, d, version)
        replayed = ex2.replay_from_journal()
        st = ex2.staleness.export_stats()
        out.append((replayed, st, ex2.staleness.get_capacity(), [r[0] for r in ex2._results],
                    [_entries([tj.JournalEntry(r[0], 0, 0, r[2], r[1])]) for r in ex2._results]))
    return out


def test_executor_journal_append_consume_replay_matches_jax(tmp_path):
    want = _executor_script("jax", tmp_path / "jax")
    got = _executor_script("port", tmp_path / "port")
    assert got == want
    (r3, st3, cap3, ids3, _), (r4, _, _, ids4, _), (r10, _, _, ids10, _) = got
    # restored at 3: the step consuming "eaten" died, so both replay; the
    # accepted count is restored, this life's submitted / running are not
    assert r3 == (2, 0) and st3["accepted"] == 2 and st3["submitted"] == st3["running"] == 0
    assert cap3 == 4 and ids3 == ["keep", "eaten"]
    assert r4 == (1, 0) and ids4 == ["keep"]
    assert r10 == (0, 1) and ids10 == []


def test_restore_accepted_matches_jax():
    from areal_tpu.infra.staleness_manager import StalenessManager as JSM
    from areal_tpu_torch.infra.staleness_manager import StalenessManager as TSM

    out = []
    for cls in (JSM, TSM):
        sm = cls(_VersionedEngine(1), max_concurrent_rollouts=8, consumer_batch_size=2, max_staleness=1)
        sm.on_submit(3)
        sm.on_accept(2)
        sm.restore_accepted(3)
        sm.restore_accepted(0)
        out.append((sm.export_stats(), sm.get_capacity()))
    assert out[0] == out[1] and out[1][0]["accepted"] == 5 and out[1][0]["submitted"] == 3


# ---------------------------------------------------------------------------
# trajectory dumps (tests/test_breadth.py:39-59)
# ---------------------------------------------------------------------------


class _Ver:
    def get_version(self):
        return 3


def _dump_traj(n_tok=6, prompt=2, reward=1.0, version=3):
    return {
        "input_ids": np.arange(1, n_tok + 1)[None],
        "attention_mask": np.ones((1, n_tok), np.int64),
        "loss_mask": np.concatenate([np.zeros(prompt), np.ones(n_tok - prompt)])[None],
        "rewards": np.asarray([reward], np.float32),
        "versions": np.concatenate([np.full(prompt, -1), np.full(n_tok - prompt, version)])[None],
    }


class _Tok:
    def decode(self, ids):
        return "".join(chr(96 + i) for i in ids)


def _dumps(cfg_cls, ex_cls, d):
    ex = ex_cls(cfg_cls(consumer_batch_size=2, dump_trajectories=True, dump_dir=str(d)), engine=_Ver())
    ex._dump_trajectory(_dump_traj(reward=0.5), task_id="t1")
    # a multi-turn mask (two completion runs) and a row without completion
    multi = _dump_traj(n_tok=9, prompt=2)
    multi["loss_mask"][0, 5:7] = 0
    multi["input_ids"] = np.concatenate([multi["input_ids"], np.arange(20, 29)[None]])
    multi["attention_mask"] = np.concatenate([multi["attention_mask"], np.ones((1, 9), np.int64)])
    multi["loss_mask"] = np.concatenate([multi["loss_mask"], np.zeros((1, 9))])
    multi["rewards"] = np.asarray([0.25, 1.0], np.float32)
    multi["versions"] = np.concatenate([multi["versions"], np.full((1, 9), 2)])
    ex._dump_trajectory(multi, task_id="t3")
    ex.tokenizer = _Tok()
    ex._dump_trajectory(_dump_traj(), task_id="t2")
    return {
        os.path.relpath(os.path.join(r, f), d): [json.loads(x) for x in open(os.path.join(r, f)).read().splitlines()]
        for r, _, fs in os.walk(d) for f in fs
    }


def test_trajectory_dump_matches_jax(tmp_path):
    want = _dumps(JInferenceEngineConfig, JWorkflowExecutor, tmp_path / "jax")
    got = _dumps(InferenceEngineConfig, WorkflowExecutor, tmp_path / "port")
    assert got == want
    rec = got[os.path.join("3", "t1.jsonl")][0]
    assert (rec["reward"], rec["prompt_len"], rec["seqlen"], rec["head_version"], rec["tail_version"]) == (0.5, 2, 6, 3, 3)
    assert rec["completion_ids"] == [3, 4, 5, 6]
    assert got[os.path.join("3", "t2.jsonl")][0]["completion"] == "cdef"
    assert len(got[os.path.join("3", "t3.jsonl")]) == 1  # the row without completion tokens is skipped


def test_dump_failure_never_stops_the_rollout(tmp_path):
    """A dump that raises is logged; the trajectory is still accepted."""
    (tmp_path / "blocked").write_text("a file where the dump wants a folder")
    ex = WorkflowExecutor(
        InferenceEngineConfig(consumer_batch_size=1, dump_trajectories=True, dump_dir=str(tmp_path / "blocked")),
        engine=_Ver(),
    )
    ex._on_result("t", (_dump_traj(), None))
    assert [r[0] for r in ex._results] == ["t"] and ex.staleness.export_stats()["accepted"] == 1


def test_append_failure_never_stops_the_rollout(tmp_path):
    class _Broken:
        def append_trajectory(self, *a, **k):
            raise OSError("disk full")

    ex = WorkflowExecutor(InferenceEngineConfig(consumer_batch_size=1), engine=_Ver())
    ex.attach_journal(_Broken())
    ex._on_result("t", (_dump_traj(), None))
    assert [r[0] for r in ex._results] == ["t"]
