"""Recovery against the JAX package on the CPU: ``atomic_io``'s bytes
across the two packages, the ``RecoverHandler`` policy and its decisions
on every corruption case (the twins of ``tests/test_recover.py``), the
exact dataloader position after a mid-epoch resume, and the ``Saver``'s
async / emergency dumps (the twins of ``tests/test_preemption.py:530-592``).

Both handlers run the same sequences through stub engines that record the
meta they receive; the records pickle each package's own classes, so the
twins compare decisions, never files. The port's handler also runs once
over the real ``TorchTrainEngine``."""

import os
import pickle
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from areal_tpu.api import config as jconfig
from areal_tpu.api import io_struct as jio
from areal_tpu.observability import catalog as jcatalog
from areal_tpu.utils import atomic_io as jatomic
from areal_tpu.utils import data as jdata
from areal_tpu.utils import recover as jrecover
from areal_tpu.utils import saver as jsaver
from areal_tpu_torch.api import config as tconfig
from areal_tpu_torch.api import io_struct as tio
from areal_tpu_torch.observability import catalog as tcatalog
from areal_tpu_torch.utils import atomic_io as tatomic
from areal_tpu_torch.utils import data as tdata
from areal_tpu_torch.utils import recover as trecover
from areal_tpu_torch.utils import saver as tsaver

PKGS = {
    "jax": dict(config=jconfig, io=jio, atomic=jatomic, data=jdata, recover=jrecover, saver=jsaver, catalog=jcatalog),
    "port": dict(config=tconfig, io=tio, atomic=tatomic, data=tdata, recover=trecover, saver=tsaver,
                 catalog=tcatalog),
}


# ---------------------------------------------------------------------------
# atomic_io: the same bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("payload", [b"", b"payload-bytes", bytes(range(256)) * 7], ids=["empty", "short", "binary"])
def test_atomic_io_files_cross_read(tmp_path, payload):
    """``checksum_wrap`` gives the same bytes; a file either package
    writes, the other reads; a tampered file raises in both; a file
    without the magic passes through both."""
    assert tatomic.checksum_wrap(payload) == jatomic.checksum_wrap(payload)
    for writer, reader in ((tatomic, jatomic), (jatomic, tatomic)):
        p = str(tmp_path / f"blob-{writer.__name__}")
        writer.write_checksummed(p, payload)
        assert reader.read_checksummed(p) == payload
        raw = bytearray(open(p, "rb").read())
        raw[-1 if payload else 10] ^= 0x01
        open(p, "wb").write(bytes(raw))
        for mod in (tatomic, jatomic):
            with pytest.raises(mod.ChecksumError):
                mod.read_checksummed(p)
    t = str(tmp_path / "text")
    tatomic.atomic_write_text(t, "plain")
    assert jatomic.read_checksummed(t) == tatomic.read_checksummed(t) == b"plain"
    with pytest.raises(tatomic.ChecksumError, match="truncated"):
        tatomic.checksum_unwrap(tatomic.CHECKSUM_MAGIC + b"abc")
    assert [f for f in os.listdir(tmp_path) if ".tmp." in f] == []


# ---------------------------------------------------------------------------
# the handler's decisions, both packages
# ---------------------------------------------------------------------------


def _mark_complete(ckpt):
    """What the end of a complete recover write leaves: the manifest (the
    port's handler looks for it; the JAX handler ignores it)."""
    os.makedirs(os.path.join(ckpt, "state"), exist_ok=True)
    open(os.path.join(ckpt, tio.RECOVER_MANIFEST), "w").write("{}")


class _StubEngine:
    """Records what the handler asks of it."""

    def __init__(self):
        self.loaded = []
        self.saved = []
        self.version = 0

    def save(self, meta):
        _mark_complete(meta.path)
        self.saved.append((os.path.basename(meta.path), meta.weight_format, meta.with_optim))

    def load(self, meta):
        self.loaded.append((os.path.basename(meta.path), meta.weight_format, meta.with_optim))

    def set_version(self, v):
        self.version = v

    def get_version(self):
        return self.version


def _handler(pkg, tmp_path, mode="auto"):
    m = PKGS[pkg]
    return m["recover"].RecoverHandler(
        m["config"].RecoverConfig(mode=mode, freq_steps=1, fileroot=str(tmp_path / pkg), experiment_name="rc",
                                  trial_name="t")
    )


def _write_generation(pkg, h, step, name, suffix="", legacy=False):
    m = PKGS[pkg]
    ckpt = os.path.join(h._root(), name)
    _mark_complete(ckpt)
    info = m["recover"].RecoverInfo(
        last_step_info=m["io"].StepInfo(epoch=0, epoch_step=step, global_step=step, steps_per_epoch=10),
        ckpt_path="" if legacy else ckpt,
    )
    if legacy:  # before the hardening: plain pickle, the path only in `latest`
        with open(h._info_path(suffix), "wb") as f:
            pickle.dump(info, f)
        with open(h._latest_path(suffix), "w") as f:
            f.write(ckpt)
    else:
        m["atomic"].write_checksummed(h._info_path(suffix), pickle.dumps(info))
        m["atomic"].write_checksummed(h._latest_path(suffix), ckpt.encode())
    return ckpt


def _truncate(h):
    raw = open(h._info_path(), "rb").read()
    open(h._info_path(), "wb").write(raw[: len(raw) // 2])


def _flip(h):
    raw = bytearray(open(h._info_path(), "rb").read())
    raw[-1] ^= 0xFF  # a payload byte: the header intact, the checksum wrong
    open(h._info_path(), "wb").write(bytes(raw))


def _corrupt_both(h):
    for sfx in ("", ".prev"):
        open(h._info_path(sfx), "wb").write(b"garbage")


CASES = {
    # name: (generations: [(step, dir, suffix, legacy)], corruption, expected (loaded dir, step) or None)
    "truncated": ([(1, "ck1", ".prev", False), (2, "ck2", "", False)], _truncate, ("ck1", 1)),
    "checksum": ([(1, "ck1", ".prev", False), (2, "ck2", "", False)], _flip, ("ck1", 1)),
    "dangling": ([(1, "ck1", ".prev", False), (2, "ck2", "", False)],
                 lambda h: shutil.rmtree(os.path.join(h._root(), "ck2")), ("ck1", 1)),
    "all-corrupt": ([(1, "ck1", ".prev", False), (2, "ck2", "", False)], _corrupt_both, None),
    "garbage-no-prev": ([(2, "ck2", "", False)], lambda h: open(h._info_path(), "wb").write(b"garbage"), None),
    "legacy": ([(4, "ck_legacy", "", True)], None, ("ck_legacy", 4)),
    "legacy-dangling-latest": ([(3, "ck3", ".prev", True), (4, "ck4", "", True)],
                               lambda h: open(h._latest_path(), "wb").write(b"\x00bad"), ("ck3", 3)),
    "intact": ([(1, "ck1", ".prev", False), (2, "ck2", "", False)], None, ("ck2", 2)),
}


def _decide(pkg, tmp_path, case):
    gens, corrupt, _ = CASES[case]
    h = _handler(pkg, tmp_path)
    for step, name, sfx, legacy in gens:
        _write_generation(pkg, h, step, name, sfx, legacy)
    if corrupt is not None:
        corrupt(h)
    fallbacks = PKGS[pkg]["catalog"].robustness_metrics().recover_fallbacks
    before = fallbacks.get()
    eng = _StubEngine()
    info = h.load(eng)
    return dict(
        should_load=h.should_load(),
        loaded=[(d, with_optim) for d, _, with_optim in eng.loaded],
        step=None if info is None else info.last_step_info.global_step,
        version=eng.version,
        fallback=fallbacks.get() - before,
    )


@pytest.mark.parametrize("case", list(CASES))
def test_corruption_decisions_match_jax(tmp_path, case):
    """The same corruption of the same generations gives the same decision
    in both handlers: which checkpoint loads (or a fresh start), the
    version set (global_step + 1), and whether the fallback was counted."""
    got, want = _decide("port", tmp_path, case), _decide("jax", tmp_path, case)
    assert got == want
    expect = CASES[case][2]
    if expect is None:
        assert got["loaded"] == [] and got["step"] is None
    else:
        assert got["loaded"] == [(expect[0], True)] and got["step"] == expect[1]
        assert got["version"] == expect[1] + 1


def _policy_sequence(pkg, tmp_path) -> list:
    """``tests/test_recover.py::test_recover_handler_policy`` as a list of
    observations, through a stub engine."""
    m = PKGS[pkg]
    obs = []
    h = _handler(pkg, tmp_path)
    obs.append(("should_load_empty", h.should_load()))
    eng = _StubEngine()
    eng.set_version(3)
    dl = m["data"].StatefulDataLoader(list(range(40)), batch_size=4)
    it = iter(dl)
    next(it), next(it)
    saver = m["saver"].Saver(m["config"].SaverConfig(freq_steps=5, fileroot=str(tmp_path / pkg)), None)
    step = m["io"].StepInfo(epoch=0, epoch_step=2, global_step=2, steps_per_epoch=10)
    path = h.dump(eng, step, saver=saver, dataloader=dl)
    # the recover format is named per package ("orbax" / "state"): compared below
    obs.append(("dumped", os.path.relpath(path, str(tmp_path / pkg)), [(d, o) for d, _, o in eng.saved]))
    obs.append(("should_load", h.should_load()))
    eng2 = _StubEngine()
    dl2 = m["data"].StatefulDataLoader(list(range(40)), batch_size=4)
    info = h.load(eng2, dataloader=dl2)
    obs.append(("loaded", info.last_step_info.global_step, info.last_step_info.next().global_step,
                eng2.version, dl2.state_dict() == dl.state_dict(), [(d, o) for d, _, o in eng2.loaded]))
    h2 = _handler(pkg, tmp_path / "x", mode="disabled")
    obs.append(("disabled", h2.dump(eng, step), h2.should_load()))
    step3 = m["io"].StepInfo(epoch=0, epoch_step=3, global_step=3, steps_per_epoch=10)
    obs.append(("second", h.dump(eng, step3, saver=saver, dataloader=dl) is not None,
                os.path.exists(h._info_path(".prev")), h.read_recover_info()[0].last_step_info.global_step))
    obs.append(("gated", h.dump(eng, step3, saver=saver, dataloader=dl)))
    h_on = _handler(pkg, tmp_path / "on", mode="on")
    obs.append(("on_empty", h_on.should_load(), h_on.load(_StubEngine())))
    return obs


def test_recover_handler_policy_matches_jax(tmp_path):
    got, want = _policy_sequence("port", tmp_path), _policy_sequence("jax", tmp_path)
    assert got == want
    assert got[1][2] == [("epoch0epochstep2globalstep2", True)]
    eng = _StubEngine()
    _handler("port", tmp_path / "fmt").dump(eng, _step("port", 0))
    assert eng.saved == [("epoch0epochstep0globalstep0", "state", True)]  # the port's recover format


def _mid_epoch(pkg, tmp_path):
    """``tests/test_recover.py::test_exact_position_resume_mid_epoch``:
    the batches and timer decisions a relaunch sees."""
    m = PKGS[pkg]
    root = str(tmp_path / pkg)
    h = _handler(pkg, tmp_path)
    dl = m["data"].StatefulDataLoader(list(range(40)), batch_size=4, shuffle=True, seed=7)
    it = iter(dl)
    consumed = [next(it) for _ in range(3)]
    saver = m["saver"].Saver(m["config"].SaverConfig(freq_steps=5, fileroot=root), None)
    evaluator = m["saver"].Evaluator(m["config"].EvaluatorConfig(freq_steps=5, fileroot=root), None)
    for gs in range(5):
        saver.freq_ctl.check(steps=gs + 1)
        evaluator.freq_ctl.check(steps=gs + 1)
    step = m["io"].StepInfo(epoch=0, epoch_step=4, global_step=4, steps_per_epoch=10)
    assert h.dump(_StubEngine(), step, saver=saver, evaluator=evaluator, dataloader=dl)
    upcoming = next(it)
    dl2 = m["data"].StatefulDataLoader(list(range(40)), batch_size=4, shuffle=True, seed=7)
    saver2 = m["saver"].Saver(m["config"].SaverConfig(freq_steps=5, fileroot=root), None)
    evaluator2 = m["saver"].Evaluator(m["config"].EvaluatorConfig(freq_steps=5, fileroot=root), None)
    info = h.load(_StubEngine(), saver=saver2, evaluator=evaluator2, dataloader=dl2)
    resumed = next(iter(dl2))
    fires = [(saver2.freq_ctl.check(steps=gs + 1), evaluator2.freq_ctl.check(steps=gs + 1)) for gs in range(5, 10)]
    return consumed, upcoming, resumed, info.last_step_info.next().global_step, fires


def test_exact_position_resume_mid_epoch_matches_jax(tmp_path):
    """After a mid-epoch resume both packages hand out the batch the dead
    process would have seen next (neither repeated nor skipped), and the
    timers fire next at step 9, as before the kill."""
    got, want = _mid_epoch("port", tmp_path), _mid_epoch("jax", tmp_path)
    assert got == want
    consumed, upcoming, resumed, next_step, fires = got
    assert resumed == upcoming and resumed != consumed[-1] and next_step == 5
    assert fires == [(False, False)] * 4 + [(True, True)]


def test_recover_handler_with_the_train_engine(tmp_path):
    """The port's handler over the real engine: a dump after a step, then
    a fresh engine loads it: parameters, moments, step count and version."""
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine

    from test_torch_checkpoint import BATCHES, _loss, _port_engine, _state, _wf
    from test_torch_qwen import jax_params, port_cfg
    from tpu_testing import TINY_QWEN2

    cfg = port_cfg(TINY_QWEN2)
    eng = _port_engine(jax_params(TINY_QWEN2, seed=2), cfg)
    eng.train_batch(BATCHES[0], _loss, _wf)
    eng.train_batch(BATCHES[1], _loss, _wf)
    h = _handler("port", tmp_path)
    step = tio.StepInfo(epoch=0, epoch_step=1, global_step=1, steps_per_epoch=4)
    h.dump(eng, step, async_=True)
    h.saver.wait_async()
    eng2 = _port_engine(jax_params(TINY_QWEN2, seed=3), cfg)
    info = h.load(eng2)
    assert isinstance(eng2, TorchTrainEngine) and info.last_step_info.global_step == 1
    assert eng2.get_version() == 2 and eng2._opt.count == 2
    a, b = _state(eng), _state(eng2)
    assert all(torch.equal(a[k], b[k]) for k in a)


def _real_engine(seed):
    from test_torch_checkpoint import _port_engine
    from test_torch_qwen import jax_params, port_cfg
    from tpu_testing import TINY_QWEN2

    return _port_engine(jax_params(TINY_QWEN2, seed=seed), port_cfg(TINY_QWEN2))


def _file_ids(ckpt):
    d = os.path.join(ckpt, "state")
    return {f: (os.stat(os.path.join(d, f)).st_ino, os.stat(os.path.join(d, f)).st_mtime_ns) for f in os.listdir(d)}


def test_emergency_dump_of_a_durable_step_rewrites_only_its_record(tmp_path):
    """The port's emergency dump of a step whose async dump is durable
    writes no state: the checkpoint's files stay as they are (a write into
    them inside the grace window could be cut by the kill), the record is
    rewritten in place with the loop's state of now, and ``.prev`` keeps
    the generation before. A relaunch preempted before its first step does
    the same over the checkpoint it loaded."""
    from test_torch_checkpoint import BATCHES, _loss, _state, _wf

    eng = _real_engine(2)
    h = _handler("port", tmp_path)
    for gs in range(2):
        eng.train_batch(BATCHES[gs], _loss, _wf)
        h.dump(eng, _step("port", gs), async_=True)
    h.saver.wait_async()
    ckpt = h.read_recover_info()[1]
    files = _file_ids(ckpt)

    def refuse(*a, **k):
        raise AssertionError("the engine's state was written again")

    eng.save = eng.snapshot_for_save = refuse
    dl = tdata.StatefulDataLoader(list(range(40)), batch_size=4)
    it = iter(dl)
    next(it), next(it), next(it)
    assert h.dump_emergency(eng, _step("port", 1), dataloader=dl) == ckpt
    assert _file_ids(ckpt) == files
    info, path = h.read_recover_info()
    assert path == ckpt and info.last_step_info == _step("port", 1) and info.dataloader_state == dl.state_dict()
    assert h._read_pair(".prev")[0].last_step_info.global_step == 0

    h2 = _handler("port", tmp_path)
    eng2 = _real_engine(3)
    assert h2.load(eng2).last_step_info.global_step == 1
    a, b = _state(eng), _state(eng2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    eng2.save = eng2.snapshot_for_save = refuse
    assert h2.dump_emergency(eng2, _step("port", 1)) == ckpt and _file_ids(ckpt) == files
    # a step not yet durable is written, synchronously
    del eng2.save, eng2.snapshot_for_save
    path3 = h2.dump_emergency(eng2, _step("port", 2))
    assert path3 != ckpt and h2.read_recover_info()[1] == path3 and h2._read_pair(".prev")[1] == ckpt


def test_cut_state_write_keeps_the_old_state_or_falls_back_to_prev(tmp_path, monkeypatch):
    """A rewrite of a checkpoint's state cut mid-write leaves the old state
    whole (the new files go to ``state.tmp/``); a cut between the two
    renames leaves no manifest, and the relaunch falls back to ``.prev``
    (counted), restoring that generation bit for bit."""
    from areal_tpu_torch.engine import train_engine as tte
    from test_torch_checkpoint import BATCHES, _loss, _state, _wf

    eng = _real_engine(2)
    h = _handler("port", tmp_path)
    states = []
    for gs in range(2):
        eng.train_batch(BATCHES[gs], _loss, _wf)
        h.dump(eng, _step("port", gs))
        states.append(_state(eng))
    ckpt = h.read_recover_info()[1]
    save_file, calls = tte.save_file, []

    def cut(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise OSError("killed mid-write")
        return save_file(*a, **k)

    monkeypatch.setattr(tte, "save_file", cut)
    eng.train_batch(BATCHES[2], _loss, _wf)
    with pytest.raises(OSError, match="killed mid-write"):
        h.dump(eng, _step("port", 1), force=True)
    monkeypatch.setattr(tte, "save_file", save_file)
    fallbacks = tcatalog.robustness_metrics().recover_fallbacks
    before = fallbacks.get()
    eng1 = _real_engine(3)
    assert _handler("port", tmp_path).load(eng1).last_step_info.global_step == 1
    got = _state(eng1)
    assert all(torch.equal(got[k], states[1][k]) for k in got) and fallbacks.get() == before

    os.replace(os.path.join(ckpt, "state"), os.path.join(ckpt, "state.old"))  # the kill between the renames
    eng0 = _real_engine(4)
    info = _handler("port", tmp_path).load(eng0)
    assert info.last_step_info.global_step == 0 and fallbacks.get() == before + 1
    got = _state(eng0)
    assert all(torch.equal(got[k], states[0][k]) for k in got)


# ---------------------------------------------------------------------------
# the saver's async and emergency dumps, both packages
# ---------------------------------------------------------------------------


class _SnapshotEngine(_StubEngine):
    """The snapshot / write split with an observable delay."""

    def __init__(self, write_delay_s=0.15):
        super().__init__()
        self.write_delay_s = write_delay_s
        self.written = []
        self.write_started = threading.Event()

    def snapshot_for_save(self, with_optim=True):
        return {"params": {"w": np.ones(4)}}

    def write_snapshot(self, snapshot, path):
        self.write_started.set()
        time.sleep(self.write_delay_s)
        _mark_complete(path)
        self.written.append(path)


def _step(pkg, gs):
    return PKGS[pkg]["io"].StepInfo(epoch=0, epoch_step=gs, global_step=gs, steps_per_epoch=10)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_async_dump_records_land_after_write(tmp_path, pkg):
    h = _handler(pkg, tmp_path)
    eng = _SnapshotEngine(write_delay_s=0.25)
    t0 = time.monotonic()
    path = h.dump(eng, _step(pkg, 0), async_=True)
    assert path is not None and time.monotonic() - t0 < 0.2  # the pause: the snapshot only
    assert eng.write_started.wait(5.0)
    assert h.read_recover_info() is None  # the write is in flight: no record yet
    h.saver.wait_async()
    info, ckpt = h.read_recover_info()
    assert ckpt == path and info.last_step_info.global_step == 0
    h.dump(eng, _step(pkg, 1), async_=True)
    h.saver.wait_async()
    assert h.read_recover_info()[0].last_step_info.global_step == 1
    assert os.path.exists(h._info_path(".prev"))


@pytest.mark.parametrize("pkg", list(PKGS))
def test_emergency_dump_forces_sync_and_skips_freq_gate(tmp_path, pkg):
    h = _handler(pkg, tmp_path)
    eng = _SnapshotEngine()
    assert h.dump(eng, _step(pkg, 0)) is not None  # consumes the trigger of step 0
    assert h.dump(eng, _step(pkg, 0)) is None  # the gated dump declines
    path = h.dump_emergency(eng, _step(pkg, 0))  # the emergency dump does not
    assert path is not None and eng.saved and not eng.written  # the sync path: engine.save
    assert os.path.isdir(h.read_recover_info()[1])


@pytest.mark.parametrize("pkg", list(PKGS))
def test_async_dump_write_failure_surfaces_and_preserves_prev(tmp_path, pkg):
    h = _handler(pkg, tmp_path)
    assert h.dump(_SnapshotEngine(write_delay_s=0.0), _step(pkg, 0), async_=True) is not None
    h.saver.wait_async()

    class _Broken(_SnapshotEngine):
        def write_snapshot(self, snapshot, path):
            raise OSError("disk gone")

    h.saver.freq_ctl.load_state_dict({"last_time_delta": 0, "last_epoch": 0, "last_step": 0})
    h.dump(_Broken(), _step(pkg, 1), async_=True)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        h.saver.wait_async()
    h.saver.wait_async()  # surfaced once
    assert h.read_recover_info()[0].last_step_info.global_step == 0  # the failed generation never rotated


def test_ckpt_save_seconds_family_matches_jax():
    """The metric families the saver and the drain report into: the same
    names, types, labels and buckets in both catalogs."""
    def families(cat):
        ns = cat.preemption_metrics()
        return {k: (f.name, f.type, f.label_names, f.buckets if f.type == "histogram" else None)
                for k, f in vars(ns).items()}

    assert families(tcatalog) == families(jcatalog)
    assert families(tcatalog)["ckpt_save_seconds"][:3] == ("areal_ckpt_save_seconds", "histogram", ("mode",))
