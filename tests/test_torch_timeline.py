"""Request timelines, the flight recorder, trace-header propagation and the
metric catalog: the port (``areal_tpu_torch/observability``) against the
JAX package on the same inputs.

Timelines run on a shared fake clock (``time.monotonic`` / ``time.time``
patched alike in both modules), so breakdowns, records, histogram
observations and Prometheus text must agree exactly, not within a
tolerance. Mirrors ``test_timeline.py`` and ``test_trace_propagation.py``.
"""

import json
import threading

import pytest

from areal_tpu.observability import catalog as jcat
from areal_tpu.observability import timeline as jtl
from areal_tpu.observability import tracecontext as jtc
from areal_tpu.observability.metrics import Registry as JRegistry
from areal_tpu.utils import perf_tracer as jpt
from areal_tpu_torch.observability import catalog as tcat
from areal_tpu_torch.observability import timeline as ttl
from areal_tpu_torch.observability import tracecontext as ttc
from areal_tpu_torch.observability.metrics import Registry as TRegistry
from areal_tpu_torch.utils import perf_tracer as tpt

SIDES = (("jax", jtl, jcat, JRegistry), ("torch", ttl, tcat, TRegistry))


class FakeClock:
    """A monotonic clock that only moves when told to."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    # both modules read the one ``time`` module: one patch covers them
    monkeypatch.setattr(jtl.time, "monotonic", c)
    monkeypatch.setattr(jtl.time, "time", lambda: 1.7e9 + c.t)
    assert ttl.time is jtl.time
    return c


# (stage, seconds after the previous event) — the sequences the decode
# engines produce; accumulators set where the loop would set them
SEQUENCES = {
    "cold": [("admitted", 0.01), ("prefill_start", 0.002), ("prefill_end", 0.05), ("first_token", 0.09),
             ("decode_chunk", 0.0), ("decode_chunk", 0.04), ("decode_chunk", 0.04)],
    "radix_hit": [("admitted", 0.003), ("radix_match", 0.0), ("prefill_start", 0.0), ("prefill_end", 0.02),
                  ("first_token", 0.06), ("decode_chunk", 0.0), ("decode_chunk", 0.04)],
    "zero_prefill_resume": [("resume", 0.004), ("admitted", 0.0), ("first_token", 0.07), ("decode_chunk", 0.0),
                            ("decode_chunk", 0.03)],
    "fence_before_first_token": [("admitted", 0.01), ("prefill_start", 0.0), ("prefill_end", 0.03),
                                 ("fence_stall", 0.01), ("first_token", 0.2), ("decode_chunk", 0.0),
                                 ("decode_chunk", 0.05)],
    "fence_after_first_token": [("admitted", 0.01), ("prefill_start", 0.0), ("prefill_end", 0.03),
                                ("first_token", 0.05), ("decode_chunk", 0.0), ("fence_stall", 0.01),
                                ("decode_chunk", 0.3), ("decode_chunk", 0.04)],
    "over_cap": [("admitted", 0.01), ("prefill_start", 0.0), ("prefill_end", 0.03), ("first_token", 0.05)]
    + [("decode_chunk", 0.002)] * 400,
}
ACCUMULATORS = {
    "zero_prefill_resume": dict(park_s=0.5),
    "fence_before_first_token": dict(fence_stall_s=0.15, fence_stall_pre_first_s=0.15),
    "fence_after_first_token": dict(fence_stall_s=0.25),
}


def _run(mod, cat, reg_cls, clock, name, n_tokens=9, reason="stop"):
    """One request's timeline through a recorder on its own registry:
    (breakdown, record, Prometheus text of the timeline histograms)."""
    clock.t = 1000.0
    reg = reg_cls()
    rec = mod.TimelineRecorder(max_recent=8)
    rec._obs = cat.timeline_metrics(reg)
    tl = rec.start("r-" + name, priority="rollout", task_id="t1", session_id="s1")
    tl.queued_ts = clock.t  # the dataclass default bound the real clock
    tl.epoch_anchor = 1.7e9
    tl.events[0] = (mod.QUEUED, clock.t, None)
    for stage, dt in SEQUENCES[name]:
        clock.t += dt
        tl.mark(stage, n=1) if stage == "decode_chunk" else tl.mark(stage)
    for k, v in ACCUMULATORS.get(name, {}).items():
        setattr(tl, k, v)
    clock.t += 0.02
    bd = rec.complete(tl, reason, n_tokens)
    return bd, rec.recent()[-1], reg.render_prometheus(), rec.stats()


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_breakdown_and_histograms_match_jax(clock, name):
    out = {side: _run(mod, cat, reg, clock, name) for side, mod, cat, reg in SIDES}
    (jbd, jrec, jtext, jst), (tbd, trec, ttext, tst) = out["jax"], out["torch"]
    assert tbd == jbd
    assert trec == jrec
    assert ttext == jtext and "areal_request_tpot_seconds_count 1" in ttext
    assert tst == jst == {"started": 1, "completed": 1, "unterminated": 0, "recent": 1}
    # the identity: the named stages plus the residual rebuild the wall time
    named = tbd["queue_wait_s"] + tbd["prefill_s"] + tbd["decode_s"] + tbd["fence_stall_s"] + tbd["other_s"]
    assert named == pytest.approx(tbd["total_s"], abs=1e-12)
    if name == "over_cap":
        assert trec["dropped_events"] > 0 and trec["events"][-1]["stage"] == "terminal"
    if name == "fence_after_first_token":
        # TPOT leaves the in-window stall out: (term - first - 0.25) / 8
        assert 'areal_request_tpot_seconds_bucket{le="0.025"} 1' in ttext


def test_breakdown_without_terminal_reads_the_clock(clock):
    bds = []
    for _, mod, _, _ in SIDES:
        clock.t = 50.0
        tl = mod.RequestTimeline(rid="x", queued_ts=50.0)
        clock.t += 0.3
        tl.mark(mod.ADMITTED)
        clock.t += 0.2
        bds.append(tl.breakdown())
    assert bds[0] == bds[1] and bds[1]["total_s"] == pytest.approx(0.5)


def test_priority_clamps_and_unterminated_counts(clock):
    for _, mod, cat, reg_cls in SIDES:
        rec = mod.TimelineRecorder(max_recent=2)
        rec._obs = cat.timeline_metrics(reg_cls())
        tls = [rec.start(f"r{i}", priority=p) for i, p in enumerate(["interactive", "rollout", "evil\"label"])]
        assert [t.priority for t in tls] == ["interactive", "rollout", "interactive"]
        for t in tls[:2]:
            rec.complete(t, "stop", 0)
        assert rec.unterminated() == 1 and rec.recent(0) == [] and len(rec.recent(5)) == 2


def _flight(mod, clock, capacity=8, n=20):
    clock.t = 1.0
    fr = mod.FlightRecorder(capacity=capacity, role="test")
    for i in range(n):
        clock.t += 0.5
        fr.record("evt", severity="warn" if i % 3 else "info", i=i)
    return fr


def test_flight_ring_overflow_matches_jax(clock):
    snaps = [_flight(mod, clock).snapshot() for _, mod, _, _ in SIDES]
    assert snaps[0] == snaps[1]
    assert snaps[1]["dropped"] == 12
    assert [e["data"]["i"] for e in snaps[1]["events"]] == list(range(12, 20))
    assert [e["seq"] for e in snaps[1]["events"]] == list(range(13, 21))


def test_flight_dump_is_atomic_and_complete(clock, tmp_path):
    dumps = []
    for side, mod, _, _ in SIDES:
        fr = _flight(mod, clock, capacity=4, n=6)
        path = tmp_path / side / "sub" / "flight.json"
        assert fr.dump(str(path), reason="wedge") == str(path)
        # no temporary file is left beside the dump
        assert [p.name for p in path.parent.iterdir()] == ["flight.json"]
        dumps.append(json.loads(path.read_text()))
    assert dumps[0] == dumps[1]
    assert set(dumps[1]) == {"role", "pid", "capacity", "dropped", "events", "dump_reason", "dumped_at"}


def test_trace_event_converters_match_jax(clock):
    records = []
    for _, mod, cat, reg in SIDES:
        for name in ("cold", "zero_prefill_resume", "fence_after_first_token"):
            records.append(_run(mod, cat, reg, clock, name)[1])
    jrecs, trecs = records[:3], records[3:]
    assert ttl.timelines_to_trace_events(trecs) == jtl.timelines_to_trace_events(trecs)
    assert ttl.timelines_to_trace_events(jrecs) == jtl.timelines_to_trace_events(jrecs)
    snap = _flight(ttl, clock).snapshot()
    assert ttl.flight_to_trace_events(snap) == jtl.flight_to_trace_events(snap)
    names = {e["name"] for e in ttl.timelines_to_trace_events(trecs)}
    assert {"queue_wait", "prefill", "decode", "resume", "fence_stall", "terminal"} <= names


def test_signal_dump_needs_the_main_thread():
    box = {}
    t = threading.Thread(target=lambda: box.update(j=jtl.install_signal_dump(), t=ttl.install_signal_dump()))
    t.start()
    t.join()
    assert box == {"j": False, "t": False}


def test_signal_dump_off_the_main_thread_once_armed():
    """Armed already (a server earlier in the process), the port still
    answers False off the main thread, as JAX's does: the early return for
    an armed handler answered True there, so the test above passed or
    failed with what ran before it in the process."""
    import signal

    prev = signal.getsignal(signal.SIGTERM)
    try:
        assert ttl.install_signal_dump() is True
        box = {}
        t = threading.Thread(target=lambda: box.update(j=jtl.install_signal_dump(), t=ttl.install_signal_dump()))
        t.start()
        t.join()
        assert box == {"j": False, "t": False}
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_default_dump_path_honors_the_flight_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("AREAL_FLIGHT_DIR", str(tmp_path))
    assert ttl.default_dump_path("wedge").startswith(str(tmp_path))
    assert ttl.default_dump_path("wedge").endswith("_wedge.json")


# ---------------------------------------------------------------------------
# x-areal-trace
# ---------------------------------------------------------------------------

HEADERS = [
    {"x-areal-trace": "task=t1;session=s1"},
    {"X-Areal-Trace": "session=s9"},
    {"X-AREAL-TRACE": "task=t2;junk;k=v;session="},
    {"x-areal-trace": ""},
    {"content-type": "application/json"},
]


@pytest.mark.parametrize("headers", HEADERS, ids=range(len(HEADERS)))
def test_trace_header_extract_matches_jax(headers):
    res = {}

    def run(side, tc, pt):
        pt.set_task_context(task_id="stale-task", session_id="stale-session")
        got = tc.extract(headers)
        res[side] = (got, pt.get_task_context(), tc.inject({"a": "b"}))

    # a thread each: a fresh context, so neither side sees the other's ids
    for side, tc, pt in (("jax", jtc, jpt), ("torch", ttc, tpt)):
        t = threading.Thread(target=run, args=(side, tc, pt))
        t.start()
        t.join()
    assert res["torch"] == res["jax"]
    got, ctx, injected = res["torch"]
    # the context is exactly what the header carries: stale ids are gone
    assert ctx == got
    if got == (None, None):
        assert injected == {"a": "b"}


def test_trace_header_round_trip():
    for task, session in (("t", "s"), ("t", None), (None, "s"), (None, None)):
        value = ttc.format_trace_header(task, session)
        assert value == jtc.format_trace_header(task, session)
        if value is not None:
            assert ttc.parse_trace_header(value) == (task, session)
    assert ttc.TRACE_HEADER == jtc.TRACE_HEADER == "x-areal-trace"


# ---------------------------------------------------------------------------
# the catalog
# ---------------------------------------------------------------------------

FAMILIES = ("timeline_metrics", "flight_metrics", "kernel_metrics", "speculative_metrics")


def _families(cat, reg_cls, name):
    reg = reg_cls()
    getattr(cat, name)(reg)
    return {f.name: (f.type, f.help, f.label_names, f.buckets) for f in reg.families()}


@pytest.mark.parametrize("name", FAMILIES)
def test_catalog_families_match_jax(name):
    j, t = _families(jcat, JRegistry, name), _families(tcat, TRegistry, name)
    assert t == j and len(t) >= 2


def test_register_all_follows_the_jax_order():
    jorder = [f.__name__ for f in jcat.ALL_FACTORIES]
    torder = [f.__name__ for f in tcat.ALL_FACTORIES]
    assert torder == [n for n in jorder if n in set(torder)]
    assert set(FAMILIES) <= set(torder)
    reg = tcat.register_all(TRegistry())
    jreg = JRegistry()
    for name in torder:
        getattr(jcat, name)(jreg)
    # train_obs_metrics leaves out the XLA compile counters (no PyTorch
    # counterpart); every other family registers in the same order
    assert [f.name for f in reg.families()] == [
        f.name for f in jreg.families() if not f.name.startswith("areal_xla_compile")
    ]


def test_same_operations_render_the_same_text():
    texts = []
    for _, _, cat, reg_cls in SIDES:
        reg = reg_cls()
        k, s, f = cat.kernel_metrics(reg), cat.speculative_metrics(reg), cat.flight_metrics(reg)
        for p, v in (("admission", 0.001), ("device_wait", 0.02), ("other", 1e-5)):
            k.phase_seconds.labels(phase=p).observe(v)
        k.step_flops.set(3.5e12)
        k.roofline_fraction.set(0.125)
        s.rounds.inc(3)
        s.draft_tokens.labels(source="ngram").inc(12)
        s.accepted_length.observe(2)
        f.events.labels(kind="wedge").inc()
        f.dumps.inc()
        texts.append(reg.render_prometheus())
    assert texts[0] == texts[1]
