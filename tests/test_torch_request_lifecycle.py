"""The request lifecycle of the port's engine, server and client against the
JAX package's: deadlines (mid-decode, in the queue, over the header), the
cancellation of a parked rid, the per-slot watchdog and the wedge detector,
both 429 admission gates and the client's backpressure, the drain / undrain
and its terminal 409, ``/statusz``, ``/autopilot/knobs`` with and without its
token, and the catalog families the engine and the server increment.

Mirrors the engine and HTTP tests of ``test_request_lifecycle.py``, the
server-side drain cases of ``test_preemption.py`` and the knob endpoint of
``test_autopilot.py``. Both sides hold ``TINY_QWEN2`` in f32 from the same
seeded numpy weights; where tokens are compared, the engines are driven
directly (no loop thread) so a reap lands at the same token in both."""

import asyncio
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from areal_tpu.api.config import RequestLifecycleConfig as JRequestLifecycleConfig
from areal_tpu.inference import decode_engine as jde
from areal_tpu.inference.server import ServerThread as JServerThread
from areal_tpu.observability import catalog as j_catalog
from areal_tpu.observability import metrics as j_metrics
from areal_tpu_torch.api import io_struct as t_io
from areal_tpu_torch.api.config import InferenceEngineConfig, RequestLifecycleConfig
from areal_tpu_torch.inference import decode_engine as tde
from areal_tpu_torch.inference.client import RemoteTorchEngine
from areal_tpu_torch.inference.server import ServerThread
from areal_tpu_torch.observability import catalog as t_catalog
from areal_tpu_torch.observability import metrics as t_metrics

from test_torch_kv_parking import jax_engine, leaked, port_engine, request, step
from test_torch_qwen import jax_params
from tpu_testing import TINY_QWEN2

LOGPROB_ATOL = 1e-4
LC_KW = dict(max_batch_size=2, decode_steps_per_call=4)
SIDES = (("jax", jax_engine), ("torch", port_engine))


@pytest.fixture(scope="module")
def weights():
    return jax_params(TINY_QWEN2, seed=31)


def _long(side, ids, rid="", **kw):
    return request(side, ids, rid=rid, max_new_tokens=100_000, greedy=True, ignore_eos=True, **kw)


def _settle(eng, timeout=30.0):
    """Wait until no request is queued, decoding or parked."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        snap = eng.admission_snapshot()
        if snap["queue_depth"] == 0 and snap["active_slots"] == 0 and not eng._parked:
            return
        time.sleep(0.02)
    raise TimeoutError("the engine never settled")


def _slow(eng, secs=0.01):
    """Hold each decode chunk for ``secs`` more, so a long request is still
    decoding when a test acts on it (the tiny model decodes its whole
    window in well under a second)."""
    dispatch = eng._dispatch_chunk

    def slowed():
        time.sleep(secs)
        return dispatch()

    eng._dispatch_chunk = slowed


def _wait_decoding(eng, rid, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if any(t is not None and t.req.rid == rid and t.out_tokens for t in eng._slot_task):
            return
        time.sleep(0.005)
    raise TimeoutError(f"{rid} never decoded")


# ---------------------------------------------------------------------------
# engine: deadlines, cancellation, watchdog, wedge detector
# ---------------------------------------------------------------------------


def test_deadline_reap_between_chunks_matches_jax(weights):
    """A request whose deadline passes mid-decode is reaped between chunks
    with its partial output (stop_reason and truncated_by "deadline"): the
    same tokens and logprobs as the JAX engine's, its pages published or
    freed as a completion's are."""
    res = {}
    for side, make in SIDES:
        eng = make(weights, **LC_KW)
        out = []
        eng.submit(_long(side, [5, 6, 7] * 7, rid="dl"), out.append)
        step(eng, 3)
        assert not out
        eng._slot_task[0].req.deadline = time.time() - 0.01  # it just passed
        assert eng._reap_lifecycle(None) is None
        assert len(out) == 1 and eng._slot_task[0] is None and not eng._state["active"][0]
        assert eng.stats.get("deadline_reaped", eng.stats.get("deadline_exceeded")) == 1
        assert leaked(eng) == 0
        res[side] = out[0]
    j, t = res["jax"], res["torch"]
    assert t.stop_reason == j.stop_reason == "deadline" and t.truncated_by == j.truncated_by == "deadline"
    assert t.output_tokens == j.output_tokens and len(t.output_tokens) == 12
    np.testing.assert_allclose(t.output_logprobs, j.output_logprobs, atol=LOGPROB_ATOL)
    assert len(t.output_versions) == len(t.output_tokens)


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_deadline_reaps_mid_decode(weights, side):
    """On a running loop: a 1.2 s deadline ends a long request with a
    partial output within seconds, and nothing leaks."""
    eng = dict(SIDES)[side](weights, **LC_KW)
    _slow(eng, 0.05)
    eng.start()
    try:
        t0 = time.time()
        req = _long(side, [5, 6, 7])
        req.deadline = t0 + 1.2
        resp = eng.generate_sync(req, timeout=60)
        assert resp.stop_reason == "deadline" and resp.truncated_by == "deadline"
        assert 0 < len(resp.output_tokens) == len(resp.output_versions)
        assert time.time() - t0 < 10
        _settle(eng)
    finally:
        eng.stop()
    assert leaked(eng) == 0


def test_deadline_expired_in_queue_never_prefills(weights):
    for side, make in SIDES:
        eng = make(weights, **LC_KW)
        out = []
        req = request(side, [1, 2], max_new_tokens=8, greedy=True)
        req.deadline = time.time() - 1.0
        eng.submit(req, out.append)
        step(eng)
        assert out[0].stop_reason == "deadline" and out[0].truncated_by == "deadline", side
        assert out[0].output_tokens == [] and eng.stats["prefills"] == 0 and eng.stats["prefill_tokens"] == 0
        assert leaked(eng) == 0


def test_cancelled_parking_counts_once(weights):
    """abort_request on a parked rid drops the parking, frees its pages and
    counts one cancellation; on a rid that is also queued for its resume,
    the queued task is answered "cancelled" and still counted once."""
    res = {}
    for side, make in SIDES:
        eng = make(weights, **LC_KW)
        out = []
        for rid in ("p1", "p2"):
            eng.submit(_long(side, [3, 1, 4, 1, 5], rid=rid), out.append)
        step(eng, 2)
        eng.pause_generation()
        eng._abort_all()
        eng.continue_generation()
        assert set(eng._parked) == {"p1", "p2"}
        # p2 resubmits, then both are cancelled before the next admission
        eng.submit(_long(side, [3, 1, 4, 1, 5] + out[1].output_tokens, rid="p2"), out.append)
        eng.abort_request("p1")
        eng.abort_request("p2")
        eng._reap_lifecycle(None)
        assert not eng._parked and eng.stats["cancelled"] == 2 and leaked(eng) == 0
        res[side] = [(r.rid, r.stop_reason, r.truncated_by, len(r.output_tokens)) for r in out]
    assert res["torch"] == res["jax"]
    assert res["torch"][-1] == ("p2", "cancelled", "cancelled", 0)


def test_watchdog_reaps_stalled_slot(weights):
    """White-box on a stopped engine (a running loop refreshes progress each
    chunk): an active slot whose progress is older than watchdog_s is
    aborted with truncated_by "watchdog"; a fresh one is untouched."""
    for side, make in SIDES:
        eng = make(weights, **LC_KW)
        eng.config.lifecycle.watchdog_s = 1.0
        task_cls = jde._Task if side == "jax" else tde._Task
        box = {}
        eng._slot_task[0] = task_cls(req=_long(side, [8, 8]), callback=lambda r: box.update(r=r), slot=0)
        eng._state["active"][0] = True
        eng._slot_progress[0] = time.monotonic() - 10.0
        assert eng._reap_lifecycle(None) is None
        assert box["r"].truncated_by == "watchdog" and box["r"].stop_reason == "cancelled", side
        assert eng.stats["watchdog_fired"] == 1 and eng._slot_task[0] is None and not eng._state["active"][0]
        assert leaked(eng) == 0
        fresh = task_cls(req=_long(side, [4, 4]), callback=lambda r: box.update(r2=r), slot=1)
        eng._slot_task[1] = fresh
        eng._state["active"][1] = True
        eng._slot_progress[1] = time.monotonic()
        eng._reap_lifecycle(None)
        assert "r2" not in box and eng._slot_task[1] is fresh


def test_wedge_detector(weights, monkeypatch, tmp_path):
    """A stale loop heartbeat + pending work + a live thread is a wedge;
    an idle, fresh, paused or switched-off detector is not. The first
    report of a wedge episode dumps the flight ring, once; a wedge that
    clears re-arms the dump."""

    class _AliveThread:
        def is_alive(self):
            return True

    for side, make in SIDES:
        flight_dir = tmp_path / side
        monkeypatch.setenv("AREAL_FLIGHT_DIR", str(flight_dir))
        eng = make(weights, **LC_KW, lifecycle=(JRequestLifecycleConfig if side == "jax" else RequestLifecycleConfig)(
            engine_stall_escalate_s=1.0))
        task_cls = jde._Task if side == "jax" else tde._Task
        assert not eng.is_wedged()  # no thread
        eng._thread = _AliveThread()
        assert not eng.is_wedged()  # no work
        eng._backlog.append(task_cls(req=request(side, [1]), callback=lambda r: None))
        eng._last_loop_ts = time.monotonic() - 30.0
        assert eng.is_wedged(), side
        dumps = list(flight_dir.glob("flight_*_wedge.json"))
        assert len(dumps) == 1, side
        snap = json.loads(dumps[0].read_text())
        assert snap["dump_reason"] == "wedge" and snap["events"][-1]["kind"] == "wedge"
        dumps[0].unlink()
        assert eng.is_wedged()  # one dump an episode, not one a poll
        assert not list(flight_dir.glob("flight_*_wedge.json"))
        eng._last_loop_ts = time.monotonic()
        assert not eng.is_wedged()
        eng._last_loop_ts = time.monotonic() - 30.0
        assert eng.is_wedged() and len(list(flight_dir.glob("flight_*_wedge.json"))) == 1  # re-armed
        eng._last_loop_ts = time.monotonic() - 30.0
        eng._held.set()
        assert not eng.is_wedged()  # a held loop idles by design
        eng._held.clear()
        eng.config.lifecycle.engine_stall_escalate_s = 0.0
        assert not eng.is_wedged()  # detector off
        eng._thread = None


def test_loop_heartbeat_and_progress(weights):
    """The running loop stamps its heartbeat every pass and a slot's
    progress at admission and at every chunk that credits it tokens."""
    eng = port_engine(weights, **LC_KW, lifecycle=RequestLifecycleConfig(engine_stall_escalate_s=5.0))
    _slow(eng)
    eng.start()
    try:
        req = _long("torch", [2, 3])
        eng.submit(req, lambda r: None)
        _wait_decoding(eng, req.rid)
        time.sleep(0.2)
        assert time.monotonic() - eng._last_loop_ts < 1.0 and not eng.is_wedged()
        assert max(eng._slot_progress) > time.monotonic() - 1.0
    finally:
        eng.stop()


# ---------------------------------------------------------------------------
# the engine's drain
# ---------------------------------------------------------------------------


def test_engine_drain_finish_or_park(weights):
    """A long rid'd request that cannot finish within the budget parks
    (partial tokens now, KV retained); admission answers "draining"; the
    summary's page audit is clean; end_drain and a cancel free the parking."""
    for side, make in SIDES:
        eng = make(weights, max_batch_size=4, decode_steps_per_call=4)
        _slow(eng)
        eng.start()
        try:
            done = []
            eng.submit(_long(side, [5, 6, 7], rid="drain-park"), done.append)
            _wait_decoding(eng, "drain-park")
            summary = eng.drain(budget_s=0.05)
            assert len(done) == 1 and done[0].stop_reason == "abort" and done[0].output_tokens, side
            assert "drain-park" in eng._parked and summary["parked"] >= 1
            assert summary["finished_in_budget"] is False
            # the JAX summary counts a parked page that is also published
            # twice (its leaked_pages goes negative then); the port's counts
            # each held page once
            assert summary["leaked_pages"] == 0 if side == "torch" else summary["leaked_pages"] <= 0
            admit, reason, _ = eng.check_admission()
            assert not admit and reason == "draining"
            assert eng.drain_status()["draining"] is True and eng.drain_status()["terminal"] is False
            assert eng.end_drain()
            eng.continue_generation()
            eng.abort_request("drain-park")
            _settle(eng)
            assert eng.check_admission()[0]
        finally:
            eng.stop()
        assert leaked(eng) == 0


def test_engine_drain_aborts_queued(weights):
    for side, make in SIDES:
        eng = make(weights, **LC_KW)
        eng.start()
        try:
            eng.pause_generation()
            eng._pause_ack.wait(5.0)
            done = []
            for i in range(3):
                eng.submit(request(side, [9 + i, 2, 3], rid=f"queued-{i}", max_new_tokens=4, greedy=True), done.append)
            summary = eng.drain(budget_s=0.05)
            assert len(done) == 3 and all(r.stop_reason == "abort" for r in done), side
            assert summary["leaked_pages"] == 0
        finally:
            eng.end_drain()
            eng.continue_generation()
            eng.stop()


# ---------------------------------------------------------------------------
# HTTP: both servers side by side
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def servers(weights):
    """A JAX and a port server over the same weights, 2 slots each."""
    jeng = jax_engine(weights, **LC_KW, host="127.0.0.1", port=0)
    js = JServerThread(jeng.config, jeng)
    js.start()
    teng = port_engine(weights, **LC_KW, host="127.0.0.1", port=0)
    for eng in (jeng, teng):
        _slow(eng)
    ts = ServerThread(teng.config, teng)
    ts.start()
    yield {"jax": js, "torch": ts}
    js.stop()
    ts.stop()


def _http(addr, path, body=None, headers=None, method=None, timeout=60):
    """(status, headers, JSON body) of one request; errors included."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://{addr}{path}", data=data, headers={"Content-Type": "application/json",
                                                                             **(headers or {})},
                                 method=method or ("GET" if body is None else "POST"))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


def _gen(ids, n=4, **sp):
    return {"input_ids": ids, "sampling_params": {"max_new_tokens": n, "greedy": True, **sp}}


def test_http_page_headroom_gate_rejects_429(servers):
    got = {}
    for side, st in servers.items():
        lc = st.engine.config.lifecycle
        lc.min_free_pages = 10**6
        try:
            got[side] = _http(st.address, "/generate", _gen([1, 2, 3]))
        finally:
            lc.min_free_pages = 0
    for status, headers, body in got.values():
        assert status == 429 and body["reason"] == "page_headroom" and body["status"] == "rejected"
        assert 1.0 <= float(headers["Retry-After"]) <= 1.5  # retry_after_s 1, jitter 0.5
    assert set(got["torch"][2]) == set(got["jax"][2])


def test_http_queue_depth_gate_rejects_429(servers):
    got = {}
    for side, st in servers.items():
        eng = st.engine
        eng.config.lifecycle.max_queue_depth = 1
        fills = []
        try:
            for _ in range(3):  # both slots busy and one queued
                done = threading.Event()
                req = _long(side, [6, 6, 6])
                eng.submit(req, lambda r, d=done: d.set())
                fills.append((req, done))
            deadline = time.monotonic() + 30
            while eng.admission_snapshot()["queue_depth"] < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            got[side] = _http(st.address, "/generate", _gen([1, 2]))
        finally:
            eng.config.lifecycle.max_queue_depth = 0
            for req, _ in fills:
                eng.abort_request(req.rid)
            for _, done in fills:
                assert done.wait(30)
            _settle(eng)
            assert leaked(eng) == 0
    for status, headers, body in got.values():
        assert status == 429 and body["reason"] == "queue_depth" and "Retry-After" in headers


def test_http_deadline_header_reaps(servers):
    for side, st in servers.items():
        status, _, body = _http(st.address, "/generate", _gen([4, 5], n=100_000, ignore_eos=True),
                                headers={"x-areal-deadline": f"{time.time() + 0.05:.6f}"})
        assert status == 200 and body["stop_reason"] == "deadline" and body["truncated_by"] == "deadline", side
        _settle(st.engine)
        assert leaked(st.engine) == 0


def test_http_bad_deadline_header_400(servers):
    for side, st in servers.items():
        status, _, _ = _http(st.address, "/generate", _gen([1]), headers={"x-areal-deadline": "not-a-number"})
        assert status == 400, side


def test_http_health_turns_503_when_wedged(servers):
    for side, st in servers.items():
        eng = st.engine
        assert _http(st.address, "/health")[0] == 200
        eng.is_wedged = lambda: True
        try:
            status, _, body = _http(st.address, "/health")
            assert status == 503 and body["status"] == "wedged", side
        finally:
            del eng.is_wedged
        assert _http(st.address, "/health")[0] == 200


def test_statusz_reports_lifecycle_snapshot(servers):
    docs = {side: _http(st.address, "/statusz")[2] for side, st in servers.items()}
    t, j = docs["torch"], docs["jax"]
    for key in ("lifecycle", "drain", "autopilot", "prefix_cache"):
        assert set(t[key]) == set(j[key]), key
    assert {"queue_depth", "free_pages", "radix_pages", "active_slots"} <= set(t["lifecycle"])
    assert {"kv_resumes", "watchdog_fired", "deadline_reaped"} <= set(t["stats"])
    assert t["memory"]["kv_pool"] > 0 and t["memory"]["freq_counts"] == 0
    assert {"role", "address", "uptime_secs", "version", "paused"} <= set(t) & set(j)


def test_client_disconnect_cancels_rid(servers):
    """A caller that closes its connection while its request decodes has
    the rid cancelled (its slot and pages reclaimed). The port's server
    only: the JAX server relies on aiohttp cancelling the handler of a
    closed connection, which aiohttp no longer does by default."""
    for side, st in (("torch", servers["torch"]),):
        eng = st.engine
        c0 = eng.stats["cancelled"]
        host, port = st.address.rsplit(":", 1)
        body = json.dumps({**_gen([7, 7], n=100_000, ignore_eos=True), "rid": f"gone-{side}"}).encode()
        s = socket.create_connection((host, int(port)), timeout=10)
        s.sendall(f"POST /generate HTTP/1.1\r\nHost: {st.address}\r\nContent-Type: application/json\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        _wait_decoding(eng, f"gone-{side}")
        s.close()
        deadline = time.monotonic() + 30
        while eng.stats["cancelled"] == c0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.stats["cancelled"] == c0 + 1, side
        _settle(eng)
        assert leaked(eng) == 0


# ---------------------------------------------------------------------------
# the client
# ---------------------------------------------------------------------------


def _client(addr, **kw):
    c = RemoteTorchEngine(InferenceEngineConfig(**{
        "max_concurrent_rollouts": 4, "consumer_batch_size": 2, "max_head_offpolicyness": 100,
        "request_timeout": 120, **kw}), addresses=[addr])
    c.initialize()
    return c


def test_client_429_is_backpressure_not_failure(servers):
    """A 429 waits out its Retry-After within backpressure_wait_s and spends
    no failure retry: past the budget the call fails; a gate that opens
    inside it lets the request through."""
    st = servers["torch"]
    lc = st.engine.config.lifecycle
    lc.min_free_pages, lc.retry_after_s = 10**6, 0.05
    robust = t_catalog.robustness_metrics()
    retries0 = robust.retries.labels(kind="post").get()
    client = _client(st.address, request_retries=2, lifecycle=RequestLifecycleConfig(backpressure_wait_s=0.4))
    try:
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="failed after retries"):
            asyncio.run(client.agenerate(t_io.ModelRequest(
                input_ids=[1, 2, 3], gconfig=t_io.GenerationHyperparameters(max_new_tokens=4, greedy=True))))
        assert 0.3 < time.monotonic() - t0 < 10
        threading.Timer(0.3, lambda: setattr(lc, "min_free_pages", 0)).start()
        client2 = _client(st.address, request_retries=1, lifecycle=RequestLifecycleConfig(backpressure_wait_s=30))
        resp = asyncio.run(client2.agenerate(t_io.ModelRequest(
            input_ids=[1, 2, 3], gconfig=t_io.GenerationHyperparameters(max_new_tokens=4, greedy=True))))
        client2.destroy()
        assert resp.stop_reason == "length" and len(resp.output_tokens) == 4
        assert robust.retries.labels(kind="post").get() == retries0
    finally:
        lc.min_free_pages, lc.retry_after_s = 0, 1.0
        client.destroy()


def test_client_stamps_default_deadline(servers):
    st = servers["torch"]
    client = _client(st.address, lifecycle=RequestLifecycleConfig(default_deadline_s=0.05))
    try:
        t0 = time.time()
        resp = asyncio.run(client.agenerate(t_io.ModelRequest(
            input_ids=[2, 4, 6], gconfig=t_io.GenerationHyperparameters(max_new_tokens=100_000, greedy=True,
                                                                        ignore_eos=True))))
        assert resp.stop_reason == "deadline" and resp.truncated_by == "deadline"
        assert time.time() - t0 < 15
        _settle(st.engine)
        assert leaked(st.engine) == 0
    finally:
        client.destroy()


# ---------------------------------------------------------------------------
# drain / undrain over HTTP, the autopilot's knobs
# ---------------------------------------------------------------------------


def test_server_drain_endpoint_and_health(servers):
    """/drain answers the summary; /health turns 503 "draining" and
    /generate 429 "draining" with Retry-After; /statusz carries the drain;
    /undrain re-opens; a terminal drain's /undrain answers 409. The same
    statuses as the JAX server's."""
    seen = {}
    for side, st in servers.items():
        a = st.address
        s = []
        status, _, out = _http(a, "/drain", {"budget_s": 0.2})
        s.append((status, out["status"], out["leaked_pages"]))
        status, _, out = _http(a, "/health")
        s.append((status, out["status"]))
        s.append(_http(a, "/statusz")[2]["drain"]["draining"])
        status, headers, out = _http(a, "/generate", _gen([4, 5], n=2))
        s.append((status, out["reason"], "Retry-After" in headers))
        s.append(_http(a, "/undrain", {})[0:3:2])
        s.append(_http(a, "/health")[2]["status"])
        s.append(_http(a, "/statusz")[2]["drain"]["draining"])
        st.engine.begin_drain(terminal=True)
        s.append(_http(a, "/undrain", {})[0])
        s.append(_http(a, "/statusz")[2]["drain"]["terminal"])
        st.engine._drain_terminal = False  # only a test may take it back
        assert st.engine.end_drain()
        st.engine.continue_generation()
        seen[side] = s
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0] == (200, "ok", 0) and seen["torch"][1] == (503, "draining")
    assert seen["torch"][3] == (429, "draining", True) and seen["torch"][7] == 409


@pytest.fixture(scope="module")
def knob_servers(weights):
    jeng = jax_engine(weights, **LC_KW, host="127.0.0.1", port=0, autopilot_token="secret-token")
    js = JServerThread(jeng.config, jeng)
    js.start()
    teng = port_engine(weights, **LC_KW, host="127.0.0.1", port=0, autopilot_token="secret-token")
    ts = ServerThread(teng.config, teng)
    ts.start()
    yield {"jax": js, "torch": ts}
    js.stop()
    ts.stop()


@pytest.mark.parametrize("token", [None, "wrong", "secret-token"], ids=["no-token", "bad-token", "token"])
def test_autopilot_knobs_endpoint(knob_servers, token):
    knobs = {"max_queue_depth": 8, "min_free_pages": 4, "radix_max_fraction": 0.25, "unknown": 1}
    got = {}
    for side, st in knob_servers.items():
        headers = {"x-areal-autopilot-token": token} if token else {}
        status, _, body = _http(st.address, "/autopilot/knobs", knobs, headers=headers)
        got[side] = (status, body.get("knobs"))
        eng = st.engine
        if status == 200:
            assert eng.config.lifecycle.max_queue_depth == 8 and eng.config.lifecycle.min_free_pages == 4
            assert eng._radix.max_pages == int((eng.pool.n_pages - 1) * 0.25)
            assert _http(st.address, "/statusz")[2]["autopilot"]["knobs"]["max_queue_depth"] == 8.0
            assert eng.check_admission()[0]
            eng.apply_autopilot_knobs({"max_queue_depth": 0, "min_free_pages": 0, "radix_max_fraction": 1.0})
    assert got["torch"][0] == got["jax"][0] == (200 if token == "secret-token" else 403)
    assert got["torch"] == got["jax"]


def test_autopilot_radix_cap_evicts_down(weights):
    """A shrunk radix cap evicts LRU leaves down to it, inline on a stopped
    engine, as the JAX engine's."""
    res = {}
    for side, make in SIDES:
        eng = make(weights, **LC_KW, page_size=16)
        out = []
        eng.submit(request(side, list(range(1, 100)), max_new_tokens=4, greedy=True), out.append)
        for _ in range(4):
            step(eng)
        held = eng.prefix_cache_stats()["pages_held"]
        status = eng.apply_autopilot_knobs({"radix_max_fraction": 0.05})
        res[side] = (held, eng.prefix_cache_stats()["pages_held"], eng._radix.max_pages, status["knobs"])
    assert res["torch"] == res["jax"] and res["torch"][0] > res["torch"][1] == res["torch"][2]


# ---------------------------------------------------------------------------
# the catalog families the engine and the server increment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["engine_metrics", "prefix_cache_metrics", "server_metrics", "autopilot_metrics"])
def test_catalog_family_renders_equal(family):
    """Same names, labels, help texts and buckets as the JAX catalog, driven
    with the same seeded values."""
    rendered = []
    for metrics_mod, catalog_mod in ((j_metrics, j_catalog), (t_metrics, t_catalog)):
        rng = np.random.default_rng(5)
        reg = metrics_mod.Registry()
        ns = getattr(catalog_mod, family)(reg)
        for _, fam in sorted(vars(ns).items()):
            for _ in range(int(rng.integers(1, 4))):
                child = fam.labels(**{ln: f"v{int(rng.integers(0, 2))}" for ln in fam.label_names}) \
                    if fam.label_names else fam
                if fam.type == "counter":
                    child.inc(float(rng.integers(1, 5)))
                elif fam.type == "gauge":
                    child.set(float(rng.standard_normal()))
                else:
                    child.observe(float(abs(rng.standard_normal()) * 3))
        rendered.append(reg.render_prometheus())
    assert rendered[0] == rendered[1]
