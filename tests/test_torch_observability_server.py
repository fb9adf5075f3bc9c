"""The serving engine's observability, the port against the JAX package, on
the tiny model on the CPU.

- Stage sequences: both engines serve the same requests at the same
  ``decode_steps_per_call`` (a cold wave, a radix-hit wave, an abort pause
  with a parked resume, and a hold fence on the live loop) and give each
  request the same sequence of timeline stages, ``decode_chunk`` counts
  included.
- Every port response's timing fields plus its timeline's ``other_s`` sum
  to its latency within 5 ms; every recorded probe step's phases plus
  ``other_s`` equal its wall time to 1e-9; no timeline is left
  unterminated after a drain; the ledger's weight and KV-pool bytes equal
  the JAX engine's analytic ledger.
- Over HTTP: ``/metrics`` (JSON unchanged, Prometheus text on request),
  ``/statusz`` and ``/debug/flight`` with the JAX server's keys,
  ``/debug/profile``'s statuses, the 429 in the flight ring, the
  ``x-areal-trace`` ids on a request's timeline (from a header and from
  the rollout client), and a SIGTERM that dumps the ring and still ends
  the process (``tests/torch_flight_child.py``).
"""

import asyncio
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from areal_tpu.api.config import MeshConfig as JMeshConfig
from areal_tpu.api.config import ServerConfig as JServerConfig
from areal_tpu.inference import decode_engine as jde
from areal_tpu.inference.server import ServerThread as JServerThread
from areal_tpu.parallel import mesh as mesh_lib
from areal_tpu_torch.api.config import InferenceEngineConfig, MeshConfig, PerfTracerConfig, ServerConfig
from areal_tpu_torch.api.io_struct import TIMING_FIELDS
from areal_tpu_torch.inference import decode_engine as tde
from areal_tpu_torch.inference.client import RemoteTorchEngine
from areal_tpu_torch.inference.server import ServerThread
from areal_tpu_torch.models import qwen as tq
from areal_tpu_torch.observability import kernel_probe
from areal_tpu_torch.utils import perf_tracer

from test_torch_kv_parking import SERVER_KW, abort_pause, drive, jax_engine, port_engine, request, step
from test_torch_qwen import jax_params, port_cfg, port_model
from tpu_testing import TINY_QWEN2

LATENCY_TOL_S = 5e-3
IDENTITY_TOL_S = 1e-9


@pytest.fixture(scope="module")
def weights():
    return jax_params(TINY_QWEN2, seed=31)


def stages(eng, rid: str) -> list[list[str]]:
    """Stage names of every completed timeline of ``rid``, oldest first."""
    return [[e["stage"] for e in r["events"]] for r in eng.timeline.recent() if r["rid"] == rid]


def check_identity(eng, responses) -> None:
    """timing + other_s == latency for every response (its own timeline)."""
    recs = {}
    for r in eng.timeline.recent():
        recs.setdefault(r["rid"], []).append(r)
    for resp in responses:
        rec = recs[resp.rid].pop(0)
        bd = rec["breakdown"]
        assert all(getattr(resp, k) == bd[k] for k in TIMING_FIELDS)
        named = resp.queue_wait_s + resp.prefill_s + resp.decode_s + resp.fence_stall_s + bd["other_s"]
        assert abs(named - resp.latency) < LATENCY_TOL_S, (resp.rid, bd, resp.latency)


def _waves(eng, side):
    """A cold wave, then a radix-hit wave, then an aborted request that
    resumes from its parked KV; responses by rid."""
    rng = np.random.default_rng(5)
    V = TINY_QWEN2.vocab_size
    shared = rng.integers(0, V, 40).tolist()
    out: dict[str, list] = {}

    def sink(resp):
        out.setdefault(resp.rid, []).append(resp)

    for i in range(3):  # cold
        eng.submit(request(side, shared + rng.integers(0, V, 5 + i).tolist(), rid=f"cold{i}", max_new_tokens=10,
                           greedy=True, ignore_eos=True), sink)
    drive(eng)
    for i in range(2):  # the first 2 pages come from the tree
        eng.submit(request(side, shared + rng.integers(0, V, 3).tolist(), rid=f"warm{i}", max_new_tokens=7,
                           greedy=True, ignore_eos=True), sink)
    drive(eng)
    prompt = rng.integers(0, V, 20).tolist()
    eng.submit(request(side, prompt, rid="park", max_new_tokens=16, greedy=True, ignore_eos=True), sink)
    step(eng, 2)
    abort_pause(eng)
    eng.continue_generation()
    first = out["park"][0]
    eng.submit(request(side, prompt + first.output_tokens, rid="park", max_new_tokens=16 - len(first.output_tokens),
                       greedy=True, ignore_eos=True), sink)
    drive(eng)
    return out


def test_stage_sequences_match_jax(weights):
    res = {}
    for side, make in (("jax", jax_engine), ("torch", port_engine)):
        eng = make(weights)
        out = _waves(eng, side)
        res[side] = (eng, out, {rid: stages(eng, rid) for rid in out})
    (jeng, jout, jst), (teng, tout, tst) = res["jax"], res["torch"]
    assert tst == jst
    # the sequences are what the paths are
    assert tst["cold0"] == [["queued", "admitted", "prefill_start", "prefill_end", "first_token"]
                            + ["decode_chunk"] * 3 + ["terminal"]]
    assert "radix_match" in tst["warm0"][0]
    park, resumed = tst["park"]
    assert park[-2:] == ["park", "terminal"] and resumed[:3] == ["queued", "resume", "admitted"]
    assert "prefill_start" not in resumed
    check_identity(teng, [r for rs in tout.values() for r in rs])
    # the resumed attempt carries its park time; the JAX engine's too
    assert tout["park"][1].park_s > 0 and jout["park"][1].park_s > 0
    assert teng.timeline.unterminated() == jeng.timeline.unterminated() == 0
    for rid in tout:
        assert [r.output_tokens for r in tout[rid]] == [r.output_tokens for r in jout[rid]]


def test_ledger_matches_jax_analytic(weights):
    """The weights and the KV pool in bytes, as the JAX engine counts them
    for the same ServerConfig. The port also itemizes the frequency
    penalty's count table (0 here: the penalty is off), which the JAX
    ledger leaves out."""
    jl = jax_engine(weights).hbm_ledger()
    tl = port_engine(weights).hbm_ledger()
    for k in ("params", "kv_page_pool", "radix_cache", "staged_update"):
        assert tl["components"][k] == jl["components"][k], k
    assert tl["source"] == jl["source"] == "analytic"
    assert tl["itemized_bytes"] == jl["itemized_bytes"]
    assert tl["components"]["freq_counts"] == 0


def _dispatch_then_hold(eng, after: int):
    """Make the engine's loop set the hold fence itself right after its
    ``after``-th non-empty dispatch, so the fence lands at the same chunk in
    both engines."""
    orig = eng._dispatch_chunk
    n = [0]

    def dispatch():
        pending = orig()
        if pending is not None:
            n[0] += 1
            if n[0] == after:
                eng.pause_generation("hold")
        return pending

    eng._dispatch_chunk = dispatch


def test_hold_fence_stage_sequence_and_probe_identity(weights):
    res = {}
    for side, make in (("jax", jax_engine), ("torch", port_engine)):
        eng = make(weights)
        _dispatch_then_hold(eng, after=2)
        eng.start()
        try:
            done = threading.Event()
            box = []
            eng.submit(request(side, list(range(1, 30)), rid="held", max_new_tokens=24, greedy=True, ignore_eos=True),
                       lambda r: (box.append(r), done.set()))
            deadline = time.monotonic() + 60
            while not eng._held.is_set() and time.monotonic() < deadline:
                time.sleep(0.005)
            assert eng.wait_fence_ack(30)
            time.sleep(0.2)
            eng.continue_generation()
            assert done.wait(60)
            if side == "torch":
                summary = eng.drain(2.0)
        finally:
            eng.stop()
        res[side] = (eng, box[0], stages(eng, "held"))
    (jeng, jresp, jst), (teng, tresp, tst) = res["jax"], res["torch"]
    assert tst == jst
    assert tst[0].count("fence_stall") == 1 and tst[0].count("decode_chunk") == 6
    assert tst[0].index("fence_stall") > tst[0].index("first_token")
    assert tresp.fence_stall_s >= 0.15 and jresp.fence_stall_s >= 0.15
    check_identity(teng, [tresp])
    assert summary["unterminated_timelines"] == 0
    # every recorded pass of the loop: the phases and other_s are its wall
    recs = teng.kprobe.recent()
    assert recs and teng.kernel_stats()["steps"] >= len(recs)
    for rec in recs:
        bd = rec["breakdown"]
        named = sum(bd[f"{p}_s"] for p in kernel_probe.DECODE_PHASES)
        assert abs(named + bd["other_s"] - bd["total_s"]) <= IDENTITY_TOL_S
        assert rec["cost_source"] in (None, "analytic")
    st = teng.kernel_stats()
    assert st["abandoned"] > 0 and st["peaks"]["source"] == "calibrated"
    assert any(k.startswith("chunk|4|4|") for k in st["costs"])


# ---------------------------------------------------------------------------
# over HTTP
# ---------------------------------------------------------------------------


def _http(addr, method, path, body=None, headers=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://{addr}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read().decode()


def _gen_body(ids, n=6):
    return {"input_ids": ids, "sampling_params": {"max_new_tokens": n, "greedy": True, "ignore_eos": True}}


@pytest.fixture(scope="module")
def servers(weights, tmp_path_factory):
    jcfg = JServerConfig(**SERVER_KW, mesh=JMeshConfig(data=1))
    jeng = jde.DecodeEngine(jcfg, params=jax.tree.map(jnp.asarray, weights), model_cfg=TINY_QWEN2,
                            mesh=mesh_lib.make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    jeng.initialize()
    jsrv = JServerThread(jcfg, jeng)
    cfg = ServerConfig(**SERVER_KW, host="127.0.0.1")
    tsrv = ServerThread(cfg, engine=tde.DecodeEngine(cfg, params=port_model(TINY_QWEN2, weights), device="cpu"))
    jsrv.start()
    tsrv.start()
    yield jsrv, tsrv
    tsrv.stop()
    jsrv.stop()


def test_metrics_statusz_and_flight_keys(servers):
    jsrv, tsrv = servers
    status, ct, body = _http(tsrv.address, "POST", "/generate", _gen_body([3, 4, 5, 6]),
                             headers={"x-areal-trace": "task=t-http;session=s-http"})
    assert status == 200
    out = json.loads(body)
    assert out["timing"]["decode_s"] > 0 and set(out["timing"]) == set(TIMING_FIELDS)
    # JSON /metrics: the engine's stats and the pause flags, as before
    status, ct, body = _http(tsrv.address, "GET", "/metrics")
    m = json.loads(body)
    assert ct.startswith("application/json")
    assert set(m) == set(tsrv.engine.stats) | {"server_paused", "paused"}
    # the Prometheus text, line by line
    status, ct, text = _http(tsrv.address, "GET", "/metrics", headers={"Accept": "text/plain"})
    assert status == 200 and ct.startswith("text/plain")
    line = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="[^"]*",?)*\})? [-+0-9.eEinfaINF]+$')
    samples = [ln for ln in text.splitlines() if ln and not ln.startswith("#")]
    assert samples and all(line.match(ln) for ln in samples), [ln for ln in samples if not line.match(ln)][:3]
    for name in ("areal_request_ttft_seconds_count", "areal_decode_phase_seconds_count", "areal_hbm_bytes",
                 "areal_server_queue_depth"):
        assert any(ln.startswith(name) for ln in samples), name
    # /statusz and /debug/flight carry the JAX server's keys
    jkeys = set(json.loads(_http(jsrv.address, "GET", "/statusz")[2]))
    tstat = json.loads(_http(tsrv.address, "GET", "/statusz")[2])
    assert jkeys <= set(tstat), jkeys - set(tstat)
    assert {"timeline_stats", "kernels", "hbm"} <= jkeys
    assert tstat["kernels"]["steps"] > 0 and tstat["hbm"]["components"]["params"] > 0
    # the serving mesh: one rank here, its bytes the ledger's and /statusz memory's
    mesh = tstat["mesh"]
    assert mesh["model"] == 1 and len(mesh["ranks"]) == 1
    assert mesh["ranks"][0]["params"] == tstat["hbm"]["components"]["params"]
    assert mesh["ranks"][0]["kv_pool"] == tstat["hbm"]["components"]["kv_page_pool"] == tstat["memory"]["kv_pool"]
    jfl = json.loads(_http(jsrv.address, "GET", "/debug/flight?timelines=1")[2])
    tfl = json.loads(_http(tsrv.address, "GET", "/debug/flight?timelines=1")[2])
    assert set(tfl) == set(jfl)
    assert len(tfl["timelines"]) == 1 and tfl["role"] == "inference_server"
    rec = tfl["timelines"][0]
    assert (rec["task_id"], rec["session_id"]) == ("t-http", "s-http")
    assert _http(tsrv.address, "GET", "/debug/flight?timelines=0")[2].count('"timelines": []') == 1


def test_statusz_and_ledger_per_rank_on_a_mesh(weights):
    """On ``mesh.model=2`` ``/statusz`` lists both ranks with their bytes:
    each holds its slices of the split leaves and all of the replicated
    ones, and its KV heads' half of a pool of the unsharded engine's page
    count (JAX's, from the whole model's heads); the ``hbm`` ledger
    itemizes every rank, and a staged update's slices show on each."""
    one = port_engine(weights)
    cfg = ServerConfig(**SERVER_KW, host="127.0.0.1", mesh=MeshConfig(model=2))
    srv = ServerThread(cfg, engine=tde.DecodeEngine(cfg, params=port_model(TINY_QWEN2, weights), device="cpu"))
    srv.start()
    try:
        assert _http(srv.address, "POST", "/generate", _gen_body([3, 4, 5, 6]))[0] == 200
        specs = tq.param_partition_specs(port_cfg(TINY_QWEN2))
        want = sum(p.numel() * p.element_size() // (2 if tq._axis_dim(tq.leaf_spec(specs, n), "model") is not None
                                                    else 1) for n, p in one.model.named_parameters())
        eng = srv.engine
        eng.begin_staged_update()
        eng.stage_weight_bucket({"embed": one.model.embed.detach().clone()})
        st = json.loads(_http(srv.address, "GET", "/statusz")[2])
        mesh = st["mesh"]
        assert mesh["model"] == 2 and mesh["backend"] == "gloo" and [r["rank"] for r in mesh["ranks"]] == [0, 1]
        half_embed = one.model.embed.numel() * one.model.embed.element_size() // 2
        for r in mesh["ranks"]:
            assert r["params"] == want and r["kv_pool"] * 2 == one.memory_bytes()["kv_pool"]
            assert r["staged_update"] == half_embed and r["device"] == "cpu"
        assert eng.pool.n_pages == one.pool.n_pages
        ranks = st["hbm"]["ranks"]
        assert len(ranks) == 2 and all(led["components"]["params"] == want for led in ranks)
        assert st["hbm"]["components"] == ranks[0]["components"]
        eng.abort_staged_update()
        assert [r["staged_update"] for r in eng.mesh_status()["ranks"]] == [0, 0]
    finally:
        srv.stop()
    assert srv.engine._group.closed and len(srv.engine._group.dead()) == 1


def test_debug_profile_statuses(servers, tmp_path, monkeypatch):
    _, tsrv = servers
    monkeypatch.setattr(perf_tracer, "_TRACER", perf_tracer.PerfTracer(PerfTracerConfig(output_dir=str(tmp_path))))
    status, _, body = _http(tsrv.address, "POST", "/debug/profile?duration_s=30")
    assert status == 200, body
    d = json.loads(body)["trace_dir"]
    assert d.startswith(str(tmp_path))
    _http(tsrv.address, "POST", "/generate", _gen_body([9, 8, 7]))
    status, _, body = _http(tsrv.address, "POST", "/debug/profile?duration_s=30")
    assert status == 409 and json.loads(body)["trace_dir"] == d
    status, _, body = _http(tsrv.address, "POST", "/debug/profile?duration_s=0")
    assert status == 200 and json.loads(body) == {"status": "stopped", "trace_dir": d}
    assert os.path.getsize(os.path.join(d, "trace.json")) > 0
    assert json.loads(_http(tsrv.address, "POST", "/debug/profile?duration_s=0")[2])["status"] == "idle"
    status, _, _ = _http(tsrv.address, "POST", "/debug/profile?duration_s=soon")
    assert status == 400
    # a timed capture stops itself
    status, _, body = _http(tsrv.address, "POST", "/debug/profile?duration_s=0.2")
    d2 = json.loads(body)["trace_dir"]
    deadline = time.monotonic() + 30
    while perf_tracer.device_profile_active() is not None and time.monotonic() < deadline:
        time.sleep(0.05)
    assert perf_tracer.device_profile_active() is None and os.path.exists(os.path.join(d2, "trace.json"))


def test_admission_reject_lands_in_the_ring(servers):
    _, tsrv = servers
    eng = tsrv.engine
    eng.begin_drain()
    try:
        status, _, body = _http(tsrv.address, "POST", "/generate", _gen_body([1, 2]))
    finally:
        assert eng.end_drain()
    assert status == 429 and json.loads(body)["reason"] == "draining"
    kinds = [e["kind"] for e in eng.flight.snapshot()["events"]]
    assert "admission_reject" in kinds and "drain_begin" in kinds
    ev = [e for e in eng.flight.snapshot()["events"] if e["kind"] == "admission_reject"][-1]
    assert ev["data"]["reason"] == "draining" and ev["severity"] == "warn"


def test_client_carries_the_trace_context(servers):
    from areal_tpu_torch.api.io_struct import GenerationHyperparameters, ModelRequest

    _, tsrv = servers
    c = RemoteTorchEngine(InferenceEngineConfig(), addresses=[tsrv.address])
    c.initialize()

    async def run():
        perf_tracer.set_task_context(task_id="t-client", session_id="s-client")
        return await c.agenerate(ModelRequest(input_ids=[5, 6, 7], rid="traced",
                                              gconfig=GenerationHyperparameters(max_new_tokens=5, greedy=True)))

    try:
        resp = asyncio.run(run())
    finally:
        c.destroy()
    rec = [r for r in tsrv.engine.timeline.recent() if r["rid"] == "traced"][-1]
    assert (rec["task_id"], rec["session_id"]) == ("t-client", "s-client")
    assert resp.decode_s > 0 and resp.queue_wait_s > 0


def test_signal_dump_on_sigterm(tmp_path):
    """A port-only server process, killed with SIGTERM, dumps its flight
    ring (a weight stage in it) and still terminates by the signal."""
    env = dict(os.environ, AREAL_FLIGHT_DIR=str(tmp_path), PYTHONPATH=os.path.dirname(os.path.dirname(__file__)))
    child = os.path.join(os.path.dirname(__file__), "torch_flight_child.py")
    p = subprocess.Popen([sys.executable, child], env=env, stdout=subprocess.PIPE, text=True)
    try:
        line = p.stdout.readline()
        assert line.startswith("READY "), line
        addr = line.split()[1]
        assert line.split()[2] == "armed"
        status, _, _ = _http(addr, "POST", "/generate", _gen_body([1, 2, 3], 4),
                             headers={"x-areal-trace": "task=t-sig;session=s-sig"})
        assert status == 200
        assert _http(addr, "POST", "/update_weights_begin", {"stage_target": "host"})[0] == 200
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=60) == -signal.SIGTERM
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    dumps = list(tmp_path.glob("flight_inference_server_*_sigterm.json"))
    assert len(dumps) == 1
    snap = json.loads(dumps[0].read_text())
    assert snap["dump_reason"] == "sigterm" and snap["pid"] == p.pid
    kinds = [e["kind"] for e in snap["events"]]
    assert "weight_stage" in kinds and kinds[-1] == "sigterm"
