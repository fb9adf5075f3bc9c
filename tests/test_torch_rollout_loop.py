"""The rollout loop of the port against the JAX package's.

1. ``WorkflowExecutor`` with a fake engine on both sides (each with its own
   copy of the ``FakeGenEngine`` / ``EchoWorkflow`` of
   ``tests/test_async_runtime.py``): the same batches and the same stats.
2. Over HTTP on the same weights (``TINY_QWEN2``, f32): the port's
   ``InferenceServer`` with ``RemoteTorchEngine`` against the JAX server with
   ``RemoteJaxEngine``: greedy ``agenerate``, a pause / set_version /
   continue in the middle of a request, ``rollout_batch`` through
   ``RLVRWorkflow``, ``prepare_batch`` under the staleness bound, and
   ``/abort_request``.
3. One ``prepare_batch`` of the port's client feeds the port's ``PPOActor``
   through one ``ppo_update``.

Both executors stamp a ``lineage_id`` on each sequence (their lineage
rings). Rows are compared sorted by ``input_ids``: the executor hands out
results in completion order. A ring numbers trajectories in the order they
were accepted, so with several rollouts in flight the ids are compared as
a relabeling (the same rows share an id on both sides, and the ids are
0..n-1 when the rings were reset before the runs); with one rollout at a
time (``prepare_batch``) and both rings reset they are equal.
"""

import asyncio
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api import io_struct as j_io
from areal_tpu.api.config import InferenceEngineConfig as JInferenceEngineConfig
from areal_tpu.api.config import MeshConfig as JMeshConfig
from areal_tpu.api.config import ServerConfig as JServerConfig
from areal_tpu.api.workflow_api import RolloutWorkflow as JRolloutWorkflow
from areal_tpu.inference import decode_engine as jde
from areal_tpu.inference.client import RemoteJaxEngine
from areal_tpu.inference.server import ServerThread as JServerThread
from areal_tpu.infra.workflow_executor import WorkflowExecutor as JWorkflowExecutor
from areal_tpu.observability import catalog as j_catalog
from areal_tpu.observability import lineage as j_lineage
from areal_tpu.parallel import mesh as mesh_lib
from areal_tpu.workflow.rlvr import GroupedRolloutWorkflow as JGroupedRolloutWorkflow
from areal_tpu.workflow.rlvr import RLVRWorkflow as JRLVRWorkflow
from areal_tpu_torch.api import io_struct as t_io
from areal_tpu_torch.api.config import (
    FaultToleranceConfig,
    InferenceEngineConfig,
    NormConfig,
    OptimizerConfig,
    PPOActorConfig,
    RequestLifecycleConfig,
    RoutingConfig,
    ServerConfig,
)
from areal_tpu_torch.api.workflow_api import RolloutWorkflow as TRolloutWorkflow
from areal_tpu_torch.engine.train_engine import TorchTrainEngine
from areal_tpu_torch.inference import decode_engine as tde
from areal_tpu_torch.inference.client import RemoteTorchEngine
from areal_tpu_torch.inference.server import ServerThread
from areal_tpu_torch.infra.workflow_executor import WorkflowExecutor as TWorkflowExecutor
from areal_tpu_torch.models import convert
from areal_tpu_torch.observability import catalog as t_catalog
from areal_tpu_torch.observability import lineage as t_lineage
from areal_tpu_torch.reward.synthetic import target_token_reward_fn
from areal_tpu_torch.trainer.ppo import PPOActor
from areal_tpu_torch.utils import perf_tracer
from areal_tpu_torch.workflow.rlvr import GroupedRolloutWorkflow as TGroupedRolloutWorkflow
from areal_tpu_torch.workflow.rlvr import RLVRWorkflow as TRLVRWorkflow

from test_torch_qwen import jax_params, port_cfg, port_model
from tpu_testing import TINY_QWEN2

LOGPROB_ATOL = 1e-4  # f32 on both sides

# ---------------------------------------------------------------------------
# 1. the executor with a fake engine
# ---------------------------------------------------------------------------


def _fake_engine_cls(io):
    class FakeGenEngine:
        """An engine stub: echoes a few tokens after a short delay."""

        def __init__(self):
            self.version = 0
            self.calls = 0

        def get_version(self):
            return self.version

        async def agenerate(self, req):
            self.calls += 1
            await asyncio.sleep(0.005)
            n = 1 + req.input_ids[0] % 3
            return io.ModelResponse(
                input_tokens=list(req.input_ids),
                output_tokens=[req.input_ids[0] + k for k in range(n)],
                output_logprobs=[-0.1 * (k + 1) for k in range(n)],
                output_versions=[self.version] * n,
                stop_reason="stop",
                rid=req.rid,
            )

    return FakeGenEngine


def _echo_workflow_cls(io, base):
    class EchoWorkflow(base):
        """One sequence per episode; raises for rows marked poison."""

        async def arun_episode(self, engine, data):
            if data.get("poison"):
                raise RuntimeError("poisoned episode")
            resp = await engine.agenerate(io.ModelRequest(input_ids=data["prompt_ids"]))
            p, o = len(resp.input_tokens), len(resp.output_tokens)
            return [
                {
                    "input_ids": np.asarray(resp.input_tokens + resp.output_tokens, np.int32),
                    "loss_mask": np.asarray([0.0] * p + [1.0] * o, np.float32),
                    "versions": np.asarray([-1] * p + resp.output_versions, np.int32),
                    "rewards": np.float32(sum(resp.output_tokens) % 5),
                }
            ]

    return EchoWorkflow


SIDES = {
    "jax": (JInferenceEngineConfig, JWorkflowExecutor, _fake_engine_cls(j_io),
            _echo_workflow_cls(j_io, JRolloutWorkflow), j_catalog, JGroupedRolloutWorkflow),
    "torch": (InferenceEngineConfig, TWorkflowExecutor, _fake_engine_cls(t_io),
              _echo_workflow_cls(t_io, TRolloutWorkflow), t_catalog, TGroupedRolloutWorkflow),
}


def _sorted_rows(batch: dict) -> dict:
    """The batch's rows sorted by input_ids (padded)."""
    ids = np.asarray(batch["input_ids"])
    order = sorted(range(len(ids)), key=lambda i: tuple(ids[i].tolist()) + (int(batch["attention_mask"][i].sum()),))
    return {k: np.asarray(v)[order] for k, v in batch.items()}


@pytest.fixture
def fresh_rings(monkeypatch):
    """Both packages' lineage rings, new: ids count from 0 again."""
    monkeypatch.setattr(j_lineage, "_LINEAGE", j_lineage.TrajectoryLineage())
    monkeypatch.setattr(t_lineage, "_LINEAGE", t_lineage.TrajectoryLineage())


def _assert_batches_equal(a: dict, b: dict, logprob_atol: float = 0.0, lineage: str = "relabel"):
    """Every key equal row by row; ``lineage_id`` equal (``"exact"``) or a
    consistent relabeling (``"relabel"``, accept order may differ)."""
    a, b = _sorted_rows(a), _sorted_rows(b)
    assert sorted(a) == sorted(b) and "lineage_id" in a
    for k in a:
        assert a[k].shape == b[k].shape, (k, a[k].shape, b[k].shape)
        if k == "lineage_id" and lineage == "relabel":
            pairs = set(zip(a[k].tolist(), b[k].tolist()))
            assert len(pairs) == len({x for x, _ in pairs}) == len({y for _, y in pairs}), pairs
        elif k == "logprobs" and logprob_atol:
            np.testing.assert_allclose(a[k], b[k], atol=logprob_atol)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _executor_run(side: str, scenario: str):
    cfg_cls, ex_cls, eng_cls, wf_cls, catalog, grouped_cls = SIDES[side]
    conc = 1 if scenario == "prepare_batch" else 4
    cfg = cfg_cls(max_concurrent_rollouts=conc, consumer_batch_size=2, max_head_offpolicyness=100, request_timeout=60)
    eng = eng_cls()
    ex = ex_cls(cfg, eng)
    rob = catalog.robustness_metrics()
    r0 = (rob.task_retries.get(), rob.task_quarantined.get())
    ex.initialize()
    wf = wf_cls()
    try:
        if scenario == "rollout_batch":
            out = [ex.rollout_batch([{"prompt_ids": [5 + i, 6, 7]} for i in range(4)], workflow=wf)]
        elif scenario == "grouped":
            out = [ex.rollout_batch([{"prompt_ids": [40 + i, 2]} for i in range(2)], workflow=grouped_cls(wf, 3))]
        elif scenario == "prepare_batch":
            loader = [{"prompt_ids": [10 + i, 3]} for i in range(6)]
            out = [ex.prepare_batch(loader, workflow=wf), ex.prepare_batch(loader, workflow=wf)]
            ex.pause()  # stop topping up; let what runs finish
            deadline = time.monotonic() + 30
            while ex.staleness.stat.running and time.monotonic() < deadline:
                time.sleep(0.01)
        elif scenario == "wait_for_task":
            tid = ex.submit({"prompt_ids": [9, 9]}, workflow=wf)
            out = [ex.wait_for_task(tid, timeout=30)]
        elif scenario == "should_accept_fn":
            accept = lambda traj: int(traj["input_ids"][0, 0]) % 2 == 0  # noqa: E731
            for i in range(6):
                ex.submit({"prompt_ids": [20 + i, 1]}, workflow=wf, should_accept_fn=accept)
            out = [ex.wait(3, timeout=30)]
            deadline = time.monotonic() + 30
            while ex.staleness.stat.running and time.monotonic() < deadline:
                time.sleep(0.01)
        else:  # quarantine
            ex.submit({"prompt_ids": [1, 2], "poison": True}, workflow=wf)
            out = [ex.rollout_batch([{"prompt_ids": [30 + i]} for i in range(2)], workflow=wf)]
            deadline = time.monotonic() + 30
            while ex.staleness.stat.running and time.monotonic() < deadline:
                time.sleep(0.01)
        stats = ex.export_stats()
    finally:
        ex.destroy()
    counters = (rob.task_retries.get() - r0[0], rob.task_quarantined.get() - r0[1])
    return out, stats, counters


@pytest.mark.parametrize("scenario", ["rollout_batch", "grouped", "prepare_batch", "wait_for_task",
                                      "should_accept_fn", "quarantine"])
def test_executor_with_fake_engine_matches_jax(scenario, fresh_rings):
    j_out, j_stats, j_counters = _executor_run("jax", scenario)
    t_out, t_stats, t_counters = _executor_run("torch", scenario)
    assert len(j_out) == len(t_out)
    for a, b in zip(j_out, t_out):
        if scenario == "prepare_batch":
            # one rollout at a time: completion order is submission order
            assert [r.tolist() for r in a["input_ids"]] == [r.tolist() for r in b["input_ids"]]
        _assert_batches_equal(a, b, lineage="exact" if scenario == "prepare_batch" else "relabel")
    if scenario != "wait_for_task":  # wait_for_task returns the trajectory, not a popped batch
        ids = np.concatenate([np.asarray(o["lineage_id"]) for o in t_out])
        assert set(ids.tolist()) <= set(range(len(ids)))
    assert j_stats == t_stats
    assert j_counters == t_counters
    if scenario == "quarantine":
        assert t_counters == (2, 1) and t_stats["rollout/rejected"] == 1.0
    if scenario == "grouped":
        assert t_out[0]["input_ids"].shape[0] == 6


def test_session_tracer_records_each_episode(tmp_path):
    """With the session tracer on, every accepted episode is one
    sessions.jsonl record; RLVRWorkflow's phases land on it."""
    perf_tracer.configure_sessions(str(tmp_path), enabled=True)
    try:
        cfg, ex_cls, eng_cls, wf_cls, _, _ = SIDES["torch"]
        ex = ex_cls(cfg(max_concurrent_rollouts=2, consumer_batch_size=2, request_timeout=60), eng_cls())
        ex.initialize()
        try:
            wf = TRLVRWorkflow(target_token_reward_fn, t_io.GenerationHyperparameters(n_samples=2))
            ex.rollout_batch([{"prompt_ids": [3, 4]}, {"prompt_ids": [5]}], workflow=wf)
        finally:
            ex.destroy()
    finally:
        perf_tracer.configure_sessions(None, enabled=False)
    import json

    recs = [json.loads(line) for line in (tmp_path / "sessions.jsonl").read_text().splitlines()]
    assert len(recs) == 2 and {r["status"] for r in recs} == {"accepted"}
    assert all({p["name"] for p in r["phases"]} == {"generate", "reward"} for r in recs)


@pytest.mark.parametrize(
    "change",
    [
        dict(routing_policy="cache_aware"),
        dict(routing=RoutingConfig(poll_interval_s=1.0)),
        dict(fault_tolerance=FaultToleranceConfig(retry_budget=8.0)),
        dict(lifecycle=RequestLifecycleConfig(gateway_max_inflight=8)),
    ],
    ids=["routing-policy", "routing", "retry-budget", "gateway-shedding"],
)
def test_unported_client_options_refused(change):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RemoteTorchEngine(dataclasses.replace(InferenceEngineConfig(), **change), addresses=["127.0.0.1:1"])


def test_unported_client_paths_refused():
    with pytest.raises(NotImplementedError, match="item 8"):
        RemoteTorchEngine(InferenceEngineConfig(), addresses=["127.0.0.1:1", "127.0.0.1:2"])
    c = RemoteTorchEngine(InferenceEngineConfig(), addresses=["127.0.0.1:1"])
    # the weight update's unported variants (the bf16 mem update and the
    # hold fence are ported: tests/test_torch_weight_sync.py)
    params = {"w": torch.zeros(2)}
    with pytest.raises(NotImplementedError, match="item 4"):
        c.update_weights(t_io.WeightUpdateMeta(wire_format="q8"), params=params)
    with pytest.raises(NotImplementedError, match="item 4"):
        c.update_weights(t_io.WeightUpdateMeta(lora_only=True), params=params)
    with pytest.raises(ValueError, match="meta.path"):
        c.update_weights(t_io.WeightUpdateMeta(type="disk"), params=params)
    relay = RemoteTorchEngine(InferenceEngineConfig(weight_update_relay=True), addresses=["127.0.0.1:1"])
    with pytest.raises(NotImplementedError, match="item 8"):
        relay.update_weights(t_io.WeightUpdateMeta(), params=params)
    relay.destroy()
    with pytest.raises(NotImplementedError, match="item 8"):
        c.set_completion_callback("http://127.0.0.1:1/done")
    c.destroy()


@pytest.mark.parametrize("default_s", [None, 30.0], ids=["explicit", "default"])
def test_deadline_sent_as_header(default_s):
    """A request's deadline, or the config's default from submission, goes
    to the server as the x-areal-deadline header and the JSON "deadline"
    field (the JAX client's wire); without either, no header."""
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    seen = []

    class Echo(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):  # noqa: N802
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            seen.append((self.headers.get("x-areal-deadline"), body["deadline"]))
            out = json.dumps({"output_tokens": [1], "output_logprobs": [-0.5], "output_versions": [0],
                              "stop_reason": "length", "latency": 0.0, "ttft": 0.0}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Echo)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    c = RemoteTorchEngine(InferenceEngineConfig(lifecycle=RequestLifecycleConfig(default_deadline_s=default_s)),
                          addresses=[f"127.0.0.1:{httpd.server_address[1]}"])
    try:
        t0 = time.time()
        explicit = t0 + 5.0 if default_s is None else None
        resp = asyncio.run(c.agenerate(t_io.ModelRequest(
            input_ids=[1], deadline=explicit, gconfig=t_io.GenerationHyperparameters(max_new_tokens=1))))
        asyncio.run(c.agenerate(t_io.ModelRequest(
            input_ids=[1], gconfig=t_io.GenerationHyperparameters(max_new_tokens=1))))
    finally:
        c.destroy()
        httpd.shutdown()
        httpd.server_close()
    assert resp.output_tokens == [1]
    (hdr, field), (hdr2, field2) = seen
    assert float(hdr) == pytest.approx(field, abs=1e-6)
    if default_s is None:
        assert field == pytest.approx(explicit, abs=1e-6) and (hdr2, field2) == (None, None)
    else:
        assert t0 + default_s <= field <= time.time() + default_s and float(hdr2) == pytest.approx(field2, abs=1e-6)


# ---------------------------------------------------------------------------
# 2. over HTTP, port against JAX on the same weights
# ---------------------------------------------------------------------------

SERVER_KW = dict(max_batch_size=4, max_seq_len=256, decode_steps_per_call=8, seed=0)
CLIENT_KW = dict(max_concurrent_rollouts=4, consumer_batch_size=2, max_head_offpolicyness=100, request_timeout=120)


@pytest.fixture(scope="module")
def weights():
    return jax_params(TINY_QWEN2, seed=3)


@pytest.fixture(scope="module")
def jax_client(weights):
    jcfg = JServerConfig(**SERVER_KW, mesh=JMeshConfig(data=1))
    eng = jde.DecodeEngine(
        jcfg,
        params=jax.tree.map(jnp.asarray, weights),
        model_cfg=TINY_QWEN2,
        mesh=mesh_lib.make_mesh(jcfg.mesh, devices=jax.devices()[:1]),
    )
    eng.initialize()
    srv = JServerThread(jcfg, eng)
    srv.start()
    c = RemoteJaxEngine(JInferenceEngineConfig(**CLIENT_KW), addresses=[srv.address])
    c.initialize()
    c.test_engine = eng
    yield c
    c.destroy()
    srv.stop()


@pytest.fixture(scope="module")
def port_server(weights):
    cfg = ServerConfig(**SERVER_KW, host="127.0.0.1")
    srv = ServerThread(cfg, engine=tde.DecodeEngine(cfg, params=port_model(TINY_QWEN2, weights), device="cpu"))
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def port_client(port_server):
    c = RemoteTorchEngine(InferenceEngineConfig(**CLIENT_KW), addresses=[port_server.address])
    c.initialize()
    yield c
    c.destroy()


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY_QWEN2.vocab_size, n).tolist() for n in lens]


def _agenerate_all(client, io, prompts, n_new):
    """Greedy agenerate of each prompt (or of each ModelRequest given) on a
    loop of its own."""
    async def run():
        reqs = [p if isinstance(p, io.ModelRequest) else io.ModelRequest(
            input_ids=p, gconfig=io.GenerationHyperparameters(max_new_tokens=n_new, greedy=True)) for p in prompts]
        out = await asyncio.gather(*[client.agenerate(r) for r in reqs])
        if hasattr(client, "close_loop_connections"):
            await client.close_loop_connections()
        else:
            from areal_tpu.inference.client import close_loop_sessions

            await close_loop_sessions()
        return out

    return asyncio.run(run())


def _slow_chunks(monkeypatch, engine, secs=0.02):
    """Hold each decode chunk of ``engine`` for ``secs`` more, so a test
    thread reliably acts while a request is in the middle of its decode."""
    dispatch = engine._dispatch_chunk

    def slowed():
        time.sleep(secs)
        return dispatch()

    monkeypatch.setattr(engine, "_dispatch_chunk", slowed)


def _wait_idle(engine, timeout=30.0):
    deadline = time.monotonic() + timeout
    while any(t is not None for t in engine._slot_task) and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.05)


def test_agenerate_greedy_matches_jax(jax_client, port_client):
    prompts = _prompts(1, (5, 13, 20))
    want = _agenerate_all(jax_client, j_io, prompts, 24)
    got = _agenerate_all(port_client, t_io, prompts, 24)
    for w, g in zip(want, got):
        assert g.stop_reason == w.stop_reason == "length"
        assert g.output_tokens == w.output_tokens
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs, atol=LOGPROB_ATOL)
        assert g.output_versions == w.output_versions == [0] * 24


def test_pause_resume_gives_uninterrupted_tokens(jax_client, port_client, port_server, monkeypatch):
    """A greedy request paused mid-generation, set to version 1 and
    continued: the tokens of the uninterrupted request (JAX's), tags 0..0
    then 1..1, and the resubmit resumed from its parked KV (no prefill, as
    in the JAX engine, whose same test path parks)."""
    prompt = _prompts(2, (150,))[0]
    n_new = 90
    want = _agenerate_all(jax_client, j_io, [prompt], n_new)[0]
    eng = port_server.engine
    _slow_chunks(monkeypatch, eng)
    box = []
    th = threading.Thread(target=lambda: box.extend(_agenerate_all(port_client, t_io, [prompt], n_new)))
    g0, aborted0 = eng.stats["generated_tokens"], eng.stats["aborted"]
    resumes0, prefill0 = eng.stats["kv_resumes"], eng.stats["prefill_tokens"]
    th.start()
    deadline = time.monotonic() + 60
    while eng.stats["generated_tokens"] - g0 < 16 and time.monotonic() < deadline:
        time.sleep(0.0005)
    try:
        port_client.pause_generation()
        port_client.set_version(1)
        time.sleep(0.2)  # the client polls the pause state meanwhile
    finally:
        port_client.continue_generation()
    th.join(timeout=120)
    got = box[0]
    port_client.set_version(0)
    assert eng.stats["aborted"] - aborted0 == 1
    assert got.output_tokens == want.output_tokens
    np.testing.assert_allclose(got.output_logprobs, want.output_logprobs, atol=LOGPROB_ATOL)
    vers = got.output_versions
    assert len(vers) == n_new and vers == sorted(vers) and vers[0] == 0 and vers[-1] == 1
    # the resubmit resumed from the parked KV: one resume, and no token
    # prefilled but the first attempt's prompt
    assert eng.stats["kv_resumes"] - resumes0 == 1
    assert eng.stats["prefill_tokens"] - prefill0 == len(prompt)


def _rlvr_batch(client, io, wf_cls, prompts):
    gconfig = io.GenerationHyperparameters(n_samples=2, max_new_tokens=6, greedy=True)
    wf = wf_cls(target_token_reward_fn, gconfig)
    return client.rollout_batch([{"prompt_ids": p, "target": 7} for p in prompts], workflow=wf)


def test_rollout_batch_rlvr_matches_jax(jax_client, port_client):
    prompts = _prompts(3, (4, 7, 11))
    want = _rlvr_batch(jax_client, j_io, JRLVRWorkflow, prompts)
    got = _rlvr_batch(port_client, t_io, TRLVRWorkflow, prompts)
    assert got["input_ids"].shape[0] == 6
    _assert_batches_equal(want, got, logprob_atol=LOGPROB_ATOL)
    # rlvr.py's layout: the prompt out of the loss, versions -1 on it
    am = got["attention_mask"]
    assert ((got["loss_mask"] > 0) == (got["versions"] >= 0))[am].all()


def test_prepare_batch_respects_staleness(port_server):
    """Two prepare_batch calls with the version bumped in between: every
    accepted trajectory is within max_head_offpolicyness of the version
    that consumes it, and the capacity never lets more than the bound
    run."""
    cfg = InferenceEngineConfig(max_concurrent_rollouts=4, consumer_batch_size=2, max_head_offpolicyness=1,
                                request_timeout=120)
    c = RemoteTorchEngine(cfg, addresses=[port_server.address])
    c.initialize()
    wf = TRLVRWorkflow(target_token_reward_fn, t_io.GenerationHyperparameters(n_samples=2, max_new_tokens=8))
    loader = [{"prompt_ids": p} for p in _prompts(4, (3, 5, 7, 9, 11, 13))]
    try:
        for step in range(2):
            batch = c.prepare_batch(loader, workflow=wf)
            assert batch["input_ids"].shape[0] == 4  # 2 tasks x 2 samples
            vers = batch["versions"][batch["loss_mask"] > 0]
            assert c.get_version() - vers.min() <= cfg.max_head_offpolicyness
            st = c.executor.staleness.stat
            assert st.running <= cfg.max_concurrent_rollouts
            assert st.accepted + st.running <= (cfg.max_head_offpolicyness + c.get_version() + 1) * 2
            c.set_version(step + 1)
    finally:
        c.pause()
        deadline = time.monotonic() + 60
        while c.executor.staleness.stat.running and time.monotonic() < deadline:
            time.sleep(0.01)
        c.destroy()
        c.set_version(0)
    _wait_idle(port_server.engine)
    assert port_server.engine.pool_audit()["ok"]


def test_abort_request_cancels_a_decoding_request(jax_client, port_client, port_server, monkeypatch):
    prompt = _prompts(5, (9,))[0]
    n_new = 240
    out = {}
    sides = (("jax", jax_client, j_io, jax_client.test_engine), ("torch", port_client, t_io, port_server.engine))
    for name, client, io, eng in sides:
        _slow_chunks(monkeypatch, eng)
        rid = f"abort-{name}"
        box = []
        req = io.ModelRequest(rid=rid, input_ids=prompt,
                              gconfig=io.GenerationHyperparameters(max_new_tokens=n_new, greedy=True))
        th = threading.Thread(target=lambda: box.extend(_agenerate_all(client, io, [req], None)))
        g0 = eng.stats["generated_tokens"]
        th.start()
        deadline = time.monotonic() + 60
        while eng.stats["generated_tokens"] - g0 < 8 and time.monotonic() < deadline:
            time.sleep(0.0005)
        client.abort_request(rid)  # decoding by now
        th.join(timeout=120)
        out[name] = box[0]
    for r in out.values():
        assert r.stop_reason == "cancelled" and r.truncated_by == "cancelled"
        assert 0 < len(r.output_tokens) < n_new
    eng = port_server.engine
    assert eng.stats["cancelled"] >= 1
    _wait_idle(eng)
    assert eng.pool_audit()["ok"]


def test_metrics_endpoint_shape(jax_client, port_client, port_server):
    """GET /metrics: the engine's stats plus server_paused and paused."""
    async def port_metrics():
        try:
            return await port_client._get_json(port_server.address, "/metrics")
        finally:
            await port_client.close_loop_connections()

    got = asyncio.run(port_metrics())
    assert got["server_paused"] is False and got["paused"] is False
    assert {"generated_tokens", "completed", "aborted", "cancelled"} <= set(got)
    async def jax_metrics():
        from areal_tpu.inference.client import close_loop_sessions

        try:
            return await jax_client._get_json(jax_client.addresses[0], "/metrics")
        finally:
            await close_loop_sessions()

    want = asyncio.run(jax_metrics())
    assert {"server_paused", "paused", "generated_tokens", "completed", "aborted"} <= set(want)


# ---------------------------------------------------------------------------
# 3. the batch feeds the trainer
# ---------------------------------------------------------------------------


def test_prepared_batch_feeds_ppo_update(weights, port_server):
    """One prepare_batch from the port's client, then the port's PPOActor:
    proximal logprobs, GRPO advantages and one ppo_update of two minibatches
    at a constant LR (the schedule's warmup is at least one step, as in
    JAX: the first minibatch runs at LR 0, the second at the full LR); the
    loss and grad norm are finite and the weights move."""
    cfg = port_cfg(TINY_QWEN2)
    acfg = PPOActorConfig(
        dtype="float32", param_dtype="float32", bucket_step=64, group_size=4,
        optimizer=OptimizerConfig(lr=1e-3, lr_scheduler_type="constant"),
        adv_norm=NormConfig(mean_level="group", std_level="batch", group_size=4),
        use_decoupled_loss=True, prox_logp_mode="recompute", ppo_n_minibatches=2,
    )
    trainer = TorchTrainEngine(acfg, model_config=cfg, device="cpu")
    trainer.initialize(t_io.FinetuneSpec(1, 8, 2))
    trainer.model.load_state_dict(convert.from_jax_params(weights, cfg))
    actor = PPOActor(acfg, trainer)
    c = RemoteTorchEngine(InferenceEngineConfig(max_concurrent_rollouts=2, consumer_batch_size=2,
                                                max_head_offpolicyness=0, request_timeout=120),
                          addresses=[port_server.address])
    c.initialize()
    # a position-weighted hash of the whole completion, scaled into [0, 1)
    # (inside the actor's reward_clip of 20): the 4 samples of a group get
    # different rewards unless two completions collide, so the
    # group-normalized advantages (and the grad norm) are never all zero
    wf = TRLVRWorkflow(lambda *a, **kw: (sum((i + 1) * t for i, t in enumerate(a[3])) % 1009) / 1009,
                       t_io.GenerationHyperparameters(n_samples=4, max_new_tokens=8))
    try:
        batch = c.prepare_batch([{"prompt_ids": p} for p in _prompts(6, (6, 10))], workflow=wf)
    finally:
        c.pause()
        deadline = time.monotonic() + 60
        while c.executor.staleness.stat.running and time.monotonic() < deadline:
            time.sleep(0.01)
        c.destroy()
    for key in ("input_ids", "attention_mask", "loss_mask", "logprobs", "versions", "rewards", "seq_no_eos_mask"):
        assert key in batch and batch[key].shape[0] == 8, key
    groups = np.asarray(batch["rewards"]).reshape(2, 4)
    assert all(len(set(g.tolist())) > 1 for g in groups), groups
    before = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    batch["prox_logp"] = actor.compute_logp(batch)
    gen = batch["loss_mask"] > 0
    # the served policy is the trainer's: its logprobs agree with the recompute
    np.testing.assert_allclose(batch["prox_logp"][gen], batch["logprobs"][gen], atol=LOGPROB_ATOL)
    stats = actor.ppo_update(actor.compute_advantages(batch))
    assert len(stats) == 2
    for s in stats:
        assert np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) and s["grad_norm"] > 0
    assert stats[1]["lr"] == pytest.approx(1e-3)
    after = trainer.model.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before)
