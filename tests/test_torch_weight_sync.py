"""The streamed weight update of the port against the JAX package's
(``tests/test_weight_sync.py``).

1. The bucket codec: byte-compatible with the JAX server's in both
   directions (bf16, f32 ``_scale`` planes, int8 and 0-d leaves).
2. The bucket plan: the JAX client's greedy pack by wire bytes (an
   oversize leaf alone), over hypothesis leaf sizes; the buckets decode to
   exactly the bf16 export.
3. The engine: a staged commit mid-generation without an abort (tags 0 then
   1, monotone), the hold fence, its self-release, ``abort_staged_update``,
   the host stage target (committed weights equal to the JAX engine's), a
   commit missing a name, a retried commit. "During generation" is judged
   by content: the engine's generated tokens rising between buckets.
4. Over HTTP, port against JAX on the same weights: one update through each
   client, then identical greedy tokens, logprobs within 1e-4 and equal
   versions; the commit fence modes.
"""

import asyncio
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from areal_tpu.api import config as jc
from areal_tpu.api import io_struct as j_io
from areal_tpu.inference import decode_engine as jde
from areal_tpu.inference import server as jserver
from areal_tpu.inference.client import RemoteJaxEngine
from areal_tpu.parallel import mesh as mesh_lib
from areal_tpu_torch.api import io_struct as t_io
from areal_tpu_torch.api.config import InferenceEngineConfig, ServerConfig
from areal_tpu_torch.inference import server as tserver
from areal_tpu_torch.inference.client import RemoteTorchEngine
from areal_tpu_torch.inference.decode_engine import DecodeEngine
from areal_tpu_torch.models import convert

from test_torch_qwen import jax_params, port_cfg, port_model
from tpu_testing import TINY_QWEN2

LOGPROB_ATOL = 1e-4  # f32 serving on both sides


def _bits(a) -> np.ndarray:
    """Raw bytes of a numpy array or a tensor, for bit-for-bit checks."""
    if isinstance(a, torch.Tensor):
        if a.numel() == 0:
            return np.zeros(0, np.uint8)
        a = a.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _codec_leaves(seed=0):
    """The same leaves for both sides: (numpy for JAX, tensor for the port)."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((6, 5)).astype(np.float32)
    bf = f.astype(ml_dtypes.bfloat16)
    scale = rng.uniform(0.01, 1.0, (5,)).astype(np.float32)
    q = rng.integers(-127, 128, (3, 7)).astype(np.int8)
    scalar = np.asarray(rng.standard_normal(), np.float32)
    jax_side = [("layers/wq", bf), ("layers/wq_scale", scale), ("layers/wq_q", q), ("step", scalar)]
    port_side = [
        ("layers/wq", torch.from_numpy(bf.view(np.uint16).copy()).view(torch.bfloat16)),
        ("layers/wq_scale", torch.from_numpy(scale)),
        ("layers/wq_q", torch.from_numpy(q)),
        ("step", torch.tensor(float(scalar))),
    ]
    return jax_side, port_side


def test_codec_byte_compatible_both_ways():
    jax_side, port_side = _codec_leaves()
    jbody = jserver.encode_weight_bucket(jax_side)
    tbody = bytes(tserver.encode_weight_bucket(port_side))
    assert tbody == jbody
    got_j = jserver.decode_weight_bucket(tbody)  # port -> JAX
    got_t = tserver.decode_weight_bucket(jbody)  # JAX -> port
    for (name, arr), (_, t) in zip(jax_side, port_side):
        # a 0-d leaf comes back as shape (1,) on both sides (the JAX
        # encoder's np.ascontiguousarray)
        shape = arr.shape or (1,)
        assert got_j[name].dtype == arr.dtype and got_j[name].shape == shape
        assert np.array_equal(_bits(got_j[name]), _bits(arr)), name
        assert got_t[name].dtype == t.dtype and tuple(got_t[name].shape) == shape
        assert np.array_equal(_bits(got_t[name]), _bits(t)), name


def _leaf(kind: str, n: int, rng):
    if kind == "int8":
        a = rng.integers(-127, 128, n).astype(np.int8)
    else:
        a = rng.standard_normal(n).astype(np.float32)
    return a


@settings(max_examples=25, deadline=None)
@given(
    st.lists(
        st.tuples(st.sampled_from(["f32", "scale", "int8", "scalar"]), st.integers(0, 700_000)),
        min_size=1,
        max_size=8,
    ),
    st.integers(0, 2**31 - 1),
)
@example(leaves=[("f32", 0), ("scale", 262145)], seed=0)  # a zero-byte leaf before an oversize one
def test_bucket_plan_follows_jax_rule(leaves, seed):
    rng = np.random.default_rng(seed)
    jparams, tparams = {}, {}
    for i, (kind, n) in enumerate(leaves):
        name = f"l{i}_scale" if kind == "scale" else f"l{i}"
        a = np.asarray(rng.standard_normal(), np.float32) if kind == "scalar" else _leaf(kind, n, rng)
        jparams[name] = a
        tparams[name] = torch.from_numpy(a.copy())
    cfg = SimpleNamespace(weight_chunk_mb=1)
    want = RemoteJaxEngine._plan_weight_buckets(SimpleNamespace(config=cfg), jparams)
    client = RemoteTorchEngine(InferenceEngineConfig(weight_chunk_mb=1), addresses=["127.0.0.1:1"])
    try:
        got = client._plan_weight_buckets(tparams)
        assert [[k for k, _ in b] for b in got] == [[k for k, _ in b] for b in want]
        limit = 1 << 20
        for b in got:
            sizes = [client._wire_nbytes(k, v) for k, v in b]
            if max(sizes) > limit:
                # an oversize leaf travels alone, but for zero-byte leaves
                # before it (the rule opens a bucket only on a nonempty one)
                assert sorted(sizes)[:-1] == [0] * (len(sizes) - 1), sizes
        decoded = {}
        for b in got:
            decoded.update(tserver.decode_weight_bucket(bytes(client._encode_bucket(b))))
        assert decoded.keys() == tparams.keys()
        for name, t in tparams.items():
            want_t = t if (name.endswith("_scale") or not t.is_floating_point()) else t.to(torch.bfloat16)
            assert decoded[name].dtype == want_t.dtype and decoded[name].numel() == want_t.numel()
            assert np.array_equal(_bits(decoded[name]), _bits(want_t)), name
    finally:
        client.destroy()


# ---------------------------------------------------------------------------
# 3. the engine
# ---------------------------------------------------------------------------


def _make_engine(**overrides) -> DecodeEngine:
    cfg = ServerConfig(max_batch_size=4, max_seq_len=1024, decode_steps_per_call=4, seed=0, **overrides)
    eng = DecodeEngine(cfg, params=port_model(TINY_QWEN2, jax_params(TINY_QWEN2, seed=0)), device="cpu")
    eng.initialize()
    return eng


def _staged_buckets(eng: DecodeEngine, delta: float = 0.5):
    """The full state dict + delta, in 2 buckets."""
    items = sorted((n, p.detach() + delta) for n, p in eng.model.named_parameters())
    mid = len(items) // 2
    return [dict(items[:mid]), dict(items[mid:])]


def _submit_long(eng: DecodeEngine, n_tokens: int = 512):
    done = threading.Event()
    box = []

    def cb(resp):
        box.append(resp)
        done.set()

    req = t_io.ModelRequest(
        input_ids=[3, 5, 7], rid="span-commit",
        gconfig=t_io.GenerationHyperparameters(max_new_tokens=n_tokens, temperature=1.0),
    )
    eng.start()
    eng.submit(req, cb)
    return done, box


def _wait_tokens(eng: DecodeEngine, n: int, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while eng.stats["generated_tokens"] < n:
        assert time.monotonic() < deadline, "generation never started"
        time.sleep(0.002)


def _slow_chunks(monkeypatch, engine, secs=0.01):
    dispatch = engine._dispatch_chunk

    def slowed():
        time.sleep(secs)
        return dispatch()

    monkeypatch.setattr(engine, "_dispatch_chunk", slowed)


def test_staged_commit_mid_generation_no_abort(monkeypatch):
    eng = _make_engine()
    _slow_chunks(monkeypatch, eng)
    try:
        done, box = _submit_long(eng)
        _wait_tokens(eng, 8)
        gen_at_begin = eng.stats["generated_tokens"]
        eng.begin_staged_update()
        buckets = _staged_buckets(eng)
        eng.stage_weight_bucket(buckets[0])
        _wait_tokens(eng, gen_at_begin + 4)  # decoding goes on between buckets
        eng.stage_weight_bucket(buckets[1])
        eng.commit_staged_weights(version=1)
        assert eng.get_version() == 1
        assert eng.last_update_gen_tokens >= 4
        assert done.wait(120), "generation did not finish"
        resp = box[0]
        assert resp.stop_reason != t_io.StopReason.ABORT.value
        versions = resp.output_versions
        assert len(versions) == 512 and versions == sorted(versions)
        assert versions[0] == 0 and versions[-1] == 1
        assert eng.stats["aborted"] == 0
        for name, p in eng.model.named_parameters():
            want = buckets[0].get(name, buckets[1].get(name))
            assert torch.equal(p.detach(), want), name
    finally:
        eng.stop()


def test_hold_fence_pauses_without_abort(monkeypatch):
    eng = _make_engine()
    _slow_chunks(monkeypatch, eng)
    try:
        done, box = _submit_long(eng, n_tokens=256)
        _wait_tokens(eng, 4)
        eng.pause_generation(mode="hold")
        assert eng.is_paused and not eng.is_abort_paused
        assert eng.wait_fence_ack(30), "loop never reached the fence"
        assert not eng._pause_ack.is_set()
        held_at = eng.stats["generated_tokens"]
        time.sleep(0.3)
        assert eng.stats["generated_tokens"] == held_at, "loop decoded while held"
        assert not done.is_set(), "hold must not complete the request"
        eng.continue_generation()
        assert not eng.is_paused
        assert done.wait(120)
        assert box[0].stop_reason != t_io.StopReason.ABORT.value
        assert len(box[0].output_tokens) == 256
    finally:
        eng.stop()


def test_hold_fence_self_releases_on_lost_continue(monkeypatch):
    eng = _make_engine(hold_fence_timeout_s=0.5)
    _slow_chunks(monkeypatch, eng)
    try:
        done, box = _submit_long(eng, n_tokens=128)
        _wait_tokens(eng, 4)
        eng.pause_generation(mode="hold")
        assert eng.wait_fence_ack(30), "loop never reached the fence"
        deadline = time.monotonic() + 30
        while eng.is_paused:
            assert time.monotonic() < deadline, "hold never self-released"
            time.sleep(0.05)
        assert done.wait(120)
        assert box[0].stop_reason != t_io.StopReason.ABORT.value
        assert len(box[0].output_tokens) == 128
    finally:
        eng.stop()


def test_abort_staged_update_leaves_serving_untouched():
    eng = _make_engine()
    ref = {n: p.detach().clone() for n, p in eng.model.named_parameters()}
    buckets = _staged_buckets(eng, delta=9.0)
    eng.begin_staged_update()
    eng.stage_weight_bucket(buckets[0])  # a partial stream only
    eng.abort_staged_update()
    assert eng.get_version() == 0
    assert all(torch.equal(p.detach(), ref[n]) for n, p in eng.model.named_parameters())
    with pytest.raises(AssertionError):  # nothing staged: a loud failure
        eng.commit_staged_weights(version=1)
    eng.begin_staged_update()
    for b in buckets:
        eng.stage_weight_bucket(b)
    eng.commit_staged_weights(version=1)
    assert eng.get_version() == 1


def test_host_stage_target_defers_copy_to_commit():
    """Host staging keeps the buckets' own tensors until the commit, which
    copies them; the committed weights equal the JAX engine's after the
    same f32 buckets."""
    params = jax_params(TINY_QWEN2, seed=0)
    delta = jax.tree.map(lambda a: (a + 0.25).astype(np.float32), params)
    mcfg = port_cfg(TINY_QWEN2)
    port_flat = convert.from_jax_params(delta, mcfg)
    eng = _make_engine(weight_stage_target="host")
    before = {n: p.detach().clone() for n, p in eng.model.named_parameters()}
    items = sorted(port_flat.items())
    eng.begin_staged_update()
    for b in (dict(items[: len(items) // 2]), dict(items[len(items) // 2 :])):
        eng.stage_weight_bucket(b)
    assert all(eng._staged[n] is port_flat[n] for n in port_flat), "host staging must not copy before the commit"
    assert all(torch.equal(p.detach(), before[n]) for n, p in eng.model.named_parameters())
    eng.commit_staged_weights(version=3)
    assert eng.get_version() == 3

    jcfg = jc.ServerConfig(max_batch_size=4, max_seq_len=1024, decode_steps_per_call=4, seed=0,
                           weight_stage_target="host", mesh=jc.MeshConfig(data=1))
    jeng = jde.DecodeEngine(jcfg, params=jax.tree.map(jnp.asarray, params), model_cfg=TINY_QWEN2,
                            mesh=mesh_lib.make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    jeng.initialize()
    jeng.begin_staged_update()
    jeng.stage_weight_bucket(jserver.flatten_params(delta))
    jeng.commit_staged_weights(version=3)
    want = convert.from_jax_params(jax.tree.map(np.asarray, jeng.params), mcfg)
    for n, p in eng.model.named_parameters():
        assert torch.equal(p.detach(), want[n]), n
    # the per-update override, and an unknown target
    eng2 = _make_engine()
    eng2.begin_staged_update(stage_target="host")
    t = torch.ones(3)
    eng2.stage_weight_bucket({"x": t})
    assert eng2._staged["x"] is t
    eng2.abort_staged_update()
    with pytest.raises(ValueError):
        eng2.begin_staged_update(stage_target="hbm3")


def test_commit_missing_a_name_changes_nothing():
    eng = _make_engine()
    ref = {n: p.detach().clone() for n, p in eng.model.named_parameters()}
    buckets = _staged_buckets(eng)
    eng.begin_staged_update()
    eng.stage_weight_bucket(buckets[0])
    partial = dict(buckets[1])
    partial.pop(sorted(partial)[-1])
    eng.stage_weight_bucket(partial)
    with pytest.raises(ValueError, match="missing"):
        eng.commit_staged_weights(version=1)
    assert eng.get_version() == 0
    assert all(torch.equal(p.detach(), ref[n]) for n, p in eng.model.named_parameters())


def test_retried_commit_of_applied_version_acks():
    eng = _make_engine()
    eng.begin_staged_update()
    for b in _staged_buckets(eng):
        eng.stage_weight_bucket(b)
    eng.commit_staged_weights(version=1)
    eng.commit_staged_weights(version=1)  # the answer was lost: the retry acks
    assert eng.get_version() == 1
    with pytest.raises(AssertionError):
        eng.commit_staged_weights(version=2)


# ---------------------------------------------------------------------------
# 4. over HTTP, port against JAX
# ---------------------------------------------------------------------------

SERVER_KW = dict(max_batch_size=4, max_seq_len=512, decode_steps_per_call=4, seed=0)
CLIENT_KW = dict(max_concurrent_rollouts=4, consumer_batch_size=2, max_head_offpolicyness=100,
                 request_timeout=120, weight_chunk_mb=1)


@pytest.fixture(scope="module")
def weights():
    return jax_params(TINY_QWEN2, seed=11)


@pytest.fixture(scope="module")
def jax_server(weights):
    jcfg = jc.ServerConfig(**SERVER_KW, mesh=jc.MeshConfig(data=1))
    eng = jde.DecodeEngine(jcfg, params=jax.tree.map(jnp.asarray, weights), model_cfg=TINY_QWEN2,
                           mesh=mesh_lib.make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    eng.initialize()
    srv = jserver.ServerThread(jcfg, eng)
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def port_server(weights):
    cfg = ServerConfig(**SERVER_KW, host="127.0.0.1")
    srv = tserver.ServerThread(cfg, engine=DecodeEngine(cfg, params=port_model(TINY_QWEN2, weights), device="cpu"))
    srv.start()
    yield srv
    srv.stop()


def _greedy(client, io, prompts, n_new):
    async def run():
        out = await asyncio.gather(*[
            client.agenerate(io.ModelRequest(input_ids=p, gconfig=io.GenerationHyperparameters(
                max_new_tokens=n_new, greedy=True)))
            for p in prompts
        ])
        if hasattr(client, "close_loop_connections"):
            await client.close_loop_connections()
        else:
            from areal_tpu.inference.client import close_loop_sessions

            await close_loop_sessions()
        return out

    return asyncio.run(run())


def test_update_over_http_matches_jax(weights, jax_server, port_server):
    """One delta through each client's update_weights; then both servers
    serve the same bf16-rounded weights: identical greedy tokens, logprobs
    within 1e-4, version 1 on both."""
    rng = np.random.default_rng(4)
    new = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), weights)
    jclient = RemoteJaxEngine(jc.InferenceEngineConfig(**CLIENT_KW), addresses=[jax_server.address])
    tclient = RemoteTorchEngine(InferenceEngineConfig(**CLIENT_KW), addresses=[port_server.address])
    jclient.initialize()
    tclient.initialize()
    try:
        jclient.update_weights(j_io.WeightUpdateMeta(type="mem"), params=new)
        tclient.update_weights(t_io.WeightUpdateMeta(type="mem"),
                               params=convert.from_jax_params(new, port_cfg(TINY_QWEN2)))
        assert jclient.get_version() == tclient.get_version() == 1
        assert jax_server.engine.get_version() == port_server.engine.get_version() == 1
        prompts = [rng.integers(0, TINY_QWEN2.vocab_size, n).tolist() for n in (5, 17, 30)]
        want = _greedy(jclient, j_io, prompts, 16)
        got = _greedy(tclient, t_io, prompts, 16)
        for w, g in zip(want, got):
            assert g.output_tokens == w.output_tokens
            np.testing.assert_allclose(g.output_logprobs, w.output_logprobs, atol=LOGPROB_ATOL)
            assert g.output_versions == w.output_versions == [1] * 16
        stats = tclient.export_stats()
        assert stats["update_weights_stage_secs"] == tclient.last_stage_secs
        assert stats["update_weights_pause_secs"] == tclient.last_pause_secs
    finally:
        jclient.destroy()
        tclient.destroy()
        for s in (jax_server, port_server):
            s.engine.set_version(0)
            s.engine.continue_generation()


def _fence_run(port_server, monkeypatch, fence: str):
    """A 256-token request across one update under ``fence``; returns the
    response, the aborted delta and the pause posts the server answered."""
    eng = port_server.engine
    _slow_chunks(monkeypatch, eng, 0.02)
    pauses = []
    h_pause = port_server.server.h_pause

    def h_pause_logged(d):
        status, out = h_pause(d)
        pauses.append(out)
        return status, out

    monkeypatch.setattr(port_server.server, "h_pause", h_pause_logged)
    c = RemoteTorchEngine(InferenceEngineConfig(**{**CLIENT_KW, "weight_commit_fence": fence}),
                          addresses=[port_server.address])
    c.initialize()
    try:
        results = []

        def run_gen():
            req = t_io.ModelRequest(input_ids=[8, 2, 4], rid=f"fence-{fence}",
                                    gconfig=t_io.GenerationHyperparameters(max_new_tokens=256, temperature=1.0))
            results.append(asyncio.run(c.agenerate(req)))

        g0, aborted0 = eng.stats["generated_tokens"], eng.stats["aborted"]
        t = threading.Thread(target=run_gen)
        t.start()
        _wait_tokens(eng, g0 + 4)
        new = {n: p.detach() + 0.02 for n, p in eng.model.named_parameters()}
        c.update_weights(t_io.WeightUpdateMeta(type="mem"), params=new)
        t.join(timeout=120)
        assert not t.is_alive()
        assert c.get_version() == 1 and eng.get_version() == 1
        return results[0], eng.stats["aborted"] - aborted0, pauses, c.last_update_gen_tokens
    finally:
        c.destroy()
        eng.set_version(0)
        eng.continue_generation()


@pytest.mark.parametrize("fence", ["hold", "none", "abort"])
def test_commit_fence_modes(port_server, monkeypatch, fence):
    """"hold" fences without an abort and answers fenced; "none" never
    pauses; "abort" pauses and aborts server-side, and the client's loop
    resumes the request: the response is whole either way, its tags 0 then
    1, monotone."""
    resp, aborted, pauses, gen_tokens = _fence_run(port_server, monkeypatch, fence)
    assert len(resp.output_tokens) == 256 and resp.stop_reason != t_io.StopReason.ABORT.value
    versions = resp.output_versions
    assert versions == sorted(versions) and versions[0] == 0 and versions[-1] == 1
    if fence == "hold":
        assert aborted == 0 and pauses == [{"status": "ok", "fenced": True}]
        assert gen_tokens > 0  # tokens emitted while the update staged
    elif fence == "none":
        assert aborted == 0 and pauses == []
    else:
        assert aborted > 0 and pauses == [{"status": "ok"}]


def test_bad_fence_config_rejected(port_server):
    c = RemoteTorchEngine(InferenceEngineConfig(weight_commit_fence="sometimes"), addresses=[port_server.address])
    try:
        with pytest.raises(ValueError):
            c._commit_fence([port_server.address])
    finally:
        c.destroy()


def test_malformed_pause_body_never_pauses(port_server):
    """An unparsable or non-object body answers 400 and leaves the server
    running: a hold never turns into an abort."""
    import urllib.error
    import urllib.request

    for body in (b"{not json", b"[1, 2]"):
        req = urllib.request.Request(f"http://{port_server.address}/pause_generation", data=body, method="POST",
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 400
        assert not port_server.engine.is_paused


def test_failed_commit_burns_the_version(port_server):
    """A commit the server refuses (a name missing) fails the update: the
    served weights and version stay, the staged copy is dropped, and the
    client's version moves on anyway, so a retried update never reuses the
    number for other weights."""
    eng = port_server.engine
    ref = {n: p.detach().clone() for n, p in eng.model.named_parameters()}
    new = {n: p.detach() + 0.1 for n, p in eng.model.named_parameters()}
    new.pop(sorted(new)[0])
    c = RemoteTorchEngine(InferenceEngineConfig(**{**CLIENT_KW, "request_retries": 1}),
                          addresses=[port_server.address])
    c.initialize()
    try:
        with pytest.raises(RuntimeError, match="commit failed"):
            c.update_weights(t_io.WeightUpdateMeta(type="mem"), params=new)
        assert c.get_version() == 1 and eng.get_version() == 0
        assert eng._staged is None and not eng.is_paused
        assert all(torch.equal(p.detach(), ref[n]) for n, p in eng.model.named_parameters())
    finally:
        c.destroy()
        eng.continue_generation()


@pytest.mark.parametrize(
    "path, headers, item",
    [
        ("/update_weights_lora", {}, "item 4"),
        ("/update_weights_bucket", {"X-Areal-Relay": "127.0.0.1:1"}, "item 8"),
    ],
    ids=["lora", "relay"],
)
def test_unported_update_routes_refused(port_server, path, headers, item):
    import urllib.error
    import urllib.request

    body = bytes(tserver.encode_weight_bucket([("x", torch.zeros(2))])) if "bucket" in path else b"{}"
    req = urllib.request.Request(f"http://{port_server.address}{path}", data=body, method="POST",
                                 headers={"Content-Type": "application/octet-stream", **headers})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    assert e.value.code == 400 and item in e.value.read().decode()
    assert port_server.engine.get_version() == 0
