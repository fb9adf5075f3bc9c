"""The port's sampler, DecodeEngine and HTTP server against the JAX engine.

The sampler takes its uniforms as arguments; the tests derive them from the
very JAX keys ``_sample_step`` splits, so both sides draw the same tokens.
The JAX engine runs on a 1-device CPU mesh (its XLA paged-attention path)."""

import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.config import MeshConfig as JMeshConfig
from areal_tpu.api.config import ServerConfig as JServerConfig
from areal_tpu.api.io_struct import GenerationHyperparameters as JGen
from areal_tpu.api.io_struct import ModelRequest as JRequest
from areal_tpu.inference import decode_engine as jde
from areal_tpu.parallel import mesh as mesh_lib
from areal_tpu_torch.api.config import ServerConfig
from areal_tpu_torch.api.io_struct import GenerationHyperparameters, ModelRequest
from areal_tpu_torch.inference import decode_engine as tde
from areal_tpu_torch.inference.server import ServerThread
from areal_tpu_torch.models import qwen as tq

from test_torch_qwen import jax_params, port_model
from tpu_testing import TINY_QWEN2

# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------


def _state(S, rng):
    temp = rng.uniform(0.5, 1.5, S).astype(np.float32)
    greedy = np.zeros(S, bool)
    greedy[::3] = True
    temp[greedy] = 0.0
    top_k = np.where(np.arange(S) % 2 == 0, 5, -1).astype(np.int32)
    top_p = np.where(np.arange(S) % 4 == 1, 0.7, 1.0).astype(np.float32)
    return dict(temp=temp, greedy=greedy, top_k=top_k, top_p=top_p)


@pytest.mark.parametrize("V", [1000, 4096])
def test_inverse_cdf_sample_same_uniforms(V):
    rng = np.random.default_rng(V)
    S = 8
    scaled = (3 * rng.standard_normal((S, V))).astype(np.float32)
    key = jax.random.PRNGKey(V)
    j_ids, j_logp, j_lse = jde._inverse_cdf_sample(jnp.asarray(scaled), key)
    u = np.array(jax.random.uniform(key, (S, 1), jnp.float32))  # the draw inside
    t_ids, t_logp, t_lse = tde._inverse_cdf_sample(torch.from_numpy(scaled), torch.from_numpy(u))
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(t_logp.numpy(), np.asarray(j_logp), atol=1e-5)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=1e-5)


@pytest.mark.parametrize(
    "capped,greedy_any", [(False, False), (False, True), (True, False), (True, True)]
)
def test_sample_step_same_uniforms(capped, greedy_any):
    """Including the top-k/top-p branch: jax.random.categorical is a
    Gumbel-max over uniforms in [tiny, 1); the port gets those uniforms."""
    rng = np.random.default_rng(7)
    S, V = 12, 2048
    logits = (2 * rng.standard_normal((S, V))).astype(np.float32)
    st = _state(S, rng)
    if not greedy_any:
        st["greedy"][:] = False
        st["temp"][st["temp"] == 0] = 1.0
    key = jax.random.PRNGKey(11)
    j_ids, j_logp = jde._sample_step(
        jnp.asarray(logits), key, {k: jnp.asarray(v) for k, v in st.items()}, capped, greedy_any
    )
    k_full, k_cap = jax.random.split(key)
    u_full = np.array(jax.random.uniform(k_full, (S, 1), jnp.float32))
    K = min(V, tde._TOPK_CAP)
    tiny = float(jnp.finfo(jnp.float32).tiny)
    u_cap = np.array(jax.random.uniform(k_cap, (S, K), jnp.float32, minval=tiny, maxval=1.0))
    t_state = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v) for k, v in st.items()}
    t_ids, t_logp = tde._sample_step(
        torch.from_numpy(logits),
        torch.from_numpy(u_full),
        torch.from_numpy(u_cap) if capped else None,
        t_state,
        capped,
        greedy_any,
    )
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(t_logp.numpy(), np.asarray(j_logp), atol=1e-5)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

PROMPT_LENS = (5, 13, 20)  # with psz 16 and 24 new tokens: several pages and chunks
N_NEW = 24


def _server_kwargs():
    return dict(
        max_batch_size=4,
        max_seq_len=128,
        page_size=16,
        decode_steps_per_call=4,
        enable_prefix_caching=False,
        seed=0,
    )


def _run_all(engine, reqs, timeout=300):
    out = [None] * len(reqs)
    done = threading.Semaphore(0)

    def cb_for(i):
        def cb(resp):
            out[i] = resp
            done.release()

        return cb

    for i, r in enumerate(reqs):
        engine.submit(r, cb_for(i))
    for _ in reqs:
        assert done.acquire(timeout=timeout), "engine timed out"
    return out


@pytest.fixture(scope="module")
def weights():
    return jax_params(TINY_QWEN2, seed=8)


@pytest.fixture(scope="module")
def port_engine(weights):
    eng = tde.DecodeEngine(
        ServerConfig(**_server_kwargs()), params=port_model(TINY_QWEN2, weights), device="cpu"
    )
    eng.start()
    yield eng
    eng.stop()


def test_greedy_token_identical_to_jax_engine(weights, port_engine):
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, TINY_QWEN2.vocab_size, n).tolist() for n in PROMPT_LENS]
    jcfg = JServerConfig(**_server_kwargs(), mesh=JMeshConfig(data=1))
    jeng = jde.DecodeEngine(
        jcfg,
        params=jax.tree.map(jnp.asarray, weights),
        model_cfg=TINY_QWEN2,
        mesh=mesh_lib.make_mesh(jcfg.mesh, devices=jax.devices()[:1]),
    )
    jeng.initialize()
    jeng.start()
    try:
        want = _run_all(
            jeng, [JRequest(input_ids=p, gconfig=JGen(max_new_tokens=N_NEW, greedy=True)) for p in prompts]
        )
    finally:
        jeng.stop()
    got = _run_all(
        port_engine,
        [ModelRequest(input_ids=p, gconfig=GenerationHyperparameters(max_new_tokens=N_NEW, greedy=True)) for p in prompts],
    )
    for w, g in zip(want, got):
        assert g.stop_reason == w.stop_reason == "length"
        assert g.output_tokens == w.output_tokens
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs, atol=1e-4)
        assert g.output_versions == [0] * N_NEW


def test_version_tags_split_across_update(weights, port_engine):
    rng = np.random.default_rng(10)
    new = port_model(TINY_QWEN2, jax_params(TINY_QWEN2, seed=12))
    box, done = [], threading.Event()
    port_engine.submit(
        ModelRequest(
            input_ids=rng.integers(0, 256, 6).tolist(),
            gconfig=GenerationHyperparameters(max_new_tokens=100, temperature=1.0),
        ),
        lambda r: (box.append(r), done.set()),
    )
    t0 = port_engine.stats["generated_tokens"]
    deadline = time.monotonic() + 60
    while port_engine.stats["generated_tokens"] == t0 and time.monotonic() < deadline:
        time.sleep(0.001)
    port_engine.update_weights_from_params(new, version=1)
    assert done.wait(120)
    vers = box[0].output_versions
    assert len(vers) == 100 and vers == sorted(vers) and vers[0] == 0 and vers[-1] == 1
    port_engine.update_weights_from_params(port_model(TINY_QWEN2, weights), version=0)


def test_pause_aborts_in_flight(port_engine):
    """A request that is decoding ends with "abort" and its partial tokens
    (queued requests wait out the pause, as in the JAX engine)."""
    box, done = [], threading.Event()
    t0 = port_engine.stats["generated_tokens"]
    port_engine.submit(
        ModelRequest(input_ids=[1, 2, 3], gconfig=GenerationHyperparameters(max_new_tokens=120)),
        lambda r: (box.append(r), done.set()),
    )
    deadline = time.monotonic() + 60
    while port_engine.stats["generated_tokens"] == t0 and time.monotonic() < deadline:
        time.sleep(0.001)
    port_engine.pause_generation()
    try:
        assert done.wait(60)
    finally:
        port_engine.continue_generation()
    assert box[0].stop_reason == "abort" and len(box[0].output_tokens) < 120


def test_generate_over_http(weights):
    cfg = ServerConfig(**_server_kwargs(), host="127.0.0.1", port=0)
    srv = ServerThread(cfg, engine=tde.DecodeEngine(cfg, params=port_model(TINY_QWEN2, weights), device="cpu"))
    srv.start()
    try:
        with urllib.request.urlopen(f"http://{srv.address}/health", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok", "version": 0}
        body = {"input_ids": [3, 1, 4, 1, 5], "sampling_params": {"max_new_tokens": 7, "greedy": True}}
        req = urllib.request.Request(
            f"http://{srv.address}/generate", data=json.dumps(body).encode(), method="POST"
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        assert len(out["output_tokens"]) == len(out["output_logprobs"]) == 7
        assert out["output_versions"] == [0] * 7 and out["stop_reason"] == "length"
        assert set(out["timing"]) >= {"queue_wait_s", "prefill_s", "decode_s"}
        req = urllib.request.Request(
            f"http://{srv.address}/set_version", data=b'{"version": 3}', method="POST"
        )
        urllib.request.urlopen(req, timeout=30).read()
        assert srv.engine.get_version() == 3
    finally:
        srv.stop()


def test_engine_stops_tokens_at_stop_id(port_engine):
    free = port_engine.generate_sync(
        ModelRequest(input_ids=[9, 8, 7], gconfig=GenerationHyperparameters(max_new_tokens=12, greedy=True)),
        timeout=60,
    )
    eos = free.output_tokens[4]
    first = free.output_tokens.index(eos)
    resp = port_engine.generate_sync(
        ModelRequest(
            input_ids=[9, 8, 7],
            gconfig=GenerationHyperparameters(max_new_tokens=12, greedy=True, stop_token_ids=[eos]),
        ),
        timeout=60,
    )
    assert resp.stop_reason == "stop" and resp.output_tokens == free.output_tokens[: first + 1]


def test_model_init_is_seeded():
    cfg = tq.ModelConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=1,
                         num_heads=4, num_kv_heads=2, dtype="float32")
    a = tq.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = tq.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    for (n, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), n
    w = a.layers[0].wq
    assert w.abs().max() <= 0.04 and 0.01 < w.std() < 0.03
    assert torch.equal(a.layers[0].bq, torch.zeros_like(a.layers[0].bq))


def test_pool_exhaustion_preempts_and_frees_every_page(weights):
    """A KV budget of 8 pages (7 usable) cannot hold two growing sequences:
    _ensure_pages preempts the slot with the most budget left (it returns
    "abort" with its partial tokens) or clamps a slot to the pages it holds,
    and every page returns to the pool."""
    kw = _server_kwargs()
    page_bytes = 2 * TINY_QWEN2.num_layers * TINY_QWEN2.num_kv_heads * kw["page_size"] * TINY_QWEN2.head_dim_ * 4
    cfg = ServerConfig(**kw, kv_hbm_gb=8 * page_bytes / (1 << 30))
    eng = tde.DecodeEngine(cfg, params=port_model(TINY_QWEN2, weights), device="cpu")
    eng.start()
    try:
        assert eng.pool.n_pages == 8
        reqs = [
            ModelRequest(input_ids=list(range(1, 21)), gconfig=GenerationHyperparameters(max_new_tokens=100, greedy=True)),
            ModelRequest(input_ids=list(range(30, 50)), gconfig=GenerationHyperparameters(max_new_tokens=90, greedy=True)),
        ]
        out = _run_all(eng, reqs)
    finally:
        eng.stop()
    reasons = sorted(r.stop_reason for r in out)
    assert eng.stats["preempted"] >= 1 and "abort" in reasons
    assert all(len(r.output_tokens) == len(r.output_logprobs) == len(r.output_versions) for r in out)
    assert all(len(r.output_tokens) < 100 for r in out)  # nobody got its full budget
    assert eng.pool.used == 0
